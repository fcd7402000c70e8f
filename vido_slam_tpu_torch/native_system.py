"""The port's C facade (``csrc/vido_system.cpp``, the C ABI of the JAX
package's ``native/vido_system.h``) and its standalone host
(``csrc/run_vido_native.cpp``): the Python half that the C side calls, and
the loaders that build both at first use.

The C side passes each buffer as an address. The functions here copy the
caller's buffers into numpy arrays (the caller may reuse its buffers,
while the tracker may keep what it was given), call the port's ``System``
and write the pose (16 float32, row-major Tcw) and the object rows (10
float64 each) back as host arrays: a pipelined tracker returns its pose
as a device tensor, which is first copied to the host. A call that raises
makes the C function print the error and return -1.

``facade()`` is the facade as a ``ctypes.CDLL`` with its argument types
set; ``runner()`` is the path of the standalone program. Both are built
by ``utils/host_build.py`` into the git-ignored ``build/`` directory;
``vido_system_init`` runs on the card, ``vido_system_init_ex`` with
``{"device": "cpu"}`` on the CPU.
"""

from __future__ import annotations

import ctypes
import json
import os

import numpy as np
import torch

from vido_slam_tpu_torch.system import Sensor, System
from vido_slam_tpu_torch.utils import host_build

_facade = None


def _view(address: int, ctype, shape) -> np.ndarray:
    """The caller's buffer at ``address`` as a numpy array (no copy)."""
    if not address:
        raise ValueError("a required buffer is NULL")
    n = int(np.prod(shape))
    return np.ctypeslib.as_array((ctype * n).from_address(address)) \
        .reshape(shape)


def _frame(gray, depth, flow, mask, tcw_gt, H, W):
    """Copies of one frame's buffers: gray and the ground-truth pose may be
    NULL (None)."""
    return (None if not gray else _view(gray, ctypes.c_float, (H, W)).copy(),
            _view(depth, ctypes.c_float, (H, W)).copy(),
            _view(flow, ctypes.c_float, (H, W, 2)).copy(),
            _view(mask, ctypes.c_int32, (H, W)).copy(),
            None if not tcw_gt else
            _view(tcw_gt, ctypes.c_float, (4, 4)).copy())


def _write_pose(Tcw, pose_out: int) -> int:
    if isinstance(Tcw, torch.Tensor):
        Tcw = Tcw.detach().cpu().numpy()
    _view(pose_out, ctypes.c_float, (16,))[:] = \
        np.asarray(Tcw, np.float32).reshape(16)
    return 0


def create() -> System:
    return System()


def init(system: System, settings_file: str, sensor: int,
         json_kwargs: str = "{}") -> int:
    """``System.Init`` with the JSON object's keyword arguments."""
    system.Init(settings_file, Sensor(sensor), **json.loads(json_kwargs))
    return 0


def track(system: System, gray, depth, flow, mask, tcw_gt, timestamp: float,
          H: int, W: int, pose_out) -> int:
    g, d, f, m, gt = _frame(gray, depth, flow, mask, tcw_gt, H, W)
    return _write_pose(system.TrackRGBD(g, d, f, m, gt, None, timestamp),
                       pose_out)


def track_imu(system: System, gray, depth, flow, mask, tcw_gt,
              timestamp: float, imu, n_imu: int, H: int, W: int,
              pose_out) -> int:
    g, d, f, m, gt = _frame(gray, depth, flow, mask, tcw_gt, H, W)
    rows = _view(imu, ctypes.c_double, (n_imu, 7)).copy() \
        if imu and n_imu > 0 else None
    return _write_pose(system.TrackRGBDWithIMUArray(g, d, f, m, gt,
                                                    timestamp, rows),
                       pose_out)


def get_objects(system: System, frame_index: int, out, max_n: int) -> int:
    """Writes up to ``max_n`` rows of the frame's objects; returns how many
    the frame has."""
    rows = system.GetFrameOutputArray(frame_index)
    k = min(rows.shape[0], max_n)
    if out and k > 0:
        _view(out, ctypes.c_double, (k, 10))[:] = rows[:k]
    return rows.shape[0]


def save(system: System, path: str) -> int:
    system.SaveResultsIJRR2020(path)
    return 0


def runner_depth(height: int = 160, width: int = 256) -> np.ndarray:
    """The raw depth the standalone host feeds every frame, as its C++
    computes it in float32: 100 (8 + 4 h / 255), h byte 2 of the pixel
    index times 2654435761 modulo 2^32."""
    i = np.arange(height * width, dtype=np.uint64)
    h = ((i * np.uint64(2654435761)) % np.uint64(2 ** 32) >> np.uint64(16)) \
        & np.uint64(0xff)
    return (np.float32(100.0) * (np.float32(8.0) + np.float32(4.0)
                                 * h.astype(np.float32) / np.float32(255.0))
            ).reshape(height, width)


# ---------------------------------------------------------------------------
# building and loading

def library_path() -> str:
    """The facade, built at first use."""
    cflags, _ = host_build.python_flags()
    return host_build.build("vido_system", cflags, ["-ldl"])


def runner() -> str:
    """The standalone program, built at first use (after the facade, which
    it links)."""
    lib = library_path()
    _, ldflags = host_build.python_flags()
    return host_build.build(
        "run_vido_native", [],
        [f"-L{os.path.dirname(lib)}", f"-l:{os.path.basename(lib)}",
         "-Wl,-rpath,$ORIGIN", *ldflags], executable=True)


def facade() -> ctypes.CDLL:
    """The facade loaded into this process (``ctypes.CDLL``: the GIL is
    released around each call, which takes it again)."""
    global _facade
    if _facade is None:
        L = ctypes.CDLL(library_path())
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        L.vido_system_create.restype = p
        L.vido_system_init.argtypes = [p, ctypes.c_char_p, i]
        L.vido_system_init_ex.argtypes = [p, ctypes.c_char_p, i,
                                          ctypes.c_char_p]
        L.vido_system_track.argtypes = [p, p, p, p, p, p, d, i, i, p]
        L.vido_system_track_imu.argtypes = [p, p, p, p, p, p, d, p, i, i, i,
                                            p]
        L.vido_system_get_objects.argtypes = [p, i, p, i]
        L.vido_system_save.argtypes = [p, ctypes.c_char_p]
        L.vido_system_destroy.argtypes = [p]
        L.vido_system_destroy.restype = None
        _facade = L
    return _facade

