"""The port's C facade (``csrc/vido_system.cpp`` through
``native_system.py``), built with the host compiler here and loaded by
ctypes, and its standalone host (``csrc/run_vido_native.cpp``) run as a
subprocess, on the CPU (``vido_system_init_ex`` with ``{"device":
"cpu"}``), on the JAX package's own facade scene
(tests/test_native_system.py: 256x160, a moving box, 5 frames).

Bars: the facade's poses, object rows and result files equal to the bit to
the port's Python ``System`` in the same process (the same calls on the
same values); its poses within 1e-3 m / 1e-3 rad of the JAX package's
``System`` (the bars of tests/test_torch_system.py), its object rows of
JAX's count with equal ids and labels, positions and velocities within
1e-3 m, yaw within 1e-3 rad and speed within 0.036 km/h (1e-3 m a frame
at 10 fps); the runner's printed translations equal to the Python
``System``'s printed the same way.
"""

import ctypes
import json
import os
import subprocess
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.geometry.se3 import make_se3
from vido_slam_tpu.geometry.so3 import exp_so3
from vido_slam_tpu.io.synthetic import SyntheticSequence, simple_scene
from vido_slam_tpu.system import Sensor as JSensor
from vido_slam_tpu.system import System as JSystem
from vido_slam_tpu_torch import native_system
from vido_slam_tpu_torch.system import Sensor, System

torch.set_num_threads(1)

KWARGS = {"device": "cpu", "n_bg": 600, "n_obj": 1500, "max_objects": 4}
RESULT_FILES = ("obj_mot_rgbd_new.txt", "initial_rgbd_new.txt",
                "refined_rgbd_new.txt", "cam_pose_gt.txt")


def write_cfg(d, cam):
    text = textwrap.dedent(f"""\
        %YAML:1.0
        slam_mode: 0
        ChooseData: 1
        DepthMapFactor: 100
        Camera.width: {cam.width}
        Camera.height: {cam.height}
        Camera.fx: {float(cam.fx)}
        Camera.fy: {float(cam.fy)}
        Camera.cx: {float(cam.cx)}
        Camera.cy: {float(cam.cy)}
        Camera.bf: {float(cam.bf)}
        Camera.fps: 10
        MaxTrackPointBG: 600
        WINDOW_SIZE: 4
    """)
    path = str(d / "config.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


def ptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def frame_arrays(fr):
    return (np.ascontiguousarray(fr.depth * 100.0, np.float32),
            np.ascontiguousarray(fr.flow, np.float32),
            np.ascontiguousarray(fr.mask, np.int32),
            np.ascontiguousarray(fr.Tcw_gt, np.float32))


def close_pose(Tj, Tt):
    Tj, Tt = np.asarray(Tj, np.float64), np.asarray(Tt, np.float64)
    assert np.abs(Tj[:3, 3] - Tt[:3, 3]).max() <= 1e-3
    R = Tj[:3, :3].T @ Tt[:3, :3]
    assert np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)) <= 1e-3


def objects(lib, sys_c, max_n=16):
    out = np.zeros((max_n, 10), np.float64)
    n = lib.vido_system_get_objects(sys_c, -1, ptr(out), max_n)
    assert n >= 0
    return out[:n]


def read_results(prefix):
    out = {}
    for name in RESULT_FILES:
        with open(prefix + name, "rb") as f:
            out[name] = f.read()
    return out


@pytest.fixture(scope="module")
def lib():
    return native_system.facade()


@pytest.fixture(scope="module")
def scene_seq():
    scene = simple_scene(width=256, height=160, moving_box=True,
                         box_speed=0.6)
    dT = np.asarray(make_se3(exp_so3(jnp.array([0.0, 0.01, 0.0])),
                             jnp.array([0.02, 0.0, -0.4])))
    return scene, SyntheticSequence(scene, [dT], n_frames=5)


def test_facade_equals_the_python_system_and_jax(lib, scene_seq, tmp_path):
    scene, seq = scene_seq
    cfg = write_cfg(tmp_path, scene.cam)
    sys_c = lib.vido_system_create()
    assert sys_c
    assert lib.vido_system_init_ex(sys_c, cfg.encode(), 2,
                                   json.dumps(KWARGS).encode()) == 0
    sys_py = System()
    sys_py.Init(cfg, Sensor.RGBD, **KWARGS)
    sys_j = JSystem()
    sys_j.Init(cfg, JSensor.RGBD, n_bg=600, n_obj=1500, max_objects=4)
    assert sys_py.tracker.device.type == "cpu"
    pose = np.zeros(16, np.float32)
    H, W = scene.cam.height, scene.cam.width
    n_rows = []
    for i, fr in enumerate(seq.frames):
        depth, flow, mask, gt = frame_arrays(fr)
        t = float(i) / 10.0
        assert lib.vido_system_track(sys_c, None, ptr(depth), ptr(flow),
                                     ptr(mask), ptr(gt), t, H, W,
                                     ptr(pose)) == 0
        p_py = sys_py.TrackRGBD(None, depth, fr.flow, fr.mask, mTcw_gt=gt,
                                timestamp=t)
        p_j = sys_j.TrackRGBD(None, depth, fr.flow, fr.mask,
                              mTcw_gt=fr.Tcw_gt, timestamp=t)
        np.testing.assert_array_equal(pose.reshape(4, 4),
                                      np.asarray(p_py, np.float32))
        close_pose(p_j, pose.reshape(4, 4))
        rows = objects(lib, sys_c)
        py_rows = sys_py.GetFrameOutputArray(-1)
        j_rows = sys_j.GetFrameOutputArray(-1)
        np.testing.assert_array_equal(rows, py_rows)
        assert py_rows.shape == j_rows.shape and py_rows.dtype == np.float64
        if len(j_rows):
            np.testing.assert_array_equal(py_rows[:, :2], j_rows[:, :2])
            assert np.abs(py_rows[:, 2:8] - j_rows[:, 2:8]).max() <= 1e-3
            assert np.abs(py_rows[:, 8] - j_rows[:, 8]).max() <= 1e-3
            assert np.abs(py_rows[:, 9] - j_rows[:, 9]).max() <= 0.036
        n_rows.append(len(rows))
    assert sum(n_rows) > 0, n_rows
    # max_n below the count: the count is returned, max_n rows written
    out = np.full((2, 10), -7.0)
    n = lib.vido_system_get_objects(sys_c, 2, ptr(out), 1)
    assert n == len(sys_py.GetFrameOutputArray(2))
    if n:
        np.testing.assert_array_equal(out[0], sys_py.GetFrameOutputArray(2)[0])
    np.testing.assert_array_equal(out[1], -7.0)
    c_prefix, py_prefix = str(tmp_path / "c_"), str(tmp_path / "py_")
    assert lib.vido_system_save(sys_c, c_prefix.encode()) == 0
    sys_py.SaveResultsIJRR2020(py_prefix)
    c_files, py_files = read_results(c_prefix), read_results(py_prefix)
    assert c_files == py_files
    assert all(c_files[name] for name in RESULT_FILES)
    lib.vido_system_destroy(sys_c)


def test_failed_calls_return_minus_one(lib, tmp_path, capfd):
    sys_c = lib.vido_system_create()
    assert sys_c
    # no such settings file: Init raises, the C call prints and returns -1
    assert lib.vido_system_init_ex(sys_c, str(tmp_path / "none.yaml")
                                   .encode(), 2, b'{"device": "cpu"}') == -1
    assert lib.vido_system_init_ex(sys_c, b"x.yaml", 2, b"[1, 2]") == -1
    pose = np.zeros(16, np.float32)
    assert lib.vido_system_track(sys_c, None, None, None, None, None, 0.0,
                                 4, 4, ptr(pose)) == -1
    err = capfd.readouterr().err
    assert "Traceback" in err
    lib.vido_system_destroy(sys_c)


def imu_rows(k):
    """Ten seeded IMU rows (ax, ay, az, wx, wy, wz, t) of the 0.1 s before
    frame k."""
    rng = np.random.RandomState(k)
    rows = np.zeros((10, 7), np.float64)
    rows[:, :3] = rng.normal(0, 0.1, (10, 3)) + [0.0, 9.81, 0.0]
    rows[:, 3:6] = rng.normal(0, 0.01, (10, 3))
    rows[:, 6] = 0.1 * (k - 1) + 0.01 * np.arange(1, 11)
    return rows


def test_vio_overload_equals_the_python_system(lib, scene_seq, tmp_path):
    scene, seq = scene_seq
    cfg = write_cfg(tmp_path, scene.cam)
    sys_c = lib.vido_system_create()
    assert lib.vido_system_init_ex(sys_c, cfg.encode(), 3,
                                   json.dumps(KWARGS).encode()) == 0
    sys_py = System()
    sys_py.Init(cfg, Sensor.IMU_RGBD, **KWARGS)
    pose = np.zeros(16, np.float32)
    H, W = scene.cam.height, scene.cam.width
    for i, fr in enumerate(seq.frames[:3]):
        depth, flow, mask, _ = frame_arrays(fr)
        imu = imu_rows(i)
        t = 0.1 * i
        assert lib.vido_system_track_imu(sys_c, None, ptr(depth), ptr(flow),
                                         ptr(mask), None, t, ptr(imu), 10, H,
                                         W, ptr(pose)) == 0
        p_py = sys_py.TrackRGBDWithIMUArray(None, depth, flow, mask, None, t,
                                            imu)
        np.testing.assert_array_equal(pose.reshape(4, 4),
                                      np.asarray(p_py, np.float32))
    assert len(sys_py.tracker._preints) == 2
    lib.vido_system_destroy(sys_c)


def test_standalone_host_prints_the_python_systems_translations(scene_seq,
                                                                tmp_path):
    scene, _ = scene_seq
    cfg = write_cfg(tmp_path, scene.cam)
    exe = native_system.runner()
    kwargs = json.dumps({"device": "cpu"})
    out = subprocess.run([exe, cfg, "3", kwargs], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert lines[-1] == "ok"
    system = System()
    system.Init(cfg, Sensor.RGBD, device="cpu")
    depth = native_system.runner_depth()
    flow = np.zeros((160, 256, 2), np.float32)
    mask = np.zeros((160, 256), np.int32)
    want = []
    for t in range(3):
        p = np.asarray(system.TrackRGBD(None, depth, flow, mask, None, None,
                                        t / 10.0), np.float32)
        want.append(f"frame {t}: t = [{p[0, 3]:.4f} {p[1, 3]:.4f} "
                    f"{p[2, 3]:.4f}]")
    assert [ln for ln in lines if ln.startswith("frame ")] == want
