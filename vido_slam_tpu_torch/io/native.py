"""Counterpart of the JAX package's ``io/native.py``: the threaded file
prefetcher, host C++ (``csrc/file_prefetcher.cpp``, built at first use by
``utils/host_build.py``, bound by ``ctypes``), and the two readers.

``FilePrefetcher(paths, n_threads, max_ahead)`` reads whole files on
worker threads ahead of the consumer; ``get(idx)`` returns a file's
bytes. As in the JAX package: a file that cannot be opened gives
``b""``, ``get`` once every file is served raises ``IOError`` (``IndexError``
for an index past the list), and ``get`` blocks
until its file is read, so a consumer that skips more than ``max_ahead``
files ahead may wait forever (the workers hold the files past the window
until the consumer is served one inside it). One repair: JAX's ``get``
can raise for a file a worker is still reading (its end-of-list test
counts the indices taken, not the files read; about a third of in-order
passes over ten files lose one), which the port's never does. Where the
JAX package reads
a file in Python when the library is missing, the port raises the build's
error: there is no fallback.

``demosaic_bg2bgr`` and ``read_flo_native`` are the port's readers
(``io/datasets.py``): its demosaic is ``cv2.cvtColor(raw,
COLOR_BayerBG2BGR)`` to the bit, where the JAX package's native one is a
plain bilinear filter that differs from cv2 by up to 2 levels inside the
image and more on the border (a known deviation, not copied).
"""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np

from vido_slam_tpu_torch.io.datasets import demosaic_bayer_bg2bgr, read_flo
from vido_slam_tpu_torch.utils import host_build

_lib = None


def _load() -> ctypes.CDLL:
    """The prefetcher's library, built at first use; a failed build
    raises."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(host_build.build("file_prefetcher", ["-pthread"]))
        lib.vido_prefetcher_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.vido_prefetcher_create.restype = ctypes.c_void_p
        lib.vido_prefetcher_get.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64]
        lib.vido_prefetcher_get.restype = ctypes.c_int64
        lib.vido_prefetcher_destroy.argtypes = [ctypes.c_void_p]
        lib.vido_prefetcher_destroy.restype = None
        _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the prefetcher's library builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def demosaic_bg2bgr(raw: np.ndarray) -> np.ndarray:
    """BayerBG -> BGR, cv2's ``COLOR_BayerBG2BGR`` to the bit."""
    return demosaic_bayer_bg2bgr(np.ascontiguousarray(raw, np.uint8))


def read_flo_native(path: str) -> np.ndarray:
    """A Middlebury ``.flo`` file as (H, W, 2) float32."""
    return read_flo(path)


class FilePrefetcher:
    """Threaded read-ahead over a file list (host C++ worker threads)."""

    def __init__(self, paths: List[str], n_threads: int = 2,
                 max_ahead: int = 8):
        self.paths = list(paths)
        self._lib = _load()
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        self._handle = self._lib.vido_prefetcher_create(
            arr, len(self.paths), n_threads, max_ahead)

    def get(self, idx: int) -> bytes:
        """File ``idx``'s bytes, once it is read (blocks until then)."""
        sz = self._lib.vido_prefetcher_get(self._handle, idx, None, 0)
        if sz < 0:
            # as in the JAX package: an index past the list raises
            # IndexError here, one already served IOError
            raise IOError(f"prefetch {self.paths[idx]}: {sz}")
        buf = np.empty(sz, np.uint8)
        got = self._lib.vido_prefetcher_get(
            self._handle, idx, buf.ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8)), sz)
        if got != sz:
            raise IOError(f"prefetch {self.paths[idx]}: {got}")
        return buf.tobytes()

    def close(self) -> None:
        if self._handle is not None:
            self._lib.vido_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self.close()
