"""Build and load the port's host C++ helpers: ``csrc/<name>.cpp`` compiled
by the host C++ compiler into ``build/lib<name>-<hash>.so`` (the directory
of the CUDA kernels), bound with ``ctypes``.

The hash of the source, of the ``csrc/`` headers it includes and of the
compiler flags names the file, so an edited source is rebuilt; the build
writes a temporary file and renames it, so processes that build at once
do not read a half-written library. A failed build raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict

from vido_slam_tpu_torch.utils import cuda_build

FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _cxx() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler: put g++ on PATH or set CXX")


def _source(name: str) -> str:
    return os.path.join(cuda_build._PKG, "csrc", f"{name}.cpp")


def library_path(name: str) -> str:
    digest = hashlib.sha1(" ".join(FLAGS).encode())
    for path in cuda_build._with_headers(_source(name)):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(cuda_build.BUILD_DIR,
                        f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cpp`` unless it is built already. Returns the
    library's path."""
    path = library_path(name)
    if os.path.exists(path):
        return path
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    proc = subprocess.run([_cxx(), *FLAGS, "-o", tmp, _source(name)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"host build of {name} failed (exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, path)
    return path


def load(name: str) -> ctypes.CDLL:
    """The helper's library, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _loaded[name] = lib
    return lib
