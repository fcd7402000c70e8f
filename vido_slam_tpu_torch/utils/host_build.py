"""Build and load the port's host C++ pieces: ``csrc/<name>.cpp`` compiled
by the host C++ compiler into ``build/lib<name>-<hash>.so`` (the directory
of the CUDA kernels), bound with ``ctypes``, or linked into an executable
``build/<name>-<hash>``.

The hash of the source, of the ``csrc/`` headers it includes and of the
compiler and linker flags names the file, so an edited source or another
flag is rebuilt; the build writes a temporary file and renames it, so
processes that build at once do not read a half-written file. A failed
build raises: there is no fallback.

``python_flags`` gives the flags of a piece that embeds CPython (the C
facade, ``csrc/vido_system.cpp``), taken from ``sysconfig`` of the
interpreter that builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
from typing import Dict, Sequence

from vido_slam_tpu_torch.utils import cuda_build

FLAGS = ["-std=c++17", "-O2"]
LIBRARY_FLAGS = ["-shared", "-fPIC"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _cxx() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler: put g++ on PATH or set CXX")


def _source(name: str) -> str:
    return os.path.join(cuda_build._PKG, "csrc", f"{name}.cpp")


def _flags(cflags: Sequence[str], executable: bool) -> list:
    return FLAGS + ([] if executable else LIBRARY_FLAGS) + list(cflags)


def output_path(name: str, cflags: Sequence[str] = (),
                ldflags: Sequence[str] = (), executable: bool = False) -> str:
    """Where ``build`` puts the piece: named by the hash of its source,
    the ``csrc/`` headers it includes and every flag."""
    flags = _flags(cflags, executable) + ["--link"] + list(ldflags)
    digest = hashlib.sha1(" ".join(flags).encode())
    for path in cuda_build._with_headers(_source(name)):
        with open(path, "rb") as f:
            digest.update(f.read())
    tag = digest.hexdigest()[:12]
    return os.path.join(cuda_build.BUILD_DIR, f"{name}-{tag}" if executable
                        else f"lib{name}-{tag}.so")


def build(name: str, cflags: Sequence[str] = (), ldflags: Sequence[str] = (),
          executable: bool = False) -> str:
    """Compile ``csrc/<name>.cpp`` into a shared library (or, with
    ``executable``, a program) unless it is built already: ``cflags``
    before the source, ``ldflags`` after it. Returns its path."""
    path = output_path(name, cflags, ldflags, executable)
    if os.path.exists(path):
        return path
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    proc = subprocess.run([_cxx(), *_flags(cflags, executable), "-o", tmp,
                           _source(name), *ldflags],
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


def python_flags() -> tuple:
    """(cflags, program ldflags) of a piece that embeds this interpreter.

    The compile flags add CPython's headers and bake in ``sys.executable``
    as ``VIDO_PYTHON_EXECUTABLE``: a program that starts the interpreter
    itself sets it as ``PyConfig.executable``, so that the interpreter
    finds the virtual environment (and the torch in it) that built the
    piece. A shared library that embeds CPython links no libpython: loaded
    into a Python process it takes the process's interpreter (where the
    executable has libpython linked in, a second libpython would be a
    second interpreter), and a program links the shared libpython, which
    an interpreter built without one lacks (that raises)."""
    cfg = sysconfig.get_config_var
    if not cfg("Py_ENABLE_SHARED"):
        raise RuntimeError("this Python has no shared libpython to link a "
                           "program that embeds it against")
    cflags = [f"-I{cfg('INCLUDEPY')}",
              f'-DVIDO_PYTHON_EXECUTABLE="{sys.executable}"']
    libdir = cfg("LIBDIR")
    return cflags, [f"-L{libdir}", f"-l:{cfg('LDLIBRARY')}",
                    f"-Wl,-rpath,{libdir}"]
