"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, bound with ``ctypes``.

At first use every ``csrc/<name>.cu`` that is not built yet becomes
``build/lib<name>-<hash>.so``, one ``nvcc`` per source, all started
together; the hash of the source and of the ``csrc/`` headers it includes
(``#include "..."``, followed through headers) names the file, so an edited
source or header is rebuilt. A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "build")
ARCH = "arch=compute_90a,code=sm_90a"

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def _source(name: str) -> str:
    return os.path.join(_PKG, "csrc", f"{name}.cu")


def sources() -> list:
    """Names of the kernel sources in ``csrc/``."""
    return sorted(os.path.splitext(os.path.basename(f))[0]
                  for f in glob.glob(os.path.join(_PKG, "csrc", "*.cu")))


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _with_headers(path: str) -> list:
    """``path`` and the files it includes by ``#include "..."``, each once,
    in the order they are first reached."""
    seen, todo = [], [os.path.abspath(path)]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as f:
            included = _INCLUDE.findall(f.read())
        todo += [os.path.join(os.path.dirname(path), h.decode())
                 for h in included]
    return seen


def library_path(name: str) -> str:
    digest = hashlib.sha1(ARCH.encode())
    for path in _with_headers(_source(name)):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build_all() -> Dict[str, str]:
    """Compile every source that is not built yet, one nvcc each, all at
    once. Returns each compiled source's nvcc report (-Xptxas -v:
    registers, shared memory, spills); sources already built are left
    out."""
    todo = [n for n in sources() if not os.path.exists(library_path(n))]
    if not todo:
        return {}
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = f"{library_path(name)}.tmp{os.getpid()}"
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
             _source(name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n"
                          f"{logs[name]}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def build(name: str) -> str:
    """Build ``csrc/<name>.cu`` (and every other source not built yet) unless
    it is built already. Returns its nvcc report, empty when nothing was
    compiled."""
    if os.path.exists(library_path(name)):
        return ""
    return build_all()[name]


def load(name: str) -> ctypes.CDLL:
    """The kernel library, built (with every other source) at first use."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(library_path(name))
        _loaded[name] = lib
    return lib
