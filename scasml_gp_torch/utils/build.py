"""Build the port's CUDA sources with nvcc and load them with ctypes.

``load_library()`` compiles every ``scasml_gp_torch/csrc/*.cu`` into one
shared library with a plain C interface, at first use, into
``scasml_gp_torch/_build/`` (listed in ``.gitignore``).  The library's name
carries a hash of the sources and flags, so an edited source is rebuilt and a
stale library is never loaded.  A missing ``nvcc``, a failed compile or a
failed load raises with the compiler's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

_PKG = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc's output of the build this process made, if any


def find_nvcc() -> str:
    """nvcc from CUDA_HOME / CUDA_PATH, then PATH, then the toolkit's
    default install location; raises if none exists."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of scasml_gp_torch cannot be built"
    )


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode())
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libscasml_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources if their library is missing; returns its path."""
    global build_log
    path = library_path()
    if os.path.exists(path):
        return path
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *_sources()]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        build_log = proc.stdout + proc.stderr
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        _lib = bind(ctypes.CDLL(build()))  # raises OSError with the loader's message
        return _lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of the library's entry points."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.scasml_fused_posterior.argtypes = [
        ci, ci, ci, ci, vp, vp, vp, ci, ci, ci, cf, cf, cf, ci, vp, vp, vp]
    lib.scasml_fused_posterior.restype = ci
    lib.scasml_fused_posterior_occupancy.argtypes = [
        ci, ci, ci, ci, ctypes.POINTER(ci)]
    lib.scasml_fused_posterior_occupancy.restype = ci
    lib.scasml_cuda_error_string.argtypes = [ci]
    lib.scasml_cuda_error_string.restype = ctypes.c_char_p
    return lib
