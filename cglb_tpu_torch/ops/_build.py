"""Build and load the port's CUDA kernels (``cglb_tpu_torch/csrc``).

All sources are compiled by ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes``.  The build runs at first
use and again whenever a source is newer than the library (as
``cglb_tpu/utils/native.py`` does for the host runtime).  The library and the
compiler's ``-Xptxas -v`` report (registers, shared memory, spills per
kernel) go to ``cglb_tpu_torch/_build/``, which git ignores.

Nothing here is touched when a module is imported; the first CUDA launch
calls :func:`load`.  A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load", "check", "build_seconds", "BUILD_DIR", "LIB_PATH",
           "LOG_PATH"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libcglb_kernels.so"
LOG_PATH = BUILD_DIR / "build.log"

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int

# entry point -> argtypes (all return the int from cudaGetLastError())
_SIGNATURES = {
    "cglb_matvec": [_P, _I64, _P, _I64, _P, _I32, _I32, _I32, _I32, _P, _P],
    "cglb_ls_grad": [_P, _I64, _P, _I64, _P, _P, _I32, _I32, _I32, _P, _P],
    "cglb_kuf_f64": [_P, _I64, _P, _I64, _I32, _I32, _P, _P, _P, _P],
    "cglb_kuf_f32": [_P, _I64, _P, _I64, _I32, _I32, _P, _P, _P, _P],
}

_lib = None
_build_seconds = 0.0


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(s.stat().st_mtime > built for s in _sources())


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build() -> None:
    global _build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".libcglb_kernels.{os.getpid()}.so"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", str(tmp)]
    cmd += [str(s) for s in sorted(CSRC.glob("*.cu"))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    _build_seconds = time.perf_counter() - t0
    LOG_PATH.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (rc={proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, LIB_PATH)


def build_seconds() -> float:
    """Wall time of the build this process ran (0.0 if none ran)."""
    return _build_seconds


def load() -> ctypes.CDLL:
    """The kernel library, built first if missing or stale."""
    global _lib
    if _lib is not None:
        return _lib
    if _stale():
        _build()
    lib = ctypes.CDLL(str(LIB_PATH))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cglb_ls_grad_blocks.argtypes = [_I64]
    lib.cglb_ls_grad_blocks.restype = _I64
    _lib = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
