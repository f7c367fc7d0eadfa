"""ctypes bindings of the native host runtime (``native/*.cpp``).

Counterpart of ``cglb_tpu/utils/native.py``, over the same C sources, which
this package reads and never edits:

- :class:`NativeLBFGS`: reverse-communication L-BFGS with a strong-Wolfe
  line search (the optimizer's update runs on the host; the device
  evaluates loss and gradient);
- :func:`conditional_variance_native`: greedy ConditionalVariance selection
  on the host, an oracle for ``utils/inducing.py`` (the configs select on
  the device).

The library is built at first use with ``g++`` and the flags of
``native/Makefile`` into ``cglb_tpu_torch/_build/``, and again when a source
is newer.  A failed build or load raises: nothing degrades to another
optimizer.  :func:`native_available` asks without raising.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["load_native", "native_available", "conditional_variance_native",
           "NativeLBFGS", "NATIVE_DIR", "LIB_PATH"]

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG.parent / "native"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libcglb_native.so"

# native/Makefile: CXXFLAGS, and FASTFLAGS for cond_var.cpp only (lbfgs.cpp
# stays strict: the Wolfe bracketing arithmetic must not be reassociated)
_CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-fopenmp", "-Wall", "-Wextra",
             "-std=c++17"]
_SOURCES = {"cond_var.cpp": _CXXFLAGS + ["-Ofast"], "lbfgs.cpp": _CXXFLAGS}

_F64P = ctypes.POINTER(ctypes.c_double)
_I64P = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "cglb_native_version": ([], ctypes.c_int),
    "cglb_conditional_variance": (
        [_F64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
         ctypes.c_double, ctypes.c_double, _I64P], ctypes.c_int),
    "cglb_lbfgs_create": (
        [ctypes.c_int64, ctypes.c_int, ctypes.c_double, ctypes.c_double,
         ctypes.c_int, ctypes.c_double], ctypes.c_void_p),
    "cglb_lbfgs_destroy": ([ctypes.c_void_p], None),
    "cglb_lbfgs_step": ([ctypes.c_void_p, _F64P, ctypes.c_double, _F64P,
                         _F64P], ctypes.c_int),
    "cglb_lbfgs_best_f": ([ctypes.c_void_p], ctypes.c_double),
    "cglb_lbfgs_best_x": ([ctypes.c_void_p, _F64P], None),
}

_lib = None


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any((NATIVE_DIR / s).stat().st_mtime > built for s in _SOURCES)


def _build() -> None:
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native library cannot be "
                           "built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs = []
    try:
        for src, flags in _SOURCES.items():
            obj = BUILD_DIR / f"{Path(src).stem}.{os.getpid()}.o"
            objs.append(obj)
            _run([cxx] + flags + ["-c", "-o", str(obj),
                                  str(NATIVE_DIR / src)])
        tmp = BUILD_DIR / f".{LIB_PATH.name}.{os.getpid()}"
        _run([cxx] + _CXXFLAGS + ["-shared", "-o", str(tmp)]
             + [str(o) for o in objs])
        os.replace(tmp, LIB_PATH)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)


def _run(cmd) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} (rc={proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")


def load_native() -> ctypes.CDLL:
    """The native library, built first if missing or stale."""
    global _lib
    if _lib is not None:
        return _lib
    if _stale():
        _build()
    lib = ctypes.CDLL(str(LIB_PATH))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    return lib


def native_available() -> bool:
    """Whether the native library loads (it is built first where missing
    or stale): :func:`load_native` that returns False where it raises."""
    try:
        load_native()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def conditional_variance_native(X, M: int, kernel, seed: int = 0,
                                jitter: float = 1e-12):
    """(Z [M, D], indices [M]) as numpy arrays: the semantics of
    ``utils.inducing.conditional_variance`` (permute with ``seed``, greedy
    argmax of the conditional variance) on the host.  ``kernel`` is one of
    the package's stationary kernels; X an array or a tensor."""
    lib = load_native()
    family = {"rbf": 0, "mat32": 1}[kernel.family]
    var = float(kernel.variance.value.detach())
    ls = kernel.lengthscales.value.detach().cpu().numpy().astype(np.float64)
    if hasattr(X, "detach"):
        X = X.detach().cpu().numpy()
    X = np.asarray(X, dtype=np.float64)
    N = X.shape[0]
    if not 1 <= M <= N:
        raise ValueError(f"M = {M} outside 1..{N}")
    perm = np.random.default_rng(seed).permutation(N)
    Xs = np.ascontiguousarray(X[perm] / ls)
    out = np.zeros(M, dtype=np.int64)
    rc = lib.cglb_conditional_variance(
        Xs.ctypes.data_as(_F64P), N, X.shape[1], M, family, var, jitter,
        out.ctypes.data_as(_I64P))
    if rc != 0:
        raise RuntimeError(f"cglb_conditional_variance failed rc={rc}")
    return X[perm][out], perm[out]


class NativeLBFGS:
    """Reverse-communication L-BFGS handle.

        opt = NativeLBFGS(n)
        x = x0
        while evals < budget:
            f, g = value_and_grad(x)
            status, x = opt.step(x, f, g)
            if status in (NativeLBFGS.CONVERGED, NativeLBFGS.FAIL): break
    """

    EVALUATE = 0
    ACCEPTED = 1
    CONVERGED = 2
    FAIL = 3

    _h = None  # the C handle; None before creation and after close()

    def __init__(self, n: int, history: int = 15, c1: float = 1e-4,
                 c2: float = 0.9, max_linesearch: int = 25,
                 gtol: float = 1e-9):
        self._lib = load_native()
        self.n = int(n)
        self._h = self._lib.cglb_lbfgs_create(self.n, history, c1, c2,
                                              max_linesearch, gtol)
        if not self._h:
            raise RuntimeError("cglb_lbfgs_create failed")

    def _vector(self, a) -> np.ndarray:
        a = np.ascontiguousarray(a, dtype=np.float64)
        if a.shape != (self.n,):
            raise ValueError(f"vector of shape {a.shape} for n = {self.n}")
        return a

    def step(self, x, f: float, g):
        """(status, next x) from the loss f and gradient g at x."""
        x, g = self._vector(x), self._vector(g)
        x_out = np.empty_like(x)
        status = self._lib.cglb_lbfgs_step(
            self._h, x.ctypes.data_as(_F64P), float(f),
            g.ctypes.data_as(_F64P), x_out.ctypes.data_as(_F64P))
        return status, x_out

    @property
    def best_f(self) -> float:
        return self._lib.cglb_lbfgs_best_f(self._h)

    @property
    def best_x(self) -> np.ndarray:
        out = np.empty(self.n, dtype=np.float64)
        self._lib.cglb_lbfgs_best_x(self._h, out.ctypes.data_as(_F64P))
        return out

    def close(self) -> None:
        if self._h:
            self._lib.cglb_lbfgs_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
