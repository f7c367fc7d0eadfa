"""Operations and bytes: the yardstick of the roofline and mfu metrics.

``bound``, ``matvec_bound``, ``ls_grad_bound`` and ``kuf_bound`` are frozen
copies of ``chip_smoke.py:358-397`` at commit 010f438 (each kernel's
operations and bytes from its call shapes, at the data's D, not the padded
width), so that a change to the program cannot change how its kernels are
judged.  ``PEAK_FLOPS`` and ``PEAK_BYTES`` are the H100 SXM data sheet's
dense rates at the 700 W limit: fp32 and fp64 outside the tensor cores, and
HBM3.

``STEP_PEAK_FLOPS`` is the rate a whole step or request is measured
against (``mfu``): 67 TFLOP/s, the data sheet's fp64 tensor-core rate and
also its fp32 rate.  cuBLAS runs fp64 GEMM and trsm on the fp64 tensor cores
at up to that rate, so 34 TFLOP/s would let a step read above 100 %.

The step counts follow these rules: a dense product 2mnk (a symmetric
A A^T: M (M + 1) N, the half a rank-k update needs), a Cholesky n^3 / 3, a
triangular solve with k right-hand sides m^2 k, a triangular inverse m^3 /
3; kernel pairs as the bounds above count them.  Element-wise work is left
out, so the counts are a floor of what the algorithm needs.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

__all__ = ["PEAK_FLOPS", "PEAK_BYTES", "STEP_PEAK_FLOPS", "bound",
           "matvec_bound", "ls_grad_bound", "kuf_bound", "matvec_flops",
           "ls_grad_flops", "kuf_flops", "KernelCall", "call_bound_ms",
           "call_flops", "kernel_flops", "cglb_step_dense_flops",
           "cglb_predict_dense_flops"]

PEAK_FLOPS = {"fp32": 67e12, "fp64": 34e12}
PEAK_BYTES = 3.35e12
STEP_PEAK_FLOPS = 67e12


def bound(flops: float, dtype: str, nbytes: float):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the operations over the peak rate of their type and the bytes (each
    input read once, each output written once) over the memory rate."""
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


def matvec_flops(ni: int, nj: int, d: int, b: int,
                 symmetric: bool = False) -> float:
    """Kernel 1 per pair: d subtractions and d FMAs for t (3d flops), about
    4 for the profile, one FMA per batch row (2b).  Symmetric (one point
    set): n(n+1)/2 pairs, each feeding both sides (4b)."""
    return (ni * (ni + 1) // 2 * (3 * d + 4 + 4 * b) if symmetric
            else ni * nj * (3 * d + 4 + 2 * b))


def matvec_bound(ni: int, nj: int, d: int, b: int, accurate: bool,
                 symmetric: bool = False):
    """Kernel 1: fp32 operations; bytes: both coordinate sets and p in
    fp32, the output in fp64 (accurate) or fp32."""
    return bound(matvec_flops(ni, nj, d, b, symmetric), "fp32",
                 (ni + nj) * d * 4 + b * ni * 4 + b * nj * (8 if accurate
                                                             else 4))


def ls_grad_flops(ni: int, nj: int, d: int, b: int,
                  symmetric: bool = False) -> float:
    """Kernel 2 per pair: d subtractions, d products df * df and d additions
    for t (3d), about 3 for rho', 2b + 1 for p.g and m (symmetric: n(n+1)/2
    pairs and 4b + 1), and one FMA per dimension for m * df^2 (2d)."""
    return (ni * (ni + 1) // 2 * (5 * d + 3 + 4 * b + 1) if symmetric
            else ni * nj * (5 * d + 3 + 2 * b + 1))


def ls_grad_bound(ni: int, nj: int, d: int, b: int, symmetric: bool = False):
    """Kernel 2: fp32 operations; bytes: coordinates, p, g."""
    return bound(ls_grad_flops(ni, nj, d, b, symmetric), "fp32",
                 (ni + nj) * d * 4 + b * (ni + nj) * 4 + d * 8)


def kuf_flops(m: int, n: int, d: int) -> float:
    """Kernel 3: about 3d + 6 operations an entry."""
    return m * n * (3 * d + 6)


def kuf_bound(m: int, n: int, d: int, with_e: bool = True):
    """Kernel 3: writes Kuf and e in fp64 (16 bytes an entry; 8 without e)
    and reads Z and X; about 3d + 6 fp64 operations an entry."""
    return bound(kuf_flops(m, n, d), "fp64",
                 (m + n) * d * 8 + m * n * (16 if with_e else 8))


class KernelCall(NamedTuple):
    """One call of a launcher of kernels 1-3, as the recorder saw it:
    ``kind`` "matvec", "ls_grad" or "kuf"; rows and columns (kuf: M and N);
    the data's D; the batch width (kuf: 1); kernel 1's accurate tier; the
    symmetric path (one point set); kernel 3's e written."""
    kind: str
    rows: int
    cols: int
    d: int
    b: int = 1
    accurate: bool = True
    symmetric: bool = False
    with_e: bool = True


def call_bound_ms(c: KernelCall) -> float:
    if c.kind == "matvec":
        return matvec_bound(c.rows, c.cols, c.d, c.b, c.accurate,
                            c.symmetric)[0]
    if c.kind == "ls_grad":
        return ls_grad_bound(c.rows, c.cols, c.d, c.b, c.symmetric)[0]
    return kuf_bound(c.rows, c.cols, c.d, c.with_e)[0]


def call_flops(c: KernelCall) -> float:
    if c.kind == "matvec":
        return matvec_flops(c.rows, c.cols, c.d, c.b, c.symmetric)
    if c.kind == "ls_grad":
        return ls_grad_flops(c.rows, c.cols, c.d, c.b, c.symmetric)
    return kuf_flops(c.rows, c.cols, c.d)


def kernel_flops(calls: Iterable[KernelCall]) -> float:
    return float(sum(call_flops(c) for c in calls))


def _precond_apply(n: int, m: int) -> float:
    """One Nystrom apply on a vector: A r, Ci (Ci^T w), A^T w."""
    return 4.0 * m * n + 4.0 * m * m


def cglb_step_dense_flops(n: int, m: int, precond_applies: int) -> float:
    """The dense linear algebra of one CGLB loss and gradient (models/
    cglb.py, models/sgpr.py), kernel calls excluded.  Forward: chol(Kuu),
    A = L^-1 Kuf (trsm), A A^T, chol(B), the fp32 preconditioner's own
    A A^T, its Cholesky and inverse, and ``precond_applies`` applies (CG's
    and the bound's).  Backward: the trsm's cotangents for Kuf and L (a
    trsm and a product), A A^T's (one product) twice, three Cholesky
    backwards (about n^3 each)."""
    mm = float(m)
    fwd = (mm ** 3 / 3 + mm * mm * n + mm * (mm + 1) * n + mm ** 3 / 3
           + mm * (mm + 1) * n + 2 * mm ** 3 / 3
           + precond_applies * _precond_apply(n, m))
    bwd = (mm * mm * n + 2 * mm * mm * n + 2 * (2 * mm * mm * n)
           + 3 * mm ** 3)
    return fwd + bwd


def cglb_predict_dense_flops(n: int, m: int, s: int,
                             precond_applies: int) -> float:
    """The dense linear algebra of one ``Model.predict_log_density`` on s
    rows, kernel calls excluded: the common terms without the backward
    (chol(Kuu), the trsm, A A^T, chol(B)), the fp32 preconditioner (A A^T,
    Cholesky, inverse) and its applies in CG, A res, the [M] solve, and per
    row L^-1 Kus and LB^-1 (two trsms with s right-hand sides) and
    tmp2^T c."""
    mm = float(m)
    prepare = (mm ** 3 / 3 + mm * mm * n + mm * (mm + 1) * n + mm ** 3 / 3
               + mm * (mm + 1) * n + 2 * mm ** 3 / 3
               + precond_applies * _precond_apply(n, m) + 2 * mm * n)
    rows = 2 * mm * mm * s + 2 * mm * s
    return prepare + rows
