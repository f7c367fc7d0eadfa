"""Cholesky factor, its inverse, and the lower solve with many columns.

The interface of ``cglb_tpu/ops/chol64.py:423-470`` (``chol_inv``,
``chol_inv_retry``) on ``torch.linalg.cholesky_ex`` and a triangular solve
against I.  The blocked and Newton internals of chol64 work around fp64
emulation on the TPU and are not ported.

:func:`solve_lower` solves L X = B for a lower L [M, M] and B [M, K].  Wide
enough, it goes by blocks of the H100's DGEMM (:func:`_blocked_solve`), in
the forward and in its backward; every other call is
``torch.linalg.solve_triangular``.

A failed factorization gives NaN, as ``jnp.linalg.cholesky`` does, so the
callers' finiteness tests (the 1000x-jitter retry, sgpr.py:106-123) behave
as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..utils.profiling import annotate

__all__ = ["cholesky", "chol_retry", "chol_inv", "chol_inv_retry",
           "solve_lower", "SOLVE_BLOCK", "SOLVE_MIN_WIDTH"]

# Rows of a diagonal block of the blocked solve, and the fewest columns of B
# for which it runs (with M >= 2 SOLVE_BLOCK).  Measured on an H100 against
# cuBLAS trsm at M 2048 (PERF.md, section 6): blocks of 128, 256 and 512
# rows are within 10 % of each other, 256 issuing fewer launches than 128;
# below about 6144 columns the builtin's one call ends before the host has
# issued the blocked solve's launches.
SOLVE_BLOCK = 256
SOLVE_MIN_WIDTH = 6144


def cholesky(P: torch.Tensor) -> torch.Tensor:
    """Lower factor of P, NaN where the factorization failed."""
    L, info = torch.linalg.cholesky_ex(P)
    return L.masked_fill(info.ne(0), float("nan"))


def _eye_like(P: torch.Tensor) -> torch.Tensor:
    return torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)


def chol_retry(P: torch.Tensor, jitter: float) -> torch.Tensor:
    """chol(P + jitter I), retried with 1000x jitter if not finite
    (clustered inducing points mid-optimization).  Reads one flag back, in
    the span ``cglb.chol.read``."""
    eye = _eye_like(P)
    L = cholesky(P + jitter * eye)
    with annotate("cglb.chol.read"):
        ok = bool(torch.isfinite(torch.diagonal(L)).all())
    if not ok:
        L = cholesky(P + (1000.0 * jitter) * eye)
    return L


def _tri_inv(L: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(L, _eye_like(L), upper=False)


def chol_inv(P: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, L^-1) with L = chol(P)."""
    L = cholesky(P)
    return L, _tri_inv(L)


def chol_inv_retry(P: torch.Tensor, jitter: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, L^-1) for chol(P + jitter I) with the 1000x-jitter retry."""
    L = chol_retry(P, jitter)
    return L, _tri_inv(L)


# Rows of the diagonal blocks that one batched trsm against I inverts; the
# blocks of the solve are built from them by doubling.
_INV_BASE = 64


def _blocks(L: torch.Tensor, n: int, size: int, step: int,
            row: int = 0) -> torch.Tensor:
    """The n blocks L[row + j:row + j + size, j:j + size] for j = 0, step,
    2 step, ..., as one [n, size, size] view."""
    s0, s1 = L.stride()
    return L.as_strided((n, size, size), ((s0 + s1) * step, s0, s1),
                        L.storage_offset() + row * s0)


def _block_inverses(L: torch.Tensor, n: int, block: int) -> torch.Tensor:
    """The inverses of L's first n diagonal blocks of ``block`` rows,
    [n, block, block]: one batched trsm against I on blocks of at most
    _INV_BASE rows (cuBLAS runs a batch of more than 8 in one launch, and
    loops over a batch of fewer at 64 rows and more), doubled by
    [[A, 0], [C, D]]^-1 = [[A^-1, 0], [-D^-1 C A^-1, D^-1]]."""
    size, m = block, n
    while size > _INV_BASE and size % 2 == 0:
        size, m = size // 2, m * 2
    eye = torch.eye(size, dtype=L.dtype, device=L.device)
    inv = torch.linalg.solve_triangular(_blocks(L, m, size, size),
                                        eye.expand(m, size, size),
                                        upper=False)
    while size < block:
        m //= 2
        a_inv, d_inv = inv[0::2], inv[1::2]
        c = _blocks(L, m, size, 2 * size, row=size)  # below each A
        out = torch.zeros(m, 2 * size, 2 * size, dtype=L.dtype,
                          device=L.device)
        out[:, :size, :size] = a_inv
        out[:, size:, size:] = d_inv
        lower = out[:, size:, :size]
        torch.bmm(d_inv, torch.bmm(c, a_inv), out=lower)
        lower.neg_()
        inv, size = out, 2 * size
    return inv


def _updates(lo: int, hi: int, transpose: bool) -> List[tuple]:
    """The updates X2 -= N21 X1 of the recursive 2 x 2 split of block rows
    lo..hi-1, in order, as (block rows updated, block rows solved before);
    with ``transpose`` (upper, backward substitution) the second half is
    solved first."""
    if hi - lo < 2:
        return []
    mid = (lo + hi) // 2
    first, second = ((mid, hi), (lo, mid)) if transpose else (
        (lo, mid), (mid, hi))
    return (_updates(*first, transpose) + [(second, first)]
            + _updates(*second, transpose))


def _blocked_solve(L: torch.Tensor, B: torch.Tensor, block: int,
                   transpose: bool = False) -> torch.Tensor:
    """L^-1 B (L^-T B with ``transpose``) for a lower L [M, M] and B [M, K],
    column-major as cuBLAS trsm leaves it.

    With D the block diagonal of L (blocks of ``block`` rows; the last may
    be shorter), L = D (I + N) where N = D^-1 L - I is strictly block lower:
    X = (I + N)^-1 D^-1 B.  So X is first D^-1 B, one batched product from
    B into the output, and then the unit block triangle is solved in place
    by a recursive 2 x 2 split, X2 -= N21 X1, whose products take almost all
    of the M^2 K operations.  Only the diagonal blocks are inverted
    (:func:`_block_inverses`).  The temporaries are those inverses and one
    N21 of at most [M/2, M/2]; nothing of B's width."""
    M, K = B.shape
    full, short = divmod(M, block)
    count = full + (short > 0)
    inv = _block_inverses(L, full, block)
    inv_short = None
    if short:
        a = full * block
        inv_short = torch.linalg.solve_triangular(
            L[a:, a:], torch.eye(short, dtype=L.dtype, device=L.device),
            upper=False)
    if transpose:
        inv = inv.mT
        inv_short = None if inv_short is None else inv_short.T

    def edge(i):
        return min(i * block, M)

    def scale(lo, hi, src, out):
        """out = D^-1 src over block rows lo..hi-1 (src and out hold just
        those rows)."""
        n = min(hi, full) - lo
        if n > 0:
            rows = n * block
            torch.bmm(inv[lo:lo + n], src[:rows].view(n, block, -1),
                      out=out[:rows].view(n, block, -1))
        if hi > full:
            torch.mm(inv_short, src[(full - lo) * block:],
                     out=out[(full - lo) * block:])

    X = torch.empty((K, M), dtype=B.dtype, device=B.device).T
    scale(0, count, B, X)
    for todo, done in _updates(0, count, transpose):
        rows = slice(edge(todo[0]), edge(todo[1]))
        cols = slice(edge(done[0]), edge(done[1]))
        n21 = torch.empty(rows.stop - rows.start, cols.stop - cols.start,
                          dtype=L.dtype, device=L.device)
        scale(*todo, L[cols, rows].T if transpose else L[rows, cols], n21)
        X[rows].addmm_(n21, X[cols], alpha=-1)
    return X


class _BlockedLowerSolve(torch.autograd.Function):
    """X = L^-1 B by :func:`_blocked_solve`, with the gradient of
    ``torch.linalg.solve_triangular``: dB = L^-T dX (the same blocks,
    transposed) and dL = -tril(dB X^T).  Saves L and X, as the builtin
    does."""

    @staticmethod
    def forward(ctx, L, B, block):
        X = _blocked_solve(L, B, block)
        ctx.block = block
        ctx.save_for_backward(L, X)
        return X

    @staticmethod
    def backward(ctx, dX):
        L, X = ctx.saved_tensors
        solve_lower.blocked_backward_calls += 1
        dB = _blocked_solve(L, dX, ctx.block, transpose=True)
        dL = None
        if ctx.needs_input_grad[0]:
            dL = (-torch.matmul(dB, X.mT)).tril()
        return dL, dB if ctx.needs_input_grad[1] else None, None


def _solve_block(L: torch.Tensor, B: torch.Tensor) -> Optional[int]:
    """The blocked solve's block size for this shape, None for the
    builtin: one 2-D L, at least two blocks, at least SOLVE_MIN_WIDTH
    columns."""
    if L.dim() != 2 or B.dim() != 2:
        return None
    M, K = B.shape
    if M < 2 * SOLVE_BLOCK or K < SOLVE_MIN_WIDTH:
        return None
    return SOLVE_BLOCK


def solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """L^-1 B for a lower-triangular L, differentiable in both; blocked
    where the shape makes it pay (:func:`_solve_block`).  Counts its
    calls, the blocked ones among them, and the blocked backward solves."""
    solve_lower.calls += 1
    block = _solve_block(L, B)
    if block is None:
        return torch.linalg.solve_triangular(L, B, upper=False)
    solve_lower.blocked_calls += 1
    return _BlockedLowerSolve.apply(L, B, block)


solve_lower.calls = 0
solve_lower.blocked_calls = 0
solve_lower.blocked_backward_calls = 0
