"""Plain reference of the CGLB configuration that never forms K(X, X) + s2 I:
the algorithm and equations of ``reference/cglb.py`` (its docstring, its
``loss_and_grad`` and its ``predict``), for data that no dense N x N fits.

- K(X, X) is recomputed by tiles in each matvec and in the gradient's block
  sum.  X's rows go in blocks of ``block``; K is symmetric, so each pair of
  blocks I <= J is one tile K(X_I, X_J), used for both (p K)[:, J] += p_I
  K_IJ and (p K)[:, I] += p_J K_IJ^T, and the block sum's bilinear form
  -(0.5 v^T K v + z^T K v) takes both of its halves from it.
- Kuf and A = L^-1 Kuf / s are held by column chunks of ``chunk`` columns
  (one chunk wherever A fits in ``A_CHUNK_ENTRIES``, so that at kin40k's
  size the common terms and the preconditioner are reference/cglb.py's own
  operations).  The gradient through A is taken chunk by chunk: the loss's
  M x M pieces (A A^T, the preconditioner's Ap Ap^T and Ap r^T) get their
  cotangents from a small graph, and each chunk is rebuilt with its graph
  and sent back with those cotangents.
- Where ``torch.distributed`` has a group, tile t and chunk c go to rank t
  mod R and c mod R, and the ranks' partial products and gradients are
  gathered and summed in rank order, so every rank holds the same bits;
  everything else (CG, the M x M algebra, the forward's chunks of A) runs
  whole on every rank.

The same functions run in the dtype of their inputs.  Nothing here imports
the program or JAX.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from .cglb import _DTYPES, _POSITIVE, LEAVES, pcg, raw_leaves
from .common import chol_retry, matern32, softplus

__all__ = ["LEAVES", "raw_leaves", "BLOCK", "A_CHUNK_ENTRIES",
           "loss_and_grad", "predict"]

# rows of X in a tile's side: K tiles of 8192^2 fp64 (512 MiB a temporary)
BLOCK = 8192
# entries of A held as one chunk: 2^27 (1 GiB in fp64)
A_CHUNK_ENTRIES = 1 << 27

Span = Tuple[int, int]


def _ranks() -> Tuple[int, int]:
    """(rank, world) of the default group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _sum_ranks(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks, added in rank order (the same bits on every
    rank)."""
    _, world = _ranks()
    if world == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x.contiguous())
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def _spans(n: int, step: int) -> List[Span]:
    return [(a, min(n, a + step)) for a in range(0, n, step)]


def _mine(items: list) -> list:
    rank, world = _ranks()
    return items[rank::world]


def _tiles(n: int, block: int) -> List[Tuple[Span, Span]]:
    """The pairs of row blocks I <= J, in one fixed order."""
    s = _spans(n, block)
    return [(s[i], s[j]) for i in range(len(s)) for j in range(i, len(s))]


def _chunks(n: int, m: int, chunk: Optional[int]) -> List[Span]:
    return _spans(n, chunk or max(1, A_CHUNK_ENTRIES // m))


def _matvec(X, var, ls, s2, block: int) -> Callable:
    """p [B, N] -> p (K + s2 I), K by this rank's tiles (no gradient)."""
    tiles = _mine(_tiles(X.shape[0], block))

    @torch.no_grad()
    def matvec(p):
        out = torch.zeros_like(p)
        for (i0, i1), (j0, j1) in tiles:
            K = matern32(X[i0:i1], X[j0:j1], var, ls)
            out[:, j0:j1] += p[:, i0:i1] @ K
            if i0 != j0:
                out[:, i0:i1] += p[:, j0:j1] @ K.T
        return _sum_ranks(out) + s2 * p

    return matvec


def _a_chunks(Z, X, var, ls, s2, L, chunks: List[Span]):
    """A = L^-1 Kuf / s, by column chunks."""
    return [torch.linalg.solve_triangular(
        L, matern32(Z, X[c0:c1], var, ls), upper=False) / torch.sqrt(s2)
        for c0, c1 in chunks]


def _gram(parts) -> torch.Tensor:
    out = parts[0] @ parts[0].T
    for a in parts[1:]:
        out = out + a @ a.T
    return out


def _chol_plus_eye(G) -> torch.Tensor:
    eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    return torch.linalg.cholesky(G + eye)


def _inverse_factor(Gp) -> torch.Tensor:
    """Ci = chol(Gp + I)^-1, the preconditioner's factor."""
    eye = torch.eye(Gp.shape[0], dtype=Gp.dtype, device=Gp.device)
    return torch.linalg.solve_triangular(_chol_plus_eye(Gp), eye,
                                         upper=False)


def _split_rows(Ap, chunks, r, dtype):
    """rt = r^T in ``dtype`` cut into the chunks' rows, and u = Ap rt."""
    rt = r.to(dtype).T
    rts = [rt[c0:c1] for c0, c1 in chunks]
    u = Ap[0] @ rts[0]
    for a, x in zip(Ap[1:], rts[1:]):
        u = u + a @ x
    return rts, u


def _rv_square(Ap, rts, w) -> torch.Tensor:
    """sum over rows of (rt - Ap^T w)^2, chunk by chunk: [B]."""
    out = None
    for a, x in zip(Ap, rts):
        rv = x - a.T @ w
        part = torch.sum(rv * rv, 0)
        out = part if out is None else out + part
    return out


def _preconditioner(Ap, chunks: List[Span], s2, Ci) -> Callable:
    """reference/cglb.py's Nystrom preconditioner from the chunks ``Ap`` of A
    in its dtype and its factor Ci: r [B, N] -> (P r, r^T P r [B])."""
    dtype = Ap[0].dtype

    def apply(r):
        rts, u = _split_rows(Ap, chunks, r, dtype)
        w = Ci.T @ (Ci @ u)
        rv = torch.cat([x - a.T @ w for a, x in zip(Ap, rts)])
        rz = torch.sum(rv * rv, 0) + torch.sum(w * w, 0)
        return rv.T.to(r.dtype) / s2, rz.to(r.dtype) / s2

    return apply


def loss_and_grad(raw: Dict[str, torch.Tensor], X, Y, v0, cfg: Dict,
                  block: Optional[int] = None, chunk: Optional[int] = None):
    """(loss, gradient in the raw leaves, CG's v) at warm start v0 [D, N],
    in X's dtype: reference/cglb.py's ``loss_and_grad``.  ``block``: rows
    of a tile's side (``BLOCK``); ``chunk``: columns of A's chunks (from
    ``A_CHUNK_ENTRIES``)."""
    block = block or BLOCK
    lower, jitter = cfg["positive_lower"], cfg["jitter"]
    pdt = _DTYPES[cfg["precond_dtype"]]
    if X.dtype == torch.float32:
        pdt = torch.float32
    rank, _ = _ranks()
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in raw.items()}

    def params():  # a graph of their own for each backward below
        return tuple(lower + softplus(leaves[k]) if k in _POSITIVE
                     else leaves[k] for k in LEAVES)

    N, D = Y.shape
    chunks = _chunks(N, raw[".inducing_Z"].shape[0], chunk)
    with torch.no_grad():
        var, ls, Z, s2, c = params()
        L = chol_retry(matern32(Z, Z, var, ls), jitter)
        A = _a_chunks(Z, X, var, ls, s2, L, chunks)
        G = _gram(A)
        Ap = [a.to(pdt) for a in A]
        Gp = _gram(Ap)
        papply = _preconditioner(Ap, chunks, s2, _inverse_factor(Gp))
        matvec = _matvec(X, var, ls, s2, block)
        err = (Y - c).T  # [D, N]
        v, _, _ = pcg(matvec, papply, err, v0, cfg["max_error"],
                      cfg["max_cg_iters"], cfg["restart_cg_iters"])
        Kv = matvec(v)
        r = err - Kv
        z, rz = papply(r)
        ub = float(torch.sum(v * err) - 0.5 * torch.sum(v * Kv)
                   + 0.5 * torch.sum(rz))
        rts, u = _split_rows(Ap, chunks, r, pdt)
        del A, L, Kv, papply

    # the small graph: everything but A's chunks, at the M x M pieces
    Gd, Gpd, ud = (t.detach().requires_grad_(True) for t in (G, Gp, u))
    var, ls, Z, s2, c = params()
    LB = _chol_plus_eye(Gd)
    trace = torch.clamp(N * var / s2 - torch.trace(Gd), min=0.0)
    logdet = (-D * torch.sum(torch.log(torch.diagonal(LB)))
              - 0.5 * N * D * torch.log(s2)
              - 0.5 * D * N * torch.log(1.0 + trace / N))
    Ci = _inverse_factor(Gpd)
    w = Ci.T @ (Ci @ ud)
    rz_live = ((_rv_square(Ap, rts, w) + torch.sum(w * w, 0)).to(X.dtype)
               / s2)  # r fixed, P live
    part = 0.5 * N * D * math.log(2.0 * math.pi) - logdet
    loss = float(part.detach()) + ub
    small = (part + 0.5 * torch.sum(rz_live)
             + torch.sum((v + z) * (Y - c).T)
             - s2 * (0.5 * torch.sum(v * v) + torch.sum(z * v)))
    names = [k for k in LEAVES if k != ".inducing_Z"]
    got = torch.autograd.grad(small, [Gd, Gpd, ud] + [leaves[k]
                                                       for k in names],
                              allow_unused=True)
    dG, dGp, du = got[:3]
    w = w.detach()
    if rank == 0:  # the small graph's share, once
        for k, g in zip(names, got[3:]):
            if g is not None:
                leaves[k].grad = g
    del G, Gp, Gd, Gpd, ud, LB, Ci, rz_live, small, got

    # A's chunks, each rebuilt with its graph, with the pieces' cotangents
    s2_fixed = s2.detach()
    for k in _mine(list(range(len(chunks)))):
        var, ls, Z, s2, c = params()
        L = chol_retry(matern32(Z, Z, var, ls), jitter)
        a = _a_chunks(Z, X, var, ls, s2, L, [chunks[k]])[0]
        ap = a.to(pdt)
        rv = rts[k] - ap.T @ w
        (torch.sum(dG * (a @ a.T)) + torch.sum(dGp * (ap @ ap.T))
         + torch.sum(du * (ap @ rts[k]))
         + 0.5 * torch.sum(torch.sum(rv * rv, 0).to(X.dtype) / s2_fixed)
         ).backward()
    del Ap, rts

    # the block sum -(0.5 v^T K v + z^T K v), by this rank's tiles
    for (i0, i1), (j0, j1) in _mine(_tiles(N, block)):
        var, ls, Z, s2, c = params()
        K = matern32(X[i0:i1], X[j0:j1], var, ls)
        if i0 == j0:
            term = torch.sum((0.5 * v[:, i0:i1] + z[:, i0:i1])
                             * (v[:, i0:i1] @ K))
        else:
            left = torch.cat([v[:, i0:i1], 0.5 * v[:, i0:i1]
                              + z[:, i0:i1]]) @ K  # [2D, |J|]
            term = (torch.sum(left[:D] * (0.5 * v[:, j0:j1] + z[:, j0:j1]))
                    + torch.sum(left[D:] * v[:, j0:j1]))
        (-term).backward()
    grad = {k: _sum_ranks(t.grad.detach() if t.grad is not None
                          else torch.zeros_like(t))
            for k, t in leaves.items()}
    return loss, grad, v


@torch.no_grad()
def predict(values: Dict, X, Y, Xs, Ys, cfg: Dict, cg_tolerance: float,
            block: Optional[int] = None, chunk: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean [S], variance [S], log density [S]) at the test rows, in X's
    dtype, from the constrained ``values`` and CG from zero:
    reference/cglb.py's ``predict``; ``block``, ``chunk`` as in
    :func:`loss_and_grad`."""
    block = block or BLOCK
    dt, dev = X.dtype, X.device

    def t(k):
        return torch.as_tensor(values[k], dtype=dt, device=dev)

    var, ls, Z = t(".kernel.variance"), t(".kernel.lengthscales"), \
        t(".inducing_Z")
    s2, c0 = t(".noise_variance"), t(".mean.c")
    chunks = _chunks(X.shape[0], Z.shape[0], chunk)
    L = chol_retry(matern32(Z, Z, var, ls), cfg["jitter"])
    A = _a_chunks(Z, X, var, ls, s2, L, chunks)
    LB = _chol_plus_eye(_gram(A))
    matvec = _matvec(X, var, ls, s2, block)
    err = (Y - c0).T
    pdts = [_DTYPES[cfg["precond_dtype"]], torch.float64]
    if dt == torch.float32:
        pdts = [torch.float32]
    for pdt in dict.fromkeys(pdts):
        Ap = [a.to(pdt) for a in A]
        papply = _preconditioner(Ap, chunks, s2, _inverse_factor(_gram(Ap)))
        v, _, e = pcg(matvec, papply, err,
                      torch.zeros_like(err), cg_tolerance,
                      cfg["max_cg_iters"], cfg["restart_cg_iters"])
        del Ap, papply
        if e <= cg_tolerance:
            break
    res = err - matvec(v)  # [D, N]
    Ares = A[0] @ res[:, chunks[0][0]:chunks[0][1]].T
    for a, (a0, a1) in zip(A[1:], chunks[1:]):
        Ares = Ares + a @ res[:, a0:a1].T
    cvec = torch.linalg.solve_triangular(LB, Ares, upper=False) \
        / torch.sqrt(s2)  # [M, D]
    del A
    # K(Xs, X) v by this rank's tiles (test block, column block)
    kv = torch.zeros(Xs.shape[0], dtype=dt, device=dev)
    tiles = [(a, b) for a in _spans(Xs.shape[0], block)
             for b in _spans(X.shape[0], block)]
    for (s0, s1), (j0, j1) in _mine(tiles):
        kv[s0:s1] += (matern32(Xs[s0:s1], X[j0:j1], var, ls)
                      @ v[:, j0:j1].T)[:, 0]
    kv = _sum_ranks(kv)
    means, fvars = [], []
    for s0, s1 in _spans(Xs.shape[0], block):
        t1 = torch.linalg.solve_triangular(
            L, matern32(Z, Xs[s0:s1], var, ls), upper=False)
        t2 = torch.linalg.solve_triangular(LB, t1, upper=False)
        means.append((t2.T @ cvec)[:, 0] + kv[s0:s1] + c0[0])
        fvars.append(var + torch.sum(t2 * t2, 0) - torch.sum(t1 * t1, 0))
    mean, fvar = torch.cat(means), torch.cat(fvars)
    tot = fvar + s2
    logdens = -0.5 * (math.log(2.0 * math.pi) + torch.log(tot)
                      + (Ys[:, 0] - mean) ** 2 / tot)
    return mean, fvar, logdens
