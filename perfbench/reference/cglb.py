"""Plain reference of the CGLB configuration: its training objective with
gradients, and its predictions, by the configuration's algorithm (Artemev,
Burt & van der Wilk, ICML 2021) on a dense K(X, X) + s2 I.

Common terms: L = chol(Kuu + jitter I) (again at 1000 x jitter where that
fails), A = L^-1 Kuf / s, LB = chol(A A^T + I).  The Nystrom preconditioner
P = (Q + s2 I)^-1 = (I - A^T (A A^T + I)^-1 A) / s2 is applied in the
configuration's ``precond_dtype`` from that dtype's own A A^T.  CG
(preconditioned, warm-started, a warm start no better than zero replaced by
zero, the residual recomputed every ``restart_cg_iters``-th step) stops once
0.5 r^T P r <= ``max_error`` or at ``max_cg_iters``.

Objective at CG's v (eq. 10 with the Jensen log-determinant bound):

    loss = 0.5 N D log 2 pi - logdet_bound + ub(v),
    logdet_bound = -D sum log diag LB - 0.5 N D log s2
                   - 0.5 D N log(1 + t / N),
    t = clamp(sum kdiag / s2 - tr(A A^T), 0),
    ub(v) = v . err - 0.5 v^T K_s v + 0.5 r^T P r,  r = err - K_s v,

err = y - c.  Its gradient holds v fixed; the part through K_s is summed a
block of rows at a time with z = P r held fixed (the chain rule through r).

Prediction (CG from zero at ``cg_tolerance``, again with an fp64
preconditioner where the configured one ends above it): mean = tmp2^T c +
K(Xs, X) v + c0 with c = LB^-1 A res / s, res = err - K_s v; variance
kdiag + ||tmp2||^2 - ||tmp1||^2, tmp1 = L^-1 Kus, tmp2 = LB^-1 tmp1.

The leaves are the raw (unconstrained) values the optimizer sees: variance,
lengthscales and noise variance as lower + softplus(raw), inducing points
and the constant mean as they are.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

from .common import (chol_retry, dense_ky, matern32, softplus,
                     softplus_inverse)

__all__ = ["LEAVES", "raw_leaves", "pcg", "loss_and_grad", "predict"]

LEAVES = (".kernel.variance", ".kernel.lengthscales", ".inducing_Z",
          ".noise_variance", ".mean.c")
_POSITIVE = (".kernel.variance", ".kernel.lengthscales", ".noise_variance")
_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def raw_leaves(values: Dict, lower: float, dtype, device
               ) -> Dict[str, torch.Tensor]:
    """The raw leaves of constrained ``values`` (model.json's)."""
    out = {}
    for k in LEAVES:
        v = torch.as_tensor(values[k], dtype=dtype, device=device)
        out[k] = softplus_inverse(v - lower) if k in _POSITIVE else v.clone()
    return out


def _common(Z, X, var, ls, s2, jitter):
    """(L, A, A A^T, LB)."""
    L = chol_retry(matern32(Z, Z, var, ls), jitter)
    A = torch.linalg.solve_triangular(L, matern32(Z, X, var, ls),
                                      upper=False) / torch.sqrt(s2)
    AAT = A @ A.T
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    return L, A, AAT, torch.linalg.cholesky(AAT + eye)


def _preconditioner(A, s2, dtype) -> Callable:
    """r [B, N] -> (P r [B, N], r^T P r [B]) in r's dtype, applied in
    ``dtype`` (rz as ||rv||^2 + ||w||^2: no cancellation)."""
    Ap = A.to(dtype)
    eye = torch.eye(Ap.shape[0], dtype=dtype, device=Ap.device)
    Ci = torch.linalg.solve_triangular(
        torch.linalg.cholesky(Ap @ Ap.T + eye), eye, upper=False)

    def apply(r):
        rt = r.to(dtype).T
        w = Ci.T @ (Ci @ (Ap @ rt))
        rv = rt - Ap.T @ w
        rz = torch.sum(rv * rv, 0) + torch.sum(w * w, 0)
        return rv.T.to(r.dtype) / s2, rz.to(r.dtype) / s2

    return apply


@torch.no_grad()
def pcg(matvec: Callable, papply: Callable, b, v0, max_error: float,
        max_iters: int, restart_iters: int):
    """Preconditioned CG on row vectors: (v, steps, 0.5 sum r^T P r)."""
    v0 = torch.where(torch.isfinite(v0), v0, torch.zeros_like(v0))
    r = b - matvec(v0)
    z, rz = papply(r)
    zb, rzb = papply(b)
    cold = torch.logical_not(rz <= rzb)
    v = torch.where(cold[:, None], torch.zeros_like(v0), v0)
    r = torch.where(cold[:, None], b, r)
    p = torch.where(cold[:, None], zb, z)
    rz = torch.where(cold, rzb, rz)
    err = float(0.5 * torch.sum(rz))
    cap = 1e6 * (err + 1.0)
    i = 0
    while err > max_error and i < max_iters and math.isfinite(err) \
            and err < cap:
        Ap = matvec(p)
        gamma = rz / torch.sum(p * Ap, 1)
        v = v + gamma[:, None] * p
        restart = (i % restart_iters) == restart_iters - 1
        r = b - matvec(v) if restart else r - gamma[:, None] * Ap
        z, new_rz = papply(r)
        p = z if restart else z + (new_rz / rz)[:, None] * p
        rz = new_rz
        i += 1
        err = float(0.5 * torch.sum(rz))
    return v, i, err


def loss_and_grad(raw: Dict[str, torch.Tensor], X, Y, v0, cfg: Dict,
                  block: int = 4096):
    """(loss, gradient in the raw leaves, CG's v) at warm start v0 [D, N],
    in X's dtype."""
    lower, jitter = cfg["positive_lower"], cfg["jitter"]
    pdt = _DTYPES[cfg["precond_dtype"]]
    if X.dtype == torch.float32:
        pdt = torch.float32
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in raw.items()}

    def params():  # a graph of their own for each backward below
        return tuple(lower + softplus(leaves[k]) if k in _POSITIVE
                     else leaves[k] for k in LEAVES)

    var, ls, Z, s2, c = params()
    N, D = Y.shape
    L, A, AAT, LB = _common(Z, X, var, ls, s2, jitter)
    trace = torch.clamp(N * var / s2 - torch.trace(AAT), min=0.0)
    logdet = (-D * torch.sum(torch.log(torch.diagonal(LB)))
              - 0.5 * N * D * torch.log(s2)
              - 0.5 * D * N * torch.log(1.0 + trace / N))
    papply = _preconditioner(A, s2, pdt)
    err = (Y - c).T  # [D, N]
    with torch.no_grad():
        Ks = dense_ky(X, var, ls, s2, block)

        def matvec(p):
            return p @ Ks

        v, _, _ = pcg(matvec, papply, err.detach(), v0, cfg["max_error"],
                      cfg["max_cg_iters"], cfg["restart_cg_iters"])
        Kv = matvec(v)
        r = err.detach() - Kv
        z, rz = papply(r)
        ub = float(torch.sum(v * err.detach()) - 0.5 * torch.sum(v * Kv)
                   + 0.5 * torch.sum(rz))
        del Ks, Kv
    _, rz_live = papply(r)  # r fixed, P live
    part = 0.5 * N * D * math.log(2.0 * math.pi) - logdet
    loss = float(part.detach()) + ub
    (part + 0.5 * torch.sum(rz_live) + torch.sum((v + z) * err)
     - s2 * (0.5 * torch.sum(v * v) + torch.sum(z * v))).backward()
    del L, A, AAT, LB, papply
    for r0 in range(0, N, block):
        var, ls, Z, s2, c = params()
        kv = v @ matern32(X, X[r0:r0 + block], var, ls)  # (v K)[:, block]
        (-torch.sum((0.5 * v[:, r0:r0 + block] + z[:, r0:r0 + block]) * kv)
         ).backward()
    return loss, {k: t.grad.detach() for k, t in leaves.items()}, v


@torch.no_grad()
def predict(values: Dict, X, Y, Xs, Ys, cfg: Dict, cg_tolerance: float,
            block: int = 4096
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean [S], variance [S], log density [S]) at the test rows, in X's
    dtype, from the constrained ``values`` and CG from zero."""
    dt, dev = X.dtype, X.device

    def t(k):
        return torch.as_tensor(values[k], dtype=dt, device=dev)

    var, ls, Z = t(".kernel.variance"), t(".kernel.lengthscales"), \
        t(".inducing_Z")
    s2, c0 = t(".noise_variance"), t(".mean.c")
    L, A, _, LB = _common(Z, X, var, ls, s2, cfg["jitter"])
    Ks = dense_ky(X, var, ls, s2, block)

    def matvec(p):
        return p @ Ks

    err = (Y - c0).T
    pdts = [_DTYPES[cfg["precond_dtype"]], torch.float64]
    if dt == torch.float32:
        pdts = [torch.float32]
    for pdt in dict.fromkeys(pdts):
        v, _, e = pcg(matvec, _preconditioner(A, s2, pdt), err,
                      torch.zeros_like(err), cg_tolerance,
                      cfg["max_cg_iters"], cfg["restart_cg_iters"])
        if e <= cg_tolerance:
            break
    res = err - matvec(v)  # [D, N]
    del Ks
    cvec = torch.linalg.solve_triangular(LB, A @ res.T, upper=False) \
        / torch.sqrt(s2)  # [M, D]
    means, fvars = [], []
    for r0 in range(0, Xs.shape[0], block):
        xs = Xs[r0:r0 + block]
        t1 = torch.linalg.solve_triangular(L, matern32(Z, xs, var, ls),
                                           upper=False)
        t2 = torch.linalg.solve_triangular(LB, t1, upper=False)
        means.append((t2.T @ cvec + matern32(xs, X, var, ls) @ v.T)[:, 0]
                     + c0[0])
        fvars.append(var + torch.sum(t2 * t2, 0) - torch.sum(t1 * t1, 0))
    mean, fvar = torch.cat(means), torch.cat(fvars)
    tot = fvar + s2
    logdens = -0.5 * (math.log(2.0 * math.pi) + torch.log(tot)
                      + (Ys[:, 0] - mean) ** 2 / tot)
    return mean, fvar, logdens
