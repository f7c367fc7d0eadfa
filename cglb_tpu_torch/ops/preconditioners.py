"""Preconditioners for the kernel-system CG solve.

Counterpart of ``cglb_tpu/ops/preconditioners.py``.  The Nystrom one is
P = (Qff + sigma^2 I)^-1 applied as (r - A^T B^-1 A r) / sigma^2 with
A = L^-1 Kuf / sigma and B = LB LB^T = A A^T + I.  No N x N work.  The
identity serves the iterative exact GP (models/gpr_iterative.py), which has
no inducing points to build a Nystrom factor from.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

__all__ = ["IdentityPreconditioner", "NystromPreconditioner", "mat_vec",
           "inv_mat_vec", "sqrt_factor_mat_vec"]


@dataclass
class IdentityPreconditioner:
    pass


@dataclass
class NystromPreconditioner:
    A: torch.Tensor         # [M, N]; the rank's columns under a mesh
    LB: torch.Tensor        # [M, M], lower
    sigma_sq: torch.Tensor  # []
    # optional LB^-1: every apply is then matmul-only
    Ci: Optional[torch.Tensor] = None
    # parallel.mesh.DataMesh of a column-sharded A
    mesh: Any = None


def mat_vec(precond, r: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P r [B, N], per-row r^T P r [B]) for row vectors r [B, N].

    The Nystrom apply runs in A's dtype; inputs and outputs stay in r's dtype.
    r^T P r is formed as (||rv||^2 + ||w||^2) / sigma^2, with w = B^-1 A r
    and rv = r - A^T w: A rv = w, so this equals (rv^T Qhat rv) / sigma^4
    and is nonnegative by construction.  The naive sum(rv * r) cancels
    catastrophically when r lies mostly in Qhat's range.

    With a mesh (A column-sharded, r replicated): A r summed over the
    ranks, rv formed on the rank's rows and all-gathered; every rank then
    holds the same z and rz."""
    if isinstance(precond, IdentityPreconditioner):
        return r, torch.sum(r * r, dim=-1)
    if not isinstance(precond, NystromPreconditioner):
        raise NotImplementedError(type(precond))
    A, LB, sigma_sq = precond.A, precond.LB, precond.sigma_sq
    mesh = precond.mesh
    rt = r.to(A.dtype).T  # [N, B]
    if mesh is not None:  # the rank's rows of r^T against its columns of A
        rt = mesh.shard(rt, 0)
    Ar = A @ rt  # [M, B]
    if mesh is not None:
        Ar = mesh.reduce(Ar)
    if precond.Ci is not None:
        w = precond.Ci.T @ (precond.Ci @ Ar)
    else:
        u = torch.linalg.solve_triangular(LB, Ar, upper=False)
        w = torch.linalg.solve_triangular(LB.T, u, upper=True)
    if mesh is None:
        rv = rt - A.T @ w  # [N, B]
    else:
        rv = mesh.gather(rt - A.T @ mesh.enter(w), r.shape[1], 0)
    rz = torch.sum(rv * rv, dim=0) + torch.sum(w * w, dim=0)
    z = rv.T.to(r.dtype) / sigma_sq
    return z, rz.to(r.dtype) / sigma_sq


def inv_mat_vec(precond: NystromPreconditioner, r: torch.Tensor
                ) -> torch.Tensor:
    """(Qff + sigma^2 I) r for row vectors r [B, N]: the inverse operator
    of :func:`mat_vec`."""
    A, sigma_sq = precond.A, precond.sigma_sq
    rt = r.T * sigma_sq
    return (A.T @ (A @ rt) + rt).T


def sqrt_factor_mat_vec(precond: NystromPreconditioner, w: torch.Tensor
                        ) -> torch.Tensor:
    """Action of a square-root factor S of (Qff + sigma^2 I) = S S^T with
    S = sigma [A^T | I] of shape [N, M+N]: w [B, M+N] -> (S w^T)^T [B, N]
    (sampling from the Nystrom-approximate prior)."""
    A, sigma_sq = precond.A, precond.sigma_sq
    m = A.shape[0]
    return torch.sqrt(sigma_sq) * (w[:, :m] @ A + w[:, m:])
