"""Nystrom preconditioner for the kernel-system CG solve.

Counterpart of ``cglb_tpu/ops/preconditioners.py:32-83``:
P = (Qff + sigma^2 I)^-1 applied as (r - A^T B^-1 A r) / sigma^2 with
A = L^-1 Kuf / sigma and B = LB LB^T = A A^T + I.  No N x N work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

__all__ = ["NystromPreconditioner", "mat_vec"]


@dataclass
class NystromPreconditioner:
    A: torch.Tensor         # [M, N]
    LB: torch.Tensor        # [M, M], lower
    sigma_sq: torch.Tensor  # []
    # optional LB^-1: every apply is then matmul-only
    Ci: Optional[torch.Tensor] = None


def mat_vec(precond: NystromPreconditioner, r: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P r [B, N], per-row r^T P r [B]) for row vectors r [B, N].

    The apply runs in A's dtype; inputs and outputs stay in r's dtype.
    r^T P r is formed as (||rv||^2 + ||w||^2) / sigma^2, with w = B^-1 A r
    and rv = r - A^T w: A rv = w, so this equals (rv^T Qhat rv) / sigma^4
    and is nonnegative by construction.  The naive sum(rv * r) cancels
    catastrophically when r lies mostly in Qhat's range."""
    A, LB, sigma_sq = precond.A, precond.LB, precond.sigma_sq
    rt = r.to(A.dtype).T  # [N, B]
    Ar = A @ rt  # [M, B]
    if precond.Ci is not None:
        w = precond.Ci.T @ (precond.Ci @ Ar)
    else:
        u = torch.linalg.solve_triangular(LB, Ar, upper=False)
        w = torch.linalg.solve_triangular(LB.T, u, upper=True)
    rv = rt - A.T @ w  # [N, B]
    rz = torch.sum(rv * rv, dim=0) + torch.sum(w * w, dim=0)
    z = rv.T.to(r.dtype) / sigma_sq
    return z, rz.to(r.dtype) / sigma_sq
