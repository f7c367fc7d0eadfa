"""Plain PyTorch pieces that the references share: the positive transform,
the Matern32 kernel, dense K(X, X) + sigma^2 I built by blocks of rows,
and Adam.

Written from the definitions, for the benchmark: nothing here imports the
program, and nothing takes a tensor the program made.  Every function runs
in the dtype of its inputs, so that the same code is the reference (fp64)
and its control (fp32, TF32 off).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

__all__ = ["SQRT3", "softplus", "softplus_inverse", "matern32",
           "dense_ky", "adam_steps", "chol_retry"]

SQRT3 = math.sqrt(3.0)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x), exact at every x (no switch to the identity)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def softplus_inverse(y: torch.Tensor) -> torch.Tensor:
    return y + torch.log(-torch.expm1(-y))


def matern32(A: torch.Tensor, B: torch.Tensor, var, ls) -> torch.Tensor:
    """var (1 + sqrt(3) r) exp(-sqrt(3) r), r the distance of A's and B's
    rows scaled by the lengthscales; [len(A), len(B)].  The square root
    takes a 1e-36 floor so that its gradient stays finite at r = 0."""
    a, b = A / ls, B / ls
    d2 = (torch.sum(a * a, 1)[:, None] + torch.sum(b * b, 1)[None, :]
          - 2.0 * (a @ b.T))
    s3r = SQRT3 * torch.sqrt(torch.clamp(d2, min=0.0) + 1e-36)
    return var * (1.0 + s3r) * torch.exp(-s3r)


def dense_ky(X: torch.Tensor, var, ls, sigma_sq, block: int = 4096
             ) -> torch.Tensor:
    """K(X, X) + sigma^2 I as one [N, N] tensor, built a block of rows at a
    time (no gradient), so that the peak is one N x N and a block's
    temporaries."""
    n = X.shape[0]
    out = torch.empty(n, n, dtype=X.dtype, device=X.device)
    with torch.no_grad():
        for r0 in range(0, n, block):
            out[r0:r0 + block] = matern32(X[r0:r0 + block], X, var, ls)
        out.diagonal().add_(sigma_sq)
    return out


def chol_retry(P: torch.Tensor, jitter: float) -> torch.Tensor:
    """chol(P + jitter I), again with 1000 x jitter where the first fails
    (the configuration's rule for K(Z, Z))."""
    eye = torch.eye(P.shape[0], dtype=P.dtype, device=P.device)
    L, info = torch.linalg.cholesky_ex(P + jitter * eye)
    if int(info) != 0:
        L, info = torch.linalg.cholesky_ex(P + 1000.0 * jitter * eye)
    if int(info) != 0:
        raise FloatingPointError("K(Z, Z) + jitter I is not positive "
                                 "definite")
    return L


def adam_steps(raw: Dict[str, torch.Tensor],
               loss_grad: Callable[[Dict[str, torch.Tensor], int],
                                   Tuple[float, Dict[str, torch.Tensor]]],
               steps: int, lr: float, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8):
    """``steps`` Adam steps (Kingma & Ba, with bias correction) on the
    leaves ``raw``.  ``loss_grad(raw, k)`` gives step k's loss and
    gradients.  Returns (losses, the first step's gradients, the leaves
    after the steps)."""
    m = {k: torch.zeros_like(v) for k, v in raw.items()}
    s = {k: torch.zeros_like(v) for k, v in raw.items()}
    raw = {k: v.clone() for k, v in raw.items()}
    losses: List[float] = []
    first = None
    for t in range(1, steps + 1):
        loss, g = loss_grad(raw, t - 1)
        losses.append(loss)
        if first is None:
            first = {k: v.clone() for k, v in g.items()}
        for k in raw:
            m[k] = b1 * m[k] + (1 - b1) * g[k]
            s[k] = b2 * s[k] + (1 - b2) * g[k] * g[k]
            mhat = m[k] / (1 - b1 ** t)
            shat = s[k] / (1 - b2 ** t)
            raw[k] = raw[k] - lr * mhat / (torch.sqrt(shat) + eps)
    return losses, first, raw
