"""Greedy ConditionalVariance inducing-point selection on the model's device.

Counterpart of ``cglb_tpu/utils/inducing.py:71-119``: permute the inputs by
a numpy generator seeded with ``seed``, then repeatedly pick the point of
largest conditional variance given the points picked so far (pivoted
Cholesky with greedy pivoting).  Same permutation and the same argmax rule
(first maximum) as ``conditional_variance_numpy`` (:31-68), so both pick
the same indices.  A host loop of M steps; the argmax never leaves the
device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["conditional_variance"]


@torch.no_grad()
def conditional_variance(X: torch.Tensor, M: int, kernel, seed: int = 0,
                         jitter: float = 1e-12
                         ) -> Tuple[torch.Tensor, np.ndarray]:
    """(Z [M, D] on X's device, indices into X [M])."""
    N = X.shape[0]
    perm = np.random.default_rng(seed).permutation(N)
    Xp = X[torch.as_tensor(perm, device=X.device)]
    di = kernel.kdiag(Xp) + jitter
    indices = torch.zeros(M, dtype=torch.long, device=X.device)
    indices[0] = torch.argmax(di)
    ci = torch.zeros(max(M - 1, 0), N, dtype=X.dtype, device=X.device)
    jit = torch.full((1,), jitter, dtype=X.dtype, device=X.device)
    for m in range(M - 1):
        j = indices[m:m + 1]
        Lcol = kernel.K(Xp, Xp.index_select(0, j))[:, 0].index_add(0, j, jit)
        cj = ci[:m].index_select(1, j)[:, 0]  # [m]
        ei = (Lcol - cj @ ci[:m]) / torch.sqrt(di.index_select(0, j))
        ci[m] = ei
        di = torch.clamp(di - ei * ei, min=0.0)
        indices[m + 1] = torch.argmax(di)
    return Xp[indices], perm[indices.cpu().numpy()]
