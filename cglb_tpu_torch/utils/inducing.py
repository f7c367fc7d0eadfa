"""Greedy ConditionalVariance inducing-point selection.

Counterpart of ``cglb_tpu/utils/inducing.py``: permute the inputs by a
numpy generator seeded with ``seed``, then repeatedly pick the point of
largest conditional variance given the points picked so far (pivoted
Cholesky with greedy pivoting).  Two implementations with the same
permutation and the same argmax rule (first maximum), so both pick the same
indices:

- ``conditional_variance_numpy``: the host oracle, numpy only, a copy of
  :31-68 that takes the kernel as two callables;
- ``conditional_variance``: on the model's device (:71-119), a host loop of
  M steps whose argmax never leaves the device.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

__all__ = ["conditional_variance", "conditional_variance_numpy"]


def conditional_variance_numpy(
    X: np.ndarray,
    M: int,
    kernel_diag: Callable[[np.ndarray], np.ndarray],
    kernel_cross: Callable[[np.ndarray, np.ndarray], np.ndarray],
    seed: int = 0,
    jitter: float = 1e-12,
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy max-conditional-variance selection (host-side).

    Args:
        X: [N, D] candidate points.
        kernel_diag: X -> diag K(X, X), shape [N].
        kernel_cross: (X, z[1,D]) -> K(X, z), shape [N, 1].
    Returns:
        (Z [M, D], indices into the original X [M])
    """
    N = X.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(N)
    Xp = X[perm]

    indices = np.zeros(M, dtype=np.int64)
    di = np.asarray(kernel_diag(Xp), dtype=np.float64) + jitter
    indices[0] = int(np.argmax(di))
    ci = np.zeros((M - 1, N), dtype=np.float64)
    for m in range(M - 1):
        j = int(indices[m])
        dj = np.sqrt(di[j])
        cj = ci[:m, j]
        Lcol = np.array(kernel_cross(Xp, Xp[j:j + 1]),
                        dtype=np.float64)[:, 0]
        Lcol[j] += jitter
        ei = (Lcol - cj @ ci[:m]) / dj
        ci[m, :] = ei
        di = np.clip(di - ei * ei, 0.0, None)
        indices[m + 1] = int(np.argmax(di))
    Z = Xp[indices]
    return Z, perm[indices]


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
