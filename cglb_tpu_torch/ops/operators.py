"""Dense operator for K(X, X) + sigma^2 I (counterpart of
``cglb_tpu/ops/operators.py``); the streaming one is ``ops/matvec.py``."""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["make_dense_operator"]


def make_dense_operator(kernel, X: torch.Tensor, sigma_sq
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Materialize K(X, X) + sigma^2 I once and return p -> p K."""
    Kmat = kernel.K(X) + sigma_sq * torch.eye(X.shape[0], dtype=X.dtype,
                                              device=X.device)

    def matvec(p):
        return p @ Kmat

    return matvec
