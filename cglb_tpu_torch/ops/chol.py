"""Cholesky factor and its inverse.

The interface of ``cglb_tpu/ops/chol64.py:423-470`` (``chol_inv``,
``chol_inv_retry``) on ``torch.linalg.cholesky_ex`` and a triangular solve
against I.  The blocked and Newton internals of chol64 work around fp64
emulation on the TPU and are not ported.

A failed factorization gives NaN, as ``jnp.linalg.cholesky`` does, so the
callers' finiteness tests (the 1000x-jitter retry, sgpr.py:106-123) behave
as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.profiling import annotate

__all__ = ["cholesky", "chol_retry", "chol_inv", "chol_inv_retry"]


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
