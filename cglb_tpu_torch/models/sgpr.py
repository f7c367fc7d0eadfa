"""SGPR: parameters, common terms, Titsias ELBO and upper bound, prediction.

Counterpart of ``cglb_tpu/models/sgpr.py`` on its fp64 route
(``_kuf_terms``, :604-654):

    L  = chol(Kuu + jitter I)                [M, M]
    A  = L^-1 Kuf / sigma                    [M, N]
    B  = A A^T + I,  LB = chol(B)            [M, M]

Kuf comes from kernel 3 (ops/kuf.py), unchunked: at M = 2048, N = 26800 it
is 439 MB in fp64.  The JAX package's ``mixed`` gram, df32 and int8 paths
work around fp64 emulation on the TPU and are not ported; the backend treats
``common_dtype="mixed"`` as fp64.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from .. import config as _config
from ..ops import chol as _chol
from ..ops.kuf import kuf as _kuf
from ..transforms import Param
from .gaussian import ConstantMean, mean_apply

__all__ = ["SGPRParams", "CommonTerms", "common_terms", "elbo",
           "upper_bound", "SGPRPredictCache", "predict_prepare",
           "predict_from_cache", "predict_f"]


def _solve_lower(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


class SGPRParams(nn.Module):
    """Kernel, inducing points, noise variance and constant mean.  Its
    ``Param``s carry the JAX package's names (``parameter_dict``)."""

    def __init__(self, kernel: nn.Module, Z, noise_variance: float = 1.0,
                 output_dim: int = 1, dtype: torch.dtype = None,
                 variance_lower: float = None,
                 trainable_inducing: bool = True, device=None):
        super().__init__()
        dtype = dtype or _config.torch_dtype()
        lower = (variance_lower if variance_lower is not None
                 else _config.positive_lower_bound(dtype))
        self.kernel = kernel
        self.inducing_Z = Param(torch.as_tensor(Z), dtype=dtype,
                                device=device, trainable=trainable_inducing)
        self.noise_variance = Param.positive(noise_variance, lower,
                                             dtype=dtype, device=device)
        self.mean = ConstantMean(output_dim, dtype=dtype, device=device)

    @property
    def num_inducing(self) -> int:
        return self.inducing_Z.raw.shape[0]

    def named_params(self):
        """(dotted JAX-style name, Param) pairs in registration order."""
        return [("." + name, m) for name, m in self.named_modules()
                if isinstance(m, Param)]

    def parameter_dict(self) -> Dict[str, np.ndarray]:
        """Constrained values keyed ``.kernel.variance``, ... (model.json)."""
        with torch.no_grad():
            return {name: p.value.detach().cpu().numpy()
                    for name, p in self.named_params()}


class CommonTerms(NamedTuple):
    A: torch.Tensor     # [M, N]  L^-1 Kuf / sigma
    AAT: torch.Tensor   # [M, M]
    B: torch.Tensor     # [M, M]  AAT + I
    LB: torch.Tensor    # [M, M]  chol(B)
    L: torch.Tensor     # [M, M]  chol(Kuu + jitter I)


def _jitter(jitter):
    return jitter if jitter is not None else _config.default_jitter()


def _kuu_chol(params: SGPRParams, jitter: float) -> torch.Tensor:
    """chol(Kuu + jitter I) with the 1000x-jitter retry (sgpr.py:106-123)."""
    Z = params.inducing_Z.value
    return _chol.chol_retry(params.kernel.K(Z), jitter)


def _kuf_terms(params: SGPRParams, L, X, sigma_scale, W=None):
    """A = L^-1 Kuf / sigma_scale, A A^T and optionally A @ W."""
    kuf = _kuf(params.kernel, params.inducing_Z.value, X)
    A = _solve_lower(L, kuf) / sigma_scale
    AAT = A @ A.T
    AW = None if W is None else A @ W
    return A, AAT, AW


def common_terms(params: SGPRParams, X, jitter: float = None) -> CommonTerms:
    """Reference semantics: cglb/backend/tensorflow/models.py:58-75."""
    jitter = _jitter(jitter)
    M = params.num_inducing
    sigma = torch.sqrt(params.noise_variance.value)
    L = _kuu_chol(params, jitter)
    A, AAT, _ = _kuf_terms(params, L, X, sigma)
    B = AAT + torch.eye(M, dtype=X.dtype, device=X.device)
    LB = _chol.cholesky(B)
    return CommonTerms(A=A, AAT=AAT, B=B, LB=LB, L=L)


def elbo(params: SGPRParams, X, Y, jitter: float = None) -> torch.Tensor:
    """Titsias (2009) collapsed ELBO."""
    jitter = _jitter(jitter)
    err = Y - mean_apply(params.mean, X)
    N, D = Y.shape
    M = params.num_inducing
    sigma_sq = params.noise_variance.value
    sigma = torch.sqrt(sigma_sq)
    L = _kuu_chol(params, jitter)
    _, AAT, Aerr = _kuf_terms(params, L, X, sigma, W=err)
    LB = _chol.cholesky(AAT + torch.eye(M, dtype=X.dtype, device=X.device))
    c = _solve_lower(LB, Aerr) / sigma

    bound = -0.5 * N * D * math.log(2.0 * math.pi)
    bound = bound - D * torch.sum(torch.log(torch.diagonal(LB)))
    bound = bound - 0.5 * N * D * torch.log(sigma_sq)
    bound = bound - 0.5 * torch.sum(torch.square(err)) / sigma_sq
    bound = bound + 0.5 * torch.sum(torch.square(c))
    # trace correction: -0.5 D (sum kdiag / sigma^2 - tr(AAT))
    kd = params.kernel.kdiag(X)
    bound = bound - 0.5 * D * (torch.sum(kd) / sigma_sq - torch.trace(AAT))
    return bound


def upper_bound(params: SGPRParams, X, Y, jitter: float = None
                ) -> torch.Tensor:
    """Titsias trace upper bound on the log marginal likelihood."""
    jitter = _jitter(jitter)
    M = params.num_inducing
    N = X.shape[0]
    sigma_sq = params.noise_variance.value
    eye_m = torch.eye(M, dtype=X.dtype, device=X.device)
    err = Y - mean_apply(params.mean, X)
    one = torch.ones((), dtype=X.dtype, device=X.device)
    L = _kuu_chol(params, jitter)
    _, AAT0, A0err = _kuf_terms(params, L, X, one, W=err)
    LB = _chol.cholesky(eye_m + AAT0 / sigma_sq)
    # trace slack tr(Kff) - tr(Qff) >= 0, clamped against cancellation
    cslack = torch.clamp(
        torch.sum(params.kernel.kdiag(X)) - torch.trace(AAT0), min=0.0)
    corrected_noise = sigma_sq + cslack

    const = -0.5 * N * torch.log(2.0 * math.pi * sigma_sq)
    logdet = -torch.sum(torch.log(torch.diagonal(LB)))
    LC = _chol.cholesky(eye_m + AAT0 / corrected_noise)
    v = _solve_lower(LC, A0err / corrected_noise)
    quad = (-0.5 * torch.sum(torch.square(err)) / corrected_noise
            + 0.5 * torch.sum(torch.square(v)))
    return const + logdet + quad


class SGPRPredictCache(NamedTuple):
    c: torch.Tensor   # [M, D] LB^-1 (A @ err) / sigma
    L: torch.Tensor
    LB: torch.Tensor


@torch.no_grad()
def predict_prepare(params: SGPRParams, X, Y, jitter: float = None
                    ) -> SGPRPredictCache:
    """The batch-independent half of predict_f."""
    jitter = _jitter(jitter)
    err = Y - mean_apply(params.mean, X)
    sigma = torch.sqrt(params.noise_variance.value)
    M = params.num_inducing
    L = _kuu_chol(params, jitter)
    _, AAT, Aerr = _kuf_terms(params, L, X, sigma, W=err)
    LB = _chol.cholesky(AAT + torch.eye(M, dtype=X.dtype, device=X.device))
    c = _solve_lower(LB, Aerr) / sigma
    return SGPRPredictCache(c=c, L=L, LB=LB)


def _cache_solves(params: SGPRParams, cache, Xnew):
    """tmp1 = L^-1 Kus, tmp2 = LB^-1 tmp1 (Kus from kernel 3)."""
    Kus = _kuf(params.kernel, params.inducing_Z.value, Xnew)  # [M, S]
    tmp1 = _solve_lower(cache.L, Kus)
    tmp2 = _solve_lower(cache.LB, tmp1)
    return tmp1, tmp2


def _marginal_var(params: SGPRParams, Xnew, tmp1, tmp2, D: int):
    var = (params.kernel.kdiag(Xnew) + torch.sum(torch.square(tmp2), dim=0)
           - torch.sum(torch.square(tmp1), dim=0))
    return var[:, None].expand(-1, D)


@torch.no_grad()
def predict_from_cache(params: SGPRParams, cache: SGPRPredictCache, Xnew
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-batch SGPR posterior mean and marginal variance: O(S M^2)."""
    tmp1, tmp2 = _cache_solves(params, cache, Xnew)
    f_mean = tmp2.T @ cache.c + mean_apply(params.mean, Xnew)
    return f_mean, _marginal_var(params, Xnew, tmp1, tmp2, cache.c.shape[1])


def predict_f(params: SGPRParams, X, Y, Xnew, jitter: float = None):
    cache = predict_prepare(params, X, Y, jitter)
    return predict_from_cache(params, cache, Xnew)
