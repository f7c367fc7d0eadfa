"""Exact GP regression by dense Cholesky.

Counterpart of ``cglb_tpu/models/gpr.py``.  Two roles: the ``gpr`` model
family of the CLI, and the dense oracle of the sparse bounds (elbo <= CGLB
<= lml <= upper bound).

K(X, X) + sigma^2 I is materialized and factored in the working dtype with
``torch.linalg`` (these products lie outside any TPU kernel of the JAX
package): O(N^2) memory, O(N^3) time.  Prediction is split as the other
models' is: :func:`predict_prepare` factors once, :func:`predict_from_cache`
serves a batch of test rows.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
from torch import nn

from .. import config as _config
from ..ops import chol as _chol
from ..transforms import Param, ParamModule
from .gaussian import ConstantMean, mean_apply, predict_log_density

__all__ = ["GPRParams", "log_marginal_likelihood", "GPRPredictCache",
           "predict_prepare", "predict_from_cache", "predict_f",
           "gpr_predict_log_density"]


def _solve_lower(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


class GPRParams(ParamModule):
    """Kernel, noise variance and constant mean (``.kernel.variance``,
    ``.kernel.lengthscales``, ``.noise_variance``, ``.mean.c``)."""

    def __init__(self, kernel: nn.Module, noise_variance: float = 1.0,
                 output_dim: int = 1, dtype: torch.dtype = None,
                 variance_lower: float = None, device=None):
        super().__init__()
        dtype = dtype or _config.torch_dtype()
        lower = (variance_lower if variance_lower is not None
                 else _config.positive_lower_bound(dtype))
        self.kernel = kernel
        self.noise_variance = Param.positive(noise_variance, lower,
                                             dtype=dtype, device=device)
        self.mean = ConstantMean(output_dim, dtype=dtype, device=device)


def _chol_Ky(params: GPRParams, X) -> torch.Tensor:
    """chol(K(X, X) + sigma^2 I), NaN where the factorization failed."""
    Ky = params.kernel.K(X)
    # the diagonal is added in place: no second N x N tensor (autograd needs
    # neither operand of an addition)
    Ky.diagonal().add_(params.noise_variance.value)
    return _chol.cholesky(Ky)


def log_marginal_likelihood(params: GPRParams, X, Y) -> torch.Tensor:
    """log p(Y | X, theta) = -0.5 [N D log 2pi + D log|Ky| + tr(err^T Ky^-1
    err)]."""
    err = Y - mean_apply(params.mean, X)
    N, D = Y.shape
    Lk = _chol_Ky(params, X)
    alpha = _solve_lower(Lk, err)
    lml = -0.5 * N * D * math.log(2.0 * math.pi)
    lml = lml - D * torch.sum(torch.log(torch.diagonal(Lk)))
    return lml - 0.5 * torch.sum(torch.square(alpha))


class GPRPredictCache(NamedTuple):
    Lk: torch.Tensor     # [N, N] chol(Ky)
    alpha: torch.Tensor  # [N, D] Lk^-1 err


def predict_prepare(params: GPRParams, X, Y) -> GPRPredictCache:
    """The batch-independent half of predict_f: one factorization."""
    err = Y - mean_apply(params.mean, X)
    Lk = _chol_Ky(params, X)
    return GPRPredictCache(Lk=Lk, alpha=_solve_lower(Lk, err))


def predict_from_cache(params: GPRParams, cache: GPRPredictCache, X, Xnew,
                       full_cov: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean [S, D] and variance of the latent f at Xnew: marginal
    [S, D] (the same for every output), or the [S, S] covariance."""
    Ksf = params.kernel.K(Xnew, X)  # [S, N]
    A = _solve_lower(cache.Lk, Ksf.T)  # [N, S]
    f_mean = A.T @ cache.alpha + mean_apply(params.mean, Xnew)
    if full_cov:
        return f_mean, params.kernel.K(Xnew) - A.T @ A
    var = params.kernel.kdiag(Xnew) - torch.sum(torch.square(A), dim=0)
    return f_mean, var[:, None].expand(-1, cache.alpha.shape[1])


def predict_f(params: GPRParams, X, Y, Xnew, full_cov: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    return predict_from_cache(params, predict_prepare(params, X, Y), X, Xnew,
                              full_cov)


def gpr_predict_log_density(params: GPRParams, X, Y, Xnew, Ynew):
    f_mean, f_var = predict_f(params, X, Y, Xnew)
    return predict_log_density(f_mean, f_var, params.noise_variance.value,
                               Ynew)
