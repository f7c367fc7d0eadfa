"""Stationary ARD kernels: SquaredExponential and Matern32.

Counterpart of ``cglb_tpu/ops/kernels.py:39-150``.  A kernel is an
``nn.Module`` holding two positive ``Param``s (``variance``,
``lengthscales``); ``K`` and ``kdiag`` are plain torch and serve as the dense
oracle that the streaming and Kuf kernels are tested against.

Two guards keep the gradient finite at r = 0: the self-distance matrix has
an exactly zero diagonal (``_sq_dist_self``), and Matern32 takes
``sqrt(d2 + 1e-36)``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .. import config as _config
from ..transforms import Param

__all__ = ["SquaredExponential", "Matern32", "K", "kdiag", "scaled_sq_dist",
           "make_kernel", "KERNELS", "GAMMA"]

# family constant folded into the scaled coordinates of the streaming and
# Kuf kernels: t = gamma * d2, so rho(t) needs no per-entry rescale
GAMMA = {"rbf": 0.5, "mat32": 3.0}


class _Stationary(nn.Module):
    family = ""

    def __init__(self, input_dim: int, variance=1.0, lengthscales=1.0,
                 dtype: torch.dtype = None, lower: float = None, device=None):
        super().__init__()
        dtype = dtype or _config.torch_dtype()
        lower = lower if lower is not None else \
            _config.positive_lower_bound(dtype)
        ls = torch.as_tensor(lengthscales, dtype=dtype).broadcast_to(
            (input_dim,)).clone()
        self.variance = Param.positive(variance, lower, dtype=dtype,
                                       device=device)
        self.lengthscales = Param.positive(ls, lower, dtype=dtype,
                                           device=device)

    def profile(self, d2: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def K(self, X: torch.Tensor, Z: Optional[torch.Tensor] = None):
        ls = self.lengthscales.value
        d2 = _sq_dist_self(X, ls) if Z is None else scaled_sq_dist(X, Z, ls)
        return self.variance.value * self.profile(d2)

    def kdiag(self, X: torch.Tensor) -> torch.Tensor:
        return self.variance.value * torch.ones(
            X.shape[0], dtype=X.dtype, device=X.device)


class SquaredExponential(_Stationary):
    """k(x, z) = variance * exp(-0.5 * ||(x - z) / lengthscales||^2)"""

    family = "rbf"

    def profile(self, d2):
        return torch.exp(-0.5 * d2)


class Matern32(_Stationary):
    """k(x, z) = variance * (1 + sqrt(3) r) exp(-sqrt(3) r)"""

    family = "mat32"

    def profile(self, d2):
        r = torch.sqrt(d2 + 1e-36)  # tiny guard: grad of sqrt at 0
        s3r = math.sqrt(3.0) * r
        return (1.0 + s3r) * torch.exp(-s3r)


def scaled_sq_dist(X, Z, lengthscales):
    """[N, M] squared distances of lengthscale-scaled inputs (matmul
    expansion, clamped at zero)."""
    Xs = X / lengthscales
    Zs = Z / lengthscales
    xn = torch.sum(Xs * Xs, dim=-1)[:, None]
    zn = torch.sum(Zs * Zs, dim=-1)[None, :]
    d2 = xn + zn - 2.0 * (Xs @ Zs.T)
    return torch.clamp(d2, min=0.0)


def _sq_dist_self(X, lengthscales):
    Xs = X / lengthscales
    xn = torch.sum(Xs * Xs, dim=-1)
    d2 = torch.clamp(xn[:, None] + xn[None, :] - 2.0 * (Xs @ Xs.T), min=0.0)
    # exact zeros on the diagonal (guards Matern's sqrt grad at r=0), written
    # in place: at N = 26800 every N x N temporary is 5.75 GB
    d2.diagonal().zero_()
    return d2


def K(kernel: _Stationary, X, Z=None):
    """Dense covariance K(X, Z); Z=None means K(X, X)."""
    return kernel.K(X, Z)


def kdiag(kernel: _Stationary, X):
    return kernel.kdiag(X)


KERNELS = {
    "SquaredExponential": SquaredExponential,
    "Matern32": Matern32,
    "rbf": SquaredExponential,
    "mat32": Matern32,
}


def make_kernel(name_or_cls, input_dim: int, variance=1.0, lengthscales=1.0,
                dtype=None, lower: float = None, device=None):
    """Kernel with the reference defaults: variance 1, ARD lengthscales 1."""
    cls = KERNELS[name_or_cls] if isinstance(name_or_cls, str) else name_or_cls
    return cls(input_dim, variance, lengthscales,
               dtype=_config.torch_dtype(dtype) if dtype is not None else None,
               lower=lower, device=device)
