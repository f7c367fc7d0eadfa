"""Constant mean function and Gaussian density helpers.

Counterpart of ``cglb_tpu/models/gaussian.py``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import config as _config
from ..transforms import Param

__all__ = ["ConstantMean", "mean_apply", "gaussian_log_density",
           "predict_log_density"]


class ConstantMean(nn.Module):
    """m(x) = c, broadcast over rows; c has shape [output_dim]."""

    def __init__(self, output_dim: int = 1, dtype: torch.dtype = None,
                 device=None):
        super().__init__()
        dtype = dtype or _config.torch_dtype()
        self.c = Param(torch.zeros(output_dim, dtype=dtype), dtype=dtype,
                       device=device)


def mean_apply(mean: ConstantMean, X: torch.Tensor) -> torch.Tensor:
    c = mean.c.value
    return c[None, :].expand(X.shape[0], c.shape[0]).to(X.dtype)


def gaussian_log_density(x, mu, var):
    """Elementwise log N(x | mu, var)."""
    return -0.5 * (math.log(2.0 * math.pi) + torch.log(var)
                   + torch.square(x - mu) / var)


def predict_log_density(f_mean, f_var, noise_variance, Y):
    """log N(Y | f_mean, f_var + sigma^2), summed over output dims."""
    return torch.sum(gaussian_log_density(Y, f_mean, f_var + noise_variance),
                     dim=-1)
