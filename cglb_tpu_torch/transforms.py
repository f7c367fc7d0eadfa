"""Constrained parameters: value = lower + softplus(raw).

Counterpart of ``cglb_tpu/transforms.py:26-136``.  A ``Param`` is an
``nn.Module`` holding its unconstrained ``raw`` values as an ``nn.Parameter``;
a frozen parameter has ``requires_grad=False`` (the JAX package's static
``trainable`` flag).  Modules that hold Params name them so that
``named_modules()`` yields the JAX package's dotted keys
(``kernel.variance``, ``inducing_Z``, ``noise_variance``, ``mean.c``).

softplus is ``torch.logaddexp(raw, 0)``, what ``jnp.logaddexp`` computes.
``torch.nn.functional.softplus`` is NOT used: it switches to the identity
above ``threshold=20``, which changes values and gradients there.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

__all__ = ["Identity", "Positive", "Param", "ParamModule", "softplus",
           "softplus_inverse"]


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def softplus_inverse(y: torch.Tensor) -> torch.Tensor:
    # log(e^y - 1) = y + log(1 - e^-y) = y + log(-expm1(-y))
    return y + torch.log(-torch.expm1(-y))


class Identity:
    def forward(self, raw):
        return raw

    def inverse(self, value):
        return value

    def __repr__(self):
        return "identity"


class Positive:
    """value = lower + softplus(raw)."""

    def __init__(self, lower: float = 0.0):
        self.lower = float(lower)

    def forward(self, raw):
        return self.lower + softplus(raw)

    def inverse(self, value):
        return softplus_inverse(value - self.lower)

    def __repr__(self):
        return f"positive(lower={self.lower:g})"


class Param(nn.Module):
    """Unconstrained ``raw`` values behind a transform; ``value`` is the
    constrained tensor (differentiable in ``raw``)."""

    def __init__(self, value, transform=None, trainable: bool = True,
                 dtype: torch.dtype = None, device=None):
        super().__init__()
        self.transform = transform if transform is not None else Identity()
        value = torch.as_tensor(value, dtype=dtype, device=device)
        raw = self.transform.inverse(value).detach().clone()
        self.raw = nn.Parameter(raw, requires_grad=trainable)

    @property
    def value(self) -> torch.Tensor:
        return self.transform.forward(self.raw)

    @property
    def trainable(self) -> bool:
        return self.raw.requires_grad

    def assign(self, value) -> None:
        """Set the constrained value (shape and dtype of ``raw`` kept)."""
        value = torch.as_tensor(value, dtype=self.raw.dtype,
                                device=self.raw.device).reshape(self.raw.shape)
        with torch.no_grad():
            self.raw.copy_(self.transform.inverse(value))

    @staticmethod
    def positive(value, lower: float, trainable: bool = True, dtype=None,
                 device=None) -> "Param":
        return Param(value, Positive(lower), trainable, dtype, device)


class ParamModule(nn.Module):
    """A model's parameter module: its ``Param``s carry the JAX package's
    dotted names."""

    def named_params(self):
        """(dotted JAX-style name, Param) pairs in registration order."""
        return [("." + name, m) for name, m in self.named_modules()
                if isinstance(m, Param)]

    def parameter_dict(self) -> Dict[str, np.ndarray]:
        """Constrained values keyed ``.kernel.variance``, ... (model.json)."""
        with torch.no_grad():
            return {name: p.value.detach().cpu().numpy()
                    for name, p in self.named_params()}
