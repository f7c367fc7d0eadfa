"""Process-wide numeric settings of the PyTorch port.

Counterpart of ``cglb_tpu/config.py:40-106``: fp64 by default, jitter 1e-6
(fp64) or 1e-5 (fp32), lower bounds of positive parameters 1e-6 (fp64) or
5e-3 (fp32), and the seed.  The settings only pick dtypes and constants when a
model is *created*; every computation takes its tensors' dtype and device.

TF32 is switched off for matrix products and convolutions when this module is
imported.  The Nystrom preconditioner re-derives LB from the very A it applies
(models/cglb._make_precond); a TF32 product (about three decimal digits)
would bring back the LB/A mismatch that step exists to remove, and with
||A A^T|| ~ 1/sigma^2 the Woodbury identity then breaks down at small noise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = [
    "default_float",
    "default_jitter",
    "positive_lower_bound",
    "set_default_float",
    "set_default_jitter",
    "set_default_seed",
    "settings",
    "torch_dtype",
]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_FLOAT_ALIASES = {
    "fp32": np.float32,
    "float32": np.float32,
    "fp64": np.float64,
    "float64": np.float64,
    np.float32: np.float32,
    np.float64: np.float64,
    np.dtype(np.float32): np.float32,
    np.dtype(np.float64): np.float64,
    torch.float32: np.float32,
    torch.float64: np.float64,
}

_TORCH = {np.float32: torch.float32, np.float64: torch.float64}

# jitter: 1e-5 for fp32, 1e-6 for fp64 (cglb_tpu/config.py:45-47)
_DEFAULT_JITTER = {np.float32: 1e-5, np.float64: 1e-6}

# lower bound of positive parameters (cglb_tpu/config.py:49-51)
_POSITIVE_LOWER = {np.float32: 5e-3, np.float64: 1e-6}


@dataclasses.dataclass
class _Settings:
    float_type: type = np.float64
    jitter: Optional[float] = None  # None -> dtype-dependent default
    seed: int = 0

    @property
    def effective_jitter(self) -> float:
        if self.jitter is not None:
            return self.jitter
        return _DEFAULT_JITTER[self.float_type]


settings = _Settings()


def default_float() -> type:
    """The numpy float type models are created in."""
    return settings.float_type


def torch_dtype(dtype=None) -> torch.dtype:
    """torch dtype of ``dtype`` (default: the process default float)."""
    ft = _FLOAT_ALIASES[dtype] if dtype is not None else settings.float_type
    return _TORCH[ft]


def default_jitter() -> float:
    return settings.effective_jitter


def positive_lower_bound(dtype=None) -> float:
    ft = _FLOAT_ALIASES[dtype] if dtype is not None else settings.float_type
    return _POSITIVE_LOWER[ft]


def set_default_float(float_type) -> None:
    """Set the default float ("fp32"/"fp64", or a numpy or torch dtype)."""
    if float_type not in _FLOAT_ALIASES:
        raise NotImplementedError(f"Unknown float type {float_type!r}")
    settings.float_type = _FLOAT_ALIASES[float_type]


def set_default_jitter(value) -> None:
    """Set jitter; accepts a float or a float-type string for its default."""
    if isinstance(value, str):
        settings.jitter = _DEFAULT_JITTER[_FLOAT_ALIASES[value]]
    else:
        settings.jitter = float(value)


def set_default_seed(seed: int) -> None:
    settings.seed = int(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
