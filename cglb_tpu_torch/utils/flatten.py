"""Trainable parameters as one fp64 host vector, and back.

Counterpart of ``cglb_tpu/utils/flatten.py:56-145`` for the scipy L-BFGS-B
bridge.  The order is ``named_params()``'s, which is the JAX package's leaf
order (kernel variance, lengthscales, inducing points, noise variance, mean,
and ``v0`` when it is trained jointly), so the two packages' vectors agree
element for element.

The JAX package builds a new pytree per vector; here the vector is written
into the live module's ``Param.raw`` tensors in place.  A parameter is
trainable while ``raw.requires_grad`` is set; ``make_unflatten`` fixes the set
at the time it is called, so it is rebuilt after a parameter is frozen.  Each
direction is one ``torch.cat`` and one copy between host and device.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List

import numpy as np
import torch

__all__ = ["flatten_trainable", "make_unflatten", "flatten_grads_like",
           "assign_parameters"]


def _trainable_raws(module) -> List[torch.Tensor]:
    return [p.raw for _, p in module.named_params() if p.trainable]


def _to_host(chunks: List[torch.Tensor]) -> np.ndarray:
    if not chunks:
        return np.zeros((0,), dtype=np.float64)
    flat = torch.cat([c.detach().reshape(-1).to(torch.float64)
                      for c in chunks])
    return flat.cpu().numpy()


def flatten_trainable(module) -> np.ndarray:
    """All trainable raw values as one fp64 host vector."""
    return _to_host(_trainable_raws(module))


def make_unflatten(module) -> Callable[[np.ndarray], object]:
    """vector -> ``module``, with the vector written into the raws that are
    trainable now (in place, under no_grad; everything else is kept)."""
    raws = _trainable_raws(module)
    sizes = [r.numel() for r in raws]

    def unflatten(vector):
        vector = np.array(vector, dtype=np.float64)  # scipy reuses its x
        if vector.shape != (sum(sizes),):
            raise ValueError(f"vector of shape {vector.shape} for "
                             f"{sum(sizes)} trainable values")
        if raws:
            flat = torch.from_numpy(vector).to(raws[0].device)
            with torch.no_grad():
                for raw, chunk in zip(raws, torch.split(flat, sizes)):
                    raw.copy_(chunk.reshape(raw.shape))
        return module

    return unflatten


def flatten_grads_like(module) -> np.ndarray:
    """The ``.grad`` of the trainable raws as one fp64 host vector, in the
    order of :func:`flatten_trainable` (a raw without a gradient gives
    zeros)."""
    return _to_host([r.grad if r.grad is not None else torch.zeros_like(r)
                     for r in _trainable_raws(module)])


def assign_parameters(module, values: Dict[str, np.ndarray]):
    """Assign constrained values keyed as both packages write them
    (``.kernel.variance``, ``.kernel.lengthscales``, ``.inducing_Z``,
    ``.noise_variance``, ``.mean.c``, ``.v0``; a ``model.json`` or the
    ``params`` of a ``checkpoint.json``).  Keys missing on either side are
    warned about and skipped."""
    named = dict(module.named_params())
    missing = set(named) - set(values)
    extra = set(values) - set(named)
    if missing:
        warnings.warn(f"Cannot load some parameters: {sorted(missing)}")
    if extra:
        warnings.warn(f"Ignoring unknown parameters: {sorted(extra)}")
    for name, param in named.items():
        if name in values:
            param.assign(np.asarray(values[name]))
    return module
