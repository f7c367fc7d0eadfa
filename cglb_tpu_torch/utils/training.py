"""Training loop (Adam) and the parameter bridge to the JAX package.

Counterpart of ``cglb_tpu/utils/training.py:351-392`` (``adam_minimize``)
on ``torch.optim.Adam``, whose defaults (betas 0.9/0.999, eps 1e-8) equal
optax's ``adam``.  Adam acts on the raw (unconstrained) parameters of the
model's trainable ``Param``s, and the CG warm start is threaded through every
step as carry state.  The scipy, L-BFGS and dispatch-bounded optimizers are
not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .logging import Logger

__all__ = ["OptimizeResult", "adam_minimize", "from_jax_parameter_dict"]

# loss_fn(params, carry) -> (loss tensor, new carry)
LossFn = Callable[[torch.nn.Module, Any], Any]


class OptimizeResult(NamedTuple):
    params: Any
    state: Any          # final carry (e.g. CGLB aux with the warm start)
    num_iters: int
    final_loss: float
    info: dict = {}


def adam_minimize(loss_fn: LossFn, params: torch.nn.Module, state,
                  num_steps: int, learning_rate: float = 0.01,
                  logger: Optional[Logger] = None,
                  sync_fn: Callable[[Any, Any], None] = None
                  ) -> OptimizeResult:
    """``num_steps`` Adam steps on the trainable raw parameters of
    ``params`` (updated in place)."""
    trainable = [p for p in params.parameters() if p.requires_grad]
    opt = torch.optim.Adam(trainable, lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8)
    if logger is not None:
        logger.timer.reset()
        logger.timer.start()
    loss = torch.tensor(np.inf)
    for i in range(num_steps):
        opt.zero_grad(set_to_none=True)
        loss, state = loss_fn(params, state)
        loss.backward()
        opt.step()
        if logger is not None:
            if sync_fn is not None:
                sync_fn(params, state)
            logger(i)
    return OptimizeResult(params=params, state=state, num_iters=num_steps,
                          final_loss=float(loss.detach()))


def from_jax_parameter_dict(model: torch.nn.Module,
                            d: Dict[str, np.ndarray]) -> torch.nn.Module:
    """Assign constrained values keyed as the JAX package writes them
    (``.kernel.variance``, ``.kernel.lengthscales``, ``.inducing_Z``,
    ``.noise_variance``, ``.mean.c``; a ``model.json`` of either package).
    Keys missing on either side are warned about and skipped."""
    named = dict(model.named_params())
    missing = set(named) - set(d)
    extra = set(d) - set(named)
    if missing:
        warnings.warn(f"Cannot load some parameters: {sorted(missing)}")
    if extra:
        warnings.warn(f"Ignoring unknown parameters: {sorted(extra)}")
    for name, param in named.items():
        if name in d:
            param.assign(np.asarray(d[name]))
    return model
