"""Preconditioned conjugate gradients, a host loop under ``torch.no_grad``.

Counterpart of ``cglb_tpu/ops/cg.py:59-182`` with the same semantics:

- a non-finite warm start is zeroed, and the warm start falls back to cold
  per column when it is not better than cold;
- the divergence cap is 1e6 * (err0 + 1);
- the residual is recomputed from scratch every ``restart_iters`` steps;
- the stop rule is 0.5 * sum(rz) <= max_error (or the iteration cap).

The stop test is read back to the host once at the start and once per
iteration, in a span ``cglb.cg.read`` (the solve is ``cglb.cg``): a solve of
k steps reads k + 1 times.  The carry keeps the last value read, so a resumed
solve does not read it again.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import torch

from ..utils.profiling import annotate
from . import preconditioners as _pc

__all__ = ["CGStats", "CGCarry", "preconditioned_cg", "cg_init",
           "cg_advance"]

MatVec = Callable[[torch.Tensor], torch.Tensor]  # [B, N] -> [B, N]


class CGStats(NamedTuple):
    steps: int
    residual_error: float  # final 0.5 * sum(rz)


class _CGState(NamedTuple):
    i: int
    v: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor


class CGCarry(NamedTuple):
    """Resumable solve state: ``cg_advance`` continues exactly the iterate
    sequence ``preconditioned_cg`` would have run."""

    state: _CGState
    err_cap: float
    err: float  # the stop test 0.5 * sum(state.rz), as last read


def _read_err(rz: torch.Tensor) -> float:
    """The stop test's 0.5 * sum(rz), read back to the host."""
    with annotate("cglb.cg.read"):
        return float(0.5 * torch.sum(rz))


@torch.no_grad()
def cg_init(matvec: MatVec, b: torch.Tensor, v0: torch.Tensor,
            precond) -> CGCarry:
    """Warm-start sanitation, initial residual and direction (one matvec)."""
    v0 = torch.where(torch.isfinite(v0), v0, torch.zeros_like(v0))
    r0 = b - matvec(v0)
    z0, rz0 = _pc.mat_vec(precond, r0)
    zb, rzb = _pc.mat_vec(precond, b)
    # never start worse than cold, per column; NOT(warm <= cold) also sends
    # a NaN warm residual to cold
    use_cold = torch.logical_not(rz0 <= rzb)
    col = use_cold[:, None]
    v0 = torch.where(col, torch.zeros_like(v0), v0)
    r0 = torch.where(col, b, r0)
    z0 = torch.where(col, zb, z0)
    rz0 = torch.where(use_cold, rzb, rz0)
    err = _read_err(rz0)
    return CGCarry(state=_CGState(i=0, v=v0, r=r0, p=z0, rz=rz0),
                   err_cap=1e6 * (err + 1.0), err=err)


@torch.no_grad()
def cg_advance(matvec: MatVec, b: torch.Tensor, precond, carry: CGCarry,
               max_error: float, max_iters: int, restart_iters: int = 40
               ) -> Tuple[CGCarry, CGStats]:
    """Iterate from ``carry`` until err <= max_error, i >= max_iters (an
    absolute cap, counted from cg_init), or divergence."""
    s, err = carry.state, carry.err
    while (err > max_error and s.i < max_iters
           and math.isfinite(err) and err < carry.err_cap):
        Ap = matvec(s.p)
        gamma = s.rz / torch.sum(s.p * Ap, dim=-1)  # [B]
        v = s.v + gamma[:, None] * s.p
        restart = (s.i % restart_iters) == (restart_iters - 1)
        r = b - matvec(v) if restart else s.r - gamma[:, None] * Ap
        z, new_rz = _pc.mat_vec(precond, r)
        p = z if restart else z + (new_rz / s.rz)[:, None] * s.p
        s = _CGState(i=s.i + 1, v=v, r=r, p=p, rz=new_rz)
        err = _read_err(s.rz)
    return (CGCarry(state=s, err_cap=carry.err_cap, err=err),
            CGStats(steps=s.i, residual_error=err))


def preconditioned_cg(matvec: MatVec, b: torch.Tensor, v0: torch.Tensor,
                      precond, max_error: float, max_iters: int,
                      restart_iters: int = 40
                      ) -> Tuple[torch.Tensor, CGStats]:
    """Solve v K = b (row vectors [B, N], K symmetric) approximately.
    The result carries no gradient."""
    with annotate("cglb.cg"):
        carry = cg_init(matvec, b, v0, precond)
        carry, stats = cg_advance(matvec, b, precond, carry, max_error,
                                  max_iters, restart_iters)
    return carry.state.v, stats
