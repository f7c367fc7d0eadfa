"""Training loops: the scipy L-BFGS-B bridge, its adaptive CG-tolerance
schedule, and Adam.

Counterpart of ``cglb_tpu/utils/training.py``:

- ``scipy_minimize`` (:77-224): host scipy L-BFGS-B driving the loss and its
  gradient on the device, with the restart-on-early-stop schedule
  (``attempts``, each given the remaining budget), the inducing-point freeze
  of the 4-attempt schedule, and the finite penalty bowl for non-finite
  probes;
- ``scipy_tol_minimize`` (:227-348): that bridge re-entered at CG tolerances
  tightened 10x each time scipy converges with budget left;
- ``adam_minimize`` (:351-392) on ``torch.optim.Adam``, whose defaults (betas
  0.9/0.999, eps 1e-8) equal optax's ``adam``.

Every optimizer acts on the raw (unconstrained) values of the model's
trainable ``Param``s and updates the live module in place; the JAX package
builds a new pytree per evaluation instead.  The CG warm start is threaded
through every path as carry state and is updated on every evaluation,
line-search probes included.  The on-device L-BFGS, the C++ L-BFGS, the
staged exact-GP schedule and the dispatch-bounded Adam are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import scipy.optimize
import torch

from . import flatten as _fl
from .logging import Logger

__all__ = ["OptimizeResult", "scipy_minimize", "scipy_tol_minimize",
           "adam_minimize"]

# loss_fn(params, carry, *loss_args) -> (loss tensor, new carry)
LossFn = Callable[..., Any]

# Non-finite losses (extreme line-search probes: CG divergence, a failed
# factorization) go back to L-BFGS-B as a smooth finite bowl centred at the
# last good iterate.  scipy's line search answers NaN by blind repeated
# halving; a finite value with an informative slope lets its interpolation
# back off in one or two evaluations.
_PENALTY = 1e12


class OptimizeResult(NamedTuple):
    params: Any
    state: Any          # final carry (e.g. CGLB aux with the warm start)
    num_iters: int
    final_loss: float
    # optimizer diagnostics for results.json (scipy: status, message, nit and
    # nfev of each attempt, and the count of penalty evaluations)
    info: dict = {}


def penalty_bowl(x: np.ndarray, x_good: Optional[np.ndarray]):
    """(f, g) handed to L-BFGS-B in place of a non-finite loss at ``x``."""
    dx = x - x_good if x_good is not None else np.zeros_like(x)
    f = _PENALTY * (1.0 + float(dx @ dx))
    return f, np.asarray((2.0 * _PENALTY) * dx, dtype=np.float64)


def _freeze_inducing(params) -> None:
    """The inducing points become non-trainable (the 4-attempt schedule
    freezes them after the 2nd attempt)."""
    z = getattr(params, "inducing_Z", None)
    if z is not None and z.trainable:
        z.raw.requires_grad_(False)
        z.raw.grad = None


def scipy_minimize(
    loss_fn: LossFn,
    params: torch.nn.Module,
    state,
    num_steps: int,
    logger: Optional[Logger] = None,
    attempts: int = 2,
    ftol: float = 0.0,
    gtol: float = 0.0,
    feval_stats_fn: Callable[[Any], dict] = None,
    loss_args: tuple = (),
    freeze_inducing_after: Optional[int] = None,
    sync_fn: Callable[[Any, Any], None] = None,
    _reset_timer: bool = True,
) -> OptimizeResult:
    """L-BFGS-B on the host, loss and gradient on the device of ``params``.

    The trainable raws are flattened to one fp64 vector; each evaluation
    writes the vector into the module, runs ``loss_fn`` and ``backward``
    once, and reads the loss and one gradient vector back.  The carry (CG
    warm start) is updated on every evaluation, line-search probes included.

    attempts: scipy sometimes stops before the step budget; minimize is
    called again with the remaining budget.  Each attempt gets
    ``maxiter=remaining`` (not an even split): a restart engages only when
    an attempt ends before its budget.
    freeze_inducing_after: index of the attempt from which the inducing
    points are frozen; the vector space changes there, so the flatten spec is
    rebuilt and the penalty bowl's centre forgotten.
    loss_args: extra positional arguments of ``loss_fn`` (the live CG
    tolerance of ``scipy_tol_minimize``'s levels).
    sync_fn(params, carry): called with the accepted iterate in the module
    before the logger fires.
    _reset_timer: False keeps the logger's clock running across calls (a
    multi-level schedule is one run).

    After each attempt the module holds ``res.x``; the loss and carry are
    refreshed there only when scipy's last evaluation was elsewhere.
    """
    holder = {
        "state": state,
        "loss": np.inf,
        "unflatten": _fl.make_unflatten(params),
        "x": None,       # where the last evaluation was
        "x_good": None,  # last iterate with a finite loss (the bowl's centre)
        "nfev": 0,
        "penalty_fevals": 0,
    }

    def fun(x):
        holder["nfev"] += 1
        holder["unflatten"](x)
        params.zero_grad(set_to_none=True)
        loss, new_state = loss_fn(params, holder["state"], *loss_args)
        holder["state"] = new_state
        holder["x"] = np.array(x, copy=True)
        if logger is not None and feval_stats_fn is not None:
            logger.log_for_feval(**feval_stats_fn(new_state))
        loss_f = float(loss.detach())
        if not np.isfinite(loss_f):
            holder["penalty_fevals"] += 1
            return penalty_bowl(x, holder["x_good"])
        loss.backward()
        holder["loss"] = loss_f
        holder["x_good"] = holder["x"]
        return loss_f, _fl.flatten_grads_like(params)

    def callback(xk):
        # The module holds the last line-search probe, not the accepted
        # iterate: publish xk before the logger's metric closures read the
        # live model.
        holder["unflatten"](xk)
        if sync_fn is not None:
            sync_fn(params, holder["state"])
        if logger is not None:
            logger(None)

    if logger is not None and _reset_timer:
        logger.timer.reset()
        logger.timer.start()

    total_iters = 0
    remaining = num_steps
    attempt_log = []
    for attempt in range(attempts):
        if remaining <= 0:
            break
        if freeze_inducing_after is not None and \
                attempt == freeze_inducing_after:
            _freeze_inducing(params)
            holder["unflatten"] = _fl.make_unflatten(params)
            holder["x"] = None
            holder["x_good"] = None
        res = scipy.optimize.minimize(
            fun,
            _fl.flatten_trainable(params),
            jac=True,
            method="L-BFGS-B",
            options=dict(maxiter=remaining, ftol=ftol, gtol=gtol),
            callback=callback,
        )
        total_iters += int(res.nit)
        remaining -= int(res.nit)
        attempt_log.append({
            "status": int(res.status),
            "message": str(res.message),
            "nit": int(res.nit),
            "nfev": int(res.nfev),
        })
        holder["unflatten"](res.x)
        if holder["x"] is None or not np.array_equal(res.x, holder["x"]):
            with torch.no_grad():
                loss, new_state = loss_fn(params, holder["state"],
                                          *loss_args)
            holder["state"] = new_state
            holder["loss"] = float(loss)
    params.zero_grad(set_to_none=True)

    return OptimizeResult(
        params=params,
        state=holder["state"],
        num_iters=total_iters,
        final_loss=holder["loss"],
        info={
            "opt/num_iters": total_iters,
            "opt/num_fevals": holder["nfev"],
            "opt/penalty_fevals": holder["penalty_fevals"],
            "opt/attempts": attempt_log,
        },
    )


def scipy_tol_minimize(
    loss_fn: LossFn,
    loss_fn_tol: LossFn,
    params: torch.nn.Module,
    state,
    num_steps: int,
    logger: Optional[Logger] = None,
    tol_start: float = 1.0,
    tol_floor: float = 1e-2,
    tol_factor: float = 0.1,
    attempts_per_level: int = 1,
    feval_stats_fn: Callable[[Any], dict] = None,
    sync_fn: Callable[[Any, Any], None] = None,
    on_level: Callable[[float], None] = None,
    tol_resume: float = None,
) -> OptimizeResult:
    """Adaptive CG-tolerance L-BFGS schedule.

    Fixed-tolerance CGLB training stalls once the true improvement of an
    iteration falls below the objective jitter that the CG stopping slack
    leaves (O(max_error) through the warm start): the line search then
    reports zero reduction against noise.  This schedule runs the bridge at
    ``tol_start`` first, then, each time scipy converges with budget left,
    multiplies the tolerance by ``tol_factor`` and restarts L-BFGS from the
    solution, down to ``tol_floor``.  The CGLB bound stays valid at every
    level (it is a lower bound for any v).

    Contract: ``loss_fn`` is the objective of the ``tol_start`` level, with
    that tolerance built in (the cheap CG tier is allowed there); every
    tightened level runs ``loss_fn_tol(params, carry, max_error)``.

    attempts_per_level defaults to 1: every level transition is a restart
    already.  The floor level has no next level to restart into, so it alone
    gets the 2-attempt early-stop workaround.
    on_level: called with the live tolerance at each level's start (the
    backend writes it into every checkpoint).
    tol_resume: re-enter the schedule at this tolerance (a resumed run).
    """
    total = 0
    remaining = num_steps
    levels = []
    fevals = 0
    penalty = 0
    me = float(tol_start)
    res = None
    first = True
    if tol_resume is not None:
        me = float(tol_resume)
        # loss_fn is valid at tol_start only
        first = me >= float(tol_start) * (1.0 - 1e-12)
    while remaining > 0:
        at_floor = me <= tol_floor * (1.0 + 1e-12)
        if on_level is not None:
            on_level(me)
        att = max(attempts_per_level, 2) if at_floor else attempts_per_level
        if first:
            res = scipy_minimize(
                loss_fn, params, state, remaining, logger, attempts=att,
                feval_stats_fn=feval_stats_fn, sync_fn=sync_fn)
        else:
            res = scipy_minimize(
                loss_fn_tol, params, state, remaining, logger, attempts=att,
                feval_stats_fn=feval_stats_fn, loss_args=(me,),
                sync_fn=sync_fn, _reset_timer=False)
        total += res.num_iters
        remaining -= res.num_iters
        fevals += res.info["opt/num_fevals"]
        penalty += res.info["opt/penalty_fevals"]
        levels.append({
            "max_error": me,
            "nit": res.num_iters,
            "final_loss": res.final_loss,
            "attempts": res.info["opt/attempts"],
        })
        state = res.state
        if at_floor:
            break
        me = max(me * tol_factor, tol_floor)
        first = False

    return OptimizeResult(
        params=params,
        state=state,
        num_iters=total,
        final_loss=res.final_loss if res is not None else float("nan"),
        info={
            "opt/num_iters": total,
            "opt/num_fevals": fevals,
            "opt/penalty_fevals": penalty,
            "opt/levels": levels,
        },
    )


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
