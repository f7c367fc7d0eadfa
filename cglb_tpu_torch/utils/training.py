"""Training loops: the scipy L-BFGS-B bridge, its adaptive CG-tolerance
schedule, Adam, L-BFGS on the device, the C++ L-BFGS and the staged exact-GP
schedule.

Counterpart of ``cglb_tpu/utils/training.py``:

- ``scipy_minimize`` (:77-224): host scipy L-BFGS-B driving the loss and its
  gradient on the device, with the restart-on-early-stop schedule
  (``attempts``, each given the remaining budget), the inducing-point freeze
  of the 4-attempt schedule, and the finite penalty bowl for non-finite
  probes;
- ``scipy_tol_minimize`` (:227-348): that bridge re-entered at CG tolerances
  tightened 10x each time scipy converges with budget left;
- ``adam_minimize`` (:351-392) on ``torch.optim.Adam``, whose defaults (betas
  0.9/0.999, eps 1e-8) equal optax's ``adam``;
- ``lbfgs_minimize`` (:540-591, optax L-BFGS with a zoom line search there):
  the two-loop recursion with memory 15 and a strong-Wolfe line search over
  the flattened trainable vector, which stays on the device;
- ``native_lbfgs_minimize`` (:432-494): the C++ L-BFGS of ``native/lbfgs.cpp``
  (utils/native.py) in the host role scipy has above;
- ``staged_gpr_optimize`` (:497-537): the exact-GP baseline's schedule.

Every optimizer acts on the raw (unconstrained) values of the model's
trainable ``Param``s and updates the live module in place; the JAX package
builds a new pytree per evaluation instead.  The CG warm start is threaded
through every path as carry state and is updated on every evaluation,
line-search probes included; ``lbfgs_minimize`` alone holds it fixed inside
one iteration's line search, as the JAX function does.  The dispatch-bounded
Adam (``bounded_adam_minimize``, :405-433) is ``adam_minimize`` with its
per-step CG stats logged: the port's CG returns to the host every iteration,
so its step is already bounded.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import scipy.optimize
import torch

from . import flatten as _fl
from .logging import Logger
from .profiling import annotate

__all__ = ["OptimizeResult", "scipy_minimize", "scipy_tol_minimize",
           "adam_minimize", "lbfgs_minimize", "native_lbfgs_minimize",
           "staged_gpr_optimize"]

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
                  sync_fn: Callable[[Any, Any], None] = None,
                  loss_args: tuple = (),
                  feval_stats_fn: Callable[[Any], dict] = None
                  ) -> OptimizeResult:
    """``num_steps`` Adam steps on the trainable raw parameters of
    ``params`` (updated in place).  loss_args: extra positional arguments
    of ``loss_fn`` (the data slice of the staged schedule).
    feval_stats_fn: stats of each step's carry for the logger's per-feval
    log (the CLI's --dispatch-bound logs them)."""
    trainable = [p for p in params.parameters() if p.requires_grad]
    opt = torch.optim.Adam(trainable, lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8)
    if logger is not None:
        logger.timer.reset()
        logger.timer.start()
    loss = torch.tensor(np.inf)
    for i in range(num_steps):
        with annotate("cglb.step"):
            opt.zero_grad(set_to_none=True)
            loss, state = loss_fn(params, state, *loss_args)
            with annotate("cglb.backward"):
                loss.backward()
            opt.step()
        if logger is not None:
            if feval_stats_fn is not None:
                logger.log_for_feval(**feval_stats_fn(state))
            if sync_fn is not None:
                sync_fn(params, state)
            logger(i)
    return OptimizeResult(params=params, state=state, num_iters=num_steps,
                          final_loss=float(loss.detach()))


def _two_loop(g: torch.Tensor, pairs) -> torch.Tensor:
    """-H g by the L-BFGS two-loop recursion over ``pairs`` of (s, y, 1 /
    y.s), oldest first, with H0 = (s.y / y.y) I from the newest pair."""
    q = g.neg()
    alphas = []
    for sv, yv, rho in reversed(pairs):
        a = rho * torch.dot(sv, q)
        alphas.append(a)
        q = q - a * yv
    sv, yv, rho = pairs[-1]
    q = q / (rho * torch.dot(yv, yv))
    for (sv, yv, rho), a in zip(pairs, reversed(alphas)):
        q = q + (a - rho * torch.dot(yv, q)) * sv
    return q


def _cubic_min(t0, f0, g0, t1, f1, g1) -> float:
    """Minimizer of the cubic through (t0, f0, g0) and (t1, f1, g1), kept
    inside the middle 80 % of the interval; its midpoint if there is no
    finite one."""
    lo, hi = min(t0, t1), max(t0, t1)
    t = 0.5 * (lo + hi)
    if all(np.isfinite(v) for v in (f0, g0, f1, g1)):
        d1 = g0 + g1 - 3.0 * (f0 - f1) / (t0 - t1)
        sq = d1 * d1 - g0 * g1
        if sq >= 0.0:
            d2 = np.sqrt(sq) * (1.0 if t1 >= t0 else -1.0)
            den = g1 - g0 + 2.0 * d2
            if den != 0.0:
                cand = t1 - (t1 - t0) * (g1 + d2 - d1) / den
                if np.isfinite(cand):
                    t = cand
    pad = 0.1 * (hi - lo)
    return float(min(max(t, lo + pad), hi - pad))


def _strong_wolfe(phi, f0: float, g0: float, t: float, c1: float = 1e-4,
                  c2: float = 0.9, max_evals: int = 25) -> float:
    """A step length along a descent direction (g0 < 0) that meets the
    strong Wolfe conditions: bracketing, then zoom by safeguarded cubic
    interpolation (Nocedal & Wright, algorithms 3.5 and 3.6).  ``phi(t)``
    returns (f, slope) as floats; a non-finite f counts as too long a step.
    Out of evaluations, the lowest point found with sufficient decrease is
    returned, or 0.0 when there is none."""
    best = (0.0, f0)

    def armijo(tv, fv):
        return np.isfinite(fv) and fv <= f0 + c1 * tv * g0

    lo = (0.0, f0, g0)
    hi = None
    evals = 0
    while evals < max_evals:
        f, g = phi(t)
        evals += 1
        if not armijo(t, f) or (evals > 1 and f >= lo[1]):
            hi = (t, f, g)
            break
        if f < best[1]:
            best = (t, f)
        if abs(g) <= -c2 * g0:
            return t
        if g >= 0.0:
            lo, hi = (t, f, g), lo
            break
        lo = (t, f, g)
        t = 2.0 * t
    while hi is not None and evals < max_evals:
        if abs(hi[0] - lo[0]) <= 1e-12 * max(abs(hi[0]), abs(lo[0])):
            break
        t = _cubic_min(*lo, *hi)
        f, g = phi(t)
        evals += 1
        if not armijo(t, f) or f >= lo[1]:
            hi = (t, f, g)
            continue
        if f < best[1]:
            best = (t, f)
        if abs(g) <= -c2 * g0:
            return t
        if g * (hi[0] - lo[0]) >= 0.0:
            hi = lo
        lo = (t, f, g)
    return best[0]


def lbfgs_minimize(loss_fn: LossFn, params: torch.nn.Module, state,
                   num_steps: int, logger: Optional[Logger] = None,
                   memory_size: int = 15,
                   feval_stats_fn: Callable[[Any], dict] = None,
                   sync_fn: Callable[[Any, Any], None] = None,
                   loss_args: tuple = ()) -> OptimizeResult:
    """L-BFGS (two-loop recursion, ``memory_size`` pairs) with a
    strong-Wolfe line search over the flattened trainable raws, which stay
    on the device of ``params``; the host reads the loss and the slope of
    each evaluation.

    Each step evaluates the loss and gradient once at the current iterate
    with the current carry and takes its new carry from that evaluation;
    the line search then re-evaluates at trial points with the carry the
    step began with (a fixed warm start, or the same probes), so that it
    searches one deterministic function.  One logged iteration per step; a
    non-finite loss ends the run.  ``final_loss`` is the last step's loss at
    its start, as in the JAX function.  A curvature pair enters the memory
    only with y.s > 0; a direction that is not a descent direction drops
    the memory; without memory the first trial step is min(1, 1 / |g|_1)
    along -g.

    ``torch.optim.LBFGS`` is not the body because its strong-Wolfe search
    takes a NaN trial value for an acceptable one: where a trial step leaves
    the region in which the loss is finite (a GP loss has such a region) it
    ends at NaN parameters or fails in its zoom phase
    (tests/test_torch_lbfgs.py holds the case).
    """
    raws = [p for p in params.parameters() if p.requires_grad]
    to_vector = torch.nn.utils.parameters_to_vector
    write = torch.nn.utils.vector_to_parameters

    def evaluate(x, carry):
        with torch.no_grad():
            write(x, raws)
        params.zero_grad(set_to_none=True)
        loss, new_carry = loss_fn(params, carry, *loss_args)
        if bool(torch.isfinite(loss.detach())):
            loss.backward()
        grads = [r.grad if r.grad is not None else torch.zeros_like(r)
                 for r in raws]
        return loss.detach(), to_vector(grads), new_carry

    if logger is not None:
        logger.timer.reset()
        logger.timer.start()
    pairs = []
    x_prev = g_prev = None
    loss_f = np.inf
    x = to_vector(raws).detach().clone()
    for i in range(num_steps):
        carry = state
        loss, g, state = evaluate(x, carry)
        loss_f = float(loss)
        if np.isfinite(loss_f):
            if x_prev is not None:
                sv, yv = x - x_prev, g - g_prev
                ys = float(torch.dot(sv, yv))
                if ys > 1e-10 * float(torch.dot(yv, yv)):
                    pairs = (pairs + [(sv, yv, 1.0 / ys)])[-memory_size:]
            d = _two_loop(g, pairs) if pairs else g.neg()
            slope = float(torch.dot(g, d))
            if pairs and not slope < 0.0:
                pairs, d = [], g.neg()
                slope = float(torch.dot(g, d))
            x_prev, g_prev = x, g

            def phi(t):
                f, gt, _ = evaluate(x + t * d, carry)
                return float(f), float(torch.dot(gt, d))

            if slope < 0.0:
                t0 = 1.0 if pairs else min(1.0, 1.0 / float(g.abs().sum()))
                x = x + _strong_wolfe(phi, loss_f, slope, t0) * d
            with torch.no_grad():
                write(x, raws)
        if logger is not None:
            if sync_fn is not None:
                sync_fn(params, state)
            if feval_stats_fn is not None:
                logger.log_for_feval(**feval_stats_fn(state))
            logger(i)
        if not np.isfinite(loss_f):
            break
    params.zero_grad(set_to_none=True)
    return OptimizeResult(params=params, state=state, num_iters=num_steps,
                          final_loss=loss_f)


def native_lbfgs_minimize(loss_fn: LossFn, params: torch.nn.Module, state,
                          num_steps: int, logger: Optional[Logger] = None,
                          history: int = 15,
                          feval_stats_fn: Callable[[Any], dict] = None,
                          sync_fn: Callable[[Any, Any], None] = None,
                          loss_args: tuple = ()) -> OptimizeResult:
    """The C++ L-BFGS (native/lbfgs.cpp, strong-Wolfe line search) in the
    host role of scipy's L-BFGS-B: the device computes the loss
    and gradient, the host the O(n * history) update.  Raises when the
    native library cannot be built or loaded.  The carry is updated on every
    evaluation; at most 12 evaluations per step on average."""
    from .native import NativeLBFGS

    unflatten = _fl.make_unflatten(params)
    x = _fl.flatten_trainable(params)
    opt = NativeLBFGS(len(x), history=history)
    holder = {"state": state}

    def evaluate(xv):
        unflatten(xv)
        params.zero_grad(set_to_none=True)
        loss, holder["state"] = loss_fn(params, holder["state"], *loss_args)
        if logger is not None and feval_stats_fn is not None:
            logger.log_for_feval(**feval_stats_fn(holder["state"]))
        loss.backward()
        return float(loss.detach()), _fl.flatten_grads_like(params)

    if logger is not None:
        logger.timer.reset()
        logger.timer.start()

    iters = fevals = 0
    max_fevals = max(num_steps * 12, num_steps + 10)
    try:
        while iters < num_steps and fevals < max_fevals:
            f, g = evaluate(x)
            fevals += 1
            status, x = opt.step(x, f, g)
            if status == NativeLBFGS.ACCEPTED:
                # the module holds the accepted point: the last one evaluated
                iters += 1
                if sync_fn is not None:
                    sync_fn(params, holder["state"])
                if logger is not None:
                    logger(iters)
            elif status in (NativeLBFGS.CONVERGED, NativeLBFGS.FAIL):
                break
        unflatten(opt.best_x if iters > 0 else x)
    finally:
        opt.close()
    params.zero_grad(set_to_none=True)
    with torch.no_grad():
        loss, holder["state"] = loss_fn(params, holder["state"], *loss_args)
    return OptimizeResult(params=params, state=holder["state"],
                          num_iters=iters, final_loss=float(loss))


def staged_gpr_optimize(loss_fn: LossFn, params: torch.nn.Module, X, Y,
                        num_steps: int, logger: Optional[Logger] = None,
                        subset_size: int = 10_000,
                        warmup_lbfgs_iters: int = 10,
                        warmup_adam_iters: int = 10, adam_lr: float = 0.1,
                        sync_fn: Callable[[Any, Any], None] = None
                        ) -> OptimizeResult:
    """The exact-GP baseline's training schedule: L-BFGS on the first
    ``subset_size`` rows at most, a few Adam steps on that subset, then
    ``num_steps`` Adam steps on all rows (logged).

    ``loss_fn(params, carry, X, Y)`` takes the data slice of the phase; each
    phase starts from a fresh carry (None)."""
    ns = min(X.shape[0], subset_size)
    sub_data = (X[:ns], Y[:ns])
    if logger is not None:
        logger.timer.reset()
        logger.timer.start()
    lbfgs_minimize(loss_fn, params, None, warmup_lbfgs_iters,
                   loss_args=sub_data)
    adam_minimize(loss_fn, params, None, warmup_adam_iters, adam_lr,
                  loss_args=sub_data)
    return adam_minimize(loss_fn, params, None, num_steps, adam_lr, logger,
                         sync_fn=sync_fn, loss_args=(X, Y))
