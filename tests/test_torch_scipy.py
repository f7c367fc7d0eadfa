"""PyTorch port: the scipy L-BFGS-B bridge (attempts, the inducing-point
freeze, the penalty bowl, the published iterate) and the adaptive
CG-tolerance schedule against the JAX package's (fp64 on the CPU).

Trajectories are compared only where the objective has no CG: L-BFGS-B
amplifies 1e-12 differences, and a CG stop test turns them into other
iterates."""

import torch_threads  # noqa: F401  (the test processes' torch thread cap)
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import torch

from cglb_tpu.models import sgpr as js
from cglb_tpu.ops import kernels as jk
from cglb_tpu.utils import flatten as jfl
from cglb_tpu.utils import training as jtr
from cglb_tpu_torch import config as tconfig
from cglb_tpu_torch.backend import Model, Torch
from cglb_tpu_torch.models import cglb as tc
from cglb_tpu_torch.models import sgpr as ts
from cglb_tpu_torch.ops import kernels as tk
from cglb_tpu_torch.utils import flatten as tfl
from cglb_tpu_torch.utils import training as ttr
from cglb_tpu_torch.utils.logging import Logger


def _problem(rng, n=150, d=2, m=10):
    X = rng.normal(size=(n, d))
    Y = np.sin(2.0 * X[:, :1]) + 0.1 * rng.normal(size=(n, 1))
    Z = X[:m].copy()
    jp = js.SGPRParams.create(
        jk.make_kernel("Matern32", d, dtype=np.float64), Z,
        noise_variance=1.0, dtype=np.float64)
    tp = ts.SGPRParams(tk.make_kernel("Matern32", d, dtype=torch.float64),
                       Z, noise_variance=1.0, dtype=torch.float64)
    return jp, tp, X, Y


# --------------------------------------------------------------------------
# the same trajectory where the objective has no CG
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bound", ["elbo", "elbo_n2m"])
def test_scipy_minimize_same_trajectory_as_jax(rng, bound):
    """sgpr and sgprn2m, 25 iterations from the same start: the same nit and
    nfev of every attempt, and the final loss to rtol 1e-8."""
    jp, tp, X, Y = _problem(rng)
    jbound, tbound = getattr(js, bound), getattr(ts, bound)
    jres = jtr.scipy_minimize(
        lambda p, s, X, Y: (-jbound(p, X, Y), s), jp, None, 25,
        data=(jnp.asarray(X), jnp.asarray(Y)))
    Xt, Yt = torch.tensor(X), torch.tensor(Y)
    tres = ttr.scipy_minimize(lambda p, s: (-tbound(p, Xt, Yt), s), tp, None,
                              25)
    assert tres.num_iters == jres.num_iters == 25
    for key in ("opt/num_iters", "opt/num_fevals", "opt/penalty_fevals"):
        assert tres.info[key] == jres.info[key], key
    assert [(a["nit"], a["nfev"]) for a in tres.info["opt/attempts"]] == [
        (a["nit"], a["nfev"]) for a in jres.info["opt/attempts"]]
    np.testing.assert_allclose(tres.final_loss, jres.final_loss, rtol=1e-8)
    # the module holds res.x: its loss is the reported one
    with torch.no_grad():
        np.testing.assert_allclose(float(-tbound(tp, Xt, Yt)),
                                   tres.final_loss, rtol=1e-12)
    np.testing.assert_allclose(tfl.flatten_trainable(tp),
                               jfl.flatten_trainable(jres.params),
                               rtol=0, atol=1e-5)
    assert all(p.raw.grad is None for _, p in tp.named_params())


def test_scipy_minimize_cglb_reaches_jax_loss_and_bracket(rng):
    """cglb at max_error 1e-3, 60 iterations: the final loss within 2e-3
    relative of the JAX package's (the objective jitters by up to max_error
    through the warm start, so the trajectories are not compared), and
    elbo <= cglb bound <= upper bound at the result."""
    from cglb_tpu.models import cglb as jc

    jp, tp, X, Y = _problem(rng)
    n = X.shape[0]
    settings = dict(max_error=1e-3, precond_dtype="float64")
    jcfg = jc.CGLBConfig(common_dtype="float64", **settings)

    def jloss(p, carry, X, Y):
        v0 = carry.v if isinstance(carry, jc.CGLBAux) else carry
        return jc.loss(p, X, Y, v0, jcfg)

    jres = jtr.scipy_minimize(jloss, jp, jc.init_v0(n), 60,
                              data=(jnp.asarray(X), jnp.asarray(Y)))
    Xt, Yt = torch.tensor(X), torch.tensor(Y)
    tcfg = tc.CGLBConfig(**settings)

    def tloss(p, carry):
        v0 = carry.v if isinstance(carry, tc.CGLBAux) else carry
        return tc.loss(p, Xt, Yt, v0, tcfg)

    logger = Logger("", lambda: {}, lambda: {}, -1, include_feval_log=True)
    tres = ttr.scipy_minimize(
        tloss, tp, tc.init_v0(n), 60, logger,
        feval_stats_fn=lambda s: {"cg/steps": s.cg_steps,
                                  "cg/error": s.cg_residual_error})
    np.testing.assert_allclose(tres.final_loss, jres.final_loss, rtol=2e-3)
    assert isinstance(tres.state, tc.CGLBAux)
    # the carry was updated on every evaluation, probes included
    series = logger.logs["cg/steps-per-feval"]
    assert len(series) == tres.info["opt/num_fevals"] and max(series) > 0
    assert max(logger.logs["cg/error-per-feval"]) <= 1e-3
    with torch.no_grad():
        lower = float(ts.elbo(tp, Xt, Yt))
        upper = float(ts.upper_bound(tp, Xt, Yt))
    assert lower <= -tres.final_loss <= upper


# --------------------------------------------------------------------------
# attempts and the freeze
# --------------------------------------------------------------------------


def _early_stopping_minimize(nits, seen):
    """A stand-in for scipy.optimize.minimize that evaluates the start,
    accepts one small step, and reports ``nits[k]`` iterations on its k-th
    call."""

    def minimize(fun, x0, jac, method, options, callback):
        seen.append({"maxiter": options["maxiter"], "size": x0.size})
        f0, g0 = fun(x0)
        x1 = x0 - 1e-4 * g0
        f1, _ = fun(x1)
        callback(x1)
        return scipy.optimize.OptimizeResult(
            x=x1, fun=f1, nit=nits[len(seen) - 1], nfev=2, status=0,
            message="CONVERGENCE: TEST")

    return minimize


def test_scipy4_attempts_get_the_remaining_budget_and_freeze(rng,
                                                             monkeypatch):
    """4 attempts that each stop after 2, 3, 1, 4 of 20 iterations: every
    attempt gets maxiter = remaining, attempts 3 and 4 optimize a vector
    without the inducing points, and those are bit-identical from the start
    of attempt 3 to the end."""
    _, tp, X, Y = _problem(rng)
    Xt, Yt = torch.tensor(X), torch.tensor(Y)
    seen, z_at = [], {}
    monkeypatch.setattr(ttr.scipy.optimize, "minimize",
                        _early_stopping_minimize([2, 3, 1, 4], seen))

    def loss(p, s):
        z_at.setdefault(len(seen), p.inducing_Z.raw.detach().clone())
        return -ts.elbo(p, Xt, Yt), s

    full = tfl.flatten_trainable(tp).size
    res = ttr.scipy_minimize(loss, tp, None, 20, attempts=4,
                             freeze_inducing_after=2)
    assert [s["maxiter"] for s in seen] == [20, 18, 15, 14]
    assert [s["size"] for s in seen] == [full, full, full - 20, full - 20]
    assert res.num_iters == res.info["opt/num_iters"] == 10
    assert [a["nit"] for a in res.info["opt/attempts"]] == [2, 3, 1, 4]
    assert not tp.inducing_Z.trainable and tp.inducing_Z.raw.grad is None
    assert not torch.equal(z_at[1], z_at[2])  # attempts 1-2 moved them
    assert torch.equal(z_at[3], tp.inducing_Z.raw)
    assert torch.equal(z_at[4], tp.inducing_Z.raw)


def test_scipy_attempts_stop_when_the_budget_is_spent(rng, monkeypatch):
    _, tp, X, Y = _problem(rng)
    Xt, Yt = torch.tensor(X), torch.tensor(Y)
    seen = []
    monkeypatch.setattr(ttr.scipy.optimize, "minimize",
                        _early_stopping_minimize([5, 5, 5], seen))
    res = ttr.scipy_minimize(lambda p, s: (-ts.elbo(p, Xt, Yt), s), tp, None,
                             5, attempts=4, freeze_inducing_after=2)
    assert len(seen) == 1 and res.num_iters == 5
    assert tp.inducing_Z.trainable  # attempt 3 never began


def test_scipy4_real_early_stops_keep_frozen_inducing_points(rng):
    """A real run whose attempts end early (ftol 1e-2): the same attempt
    log as the JAX package's, and Z unchanged by attempts 3-4."""
    jp, tp, X, Y = _problem(rng)
    Xt, Yt = torch.tensor(X), torch.tensor(Y)
    jres = jtr.scipy_minimize(
        lambda p, s, X, Y: (-js.elbo(p, X, Y), s), jp, None, 200,
        attempts=4, freeze_inducing_after=2, ftol=1e-2,
        data=(jnp.asarray(X), jnp.asarray(Y)))
    z_seen = []

    def loss(p, s):
        if not p.inducing_Z.trainable:
            z_seen.append(p.inducing_Z.raw.detach().clone())
        return -ts.elbo(p, Xt, Yt), s

    tres = ttr.scipy_minimize(loss, tp, None, 200, attempts=4,
                              freeze_inducing_after=2, ftol=1e-2)
    attempts = tres.info["opt/attempts"]
    assert len(attempts) == 4 and tres.num_iters < 200
    assert [(a["nit"], a["nfev"]) for a in attempts] == [
        (a["nit"], a["nfev"]) for a in jres.info["opt/attempts"]]
    assert sum(a["nit"] for a in attempts) == tres.info["opt/num_iters"]
    assert z_seen and all(torch.equal(z, tp.inducing_Z.raw) for z in z_seen)
    np.testing.assert_allclose(tres.final_loss, jres.final_loss, rtol=1e-8)


# --------------------------------------------------------------------------
# the penalty bowl
# --------------------------------------------------------------------------


def _probe_minimize(step, seen):
    """Evaluates the start and the start + step, and returns the start."""

    def minimize(fun, x0, jac, method, options, callback):
        x0 = np.asarray(x0, dtype=np.float64)
        seen.append(fun(x0))
        seen.append(fun(x0 + step))
        return scipy.optimize.OptimizeResult(
            x=x0, fun=seen[-2][0], nit=1, nfev=2, status=0, message="TEST")

    return minimize


def test_penalty_bowl_equals_jax_formula(rng, monkeypatch):
    """A loss that is NaN beyond a threshold, probed at the start (finite)
    and past the threshold: both packages hand scipy the same (f, g) for
    both probes, the second being the bowl 1e12 (1 + |dx|^2), 2e12 dx
    around the start."""
    jp, tp, _, _ = _problem(rng, n=20, m=3)
    step = np.zeros(jfl.flatten_trainable(jp).size)
    step[0] = 5.0  # the kernel variance's raw value leads the vector
    step[2] = -0.25

    def jloss(p, s):
        bad = jnp.where(p.kernel.variance.raw > 3.0, jnp.nan, 0.0)
        return jnp.sum(p.kernel.lengthscales.raw ** 2) + bad, s

    def tloss(p, s):
        bad = torch.where(p.kernel.variance.raw > 3.0, float("nan"), 0.0)
        return torch.sum(p.kernel.lengthscales.raw ** 2) + bad, s

    jseen, tseen = [], []
    monkeypatch.setattr(scipy.optimize, "minimize",
                        _probe_minimize(step, jseen))
    jres = jtr.scipy_minimize(jloss, jp, None, 3, attempts=1)
    monkeypatch.setattr(scipy.optimize, "minimize",
                        _probe_minimize(step, tseen))
    tres = ttr.scipy_minimize(tloss, tp, None, 3, attempts=1)
    assert tres.info["opt/penalty_fevals"] == 1
    assert jres.info["opt/penalty_fevals"] == 1
    for (tf, tg), (jf, jg) in zip(tseen, jseen):
        assert np.isfinite(tf) and np.all(np.isfinite(tg))
        assert tg.dtype == np.float64
        np.testing.assert_allclose(tf, jf, rtol=1e-14)
        np.testing.assert_allclose(tg, jg, rtol=1e-14, atol=0)
    f, g = tseen[1]
    assert f == 1e12 * (1.0 + 25.0 + 0.0625)
    np.testing.assert_array_equal(g, 2e12 * step)
    # the refresh at res.x re-evaluated the finite start
    assert tres.final_loss == tseen[0][0]
    f0, g0 = ttr.penalty_bowl(step, None)  # no good iterate yet
    assert f0 == 1e12 and not g0.any()


def test_nan_probe_is_answered_by_the_bowl_and_the_run_finishes(rng):
    """The 4th evaluation of a real run returns NaN: one penalty
    evaluation, a finite final loss below the start's, and the budget
    used."""
    _, tp, X, Y = _problem(rng)
    Xt, Yt = torch.tensor(X), torch.tensor(Y)
    calls = {"n": 0}
    with torch.no_grad():
        start = float(-ts.elbo(tp, Xt, Yt))

    def loss(p, s):
        calls["n"] += 1
        value = -ts.elbo(p, Xt, Yt)
        return (value * float("nan") if calls["n"] == 4 else value), s

    res = ttr.scipy_minimize(loss, tp, None, 15)
    assert res.info["opt/penalty_fevals"] == 1
    assert res.num_iters == 15
    assert np.isfinite(res.final_loss) and res.final_loss < start


@pytest.mark.parametrize("streaming", [False, True])
def test_nan_parameters_give_a_nan_loss_not_an_exception(streaming):
    """A probe with NaN lengthscales makes the loss NaN without raising
    (the factorizations fail in NaN, CG stops at once), on the dense and on
    the streaming operator, so that the bowl can answer L-BFGS-B."""
    from cglb_tpu_torch.ops import matvec as tmv

    X = np.linspace(-1.0, 1.0, 40)[:, None]
    tp = ts.SGPRParams(tk.make_kernel("Matern32", 1, dtype=torch.float64),
                       X[:12], dtype=torch.float64)
    with torch.no_grad():
        tp.kernel.lengthscales.raw.fill_(float("nan"))
    Xt, Yt = torch.tensor(X), torch.tensor(np.sin(X))
    ops = {}
    if streaming:
        acc, cg = tmv.make_streaming_operator_pair(
            tp.kernel, Xt, tp.noise_variance.value)
        ops = dict(matvec=acc, matvec_cg=cg)
    loss, aux = tc.loss(tp, Xt, Yt, tc.init_v0(40), tc.CGLBConfig(), **ops)
    assert np.isnan(float(loss.detach())) and aux.cg_steps == 0


# --------------------------------------------------------------------------
# the published iterate
# --------------------------------------------------------------------------


def test_callback_publishes_the_accepted_iterate(rng, monkeypatch):
    """At every callback the module holds xk (not the last probe) before
    sync_fn and the logger run, and the metrics logged mid-run move away
    from those at the initial parameters."""
    tconfig.set_default_float("fp64")
    tconfig.set_default_jitter("fp64")
    _, tp, X, Y = _problem(rng)
    model = Model("cglb", tp, (torch.tensor(X), torch.tensor(Y)),
                  tc.CGLBConfig(max_error=1.0))
    backend = Torch(device="cpu")
    metrics_fn = backend.metrics_fn(model, ((X, Y), (X[:40], Y[:40])))
    initial = metrics_fn()
    logger = Logger("", metrics_fn, lambda: backend.model_parameters(model),
                    holdout_interval=1, include_feval_log=True)

    accepted, held = [], []
    real_minimize = scipy.optimize.minimize

    def recording_minimize(fun, x0, callback=None, **kw):
        def cb(xk):
            accepted.append(np.array(xk, copy=True))
            callback(xk)
        return real_minimize(fun, x0, callback=cb, **kw)

    monkeypatch.setattr(ttr.scipy.optimize, "minimize", recording_minimize)
    real_sync = {}

    def spy_sync(params, state):
        held.append(tfl.flatten_trainable(params))
        real_sync["fn"](params, state)

    real_scipy = ttr.scipy_minimize

    def spying(*args, sync_fn=None, **kw):
        real_sync["fn"] = sync_fn
        return real_scipy(*args, sync_fn=spy_sync, **kw)

    monkeypatch.setattr(ttr, "scipy_minimize", spying)
    res = backend.optimize(model, None, 8, logger, "scipy")
    assert len(accepted) == len(held) == res.num_iters == 8
    for xk, got in zip(accepted, held):
        np.testing.assert_array_equal(got, xk)
    # more evaluations than iterations: some probes were not accepted
    assert res.info["opt/num_fevals"] > res.num_iters
    logs = logger.logs
    assert len(logs["loss"]) == 8
    assert all(abs(v - initial["loss"]) > 1e-3 for v in logs["loss"])
    assert logs["loss"][-1] < logs["loss"][0] < initial["loss"]
    assert len({round(v, 9) for v in logs["test/rmse"]}) > 1
    assert len(logs["cg/steps-per-feval"]) == res.info["opt/num_fevals"]
    np.testing.assert_array_equal(tfl.flatten_trainable(tp), accepted[-1])


# --------------------------------------------------------------------------
# scipy_tol
# --------------------------------------------------------------------------


def _toy_losses(calls):
    """A quadratic in the raw lengthscales and noise in both packages; the
    tolerance argument only records which program ran."""

    def jloss(p, s, _d):
        calls.append(("jax", None))
        return (jnp.sum((p.kernel.lengthscales.raw - 1.5) ** 2)
                + (p.noise_variance.raw + 0.5) ** 2), s

    def jloss_tol(p, s, _d, me):
        return jloss(p, s, _d)[0] + 0.0 * me, s

    def tloss(p, s, me=None):
        calls.append(("torch", me))
        return (torch.sum((p.kernel.lengthscales.raw - 1.5) ** 2)
                + (p.noise_variance.raw + 0.5) ** 2), s

    return jloss, jloss_tol, tloss


@pytest.mark.parametrize("tol_resume", [None, 0.1, 0.01])
def test_scipy_tol_levels_equal_jax(rng, tol_resume):
    """The level sequence 1.0, 0.1, 0.01 (or its tail after a resume), one
    attempt per level and two at the floor, on_level called with each, and
    level 0 alone running loss_fn: all as the JAX package on the same toy
    loss."""
    jp, tp, _, _ = _problem(rng, n=20, m=3)
    calls = []
    jloss, jloss_tol, tloss = _toy_losses(calls)
    jlevels, tlevels = [], []
    jres = jtr.scipy_tol_minimize(
        jloss, jloss_tol, jp, None, 400, data=(jnp.zeros(1),),
        on_level=jlevels.append, tol_resume=tol_resume)
    calls.clear()
    tres = ttr.scipy_tol_minimize(
        lambda p, s: tloss(p, s), tloss, tp, None, 400,
        on_level=tlevels.append, tol_resume=tol_resume)
    want = {None: [1.0, 0.1, 0.01], 0.1: [0.1, 0.01], 0.01: [0.01]}[
        tol_resume]
    np.testing.assert_allclose(tlevels, want, rtol=1e-12)
    np.testing.assert_allclose(jlevels, want, rtol=1e-12)
    got = tres.info["opt/levels"]
    np.testing.assert_allclose([lv["max_error"] for lv in got],
                               [lv["max_error"] for lv in
                                jres.info["opt/levels"]], rtol=1e-12)
    assert [len(lv["attempts"]) for lv in got] == [
        len(lv["attempts"]) for lv in jres.info["opt/levels"]]
    assert len(got[-1]["attempts"]) == 2  # the floor level
    assert all(len(lv["attempts"]) == 1 for lv in got[:-1])
    assert tres.num_iters == sum(lv["nit"] for lv in got)
    assert tres.info["opt/num_fevals"] == sum(
        a["nfev"] for lv in got for a in lv["attempts"])
    assert tres.info["opt/num_iters"] == jres.info["opt/num_iters"]
    np.testing.assert_allclose(tres.final_loss, 0.0, atol=1e-10)
    # which program ran at which level: loss_fn only at tol_start
    tolerances = [me for _, me in calls]
    if tol_resume is None:
        first = got[0]["attempts"][0]["nfev"]
        assert all(me is None for me in tolerances[:first])
        assert tolerances[first] == pytest.approx(0.1)
    else:
        assert tolerances[0] == pytest.approx(tol_resume)
    assert tolerances[-1] == pytest.approx(0.01)


def test_scipy_tol_stops_when_the_budget_is_spent(rng):
    _, tp, _, _ = _problem(rng, n=20, m=3)
    _, _, tloss = _toy_losses([])
    res = ttr.scipy_tol_minimize(lambda p, s: tloss(p, s), tloss, tp, None, 2)
    assert res.num_iters == 2 and len(res.info["opt/levels"]) == 1


def test_backend_scipy_tol_without_cg_runs_the_plain_bridge(rng):
    """sgpr, and cglb with --vzero, have no CG in the loss: scipy_tol is the
    plain bridge (opt/attempts, no opt/levels)."""
    tconfig.set_default_float("fp64")
    tconfig.set_default_jitter("fp64")
    _, tp, X, Y = _problem(rng)
    data = (torch.tensor(X), torch.tensor(Y))
    backend = Torch(device="cpu")
    for model in (Model("sgpr", tp, data),
                  Model("cglb", tp, data, tc.CGLBConfig(vzero=True))):
        res = backend.optimize(model, None, 3, None, "scipy_tol")
        assert "opt/attempts" in res.info and "opt/levels" not in res.info
    model = Model("cglb", tp, data, tc.CGLBConfig(max_error=1.0))
    res = backend.optimize(model, None, 3, None, "scipy_tol")
    assert [lv["max_error"] for lv in res.info["opt/levels"]] == [1.0]
    with pytest.raises(ValueError, match="requires a CGLB model"):
        Model("sgpr", tp, data).loss_fn_tol()


def test_backend_rejects_unported_optimizers(rng):
    """``staged`` is the exact-GP schedule and is refused on a sparse model,
    as an optimizer name that the port does not know is."""
    _, tp, X, Y = _problem(rng, n=20, m=3)
    model = Model("sgpr", tp, (torch.tensor(X), torch.tensor(Y)))
    backend = Torch(device="cpu")
    for name in ("staged", "sgd_0.1"):
        with pytest.raises(NotImplementedError, match=name):
            backend.optimize(model, None, 1, None, name)


@pytest.mark.parametrize("name", ["lbfgs", "lbfgs_native"])
def test_backend_runs_lbfgs_routes_on_sparse_model(rng, name):
    _, tp, X, Y = _problem(rng, n=20, m=3)
    model = Model("sgpr", tp, (torch.tensor(X), torch.tensor(Y)))
    start = model.loss_value()
    res = Torch(device="cpu").optimize(model, None, 2, None, name)
    assert np.isfinite(res.final_loss) and model.loss_value() < start
