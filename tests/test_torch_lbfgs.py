"""PyTorch port: L-BFGS on the device, the C++ L-BFGS and native
ConditionalVariance (utils/native.py), and the staged exact-GP schedule,
beside the JAX package's."""

import torch_threads  # noqa: F401  (the test processes' torch thread cap)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cglb_tpu.models import sgpr as js
from cglb_tpu.ops import kernels as jk
from cglb_tpu.utils import training as jtraining
from cglb_tpu_torch import config as tconfig
from cglb_tpu_torch import configs as tcfgs
from cglb_tpu_torch.backend import Torch
from cglb_tpu_torch.models import sgpr as ts
from cglb_tpu_torch.ops import kernels as tk
from cglb_tpu_torch.utils import inducing as tind
from cglb_tpu_torch.utils import native as tnative
from cglb_tpu_torch.utils import training as ttraining
from cglb_tpu_torch.utils.logging import Logger


def test_native_library_builds_and_loads():
    assert tnative.load_native().cglb_native_version() == 1
    assert tnative.LIB_PATH.parent.name == "_build"


def test_native_lbfgs_rosenbrock():
    def f_and_g(x):
        a, b = 1.0, 100.0
        f = (a - x[0]) ** 2 + b * (x[1] - x[0] ** 2) ** 2
        g = np.array([-2 * (a - x[0]) - 4 * b * x[0] * (x[1] - x[0] ** 2),
                      2 * b * (x[1] - x[0] ** 2)])
        return f, g

    opt = tnative.NativeLBFGS(2, history=10)
    x = np.array([-1.2, 1.0])
    for _ in range(500):
        status, x = opt.step(x, *f_and_g(x))
        if status in (opt.CONVERGED, opt.FAIL):
            break
    np.testing.assert_allclose(opt.best_x, [1.0, 1.0], atol=1e-5)
    assert opt.best_f < 1e-9
    with pytest.raises(ValueError, match="shape"):
        opt.step(np.zeros(3), 0.0, np.zeros(3))
    opt.close()
    opt.close()  # idempotent


def test_native_lbfgs_quadratic_converges_fast():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(20, 20))
    Q = A @ A.T + np.eye(20)
    b = rng.normal(size=20)
    opt = tnative.NativeLBFGS(20)
    x = np.zeros(20)
    for _ in range(300):
        status, x = opt.step(x, 0.5 * x @ Q @ x - b @ x, Q @ x - b)
        if status == opt.CONVERGED:
            break
    np.testing.assert_allclose(opt.best_x, np.linalg.solve(Q, b), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("family", ["Matern32", "rbf"])
def test_native_conditional_variance_picks_the_ports_indices(rng, family):
    X = rng.normal(size=(300, 4))
    kern = tk.make_kernel(family, 4, variance=1.4,
                          lengthscales=rng.uniform(0.5, 2.0, size=4),
                          dtype=torch.float64)
    Z, idx = tind.conditional_variance(torch.tensor(X), 25, kern, seed=5)
    Zn, idxn = tnative.conditional_variance_native(torch.tensor(X), 25, kern,
                                                   seed=5)
    np.testing.assert_array_equal(idxn, idx)
    np.testing.assert_array_equal(Zn, Z.numpy())
    assert len(set(idxn.tolist())) == 25
    with pytest.raises(ValueError, match="outside"):
        tnative.conditional_variance_native(X, 301, kern)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No source, no library: NativeLBFGS and -o lbfgs_native raise (the JAX
    module degrades to another optimizer instead)."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "NATIVE_DIR", tmp_path / "no_sources")
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "LIB_PATH", tmp_path / "build" / "lib.so")
    with pytest.raises(RuntimeError, match="cond_var.cpp"):
        tnative.NativeLBFGS(3)
    X = torch.tensor(np.random.default_rng(0).normal(size=(30, 2)))
    kern = tk.make_kernel("rbf", 2, dtype=torch.float64)
    params = ts.SGPRParams(kern, X[:4], dtype=torch.float64)
    with pytest.raises(RuntimeError, match="rc="):
        ttraining.native_lbfgs_minimize(
            lambda p, s: (-ts.elbo(p, X, X[:, :1]), s), params, None, 3)


def _sgpr_problem(rng, n=60, m=8):
    X = rng.normal(size=(n, 2))
    Y = np.sin(X[:, :1]) + 0.05 * rng.normal(size=(n, 1))
    # fixed inducing points: with trainable ones the loss has several
    # basins, and each line search falls into its own (80 iterations end at
    # -74.42 / -74.40 with the JAX functions, -73.46 with this L-BFGS and
    # -73.41 with scipy's L-BFGS-B)
    jp = js.SGPRParams.create(jk.make_kernel("Matern32", 2, dtype=np.float64),
                              X[:m], dtype=np.float64,
                              trainable_inducing=False)
    tp = ts.SGPRParams(tk.make_kernel("Matern32", 2, dtype=torch.float64),
                       X[:m], dtype=torch.float64, trainable_inducing=False)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    Xt, Yt = torch.tensor(X), torch.tensor(Y)
    return (jp, lambda p, s: (-js.elbo(p, Xj, Yj), s),
            tp, lambda p, s: (-ts.elbo(p, Xt, Yt), s))


def _loss_logger(tmp_path, params, loss_fn):
    """A Logger recording the loss at the live parameters every iteration."""
    def metrics():
        with torch.no_grad():
            return {"loss": float(loss_fn(params, None)[0])}

    return Logger(str(tmp_path), metrics, dict, holdout_interval=1)


@pytest.mark.parametrize("which", ["lbfgs", "lbfgs_native"])
def test_lbfgs_reaches_the_jax_final_loss(rng, tmp_path, which):
    """40 iterations on a small SGPR loss (N 60, M 8 fixed inducing points,
    5 parameters): the optimum of the JAX function of the same name to 1e-5
    relative (the iterates differ: another line search), with a loss that
    never rises between logged iterations."""
    jp, jloss, tp, tloss = _sgpr_problem(rng)
    jfn = {"lbfgs": jtraining.lbfgs_minimize,
           "lbfgs_native": jtraining.native_lbfgs_minimize}[which]
    tfn = {"lbfgs": ttraining.lbfgs_minimize,
           "lbfgs_native": ttraining.native_lbfgs_minimize}[which]
    want = jfn(jloss, jp, None, 40)
    start = float(tloss(tp, None)[0])
    logger = _loss_logger(tmp_path, tp, tloss)
    got = tfn(tloss, tp, None, 40, logger)
    losses = logger.logs["loss"]
    assert len(losses) == got.num_iters
    assert got.num_iters == 40 or which == "lbfgs_native"
    assert losses[0] < start
    assert all(b <= a + 1e-9 for a, b in zip(losses, losses[1:]))
    np.testing.assert_allclose(got.final_loss, want.final_loss, rtol=1e-5)
    np.testing.assert_allclose(losses[-1], want.final_loss, rtol=1e-5)
    assert all(p.raw.grad is None for _, p in tp.named_params())


def test_lbfgs_carry_contract():
    """One evaluation with the live carry per step, whose new carry is kept;
    the line search re-evaluates with the carry the step began with; a
    non-finite loss ends the run after its iteration is logged."""
    w = torch.nn.Parameter(torch.tensor([3.0, -2.0], dtype=torch.float64))
    module = torch.nn.Module()
    module.w = w
    seen = []

    def loss_fn(params, carry):
        seen.append(carry)
        return torch.sum((params.w - 1.0) ** 4) + 0.0 * carry, carry + 1

    res = ttraining.lbfgs_minimize(loss_fn, module, 0, 6)
    assert res.state == 6 and res.num_iters == 6
    # carries are non-decreasing, each step's first evaluation opens a new one
    assert seen == sorted(seen) and sorted(set(seen)) == list(range(6))
    assert len(seen) > 6  # the line search evaluated too
    assert float(torch.sum((w.detach() - 1.0) ** 4)) < 16.0 + 81.0

    calls = []

    def nan_loss(params, carry):
        calls.append(1)
        return torch.sum(params.w) * float("nan"), carry

    res = ttraining.lbfgs_minimize(nan_loss, module, 0, 5)
    assert not np.isfinite(res.final_loss) and len(calls) < 5 * 25


def test_lbfgs_backs_off_a_non_finite_trial_step():
    """Why the port has its own line search: a GP loss is not finite
    everywhere (a trial step can leave the region where the Cholesky factor
    exists), and ``torch.optim.LBFGS`` treats a NaN trial value as an
    acceptable one.  On sum((sqrt(w) - 1)^2 + w / 10) from w = (8, 8), NaN
    for w < 0, it ends at NaN parameters or fails inside its line search;
    ``lbfgs_minimize`` counts the NaN as too long a step and reaches the
    minimum 2 / 11 to 1e-9."""
    def f(w):
        return torch.sum((torch.sqrt(w) - 1.0) ** 2 + 0.1 * w)

    def module():
        m = torch.nn.Module()
        m.w = torch.nn.Parameter(torch.tensor([8.0, 8.0],
                                              dtype=torch.float64))
        return m

    theirs = module()
    opt = torch.optim.LBFGS([theirs.w], history_size=15, max_iter=1,
                            max_eval=26, line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        loss = f(theirs.w)
        loss.backward()
        return loss

    try:
        for _ in range(30):
            opt.step(closure)
        failed = not bool(torch.isfinite(f(theirs.w)))
    except IndexError:  # its zoom phase, on an empty bracket
        failed = True
    assert failed

    ours = module()
    res = ttraining.lbfgs_minimize(lambda p, s: (f(p.w), s), ours, None, 30)
    np.testing.assert_allclose(res.final_loss, 2.0 / 11.0, atol=1e-9)
    np.testing.assert_allclose(ours.w.detach().numpy(), 1.0 / 1.21,
                               atol=1e-6)


@pytest.fixture()
def synth(monkeypatch, tmp_path):
    from cglb_tpu_torch.experiments.datasets import get_dataset

    monkeypatch.setenv("CGLB_DATA_DIR", str(tmp_path / "no_data_here"))
    tconfig.set_default_float("fp64")
    tconfig.set_default_jitter("fp64")
    return get_dataset("synth_300x3", dtype=np.float64)


@pytest.mark.parametrize("kind", ["gpr", "exactgp"])
def test_staged_schedule_trains(synth, monkeypatch, kind):
    """tests/test_baseline_gpr.py's check on the port, and the phases: the
    warm-up runs on the subset with a fresh carry each, the logged phase on
    all rows."""
    backend = Torch(device="cpu")
    cfg = {"gpr": tcfgs.GPRConfig, "exactgp": tcfgs.ExactGPConfig}[kind](
        tcfgs.Matern32Config())
    model = backend.create_model(cfg, synth.train, seed=0)
    before = backend.metrics_fn(model, synth.to_tuple())()
    assert set(before) == {"lml", "loss", "train/rmse", "test/rmse",
                           "train/nlpd", "test/nlpd"}
    calls, evals = [], []
    inner = model.loss_fn()

    def loss_fn(params, carry, X, Y):
        evals.append((len(calls) - 1, X.shape[0], carry is None))
        return inner(params, carry, X, Y)

    def recorded(name):
        real = getattr(ttraining, name)

        def fn(loss, params, state, num_steps, *args, **kw):
            calls.append((name, num_steps, state))
            return real(loss, params, state, num_steps, *args, **kw)

        monkeypatch.setattr(ttraining, name, fn)

    recorded("lbfgs_minimize")
    recorded("adam_minimize")
    res = ttraining.staged_gpr_optimize(loss_fn, model.params, *model.data,
                                        25, subset_size=120)
    model.carry_out(res.state)
    assert calls == [("lbfgs_minimize", 10, None), ("adam_minimize", 10, None),
                     ("adam_minimize", 25, None)]
    n = model.data[0].shape[0]
    assert {(c, r) for c, r, _ in evals} == {(0, 120), (1, 120), (2, n)}
    # each phase's first evaluation starts from a fresh carry
    assert all(next(e for e in evals if e[0] == c)[2] for c in range(3))
    assert [sum(e[0] == c for e in evals) for c in (1, 2)] == [10, 25]
    after = backend.metrics_fn(model, synth.to_tuple())()
    assert after["loss"] < before["loss"]
    assert after["test/rmse"] < 1.0


@pytest.mark.parametrize("optimizer,lr", [("staged", 0.1), ("adam_0.01", 0.01),
                                          ("adam_0.001", 0.001)])
def test_adam_on_an_exact_gp_routes_through_the_staged_schedule(
        synth, monkeypatch, optimizer, lr):
    """As the JAX package's backend (cglb_tpu/backend.py:755-776): -o staged
    and every -o adam_<lr> on gpr / exactgp run the staged schedule, with
    that learning rate; on other kinds adam stays plain Adam and staged is
    refused."""
    seen = {}
    real = ttraining.staged_gpr_optimize

    def spy(*args, **kw):
        seen.update(kw, n_args=len(args))
        return real(*args, **kw)

    monkeypatch.setattr(ttraining, "staged_gpr_optimize", spy)
    backend = Torch(device="cpu")
    model = backend.create_model(tcfgs.ExactGPConfig(tcfgs.Matern32Config()),
                                 synth.train, seed=0)
    backend.optimize(model, None, 2, None, optimizer)
    assert seen.pop("adam_lr", 0.1) == lr
    assert model.generator_state is not None
    seen.clear()
    sparse = backend.create_model(
        tcfgs.SGPRConfig(tcfgs.Matern32Config(),
                         tcfgs.InducingVariableConfig(6)), synth.train, seed=0)
    if optimizer == "staged":
        with pytest.raises(NotImplementedError):
            backend.optimize(sparse, None, 2, None, optimizer)
    else:
        backend.optimize(sparse, None, 2, None, optimizer)
    assert not seen


def test_exactgp_carry_is_seeded_and_threads(synth):
    """The probes' generator is seeded from settings.seed at first use and
    its state rides in the carry: the same seed gives the same loss, another
    seed another, and each evaluation advances the state."""
    backend = Torch(device="cpu")
    cfg = tcfgs.ExactGPConfig(tcfgs.Matern32Config())
    losses = []
    for seed in (0, 0, 1):
        backend.set_seed(seed)
        model = backend.create_model(cfg, synth.train)
        first = model.loss_value()
        state = model.generator_state.clone()
        second = model.loss_value()
        assert not torch.equal(state, model.generator_state)
        assert first != second
        losses.append(first)
    backend.set_seed(0)
    assert losses[0] == losses[1] != losses[2]
