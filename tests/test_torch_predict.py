"""PyTorch port: full-covariance prediction, the predictive log densities
and their gradients, ``Model.predict_log_density``, the numpy
ConditionalVariance oracle, ``StopWatch.stop`` and ``native_available``,
against the JAX package on the CPU in fp64 (where every kernel wrapper
takes its plain version), inputs made with numpy from a seed."""

import torch_threads  # noqa: F401  (the test processes' torch thread cap)
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cglb_tpu.models import cglb as jc
from cglb_tpu.models import sgpr as js
from cglb_tpu.ops import kernels as jk
from cglb_tpu_torch.models import cglb as tc
from cglb_tpu_torch.models import sgpr as ts
from cglb_tpu_torch.ops import kernels as tk
from cglb_tpu_torch.ops import kuf as tkuf

FAMILIES = ["Matern32", "SquaredExponential"]
# M 40 inducing points for N 200: the Nystrom preconditioner then takes CG
# to 1e-10 in 17-19 steps, before the two packages' iterates drift apart
# (about 1e2-fold every two steps once Ritz values converge; at M 15 the
# same solves take 25 steps and end 1e-7 apart)
N, S, M_IND = 200, 25, 40


def _problem(family, outputs, seed=0):
    """Inputs, targets (``outputs`` columns), test points and the same
    parameters in both packages (mean c nonzero so that its gradient is
    not trivially the same)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, 3))
    W = rng.normal(size=(3, outputs))
    Y = np.sin(X @ W) + 0.1 * rng.normal(size=(N, outputs))
    Xs = rng.normal(size=(S, 3))
    Ys = np.sin(Xs @ W) + 0.1 * rng.normal(size=(S, outputs))
    Z = X[:M_IND].copy()
    c = 0.1 * rng.normal(size=outputs)
    jkern = jk.make_kernel(family, 3, variance=1.3, lengthscales=0.9,
                           dtype=np.float64)
    jp = js.SGPRParams.create(jkern, Z, noise_variance=0.3,
                              output_dim=outputs, dtype=np.float64)
    jp = dataclasses.replace(jp, mean=dataclasses.replace(
        jp.mean, c=dataclasses.replace(jp.mean.c, raw=jnp.asarray(c))))
    tkern = tk.make_kernel(family, 3, variance=1.3, lengthscales=0.9,
                           dtype=torch.float64)
    tp = ts.SGPRParams(tkern, Z, noise_variance=0.3, output_dim=outputs,
                       dtype=torch.float64)
    with torch.no_grad():
        tp.mean.c.assign(torch.tensor(c))
    return jp, tp, (X, Y, Xs, Ys)


def _close(got, want, tol, what=""):
    """|got - want| <= tol * max |want| (and tol absolute near zero)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0),
                               err_msg=what)


# both sides: fp64 preconditioners and the same CG knobs, so that the two
# solves run the same iterations
JCFG = jc.CGLBConfig(precond_dtype="float64", max_cg_iters=500)
TCFG = tc.CGLBConfig(precond_dtype="float64", max_cg_iters=500)


def _jax_predict(model, jp, X, Y, Xs, full_cov, cg_tolerance=1e-10):
    X, Y, Xs = (jnp.asarray(a) for a in (X, Y, Xs))
    if model == "sgpr":
        return js.predict_f(jp, X, Y, Xs, full_cov=full_cov)
    return jc.predict_f(jp, X, Y, jc.init_v0(N, Y.shape[1]), Xs, JCFG,
                        cg_tolerance=cg_tolerance, full_cov=full_cov)


def _torch_predict(model, tp, X, Y, Xs, full_cov, cg_tolerance=1e-10):
    X, Y, Xs = (torch.tensor(a) for a in (X, Y, Xs))
    if model == "sgpr":
        return ts.predict_f(tp, X, Y, Xs, full_cov=full_cov)
    return tc.predict_f(tp, X, Y, tc.init_v0(N, Y.shape[1], torch.float64),
                        Xs, TCFG, cg_tolerance=cg_tolerance,
                        full_cov=full_cov)


@pytest.mark.parametrize("model", ["sgpr", "cglb"])
@pytest.mark.parametrize("outputs", [1, 2])
@pytest.mark.parametrize("family", FAMILIES)
def test_full_cov_matches_jax(family, outputs, model):
    """predict_f(full_cov=True): mean [S, D] and covariance [D, S, S] to
    1e-12 of their scale (CGLB at CG tolerance 1e-10)."""
    jp, tp, (X, Y, Xs, _) = _problem(family, outputs)
    jm, jv = _jax_predict(model, jp, X, Y, Xs, True)
    with torch.no_grad():
        tm, tv = _torch_predict(model, tp, X, Y, Xs, True)
    assert tv.shape == (outputs, S, S)
    _close(tm, jm, 1e-12, "mean")
    _close(tv, jv, 1e-12, "covariance")


@pytest.mark.parametrize("model", ["sgpr", "cglb"])
@pytest.mark.parametrize("family", FAMILIES)
def test_full_cov_diagonal_is_the_marginal_variance(family, model):
    """The covariance's diagonal equals full_cov=False's variance, it is
    symmetric, one matrix over the outputs, and K(Xs, Xs)'s diagonal from
    kernel 3's plain version is exactly the kernel variance."""
    _, tp, (X, Y, Xs, _) = _problem(family, 2)
    with torch.no_grad():
        fm, fv = _torch_predict(model, tp, X, Y, Xs, True)
        mm, mv = _torch_predict(model, tp, X, Y, Xs, False)
        kss = tkuf.kuf(tp.kernel, torch.tensor(Xs), torch.tensor(Xs))
    assert torch.equal(fm, mm)
    assert mv.shape == (S, 2)
    for d in range(2):
        _close(torch.diagonal(fv[d]), mv[:, d].numpy(), 1e-12)
    assert torch.equal(fv[0], fv[1])
    _close(fv[0], fv[0].T.numpy(), 1e-14)
    assert torch.equal(torch.diagonal(kss),
                       tp.kernel.variance.value.expand(S))


def _grads(tp):
    return {name: p.raw.grad.numpy() for name, p in tp.named_params()}


def _grads_jax(g):
    return {".kernel.variance": g.kernel.variance.raw,
            ".kernel.lengthscales": g.kernel.lengthscales.raw,
            ".inducing_Z": g.inducing_Z.raw,
            ".noise_variance": g.noise_variance.raw, ".mean.c": g.mean.c.raw}


def _assert_grads(tp, jg, tol=1e-7):
    got = _grads(tp)
    for name, want in _grads_jax(jg).items():
        _close(got[name], np.asarray(want), tol, name)


@pytest.mark.parametrize("model", ["sgpr", "cglb"])
@pytest.mark.parametrize("outputs", [1, 2])
@pytest.mark.parametrize("family", FAMILIES)
def test_log_density_and_gradients_match_jax(family, outputs, model):
    """sgpr_predict_log_density and cglb_predict_log_density (CG at its
    default 1e-6 from zeros): the values to 1e-9, and the gradients of
    their sum with respect to variance, lengthscales, Z, noise and the
    mean to 1e-7 of each gradient's scale, against jax.grad (v is
    stop_gradient there and detached here)."""
    jp, tp, (X, Y, Xs, Ys) = _problem(family, outputs)
    if model == "sgpr":
        def jfn(p):
            return js.sgpr_predict_log_density(p, X, Y, Xs, Ys)

        got = ts.sgpr_predict_log_density(
            tp, *(torch.tensor(a) for a in (X, Y, Xs, Ys)))
    else:
        def jfn(p):
            return jc.cglb_predict_log_density(
                p, X, Y, jc.init_v0(N, outputs), Xs, Ys, JCFG)

        got = tc.cglb_predict_log_density(
            tp, *(torch.tensor(a) for a in (X, Y)),
            tc.init_v0(N, outputs, torch.float64),
            *(torch.tensor(a) for a in (Xs, Ys)), TCFG)
    want, vjp = jax.vjp(jfn, jp)
    assert got.shape == (S,)
    _close(got, want, 1e-9, "log density")
    torch.sum(got).backward()
    (jg,) = vjp(jnp.ones_like(want))
    _assert_grads(tp, jg)


@pytest.mark.parametrize("full_cov", [False, True])
@pytest.mark.parametrize("model", ["sgpr", "cglb"])
def test_predict_f_gradients_match_jax(model, full_cov):
    """predict_f carries the gradient JAX's does: of <w1, mean> + <w2,
    var> with fixed random weights, marginal and full covariance, to 1e-7
    of each gradient's scale (CGLB at CG tolerance 1e-10, v detached)."""
    jp, tp, (X, Y, Xs, _) = _problem("Matern32", 2)
    rng = np.random.default_rng(7)
    w1 = rng.normal(size=(S, 2))
    w2 = rng.normal(size=(2, S, S) if full_cov else (S, 2))

    def jfn(p):
        m, v = _jax_predict(model, p, X, Y, Xs, full_cov)
        return jnp.sum(w1 * m) + jnp.sum(w2 * v)

    jg = jax.grad(jfn)(jp)
    tm, tv = _torch_predict(model, tp, X, Y, Xs, full_cov)
    (torch.sum(torch.tensor(w1) * tm)
     + torch.sum(torch.tensor(w2) * tv)).backward()
    _assert_grads(tp, jg)


# Model.predict_log_density: the JAX Model's at the same parameters
# (assign_parameters), synth_300x2, M 12, fp64 common terms and
# preconditioners on both sides
_KINDS = ["cglb", "cglbn2m", "sgpr", "gpr", "exactgp"]


def _model_configs(kind, cfgs):
    """The model configuration of ``kind`` from a package's configs
    module."""
    kern = cfgs.Matern32Config()
    if kind in ("gpr", "exactgp"):
        return {"gpr": cfgs.GPRConfig, "exactgp": cfgs.ExactGPConfig}[kind](
            kern)
    ind = cfgs.InducingVariableConfig(12)
    return {"cglb": cfgs.CGLBConfig, "cglbn2m": cfgs.CGLBN2MConfig,
            "sgpr": cfgs.SGPRConfig}[kind](kern, ind)


@pytest.mark.parametrize("kind", _KINDS)
def test_model_predict_log_density_matches_jax(kind):
    """To 1e-9 of the scale; ``exactgp`` to 1e-6.  Its mean is an
    unpreconditioned CG solve stopped at 0.5 |r|^2 <= 1e-6
    (``IterGPConfig.cg_tolerance`` 1e-4 x 1e-2), which no caller of
    ``predict_log_density`` can tighten.  The two packages' iterates agree
    to 1e-14 for eight steps, then drift apart about 1e2-fold every two
    (last-bit matmul differences once Ritz values converge; ROADMAP.md
    section 3), and the solve stops after about 16: here each package's
    log density lies 5.4e-5 nats from the converged one and the two 2e-7
    of the scale apart (its Lanczos variance agrees to 1e-15).  The port's
    value is [S], on the model's device, with no gradient."""
    from cglb_tpu import configs as jcfgs
    from cglb_tpu.backend import Jax
    from cglb_tpu_torch import configs as tcfgs
    from cglb_tpu_torch.backend import Torch
    from cglb_tpu_torch.experiments.datasets import get_dataset
    from cglb_tpu_torch.utils.flatten import assign_parameters

    bundle = get_dataset("synth_300x2", dtype=np.float64)
    jm = Jax.create_model(_model_configs(kind, jcfgs), bundle.train, seed=0)
    jm.common_dtype = "float64"
    tm = Torch(device="cpu").create_model(_model_configs(kind, tcfgs),
                                          bundle.train, seed=0)
    assign_parameters(tm.params, jm.parameter_dict())
    if jm.run_cfg is not None:
        jm.run_cfg = dataclasses.replace(jm.run_cfg, common_dtype="float64",
                                         precond_dtype="float64")
        tm.run_cfg = dataclasses.replace(tm.run_cfg, precond_dtype="float64")
    want = np.asarray(jm.predict_log_density(bundle.test))
    got = tm.predict_log_density(bundle.test)
    assert got.shape == (bundle.test[0].shape[0],)
    assert got.device == tm.data[0].device and not got.requires_grad
    _close(got, want, 1e-6 if kind == "exactgp" else 1e-9)


@pytest.mark.parametrize("kind", ["cglb", "sgpr"])
def test_model_predict_log_density_batches(kind):
    """Batched in 17 rows it equals one batch, and for CGLB it is the
    batched prediction's at the given CG tolerance."""
    from cglb_tpu_torch import configs as tcfgs
    from cglb_tpu_torch.backend import Torch
    from cglb_tpu_torch.experiments.datasets import get_dataset
    from cglb_tpu_torch.models.gaussian import predict_log_density

    bundle = get_dataset("synth_300x2", dtype=np.float64)
    model = Torch(device="cpu").create_model(_model_configs(kind, tcfgs),
                                             bundle.train, seed=0)
    one = model.predict_log_density(bundle.test, cg_tolerance=1e-8)
    real = model.predict_f_batched
    model.predict_f_batched = lambda xs, cg_tolerance: real(
        xs, batch_size=17, cg_tolerance=cg_tolerance)
    batched = model.predict_log_density(bundle.test, cg_tolerance=1e-8)
    torch.testing.assert_close(batched, one, rtol=1e-12, atol=1e-12)
    with torch.no_grad():
        mean, var = real(torch.tensor(bundle.test[0]), cg_tolerance=1e-8)
    torch.testing.assert_close(
        one, predict_log_density(mean, var, model.params.noise_variance.value,
                                 torch.tensor(bundle.test[1])),
        rtol=0, atol=0)


def _numpy_matern32(ls=0.7, var=1.1):
    def diag(A):
        return np.full(A.shape[0], var)

    def cross(A, B):
        r = np.sqrt(np.maximum(np.sum((A[:, None] - B[None]) ** 2, -1),
                               0.0)) / ls
        return var * (1 + np.sqrt(3) * r) * np.exp(-np.sqrt(3) * r)

    return diag, cross


@pytest.mark.parametrize("seed", [0, 3])
def test_conditional_variance_numpy_matches_jax(seed):
    """The port's numpy oracle against JAX's, the same callables: the
    same indices and the same Z."""
    from cglb_tpu.utils.inducing import conditional_variance_numpy as jcv
    from cglb_tpu_torch.utils.inducing import conditional_variance_numpy

    X = np.random.default_rng(seed).normal(size=(300, 3))
    diag, cross = _numpy_matern32()
    Z, idx = conditional_variance_numpy(X, 25, diag, cross, seed=seed)
    jZ, jidx = jcv(X, 25, diag, cross, seed=seed)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(Z, jZ)
    assert len(set(idx.tolist())) == 25


@pytest.mark.parametrize("family", FAMILIES)
def test_device_conditional_variance_matches_numpy_oracle(family):
    """The port's device version (here the CPU) picks the oracle's indices
    when the oracle evaluates the same kernel."""
    from cglb_tpu_torch.utils.inducing import (conditional_variance,
                                               conditional_variance_numpy)

    X = np.random.default_rng(5).normal(size=(400, 2))
    kern = tk.make_kernel(family, 2, variance=1.4, lengthscales=0.6,
                          dtype=torch.float64)
    with torch.no_grad():
        Z, idx = conditional_variance(torch.tensor(X), 30, kern, seed=2)
        oZ, oidx = conditional_variance_numpy(
            X, 30, lambda A: kern.kdiag(torch.tensor(A)).numpy(),
            lambda A, B: kern.K(torch.tensor(A), torch.tensor(B)).numpy(),
            seed=2)
    np.testing.assert_array_equal(idx, oidx)
    np.testing.assert_array_equal(Z.numpy(), oZ)


def test_stopwatch_stop_returns_elapsed_and_resets():
    from cglb_tpu.utils.logging import StopWatch as JaxStopWatch
    from cglb_tpu_torch.utils.logging import StopWatch

    assert hasattr(JaxStopWatch, "stop")
    watch = StopWatch()
    watch.start()
    time.sleep(0.01)
    watch.pause()
    time.sleep(0.05)
    watch.resume()
    elapsed = watch.stop()
    assert 0.005 <= elapsed < 0.05
    assert not watch.started()


@pytest.mark.parametrize("outcome,want", [
    ("lib", True), (RuntimeError("g++ not found"), False),
    (OSError("cannot open"), False)])
def test_native_available_never_raises(monkeypatch, outcome, want):
    """load_native's library means True; its build or load errors mean
    False (load_native is stubbed: the library is not built here)."""
    from cglb_tpu_torch.utils import native as tnat

    def load():
        if isinstance(outcome, Exception):
            raise outcome
        return outcome

    monkeypatch.setattr(tnat, "load_native", load)
    assert tnat.native_available() is want
