"""PyTorch port: the n2m / nm2 log-det variants, vzero, the jointly trained
v and SGPRN2M against the JAX package and the golden constants (fp64 on the
CPU)."""

import torch_threads  # noqa: F401  (the test processes' torch thread cap)
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
from test_golden import GOLDEN

FAMILIES = ["Matern32", "SquaredExponential"]


def _problem(rng, family, n=220, d=3, m=15):
    X = rng.normal(size=(n, d))
    Y = np.sin(X[:, :1]) + 0.1 * rng.normal(size=(n, 1))
    Z = X[:m].copy()
    ls = rng.uniform(0.6, 1.6, size=d)
    jp = js.SGPRParams.create(
        jk.make_kernel(family, d, variance=1.3, lengthscales=ls,
                       dtype=np.float64), Z, noise_variance=0.3,
        dtype=np.float64)
    tp = ts.SGPRParams(
        tk.make_kernel(family, d, variance=1.3, lengthscales=ls,
                       dtype=torch.float64), Z, noise_variance=0.3,
        dtype=torch.float64)
    return jp, tp, X, Y


def _jax_grads(g):
    return {".kernel.variance": g.kernel.variance.raw,
            ".kernel.lengthscales": g.kernel.lengthscales.raw,
            ".inducing_Z": g.inducing_Z.raw,
            ".noise_variance": g.noise_variance.raw, ".mean.c": g.mean.c.raw}


def _assert_grads(tp, jg, scale=1e-7):
    for name, want in _jax_grads(jg).items():
        want = np.asarray(want)
        got = dict(tp.named_params())[name].raw.grad.numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=scale * np.max(np.abs(want)),
                                   err_msg=name)


@pytest.mark.parametrize("variant,key", [("n2m", "cglb_n2m"),
                                         ("nm2", "cglb_nm2")])
def test_golden_logdet_variants(monkeypatch, tmp_path, variant, key):
    """tests/test_golden.py's frozen n2m / nm2 bounds at converged v, at
    that file's rtol (1e-8)."""
    monkeypatch.setenv("CGLB_DATA_DIR", str(tmp_path / "no_data_here"))
    from cglb_tpu_torch.experiments.datasets import get_dataset

    b = get_dataset("snelson1d", dtype=np.float64)
    X, Y = torch.tensor(b.train[0]), torch.tensor(b.train[1])
    kern = tk.make_kernel("Matern32", 1, variance=1.2, lengthscales=0.8,
                          dtype=torch.float64)
    params = ts.SGPRParams(kern, X[:30], noise_variance=0.1,
                           dtype=torch.float64)
    cfg = tc.CGLBConfig(max_error=1e-14, max_cg_iters=500,
                        logdet_variant=variant)
    with torch.no_grad():
        bound, _ = tc.bound(params, X, Y, tc.init_v0(X.shape[0]), cfg,
                            jitter=1e-6)
    np.testing.assert_allclose(float(bound), GOLDEN[key], rtol=1e-8)


def test_unknown_logdet_variant_raises(rng):
    _, tp, X, Y = _problem(rng, "Matern32", n=40, m=5)
    with pytest.raises(ValueError, match="unknown logdet variant"):
        tc.bound(tp, torch.tensor(X), torch.tensor(Y), tc.init_v0(40),
                 tc.CGLBConfig(logdet_variant="other"))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("variant", ["n2m", "nm2"])
def test_logdet_variant_loss_and_grad_match_jax(rng, family, variant):
    """value (rtol 1e-9) and gradient (1e-7 of the largest entry) of the
    loss at the same parameters and the same v, no CG step on either side,
    fp64 preconditioner on both."""
    jp, tp, X, Y = _problem(rng, family)
    v = 0.05 * rng.normal(size=(1, X.shape[0]))
    settings = dict(max_error=1e30, precond_dtype="float64",
                    logdet_variant=variant)
    jcfg = jc.CGLBConfig(common_dtype="float64", **settings)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jc.loss(p, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(v),
                          jcfg), has_aux=True))(jp)
    tl, aux = tc.loss(tp, torch.tensor(X), torch.tensor(Y), torch.tensor(v),
                      tc.CGLBConfig(**settings))
    tl.backward()
    assert aux.cg_steps == 0
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-9)
    _assert_grads(tp, jg)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mode", ["vzero", "vjoint"])
def test_external_v_loss_and_grad_match_jax(rng, family, mode):
    """--vzero and --vjoint: no CG on either side (even at max_error 0),
    same value (rtol 1e-9) and gradient (1e-7 of scale); with vjoint the
    gradient with respect to v0 is compared too and the aux carries v0
    without a graph."""
    jp, tp, X, Y = _problem(rng, family)
    n = X.shape[0]
    joint = mode == "vjoint"
    v = 0.05 * rng.normal(size=(1, n)) if joint else np.zeros((1, n))
    settings = dict(max_error=0.0, precond_dtype="float64",
                    joint_optimization=joint, vzero=not joint)
    jcfg = jc.CGLBConfig(common_dtype="float64", **settings)
    assert jcfg.v_is_external and tc.CGLBConfig(**settings).v_is_external

    (jl, jaux), (jg, jgv) = jax.jit(jax.value_and_grad(
        lambda p, v0: jc.loss(p, jnp.asarray(X), jnp.asarray(Y), v0, jcfg),
        argnums=(0, 1), has_aux=True))(jp, jnp.asarray(v))
    tv = torch.tensor(v, requires_grad=joint)
    tl, aux = tc.loss(tp, torch.tensor(X), torch.tensor(Y), tv,
                      tc.CGLBConfig(**settings))
    tl.backward()
    assert aux.cg_steps == 0 and int(jaux.cg_steps) == 0
    assert aux.cg_residual_error == 0.0
    assert not aux.v.requires_grad
    np.testing.assert_array_equal(aux.v.numpy(), v)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-9)
    _assert_grads(tp, jg)
    if joint:
        want = np.asarray(jgv)
        np.testing.assert_allclose(tv.grad.numpy(), want, rtol=0,
                                   atol=1e-7 * np.max(np.abs(want)))


@pytest.mark.parametrize("family", FAMILIES)
def test_elbo_n2m_value_and_grad_match_jax(rng, family):
    jp, tp, X, Y = _problem(rng, family)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: js.elbo_n2m(p, jnp.asarray(X), jnp.asarray(Y))))(jp)
    tl = ts.elbo_n2m(tp, torch.tensor(X), torch.tensor(Y))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-9)
    _assert_grads(tp, jg)
    with torch.no_grad():  # the n2m term replaces a trace term >= it
        assert float(tl) >= float(ts.elbo(tp, torch.tensor(X),
                                          torch.tensor(Y))) - 1e-9


def test_n2m_log_trace_is_clamped_at_its_minimum(rng):
    """With Z = X the Nystrom term equals K and tr(K - Q) cancels to
    rounding: the clamp at N sigma^2 keeps log_trace >= 0 and finite."""
    X = rng.normal(size=(25, 2))
    tp = ts.SGPRParams(tk.make_kernel("SquaredExponential", 2,
                                      dtype=torch.float64), X,
                       noise_variance=1e-3, dtype=torch.float64)
    with torch.no_grad():
        ct = ts.common_terms(tp, torch.tensor(X), jitter=1e-10)
        lt = ts.n2m_log_trace(tp, ct, torch.tensor(X))
    assert np.isfinite(float(lt)) and float(lt) >= 0.0


@pytest.mark.parametrize("mode", ["vzero", "vjoint"])
def test_predict_with_external_v_reuses_v0(rng, mode):
    """predict_prepare runs no CG for an external v: the cache's v is v0
    itself, as in the JAX package (prediction compared at 1e-9)."""
    jp, tp, X, Y = _problem(rng, "Matern32", n=120)
    Xs = rng.normal(size=(30, 3))
    joint = mode == "vjoint"
    v = 0.05 * rng.normal(size=(1, 120)) if joint else np.zeros((1, 120))
    settings = dict(joint_optimization=joint, vzero=not joint,
                    precond_dtype="float64")
    with torch.no_grad():  # the predictions carry gradients, as JAX's do
        cache = tc.predict_prepare(tp, torch.tensor(X), torch.tensor(Y),
                                   torch.tensor(v), tc.CGLBConfig(**settings))
        tm, tv = tc.predict_from_cache(tp, cache, torch.tensor(X),
                                       torch.tensor(Xs))
    np.testing.assert_array_equal(cache.v.numpy(), v)
    jm, jv = jax.jit(lambda p: jc.predict_f(
        p, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(v), jnp.asarray(Xs),
        jc.CGLBConfig(common_dtype="float64", **settings)))(jp)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-9,
                               atol=1e-11)
