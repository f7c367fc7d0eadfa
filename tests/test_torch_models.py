"""PyTorch port: SGPR and CGLB bounds, the CGLB loss and its gradient, CG
and prediction against the JAX package and the golden constants, fp64 on
the CPU (where every kernel wrapper takes its plain version)."""

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
from cglb_tpu_torch.ops import cg as tcg
from cglb_tpu_torch.ops import chol as tchol
from cglb_tpu_torch.ops import kernels as tk
from cglb_tpu_torch.ops import matvec as tmv
from cglb_tpu_torch.ops import preconditioners as tpc
from test_golden import GOLDEN

FAMILIES = ["Matern32", "SquaredExponential"]


def _params(family, X, Z, var=1.3, ls=0.9, noise=0.3):
    d = X.shape[1]
    jkern = jk.make_kernel(family, d, variance=var, lengthscales=ls,
                           dtype=np.float64)
    jp = js.SGPRParams.create(jkern, Z, noise_variance=noise,
                              dtype=np.float64)
    tkern = tk.make_kernel(family, d, variance=var, lengthscales=ls,
                           dtype=torch.float64)
    tp = ts.SGPRParams(tkern, Z, noise_variance=noise, dtype=torch.float64)
    return jp, tp


def _data(rng, n=500, d=3, m=20):
    X = rng.normal(size=(n, d))
    Y = np.sin(X[:, :1]) + 0.1 * rng.normal(size=(n, 1))
    return X, Y, X[:m].copy()


@pytest.fixture()
def snelson(monkeypatch, tmp_path):
    monkeypatch.setenv("CGLB_DATA_DIR", str(tmp_path / "no_data_here"))
    from cglb_tpu_torch.experiments.datasets import get_dataset

    b = get_dataset("snelson1d", dtype=np.float64)
    assert b.synthetic and b.train[0].shape == (134, 1)
    return torch.tensor(b.train[0]), torch.tensor(b.train[1])


@pytest.mark.parametrize("family,prefix", [("Matern32", ""),
                                           ("SquaredExponential", "rbf_")])
def test_golden_constants(snelson, family, prefix):
    """tests/test_golden.py's frozen elbo, upper and CGLB values."""
    X, Y = snelson
    kern = tk.make_kernel(family, 1, variance=1.2, lengthscales=0.8,
                          dtype=torch.float64)
    params = ts.SGPRParams(kern, X[:30], noise_variance=0.1,
                           dtype=torch.float64)
    with torch.no_grad():
        np.testing.assert_allclose(float(ts.elbo(params, X, Y, jitter=1e-6)),
                                   GOLDEN[prefix + "elbo"], rtol=1e-9)
        np.testing.assert_allclose(
            float(ts.upper_bound(params, X, Y, jitter=1e-6)),
            GOLDEN[prefix + "upper"], rtol=1e-8)
        cfg = tc.CGLBConfig(max_error=1e-14, max_cg_iters=500)
        b, _ = tc.bound(params, X, Y, tc.init_v0(X.shape[0]), cfg,
                        jitter=1e-6)
    np.testing.assert_allclose(float(b), GOLDEN[prefix + "cglb"], rtol=1e-8)
    assert GOLDEN[prefix + "elbo"] < float(b) < GOLDEN[prefix + "lml"]


@pytest.mark.parametrize("family", FAMILIES)
def test_elbo_and_upper_match_jax(rng, family):
    X, Y, Z = _data(rng, n=300)
    jp, tp = _params(family, X, Z)
    Xt, Yt = torch.tensor(X), torch.tensor(Y)
    want = jax.jit(lambda p: (js.elbo(p, X, Y), js.upper_bound(p, X, Y)))(jp)
    with torch.no_grad():
        got = (ts.elbo(tp, Xt, Yt), ts.upper_bound(tp, Xt, Yt))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-12)


def _grads_jax(g):
    return {".kernel.variance": g.kernel.variance.raw,
            ".kernel.lengthscales": g.kernel.lengthscales.raw,
            ".inducing_Z": g.inducing_Z.raw,
            ".noise_variance": g.noise_variance.raw, ".mean.c": g.mean.c.raw}


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("settings,rtol_loss,rtol_grad", [
    ({"common_dtype": "float64", "precond_dtype": "float64"}, 1e-9, 1e-7),
    ({"common_dtype": "float64"}, 1e-6, 1e-6),
    # the JAX default ("mixed") evaluates dKuf of its Gram product in f32
    # by design (models/sgpr._gram_outer_bwd, ~3e-6 relative), so its
    # gradient is f32-grade; the port's default is fp64 throughout
    ({}, 1e-6, 2e-5),
])
def test_loss_and_grad_match_jax_at_converged_v(rng, family, settings,
                                                rtol_loss, rtol_grad):
    """value_and_grad of cglb.loss at N=500, both packages fed the same
    converged v (CG then takes no step, so both assemble the bound at one
    v).  The port runs with the preconditioner dtype of ``settings`` and its
    fp64 common terms (it has no ``mixed`` path)."""
    X, Y, Z = _data(rng)
    jp, tp = _params(family, X, Z)
    n = X.shape[0]
    tight = tc.CGLBConfig(max_error=1e-14, max_cg_iters=1000,
                          precond_dtype="float64")
    with torch.no_grad():
        _, aux = tc.loss(tp, torch.tensor(X), torch.tensor(Y),
                         tc.init_v0(n), tight)
    v = aux.v.numpy()

    jcfg = jc.CGLBConfig(max_error=1e30, **settings)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jc.loss(p, jnp.asarray(X), jnp.asarray(Y),
                          jnp.asarray(v), jcfg), has_aux=True))(jp)
    tcfg = tc.CGLBConfig(max_error=1e30, precond_dtype=settings.get(
        "precond_dtype", "float32"))
    tl, taux = tc.loss(tp, torch.tensor(X), torch.tensor(Y), torch.tensor(v),
                       tcfg)
    tl.backward()
    assert taux.cg_steps == 0
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=rtol_loss)
    tgrads = {name: p.raw.grad.numpy() for name, p in tp.named_params()}
    for name, want in _grads_jax(jg).items():
        want = np.asarray(want)
        np.testing.assert_allclose(
            tgrads[name], want, rtol=0,
            atol=rtol_grad * np.max(np.abs(want)), err_msg=name)


@pytest.mark.parametrize("family", FAMILIES)
def test_streaming_loss_matches_dense(rng, family):
    """The loss on the streaming operator pair (plain kernels 1 and 2 on
    the CPU, CG tier in CG) against the dense operator: value and
    gradient."""
    X, Y, Z = _data(rng, n=240)
    _, tp = _params(family, X, Z)
    Xt, Yt = torch.tensor(X), torch.tensor(Y)
    cfg = tc.CGLBConfig(max_error=1e-10, max_cg_iters=500)
    v0 = tc.init_v0(X.shape[0])
    ld, _ = tc.loss(tp, Xt, Yt, v0, cfg)
    gd = torch.autograd.grad(ld, list(tp.parameters()))
    acc, cgt = tmv.make_streaming_operator_pair(tp.kernel, Xt,
                                                tp.noise_variance.value)
    ls, _ = tc.loss(tp, Xt, Yt, v0, cfg, matvec=acc, matvec_cg=cgt)
    gs = torch.autograd.grad(ls, list(tp.parameters()))
    np.testing.assert_allclose(float(ls.detach()), float(ld.detach()),
                               rtol=1e-10)
    for a, b in zip(gs, gd):
        torch.testing.assert_close(a, b, rtol=1e-6,
                                   atol=1e-6 * float(b.abs().max()))


def _precond(tp, X):
    with torch.no_grad():
        ct = ts.common_terms(tp, X)
        return tc._make_precond(ct, tp.noise_variance.value,
                                tc.CGLBConfig(precond_dtype="float64"))


def test_cg_sanitises_and_falls_back_to_cold(rng):
    X, Y, Z = _data(rng, n=120)
    _, tp = _params("Matern32", X, Z)
    Xt, b = torch.tensor(X), torch.tensor(Y).T
    P = _precond(tp, Xt)
    with torch.no_grad():
        Kmat = tp.kernel.K(Xt) + tp.noise_variance.value * torch.eye(120)
    matvec = lambda p: p @ Kmat  # noqa: E731
    v_cold, s_cold = tcg.preconditioned_cg(matvec, b, torch.zeros_like(b), P,
                                           1e-22, 500)
    nan_v0 = torch.full_like(b, float("nan"))
    v_nan, s_nan = tcg.preconditioned_cg(matvec, b, nan_v0, P, 1e-22, 500)
    bad_v0 = torch.full_like(b, 1e6)
    v_bad, s_bad = tcg.preconditioned_cg(matvec, b, bad_v0, P, 1e-22, 500)
    for v in (v_nan, v_bad):
        torch.testing.assert_close(v, v_cold)
    assert s_nan.steps == s_cold.steps == s_bad.steps
    exact = torch.linalg.solve(Kmat, b.T).T
    torch.testing.assert_close(v_cold, exact, rtol=1e-6, atol=1e-8)


def test_cg_restart_and_resume_match_one_solve(rng):
    X, Y, Z = _data(rng, n=150)
    _, tp = _params("SquaredExponential", X, Z)
    Xt, b = torch.tensor(X), torch.tensor(Y).T
    P = _precond(tp, Xt)
    with torch.no_grad():
        Kmat = tp.kernel.K(Xt) + tp.noise_variance.value * torch.eye(150)
    matvec = lambda p: p @ Kmat  # noqa: E731
    v_all, stats = tcg.preconditioned_cg(matvec, b, torch.zeros_like(b), P,
                                         1e-20, 12, restart_iters=5)
    carry = tcg.cg_init(matvec, b, torch.zeros_like(b), P)
    carry, _ = tcg.cg_advance(matvec, b, P, carry, 1e-20, 7, 5)
    carry, s2 = tcg.cg_advance(matvec, b, P, carry, 1e-20, 12, 5)
    assert stats.steps == s2.steps == 12
    torch.testing.assert_close(carry.state.v, v_all, rtol=0, atol=0)


def test_preconditioner_quadratic_form_nonnegative(rng):
    X, Y, Z = _data(rng, n=100)
    _, tp = _params("Matern32", X, Z, noise=1e-4)
    Xt = torch.tensor(X)
    with torch.no_grad():
        ct = ts.common_terms(tp, Xt)
        P = tc._make_precond(ct, tp.noise_variance.value, tc.CGLBConfig())
        r = (ct.A.T @ torch.tensor(rng.normal(size=(20, 3)))).T
        _, rz = tpc.mat_vec(P, r)
    assert bool((rz >= 0).all())


def test_chol_retry_with_larger_jitter():
    """A singular Kuu factors after the 1000x-jitter retry; a failed
    factor is NaN as jnp.linalg.cholesky gives."""
    v = torch.tensor([[1.0], [1.0], [1.0]], dtype=torch.float64)
    P = v @ v.T - 1e-7 * torch.eye(3, dtype=torch.float64)
    assert not torch.isfinite(tchol.cholesky(P + 1e-8 * torch.eye(3))).all()
    L, Li = tchol.chol_inv_retry(P, 1e-8)
    assert torch.isfinite(L).all()
    torch.testing.assert_close(L @ L.T, P + 1e-5 * torch.eye(3,
                                                             dtype=P.dtype))
    torch.testing.assert_close(Li @ L, torch.eye(3, dtype=P.dtype))


@pytest.mark.parametrize("family", FAMILIES)
def test_predict_matches_jax(rng, family):
    X, Y, Z = _data(rng, n=200)
    Xs = rng.normal(size=(40, 3))
    jp, tp = _params(family, X, Z)
    # CG to fp64 precision with fp64 preconditioners on both sides, so
    # the comparison does not see where each solve stopped
    jcfg = jc.CGLBConfig(precond_dtype="float64", max_cg_iters=1000)
    jm, jv = jax.jit(lambda p: jc.predict_f(
        p, jnp.asarray(X), jnp.asarray(Y), jc.init_v0(200), jnp.asarray(Xs),
        jcfg, cg_tolerance=1e-24))(jp)
    tcfg = tc.CGLBConfig(precond_dtype="float64", max_cg_iters=1000)
    tm, tv = tc.predict_f(tp, torch.tensor(X), torch.tensor(Y),
                          tc.init_v0(200), torch.tensor(Xs), tcfg,
                          cg_tolerance=1e-24)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-9,
                               atol=1e-11)
    sm, sv = ts.predict_f(tp, torch.tensor(X), torch.tensor(Y),
                          torch.tensor(Xs))
    jsm, jsv = jax.jit(lambda p: js.predict_f(
        p, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Xs)))(jp)
    np.testing.assert_allclose(sm.numpy(), np.asarray(jsm), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(sv.numpy(), np.asarray(jsv), rtol=1e-9,
                               atol=1e-12)
