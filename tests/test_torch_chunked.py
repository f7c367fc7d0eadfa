"""PyTorch port: the column-chunked common terms (models/sgpr.py), with each
chunk recomputed in the backward, against the JAX package's chunked
``_kuf_terms`` and ``cglb.bound(remat_common_terms=True)``, and against the
port's own unchunked pass; fp64 on the CPU.

N = 300 with chunks of 96 columns: the JAX package pads the last chunk to
96 with masked columns, the port takes a last chunk of 12.  Tolerances:
1e-12 where both sides compute the same fp64 products; the CGLB loss 1e-9
and its gradients 1e-7 with the fp64 preconditioner (as
tests/test_torch_models.py holds the unchunked loss), 1e-6 with the fp32
one, whose A is cast per chunk here and whole there."""

import torch_threads  # noqa: F401  (the test processes' torch thread cap)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cglb_tpu.models import cglb as jc
from cglb_tpu.models import sgpr as js
from cglb_tpu_torch.models import cglb as tc
from cglb_tpu_torch.models import sgpr as ts
from test_torch_models import _data, _grads_jax, _params

FAMILIES = ["Matern32", "SquaredExponential"]
N, M, WIDTH, JITTER = 300, 18, 96, 1e-6


@pytest.fixture()
def chunked(monkeypatch):
    """Chunking forced in both packages: the port by its own constants
    (chunks of WIDTH columns above 1024 Kuf elements); the JAX package by
    its threshold, and by WIDTH on its fp64 `_kuf_terms`, whose own width
    (threshold / M, at least 1024 columns) would not chunk 300 rows."""
    monkeypatch.setattr(ts, "CHUNK_THRESHOLD_ELEMENTS", 1024)
    monkeypatch.setattr(ts, "CHUNK_ELEMENTS", WIDTH * M)
    monkeypatch.setattr(js, "CHUNK_THRESHOLD_ELEMENTS", 1024)
    real = js._kuf_terms

    @functools.wraps(real)
    def kuf_terms(*args, chunk_size=None, **kw):
        return real(*args, chunk_size=WIDTH, **kw)

    monkeypatch.setattr(js, "_kuf_terms", kuf_terms)
    assert ts.chunk_width(N, M) == WIDTH


def _setup(rng, family):
    X, Y, Z = _data(rng, n=N, m=M)
    jp, tp = _params(family, X, Z)
    W = rng.normal(size=(N, 2))
    return X, Y, W, jp, tp


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.max(np.abs(want))))


@pytest.mark.parametrize("family", FAMILIES)
def test_kuf_terms_match_jax_chunked_with_remat(rng, family):
    """A, A A^T and A W of the chunked `_kuf_terms` with chunk recompute, to
    1e-12, and the port's unchunked pass to 1e-12 of them."""
    X, _, W, jp, tp = _setup(rng, family)
    Xt, Wt = torch.tensor(X), torch.tensor(W)
    sigma = 0.7
    want = jax.jit(lambda p: js._kuf_terms(
        p, js._kuu_chol(p, JITTER), jnp.asarray(X), sigma, W=jnp.asarray(W),
        chunk_size=WIDTH, remat=True))(jp)
    L = ts._kuu_chol(tp, JITTER)
    got = ts._kuf_terms(tp, L, Xt, sigma, W=Wt, chunk_size=WIDTH, remat=True)
    whole = ts._kuf_terms(tp, L, Xt, sigma, W=Wt)
    assert ts.chunk_width(N, M, WIDTH) == WIDTH
    for g, w, u in zip(got, want, whole):
        _close(g, w, 1e-12)
        _close(g, u.detach().numpy(), 1e-12)


@pytest.mark.parametrize("family,precond,rtol_loss,rtol_grad", [
    ("Matern32", "float64", 1e-9, 1e-7),
    ("SquaredExponential", "float64", 1e-9, 1e-7),
    ("Matern32", "float32", 1e-6, 1e-6)])
def test_bound_with_remat_matches_jax(rng, chunked, family, precond,
                                      rtol_loss, rtol_grad):
    """value_and_grad of the CGLB bound with the common terms chunked and
    recomputed in the backward, both packages at one converged v (CG takes
    no step): gradients with respect to Z, the lengthscales, the variance,
    the noise and the mean."""
    X, Y, _, jp, tp = _setup(rng, family)
    Xt, Yt = torch.tensor(X), torch.tensor(Y)
    tight = tc.CGLBConfig(max_error=1e-14, max_cg_iters=1000,
                          precond_dtype="float64")
    with torch.no_grad():
        _, aux = tc.loss(tp, Xt, Yt, tc.init_v0(N), tight)
    v = aux.v

    jcfg = jc.CGLBConfig(max_error=1e30, common_dtype="float64",
                         precond_dtype=precond)
    (jb, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jc.bound(p, jnp.asarray(X), jnp.asarray(Y),
                           jnp.asarray(v.numpy()), jcfg,
                           remat_common_terms=True), has_aux=True))(jp)
    tcfg = tc.CGLBConfig(max_error=1e30, precond_dtype=precond)
    tb, taux = tc.bound(tp, Xt, Yt, v, tcfg, remat_common_terms=True)
    tb.backward()
    assert taux.cg_steps == 0
    np.testing.assert_allclose(float(tb.detach()), float(jb), rtol=rtol_loss)
    tgrads = {name: p.raw.grad.numpy() for name, p in tp.named_params()}
    for name, want in _grads_jax(jg).items():
        want = np.asarray(want)
        np.testing.assert_allclose(
            tgrads[name], want, rtol=0,
            atol=rtol_grad * np.max(np.abs(want)), err_msg=name)


@pytest.mark.parametrize("family", FAMILIES)
def test_chunked_matches_unchunked_in_the_port(rng, monkeypatch, family):
    """Inside the port, chunked (with and without recompute) against one
    pass: common terms, elbo, upper bound and the CGLB loss to 1e-12, the
    loss's gradients to 1e-10 (fp64 preconditioner: both build one P).  The
    chunked A has the one pass's column-major layout, so that the
    preconditioner's products on it take the same route."""
    X, Y, _, _, tp = _setup(rng, family)
    Xt, Yt = torch.tensor(X), torch.tensor(Y)
    cfg = tc.CGLBConfig(max_error=1e-8, max_cg_iters=6,
                        precond_dtype="float64")
    v0 = tc.init_v0(N)
    with torch.no_grad():
        whole = ts.common_terms(tp, Xt, JITTER)
        parts = ts.common_terms(tp, Xt, JITTER, chunk_size=WIDTH)
        for a, b in zip(parts, whole):
            _close(a, b.numpy(), 1e-12)
        assert parts.A.stride() == whole.A.stride() == (1, M)
        bounds = [fn(tp, Xt, Yt, JITTER) for fn in (ts.elbo, ts.upper_bound)]
        monkeypatch.setattr(ts, "CHUNK_THRESHOLD_ELEMENTS", 1024)
        monkeypatch.setattr(ts, "CHUNK_ELEMENTS", WIDTH * M)
        for fn, want in zip((ts.elbo, ts.upper_bound), bounds):
            _close(fn(tp, Xt, Yt, JITTER), want.numpy(), 1e-12)
        monkeypatch.undo()

    def loss_and_grads(**kw):
        tp.zero_grad()
        loss, aux = tc.loss(tp, Xt, Yt, v0, cfg, **kw)
        loss.backward()
        return loss.detach(), aux, [p.grad.clone() for p in tp.parameters()]

    base, base_aux, base_g = loss_and_grads()
    for remat in (False, True):
        loss, aux, grads = loss_and_grads(chunk_size=WIDTH,
                                          remat_common_terms=remat)
        assert aux.cg_steps == base_aux.cg_steps > 0
        _close(loss, base.numpy(), 1e-12)
        for g, b in zip(grads, base_g):
            _close(g, b.numpy(), 1e-10)


@pytest.mark.parametrize("family", FAMILIES)
def test_sgpr_and_cglb_predictor_chunked_match_jax(rng, chunked, family):
    """SGPR elbo and upper bound, and the CGLB predictor (whose A @ res the
    port forms by ``kuf_weighted``), chunked in both packages."""
    X, Y, _, jp, tp = _setup(rng, family)
    Xt, Yt = torch.tensor(X), torch.tensor(Y)
    Xnew = rng.normal(size=(40, X.shape[1]))
    want = jax.jit(lambda p: (js.elbo(p, X, Y, jitter=JITTER),
                              js.upper_bound(p, X, Y, jitter=JITTER)))(jp)
    with torch.no_grad():
        got = (ts.elbo(tp, Xt, Yt, JITTER), ts.upper_bound(tp, Xt, Yt,
                                                           JITTER))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-12)

    cfg = tc.CGLBConfig(max_error=1e-14, max_cg_iters=1000,
                        precond_dtype="float64")
    with torch.no_grad():
        _, aux = tc.loss(tp, Xt, Yt, tc.init_v0(N), cfg)
        mean, var = tc.predict_f(tp, Xt, Yt, aux.v, torch.tensor(Xnew), cfg,
                                 cg_tolerance=None, jitter=JITTER)
    jcfg = jc.CGLBConfig(common_dtype="float64", precond_dtype="float64")
    jmean, jvar = jax.jit(lambda p: jc.predict_f(
        p, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(aux.v.numpy()),
        jnp.asarray(Xnew), jcfg, cg_tolerance=None, jitter=JITTER))(jp)
    _close(mean, jmean, 1e-12)
    _close(var, jvar, 1e-12)


def test_kuf_weighted_is_a_times_w(rng):
    """kuf_weighted's L^-1 (sum over chunks of Kuf_c W_c) / sigma equals
    A @ W of the unchunked pass, to 1e-12."""
    X, _, W, _, tp = _setup(rng, "Matern32")
    Xt, Wt = torch.tensor(X), torch.tensor(W)
    with torch.no_grad():
        L = ts._kuu_chol(tp, JITTER)
        A, _, AW = ts._kuf_terms(tp, L, Xt, 0.7, W=Wt)
        got = ts.kuf_weighted(tp, L, Xt, Wt, 0.7, chunk_size=WIDTH)
    _close(got, AW.numpy(), 1e-12)
    _close(got, (A @ Wt).numpy(), 1e-12)
