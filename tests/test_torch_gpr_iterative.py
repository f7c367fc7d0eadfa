"""PyTorch port: the iterative exact GP (models/gpr_iterative.py: Lanczos,
SLQ, the surrogate-gradient lml, the LOVE-style predictor) and the grouped
wrappers of kernels 1 and 2 against the JAX package, fp64 on the CPU.

Both packages get one Z: the test draws it as the JAX functions would from
their key and hands it to the port as ``probes``."""

import torch_threads  # noqa: F401  (the test processes' torch thread cap)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cglb_tpu.models import gpr as jg
from cglb_tpu.models import gpr_iterative as jit_gp
from cglb_tpu.ops import kernels as jk
from cglb_tpu.ops import matvec_pallas as jmv
from cglb_tpu_torch.models import gpr as tg
from cglb_tpu_torch.models import gpr_iterative as tit
from cglb_tpu_torch.ops import kernels as tk
from cglb_tpu_torch.ops import matvec as tmv


def _data(rng, n=150, d=3, out=1):
    X = rng.normal(size=(n, d))
    W = rng.normal(size=(d, out))
    Y = np.tanh(X @ W) + 0.1 * rng.normal(size=(n, out))
    return X, Y


def _params(family, d, out=1, var=1.3, noise=0.3):
    ls = np.linspace(0.7, 1.4, d)
    jp = jg.GPRParams.create(
        jk.make_kernel(family, d, variance=var, lengthscales=ls,
                       dtype=np.float64),
        noise_variance=noise, output_dim=out, dtype=np.float64)
    tp = tg.GPRParams(
        tk.make_kernel(family, d, variance=var, lengthscales=ls,
                       dtype=torch.float64),
        noise_variance=noise, output_dim=out, dtype=torch.float64)
    return jp, tp


def _spd(rng, n):
    G = rng.normal(size=(n, n))
    return G @ G.T / n + np.eye(n)


def _probes_of_lml(key, P, N):
    """The Z iterative_lml draws from ``key``."""
    return np.asarray(jax.random.rademacher(jax.random.split(key)[0], (P, N),
                                            dtype=np.float64))


def _jax_grads(g):
    return {".kernel.variance": g.kernel.variance.raw,
            ".kernel.lengthscales": g.kernel.lengthscales.raw,
            ".noise_variance": g.noise_variance.raw, ".mean.c": g.mean.c.raw}


@pytest.mark.parametrize("reorth", [False, True])
def test_lanczos_matches_jax(rng, reorth):
    """alphas, betas and Q of 12 steps on a 60 x 60 SPD matrix from 3 start
    vectors: 1e-10 of their scale (the recurrence amplifies the last-bit
    differences of the two matmuls)."""
    K = _spd(rng, 60)
    V0 = rng.normal(size=(3, 60))
    ja, jb, jq = jit_gp.lanczos(lambda p: p @ jnp.asarray(K),
                                jnp.asarray(V0), 12, reorth=reorth)
    Kt = torch.tensor(K)
    ta, tb, tq = tit.lanczos(lambda p: p @ Kt, torch.tensor(V0), 12,
                             reorth=reorth)
    assert ta.shape == (3, 12) and tb.shape == (3, 11)
    assert tq.shape == (12, 3, 60)
    for got, want in ((ta, ja), (tb, jb), (tq, jq)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-10 * np.abs(want).max())


def test_lanczos_reorth_keeps_q_orthonormal(rng):
    K = torch.tensor(_spd(rng, 40))
    _, _, Q = tit.lanczos(lambda p: p @ K,
                          torch.tensor(rng.normal(size=(1, 40))), 30,
                          reorth=True)
    gram = Q[:, 0] @ Q[:, 0].T
    torch.testing.assert_close(gram, torch.eye(30, dtype=torch.float64),
                               rtol=0, atol=1e-10)


def test_slq_logdet_matches_jax_and_generator_draws(rng):
    X, _ = _data(rng)
    jp, tp = _params("Matern32", 3)
    N = X.shape[0]
    key = jax.random.PRNGKey(3)
    Z = np.asarray(jax.random.rademacher(key, (10, N), dtype=np.float64))
    Kj = jk.K(jp.kernel, jnp.asarray(X)) + 0.3 * jnp.eye(N)
    want = jit_gp.slq_logdet(lambda p: p @ Kj, N, key, 10, 25, np.float64)
    Kt = torch.tensor(np.asarray(Kj))
    got = tit.slq_logdet(lambda p: p @ Kt, N, None, 10, 25, torch.float64,
                         probes=torch.tensor(Z))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-10)
    # without probes the generator supplies +-1 rows; one state, one Z
    gen = tit.make_generator(7, "cpu")
    state = gen.get_state()
    z1 = tit.rademacher(gen, (10, N), torch.float64)
    z2 = tit.rademacher(tit.make_generator(state, "cpu"), (10, N),
                        torch.float64)
    assert torch.equal(z1, z2) and set(z1.unique().tolist()) == {-1.0, 1.0}
    drawn = tit.slq_logdet(lambda p: p @ Kt, N,
                           tit.make_generator(state, "cpu"), 10, 25,
                           torch.float64)
    again = tit.slq_logdet(lambda p: p @ Kt, N, None, 10, 25, torch.float64,
                           probes=z1)
    assert float(drawn) == float(again)
    exact = float(np.linalg.slogdet(np.asarray(Kj))[1])
    assert abs(float(drawn) - exact) < 0.2 * abs(exact)


# CG amplifies the last-bit differences of the two packages' matmuls by about
# 1e4 every four steps once its Ritz values start to converge (measured here:
# the iterates differ by 2e-16 after 3 steps, 5e-15 after 8, 5e-11 after 12,
# 5e-7 after 20).  So the tight comparison caps CG at 8 steps, where both
# packages still hold the same iterate, and the default config (17 steps
# here, to 0.5 |r|^2 <= 1e-4) is compared at what that leaves: alpha to 1e-4,
# the value to 1e-7 and the gradients to 5e-3 of their scale (the mean's
# gradient is sum(alpha), a cancelling sum that inherits alpha's spread).
@pytest.mark.parametrize("family", ["Matern32", "SquaredExponential"])
@pytest.mark.parametrize("out", [1, 3])
@pytest.mark.parametrize("max_cg_iters,rtol,gtol", [(8, 1e-9, 1e-7),
                                                    (200, 1e-7, 5e-3)])
def test_iterative_lml_and_gradient_match_jax(rng, family, out, max_cg_iters,
                                              rtol, gtol):
    """Dense branch (N <= 4096), 10 probes, 25 Lanczos steps, shared Z:
    value, SLQ log-det and the solve alpha to ``rtol``, raw gradients to
    ``gtol`` of their scale, and the same CG step count."""
    X, Y = _data(rng, out=out)
    jp, tp = _params(family, 3, out)
    key = jax.random.PRNGKey(1)
    Z = _probes_of_lml(key, 10, X.shape[0])
    jcfg = jit_gp.IterGPConfig(max_cg_iters=max_cg_iters)
    (want, jaux), jgrads = jax.value_and_grad(
        lambda p: jit_gp.iterative_lml(p, X, Y, key, jcfg), has_aux=True)(jp)
    got, aux = tit.iterative_lml(
        tp, torch.tensor(X), torch.tensor(Y),
        cfg=tit.IterGPConfig(max_cg_iters=max_cg_iters),
        probes=torch.tensor(Z))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=rtol)
    np.testing.assert_allclose(float(aux.logdet), float(jaux.logdet),
                               rtol=1e-9)
    np.testing.assert_allclose(aux.alpha.numpy(), np.asarray(jaux.alpha),
                               rtol=0, atol=1e3 * rtol)
    assert aux.cg_steps == int(jaux.cg_steps) <= max_cg_iters
    assert 0 < aux.probe_cg_steps <= max_cg_iters
    for name, p in tp.named_params():
        want_g = np.asarray(_jax_grads(jgrads)[name])
        scale = max(np.abs(want_g).max(), 1e-12)
        np.testing.assert_allclose(p.raw.grad.numpy() / scale,
                                   want_g / scale, rtol=0, atol=gtol,
                                   err_msg=name)


def test_iterative_loss_draws_from_the_generator(rng):
    X, Y = map(torch.tensor, _data(rng, n=60))
    _, tp = _params("Matern32", 3)
    with torch.no_grad():
        a, _ = tit.iterative_loss(tp, X, Y, tit.make_generator(5, "cpu"))
        b, _ = tit.iterative_loss(tp, X, Y, tit.make_generator(5, "cpu"))
        c, _ = tit.iterative_loss(tp, X, Y, tit.make_generator(6, "cpu"))
    assert float(a) == float(b) and float(a) != float(c)
    with torch.no_grad():
        exact = -float(tg.log_marginal_likelihood(tp, X, Y))
    assert abs(float(a) - exact) < 0.05 * abs(exact) + 2.0


@pytest.mark.parametrize("out", [1, 2])
def test_predict_f_iterative_matches_jax(rng, out):
    """Mean and variance to 1e-9 of their scale with the mean's CG run to
    convergence (a CG stopped at a tolerance leaves the two packages up to
    that tolerance apart, see above) and 64 reorthogonalized Lanczos steps;
    the default config within its CG tolerance, and near the dense
    predictor."""
    X, Y = _data(rng, out=out)
    Xs = rng.normal(size=(13, 3))
    jp, tp = _params("Matern32", 3, out)
    args = tuple(map(torch.tensor, (X, Y, Xs)))
    jm, jv = jit_gp.predict_f_iterative(
        jp, X, Y, Xs, jit_gp.IterGPConfig(cg_tolerance=1e-20))
    tm, tv = tit.predict_f_iterative(tp, *args,
                                     tit.IterGPConfig(cg_tolerance=1e-20))
    assert tm.shape == (13, out) and tv.shape == (13, out)
    for got, want in ((tm, jm), (tv, jv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-9 * np.abs(want).max())
    jm, jv = jit_gp.predict_f_iterative(jp, X, Y, Xs)
    tm, tv = tit.predict_f_iterative(tp, *args)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-3)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                               atol=1e-9 * np.abs(jv).max())
    dm, _ = tg.predict_f(tp, *args)
    np.testing.assert_allclose(tm.numpy(), dm.detach().numpy(), atol=1e-3)
    with torch.no_grad():
        lpd = tit.iterative_predict_log_density(
            tp, *args, torch.tensor(rng.normal(size=(13, out))))
    assert lpd.shape == (13,) and torch.isfinite(lpd).all()


def test_streaming_branch_matches_jax_interpret_mode(rng):
    """N = 4160 > 4096: both packages stream (the JAX side through its
    Pallas kernels in interpret mode, as tests/test_matvec_pallas.py runs
    them; the port through its plain versions).  A cut config keeps it
    short.  The Pallas kernels' bf16-split distances are fp32-grade, so the
    value agrees to 1e-5 relative and the gradients to 1e-3 of their
    scale."""
    X, Y = _data(rng, n=4160, d=2)
    jp, tp = _params("Matern32", 2, noise=0.5)
    jcfg = jit_gp.IterGPConfig(num_probes=3, lanczos_steps=4,
                               max_cg_iters=6)
    tcfg = tit.IterGPConfig(num_probes=3, lanczos_steps=4, max_cg_iters=6)
    key = jax.random.PRNGKey(2)
    Z = _probes_of_lml(key, 3, 4160)
    (want, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jit_gp.iterative_lml(p, X, Y, key, jcfg), has_aux=True))(jp)
    launched = []
    real = tmv.matvec_unit_plain
    tmv.matvec_unit_plain = lambda *a: launched.append(1) or real(*a)
    try:
        got, aux = tit.iterative_lml(tp, torch.tensor(X), torch.tensor(Y),
                                     cfg=tcfg, probes=torch.tensor(Z))
    finally:
        tmv.matvec_unit_plain = real
    got.backward()
    assert launched, "the streaming operator was not used"
    assert aux.cg_steps == int(jaux.cg_steps) == 6
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for name, p in tp.named_params():
        want_g = np.asarray(_jax_grads(jgrads)[name])
        scale = max(np.abs(want_g).max(), 1e-12)
        np.testing.assert_allclose(p.raw.grad.numpy() / scale,
                                   want_g / scale, rtol=0, atol=1e-3,
                                   err_msg=name)


def _kernels(rng, d):
    from cglb_tpu.transforms import Param as JParam

    ls = rng.uniform(0.5, 2.0, size=d)
    jkern = dataclasses.replace(
        jk.make_kernel("Matern32", d, dtype=np.float64),
        variance=JParam.positive(1.7, lower=1e-6),
        lengthscales=JParam.positive(jnp.asarray(ls), lower=1e-6))
    tkern = tk.make_kernel("Matern32", d, variance=1.7, lengthscales=ls,
                           dtype=torch.float64)
    return jkern, tkern


@pytest.mark.parametrize("B", [10, 64])
def test_wrappers_take_wide_batches_like_the_jax_functions(rng, B):
    """kernel_matvec, kernel_cross_matvec and the lengthscale / variance
    gradient at B = 10 and 64 (above one launch's 8 rows): 5e-5 of scale
    against the Pallas kernels in interpret mode (their accuracy contract),
    1e-9 against dense fp64."""
    n, nc, d = 200, 90, 3
    X, Xc = rng.normal(size=(n, d)), rng.normal(size=(nc, d))
    p, w = rng.normal(size=(B, n)), rng.normal(size=(B, n))
    jkern, tkern = _kernels(rng, d)

    def f_pallas(kern):
        out = jmv.kernel_matvec(kern, jnp.asarray(X), jnp.asarray(p), 128,
                                128, interpret=True)
        return jnp.sum(out * w), out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(f_pallas, has_aux=True))(
        jkern)
    dense = p @ np.asarray(jk.K(jkern, jnp.asarray(X)))
    out = tmv.kernel_matvec(tkern, torch.tensor(X), torch.tensor(p))
    torch.sum(out * torch.tensor(w)).backward()
    scale = np.abs(dense).max()
    assert out.shape == (B, n)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=5e-5 * scale)
    np.testing.assert_allclose(out.detach().numpy(), dense, rtol=0,
                               atol=1e-9 * scale)
    for got, want in ((tkern.variance.raw.grad, jgrad.variance.raw),
                      (tkern.lengthscales.raw.grad, jgrad.lengthscales.raw)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=5e-5 * np.abs(want).max())
    cross = tmv.kernel_cross_matvec(tkern, torch.tensor(X), torch.tensor(Xc),
                                    torch.tensor(p)).detach().numpy()
    jcross = np.asarray(jmv.kernel_cross_matvec(
        jkern, jnp.asarray(X), jnp.asarray(Xc), jnp.asarray(p), 64, 64,
        interpret=True))
    assert cross.shape == (B, nc)
    np.testing.assert_allclose(cross, jcross, rtol=0,
                               atol=5e-5 * np.abs(jcross).max())


def test_launch_groups_cover_any_batch():
    assert tmv._groups(1) == [(0, 1)]
    assert tmv._groups(8) == [(0, 8)]
    assert tmv._groups(10) == [(0, 8), (8, 10)]
    assert len(tmv._groups(64)) == 8 and tmv._groups(64)[-1] == (56, 64)
    assert [tmv._bpad(b1 - b0) for b0, b1 in tmv._groups(11)] == [8, 4]
    for bad in (0, -1):
        with pytest.raises(ValueError):
            tmv._groups(bad)
        with pytest.raises(ValueError):
            tmv._bpad(bad)
    with pytest.raises(ValueError):
        tmv._bpad(9)


def test_surrogate_backward_skips_dp(rng):
    """The surrogates' vectors are detached: the Function's backward must
    not compute dp (one more kernel-1 launch a group on the card)."""
    X = torch.tensor(rng.normal(size=(50, 2)))
    kern = tk.make_kernel("Matern32", 2, dtype=torch.float64)
    calls = []
    real = tmv.matvec_unit
    tmv.matvec_unit = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        out = tmv.kernel_matvec(kern, X, torch.tensor(rng.normal(size=(10,
                                                                       50))))
        out.sum().backward()
    finally:
        tmv.matvec_unit = real
    assert len(calls) == 1 and kern.lengthscales.raw.grad is not None


def test_probes_need_a_generator_or_ready_made_rows(rng):
    X, Y = map(torch.tensor, _data(rng, n=30))
    _, tp = _params("Matern32", 3)
    with pytest.raises(ValueError, match="generator or ready-made"):
        tit.iterative_lml(tp, X, Y)
