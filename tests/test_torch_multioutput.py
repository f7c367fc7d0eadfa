"""PyTorch port: multi-output Y [N, D_out] through cglb, sgpr, gpr and
exactgp: the port's counterpart of tests/test_multioutput.py, beside the JAX
package (fp64, CPU)."""

import torch_threads  # noqa: F401  (the test processes' torch thread cap)
import numpy as np
import pytest
import torch

from cglb_tpu.models import cglb as jc
from cglb_tpu.models import gpr as jg
from cglb_tpu.models import sgpr as js
from cglb_tpu.ops import kernels as jk
from cglb_tpu_torch import config as tconfig
from cglb_tpu_torch import configs as tcfgs
from cglb_tpu_torch.backend import Torch
from cglb_tpu_torch.models import cglb as tc
from cglb_tpu_torch.models import gpr as tg
from cglb_tpu_torch.models import sgpr as ts
from cglb_tpu_torch.ops import kernels as tk
from cglb_tpu_torch.ops import matvec as tmv


def _setup_multi(rng, n=48, d=2, m=8, out=3):
    X = rng.normal(size=(n, d))
    W = rng.normal(size=(d, out))
    Y = np.tanh(X @ W) + 0.05 * rng.normal(size=(n, out))
    Z = X[rng.choice(n, m, replace=False)]
    jkern = jk.make_kernel("rbf", d, dtype=np.float64)
    jp = js.SGPRParams.create(jkern, Z, noise_variance=0.4, output_dim=out,
                              dtype=np.float64)
    jgp = jg.GPRParams.create(jkern, noise_variance=0.4, output_dim=out,
                              dtype=np.float64)
    tkern = tk.make_kernel("rbf", d, dtype=torch.float64)
    tp = ts.SGPRParams(tkern, Z, noise_variance=0.4, output_dim=out,
                       dtype=torch.float64)
    tgp = tg.GPRParams(tkern, noise_variance=0.4, output_dim=out,
                       dtype=torch.float64)
    return X, Y, (jp, jgp), (tp, tgp)


def test_multioutput_bracket(rng):
    """3 outputs: elbo <= CGLB <= lml (shared kernel and noise), v is
    [3, N], and each of the three equals the JAX package's to 1e-9."""
    X, Y, (jp, jgp), (tp, tgp) = _setup_multi(rng)
    Xt, Yt = torch.tensor(X), torch.tensor(Y)
    cfg = tc.CGLBConfig(max_error=1e-8, max_cg_iters=300,
                        precond_dtype="float64")
    with torch.no_grad():
        b, aux = tc.bound(tp, Xt, Yt, tc.init_v0(48, 3, torch.float64), cfg)
        e = float(ts.elbo(tp, Xt, Yt))
        lml = float(tg.log_marginal_likelihood(tgp, Xt, Yt))
    assert e <= float(b) + 1e-8 and float(b) <= lml + 1e-8
    assert aux.v.shape == (3, 48)
    jb, _ = jc.bound(jp, X, Y, jc.init_v0(48, output_dim=3),
                     jc.CGLBConfig(max_error=1e-8, max_cg_iters=300,
                                   common_dtype="float64",
                                   precond_dtype="float64"))
    np.testing.assert_allclose(float(b), float(jb), rtol=1e-9)
    np.testing.assert_allclose(e, float(js.elbo(jp, X, Y)), rtol=1e-9)
    np.testing.assert_allclose(
        lml, float(jg.log_marginal_likelihood(jgp, X, Y)), rtol=1e-9)


def test_multioutput_predict_matches_gpr(rng):
    """CGLB's prediction at a converged v equals the dense GP's, per
    output; the variance is tiled over the outputs."""
    X, Y, _, (tp, tgp) = _setup_multi(rng)
    Xt, Yt = torch.tensor(X), torch.tensor(Y)
    Xs = torch.tensor(np.random.default_rng(3).normal(size=(7, 2)))
    cfg = tc.CGLBConfig(max_cg_iters=400, precond_dtype="float64")
    with torch.no_grad():
        mean_c, var_c = tc.predict_f(tp, Xt, Yt,
                                     tc.init_v0(48, 3, torch.float64), Xs,
                                     cfg, cg_tolerance=1e-12)
        mean_g, var_g = tg.predict_f(tgp, Xt, Yt, Xs)
    assert mean_c.shape == (7, 3) and var_c.shape == (7, 3)
    assert var_g.shape == (7, 3)
    np.testing.assert_allclose(mean_c.numpy(), mean_g.numpy(), rtol=1e-4,
                               atol=1e-6)
    assert torch.equal(var_c[:, 0], var_c[:, 2])
    assert torch.equal(var_g[:, 0], var_g[:, 1])


def test_multioutput_streaming_cg_is_one_batch(rng):
    """Above the streaming threshold the CG on a 3-output error is one
    kernel-1 batch of 3 rows a step, and gives the dense operator's loss."""
    X, Y, _, (tp, _) = _setup_multi(rng)
    Xt, Yt = torch.tensor(X), torch.tensor(Y)
    cfg = tc.CGLBConfig(max_error=1e-6, precond_dtype="float64")
    v0 = tc.init_v0(48, 3, torch.float64)
    batches = []
    real = tmv.matvec_unit

    def spy(rows, cols, p, accurate=True):
        batches.append(p.shape[0])
        return real(rows, cols, p, accurate)

    tmv.matvec_unit = spy
    try:
        with torch.no_grad():
            op = tmv.make_streaming_operator(tp.kernel, Xt,
                                             tp.noise_variance.value)
            got, aux = tc.loss(tp, Xt, Yt, v0, cfg, matvec=op)
    finally:
        tmv.matvec_unit = real
    with torch.no_grad():
        want, _ = tc.loss(tp, Xt, Yt, v0, cfg)
    assert batches and set(batches) == {3} and aux.v.shape == (3, 48)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-9)


@pytest.mark.parametrize("kind", ["cglb", "sgpr", "gpr", "exactgp"])
def test_multioutput_through_the_backend(rng, kind):
    """Y [N, 3] through create_model, two optimizer steps, metrics and
    prediction of each model kind."""
    tconfig.set_default_float("fp64")
    tconfig.set_default_jitter("fp64")
    X = rng.normal(size=(90, 2))
    Y = np.tanh(X @ rng.normal(size=(2, 3))) + 0.05 * rng.normal(size=(90, 3))
    train, test = (X[:60], Y[:60]), (X[60:], Y[60:])
    kernel, iv = tcfgs.Matern32Config(), tcfgs.InducingVariableConfig(8)
    cfg = {"cglb": tcfgs.CGLBConfig(kernel, iv),
           "sgpr": tcfgs.SGPRConfig(kernel, iv),
           "gpr": tcfgs.GPRConfig(kernel),
           "exactgp": tcfgs.ExactGPConfig(kernel)}[kind]
    backend = Torch(device="cpu")
    model = backend.create_model(cfg, train, seed=0)
    assert model.params.mean.c.value.shape == (3,)
    before = backend.metrics_fn(model, (train, test))()
    backend.optimize(model, None, 2, None,
                     "scipy" if kind in ("cglb", "sgpr") else "lbfgs")
    after = backend.metrics_fn(model, (train, test))()
    assert all(np.isfinite(v) for v in after.values())
    if kind != "exactgp":  # whose loss is a fresh stochastic estimate
        assert after["loss"] < before["loss"]
    mean, var = model.predict_f(test[0])
    assert mean.shape == (30, 3) and var.shape == (30, 3)
    if kind == "cglb":
        assert model.v0.shape == (3, 60)


def test_multioutput_lml_counts_the_logdet_per_output(rng):
    """D identical outputs: lml(Y tiled) = D lml(y), dense and iterative
    (shared probes), which holds only with the D log|Ky| term.  The
    iterative one to 1e-5: its CG stops on the error summed over the
    outputs, so three copies stop a step apart from one."""
    from cglb_tpu_torch.models import gpr_iterative as tit

    X, Y, _, (_, tgp) = _setup_multi(rng)
    Xt = torch.tensor(X)
    y1 = torch.tensor(Y[:, :1])
    one = tg.GPRParams(tgp.kernel, noise_variance=0.4, dtype=torch.float64)
    Z = tit.rademacher(tit.make_generator(0, "cpu"), (10, 48), torch.float64)
    with torch.no_grad():
        np.testing.assert_allclose(
            float(tg.log_marginal_likelihood(tgp, Xt, y1.expand(-1, 3))),
            3 * float(tg.log_marginal_likelihood(one, Xt, y1)), rtol=1e-12)
    a, _ = tit.iterative_lml(tgp, Xt, y1.expand(-1, 3).contiguous(), probes=Z)
    b, _ = tit.iterative_lml(one, Xt, y1, probes=Z)
    np.testing.assert_allclose(float(a.detach()), 3 * float(b.detach()),
                               rtol=1e-5)
