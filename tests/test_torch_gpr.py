"""PyTorch port: the dense exact GP (models/gpr.py) and the preconditioner's
inverse and square-root applies against the JAX package, fp64 on the CPU,
inputs from a numpy seed through both."""

import torch_threads  # noqa: F401  (the test processes' torch thread cap)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cglb_tpu.models import gpr as jg
from cglb_tpu.ops import kernels as jk
from cglb_tpu.ops import preconditioners as jpc
from cglb_tpu_torch.backend import Torch
from cglb_tpu_torch.models import gpr as tg
from cglb_tpu_torch.ops import kernels as tk
from cglb_tpu_torch.ops import preconditioners as tpc

FAMILIES = ["Matern32", "SquaredExponential"]


def _data(rng, n=120, d=3, out=1):
    X = rng.normal(size=(n, d))
    W = rng.normal(size=(d, out))
    Y = np.tanh(X @ W) + 0.1 * rng.normal(size=(n, out))
    return X, Y


def _params(family, d, out=1, var=1.3, noise=0.3, c=None):
    ls = np.linspace(0.7, 1.4, d)
    jp = jg.GPRParams.create(
        jk.make_kernel(family, d, variance=var, lengthscales=ls,
                       dtype=np.float64),
        noise_variance=noise, output_dim=out, dtype=np.float64)
    tp = tg.GPRParams(
        tk.make_kernel(family, d, variance=var, lengthscales=ls,
                       dtype=torch.float64),
        noise_variance=noise, output_dim=out, dtype=torch.float64)
    if c is not None:
        from cglb_tpu.utils import flatten as jfl

        tp.mean.c.assign(np.asarray(c))
        jp = jfl.assign_parameters(jp, tp.parameter_dict())
    return jp, tp


def _jax_grads(g):
    return {".kernel.variance": g.kernel.variance.raw,
            ".kernel.lengthscales": g.kernel.lengthscales.raw,
            ".noise_variance": g.noise_variance.raw, ".mean.c": g.mean.c.raw}


def _assert_grads(tp, jgrads, rtol):
    """Raw-parameter gradients, each relative to its largest entry."""
    for name, p in tp.named_params():
        want = np.asarray(_jax_grads(jgrads)[name])
        scale = max(np.abs(want).max(), 1e-12)
        np.testing.assert_allclose(p.raw.grad.numpy() / scale, want / scale,
                                   rtol=0, atol=rtol, err_msg=name)


def test_parameter_names_are_the_reference_model_json():
    _, tp = _params("Matern32", 8)
    assert list(tp.parameter_dict()) == [
        ".kernel.variance", ".kernel.lengthscales", ".noise_variance",
        ".mean.c"]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("out", [1, 3])
def test_lml_and_gradient_match_jax(rng, family, out):
    """Value to 1e-10 relative, raw gradients to 1e-7 of their scale."""
    X, Y = _data(rng, out=out)
    jp, tp = _params(family, 3, out, c=0.2 * np.arange(1, out + 1))
    want, jgrads = jax.value_and_grad(
        lambda p: jg.log_marginal_likelihood(p, X, Y))(jp)
    got = tg.log_marginal_likelihood(tp, torch.tensor(X), torch.tensor(Y))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-10)
    _assert_grads(tp, jgrads, 1e-7)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("full_cov", [False, True])
def test_predict_f_and_gradient_match_jax(rng, family, full_cov):
    """Mean and (co)variance to 1e-10 of their scale; the gradient of a
    weighted sum of both to 1e-7."""
    X, Y = _data(rng, out=2)
    Xs = rng.normal(size=(9, 3))
    wm = rng.normal(size=(9, 2))
    wv = rng.normal(size=(9, 9) if full_cov else (9, 2))
    jp, tp = _params(family, 3, 2, c=[0.3, -0.1])

    def jax_fn(p):
        m, v = jg.predict_f(p, X, Y, Xs, full_cov=full_cov)
        return jnp.sum(wm * m) + jnp.sum(wv * v), (m, v)

    (_, (jm, jv)), jgrads = jax.value_and_grad(jax_fn, has_aux=True)(jp)
    tm, tv = tg.predict_f(tp, torch.tensor(X), torch.tensor(Y),
                          torch.tensor(Xs), full_cov=full_cov)
    assert tm.shape == (9, 2)
    assert tv.shape == ((9, 9) if full_cov else (9, 2))
    (torch.sum(torch.tensor(wm) * tm)
     + torch.sum(torch.tensor(wv) * tv)).backward()
    np.testing.assert_allclose(tm.detach().numpy(), np.asarray(jm),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                               rtol=0, atol=1e-10)
    _assert_grads(tp, jgrads, 1e-7)


def test_predict_log_density_matches_jax(rng):
    X, Y = _data(rng, out=2)
    Xs, Ys = _data(np.random.default_rng(5), n=11, out=2)
    jp, tp = _params("Matern32", 3, 2)
    want = jg.gpr_predict_log_density(jp, X, Y, Xs, Ys)
    with torch.no_grad():
        got = tg.gpr_predict_log_density(tp, *map(torch.tensor,
                                                  (X, Y, Xs, Ys)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)


def test_backend_batched_predict_matches_unbatched(monkeypatch, tmp_path):
    """Model.predict_f_batched over batches of 17 rows equals one batch
    (tests/test_baseline_gpr.py's check), and the dense batch rule holds a
    batch's K(batch, X) to 1 GiB."""
    from cglb_tpu_torch import config as tconfig
    from cglb_tpu_torch import configs as tcfgs
    from cglb_tpu_torch.experiments.datasets import get_dataset

    monkeypatch.setenv("CGLB_DATA_DIR", str(tmp_path / "no_data_here"))
    tconfig.set_default_float("fp64")
    bundle = get_dataset("synth_300x3", dtype=np.float64)
    model = Torch(device="cpu").create_model(
        tcfgs.GPRConfig(tcfgs.Matern32Config()), bundle.train, seed=0)
    assert model.kind == "gpr"
    m1, v1 = model.predict_f(bundle.test[0])
    m2, v2 = model.predict_f_batched(bundle.test[0], batch_size=17)
    torch.testing.assert_close(m1, m2, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(v1, v2, rtol=1e-10, atol=1e-12)
    assert model.default_predict_batch() == 100_000
    model.data = (torch.empty(26800, 8), model.data[1])
    assert model.default_predict_batch() == (1 << 30) // (8 * 26800) == 5008


def _nystrom(rng, n=40, m=8, sigma_sq=0.4):
    U = rng.normal(size=(n, m))
    A = (U / np.sqrt(sigma_sq)).T  # [m, n]
    LB = np.linalg.cholesky(A @ A.T + np.eye(m))
    jP = jpc.NystromPreconditioner(A=jnp.asarray(A), LB=jnp.asarray(LB),
                                   sigma_sq=jnp.asarray(sigma_sq))
    tP = tpc.NystromPreconditioner(
        A=torch.tensor(A), LB=torch.tensor(LB),
        sigma_sq=torch.tensor(sigma_sq, dtype=torch.float64))
    return A, jP, tP


def test_sqrt_factor_consistency(rng):
    """S S^T r == (Qff + s2 I) r for the square-root factor, as
    tests/test_baseline_gpr.py holds the JAX functions, and both equal
    theirs to 1e-12 of their scale."""
    A, jP, tP = _nystrom(rng)
    r = rng.normal(size=(2, 40))
    St_r = np.sqrt(0.4) * np.concatenate([(A @ r.T).T, r], axis=1)
    got = tpc.sqrt_factor_mat_vec(tP, torch.tensor(St_r)).numpy()
    want = tpc.inv_mat_vec(tP, torch.tensor(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-11)
    atol = 1e-12 * np.abs(want).max()
    np.testing.assert_allclose(
        got, np.asarray(jpc.sqrt_factor_mat_vec(jP, jnp.asarray(St_r))),
        rtol=0, atol=atol)
    np.testing.assert_allclose(
        want, np.asarray(jpc.inv_mat_vec(jP, jnp.asarray(r))), rtol=0,
        atol=atol)


def test_inv_mat_vec_inverts_mat_vec(rng):
    _, _, tP = _nystrom(rng)
    r = torch.tensor(rng.normal(size=(3, 40)))
    z, _ = tpc.mat_vec(tP, r)
    torch.testing.assert_close(tpc.inv_mat_vec(tP, z), r, rtol=1e-10,
                               atol=1e-12)


def test_identity_preconditioner_matches_jax(rng):
    r = rng.normal(size=(3, 25))
    z, rz = tpc.mat_vec(tpc.IdentityPreconditioner(), torch.tensor(r))
    jz, jrz = jpc.mat_vec(jpc.IdentityPreconditioner(), jnp.asarray(r))
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    np.testing.assert_allclose(rz.numpy(), np.asarray(jrz), rtol=1e-15)
    with pytest.raises(NotImplementedError):
        tpc.mat_vec(object(), torch.tensor(r))
