"""PyTorch port: the fused Kuf builder's plain version (kernel 3 on the CPU)
and its autograd Function against the JAX package's Pallas builder in
interpret mode and against dense fp64.

Tolerances: 1e-10 on values against the Pallas df32 route (its own
contract); f32 grade (2e-5 * scale) on gradients against it, whose backward
runs in f32; 1e-12 on values and 1e-9 on gradients against dense fp64."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cglb_tpu.ops import kernels as jk
from cglb_tpu.ops import kuf_pallas as jkp
from cglb_tpu.transforms import Param as JParam
from cglb_tpu_torch.ops import kernels as tk
from cglb_tpu_torch.ops import kuf as tkuf

FAMILIES = ["Matern32", "SquaredExponential"]


def _setup(rng, family, m=32, n=96, d=4):
    ls = rng.uniform(0.5, 1.5, size=d)
    jkern = jk.make_kernel(family, d, dtype=np.float64)
    jkern = dataclasses.replace(
        jkern, variance=JParam.positive(1.3, lower=1e-6),
        lengthscales=JParam.positive(jnp.asarray(ls), lower=1e-6))
    tkern = tk.make_kernel(family, d, variance=1.3, lengthscales=ls,
                           dtype=torch.float64)
    Z = rng.normal(size=(m, d))
    X = rng.normal(size=(n, d))
    return jkern, tkern, Z, X


def _pallas(kern, Z, X):
    return jkp.kuf_build(kern, Z, jnp.asarray(X), block_m=32, block_n=64,
                         interpret=True)


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_matches_pallas_and_dense(rng, family):
    jkern, tkern, Z, X = _setup(rng, family)
    got = tkuf.kuf(tkern, torch.tensor(Z), torch.tensor(X)).detach().numpy()
    pallas = np.asarray(_pallas(jkern, jnp.asarray(Z), X))
    dense = np.asarray(jk.K(jkern, jnp.asarray(Z), jnp.asarray(X)))
    scale = np.max(np.abs(dense))
    assert np.max(np.abs(got - pallas)) / scale < 1e-10
    assert np.max(np.abs(got - dense)) / scale < 1e-12


@pytest.mark.parametrize("family", FAMILIES)
def test_backward_matches_pallas_and_dense(rng, family):
    jkern, tkern, Z, X = _setup(rng, family)
    W = rng.normal(size=(Z.shape[0], X.shape[0]))

    def loss_pallas(kern, Zv):
        return jnp.sum(W * _pallas(kern, Zv, X))

    def loss_dense(kern, Zv):
        return jnp.sum(W * jk.K(kern, Zv, jnp.asarray(X)))

    gp = jax.jit(jax.grad(loss_pallas, argnums=(0, 1)))(jkern, jnp.asarray(Z))
    gd = jax.jit(jax.grad(loss_dense, argnums=(0, 1)))(jkern, jnp.asarray(Z))

    Zt = torch.tensor(Z, requires_grad=True)
    torch.sum(torch.tensor(W) * tkuf.kuf(tkern, Zt, torch.tensor(X))
              ).backward()
    got = {"var": tkern.variance.raw.grad.numpy(),
           "ls": tkern.lengthscales.raw.grad.numpy(), "Z": Zt.grad.numpy()}
    for g, tol in ((gd, 1e-9), (gp, 2e-5)):
        want = {"var": np.asarray(g[0].variance.raw),
                "ls": np.asarray(g[0].lengthscales.raw),
                "Z": np.asarray(g[1])}
        for key in want:
            scale = np.max(np.abs(want[key]))
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=tol * scale, err_msg=key)


def test_x_cotangent_is_zero_and_coincident_points_exact(rng):
    _, tkern, Z, X = _setup(rng, "Matern32", m=8, n=24, d=3)
    X[:8] = Z  # exact duplicates: t = 0
    Xt = torch.tensor(X, requires_grad=True)
    out = tkuf.kuf(tkern, torch.tensor(Z), Xt)
    np.testing.assert_allclose(np.diag(out[:, :8].detach().numpy()), 1.3,
                               rtol=1e-14)
    out.sum().backward()
    assert Xt.grad is None or float(Xt.grad.abs().max()) == 0.0
    assert torch.isfinite(tkern.lengthscales.raw.grad).all()


def test_residual_e_only_when_a_gradient_is_needed(rng):
    _, tkern, Z, X = _setup(rng, "SquaredExponential", m=4, n=8, d=2)
    c = 1.0 / tkern.lengthscales.value.detach()
    kuf, e = tkuf.kuf_unit(torch.tensor(Z) * c, torch.tensor(X) * c,
                           torch.tensor(1.3, dtype=torch.float64), "rbf",
                           with_e=False)
    assert e is None and kuf.shape == (4, 8)
