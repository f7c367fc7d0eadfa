"""PyTorch port: the streaming matvec's plain version (kernels 1 and 2 on the
CPU) and its autograd Function against the JAX package's Pallas kernels in
interpret mode and against dense fp64 autodiff.

Tolerances: 5e-5 * scale against interpret mode, whose bf16-split distance
matmul is the TPU kernel's own accuracy contract (tests/test_matvec_pallas);
1e-9 against dense fp64, since the plain version runs in fp64."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cglb_tpu.ops import kernels as jk
from cglb_tpu.ops import matvec_pallas as jmv
from cglb_tpu.transforms import Param as JParam
from cglb_tpu_torch.ops import kernels as tk
from cglb_tpu_torch.ops import matvec as tmv

FAMILIES = [("Matern32", "mat32"), ("SquaredExponential", "rbf")]


def _kernels(name, d, rng):
    ls = rng.uniform(0.5, 2.0, size=d)
    jkern = jk.make_kernel(name, d, dtype=np.float64)
    jkern = dataclasses.replace(
        jkern, variance=JParam.positive(1.7, lower=1e-6),
        lengthscales=JParam.positive(jnp.asarray(ls), lower=1e-6))
    tkern = tk.make_kernel(name, d, variance=1.7, lengthscales=ls,
                           dtype=torch.float64)
    return jkern, tkern


@pytest.mark.parametrize("name,family", FAMILIES)
def test_plain_matvec_matches_pallas_and_dense(rng, name, family):
    n, d = 200, 4
    X = rng.normal(size=(n, d))
    p = rng.normal(size=(2, n))
    jkern, tkern = _kernels(name, d, rng)
    got = tmv.kernel_matvec(tkern, torch.tensor(X), torch.tensor(p))
    got = got.detach().numpy()
    pallas = np.asarray(jmv.kernel_matvec(jkern, jnp.asarray(X),
                                          jnp.asarray(p), 128, 128,
                                          interpret=True))
    dense = np.asarray(jnp.asarray(p) @ jk.K(jkern, jnp.asarray(X)))
    scale = np.max(np.abs(dense))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=5e-5 * scale)
    np.testing.assert_allclose(got, dense, rtol=0, atol=1e-9 * scale)


@pytest.mark.parametrize("name,family", FAMILIES)
def test_plain_cross_matvec_matches_pallas_and_dense(rng, name, family):
    nr, nc, d = 150, 90, 3
    Xr, Xc = rng.normal(size=(nr, d)), rng.normal(size=(nc, d))
    p = rng.normal(size=(1, nr))
    jkern, tkern = _kernels(name, d, rng)
    got = tmv.kernel_cross_matvec(tkern, torch.tensor(Xr), torch.tensor(Xc),
                                  torch.tensor(p)).detach().numpy()
    pallas = np.asarray(jmv.kernel_cross_matvec(
        jkern, jnp.asarray(Xr), jnp.asarray(Xc), jnp.asarray(p), 64, 64,
        interpret=True))
    dense = np.asarray(jnp.asarray(p) @ jk.K(jkern, jnp.asarray(Xr),
                                             jnp.asarray(Xc)))
    scale = np.max(np.abs(dense))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=5e-5 * scale)
    np.testing.assert_allclose(got, dense, rtol=0, atol=1e-9 * scale)


@pytest.mark.parametrize("name,family", FAMILIES)
def test_function_backward_matches_pallas_and_dense(rng, name, family):
    """dp, dvar, dls of the Function (kernel 1 swapped for dp, kernel 2
    for dls) vs the Pallas custom_vjp and vs dense fp64 autodiff, on the
    raw parameters."""
    n, d = 160, 4
    X = rng.normal(size=(n, d))
    p = rng.normal(size=(1, n))
    w = rng.normal(size=(1, n))
    jkern, tkern = _kernels(name, d, rng)

    def f_pallas(kern, pv):
        out = jmv.kernel_matvec(kern, jnp.asarray(X), pv, 128, 128,
                                interpret=True)
        return jnp.sum(out * w)

    def f_dense(kern, pv):
        return jnp.sum((pv @ jk.K(kern, jnp.asarray(X))) * w)

    gp = jax.jit(jax.grad(f_pallas, argnums=(0, 1)))(jkern, jnp.asarray(p))
    gd = jax.jit(jax.grad(f_dense, argnums=(0, 1)))(jkern, jnp.asarray(p))

    pt = torch.tensor(p, requires_grad=True)
    out = tmv.kernel_matvec(tkern, torch.tensor(X), pt)
    torch.sum(out * torch.tensor(w)).backward()
    got = {"var": tkern.variance.raw.grad.numpy(),
           "ls": tkern.lengthscales.raw.grad.numpy(), "p": pt.grad.numpy()}
    for g, tol in ((gd, 1e-9), (gp, 5e-5)):
        want = {"var": np.asarray(g[0].variance.raw),
                "ls": np.asarray(g[0].lengthscales.raw),
                "p": np.asarray(g[1])}
        for key in want:
            scale = np.max(np.abs(want[key]))
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=tol * scale, err_msg=key)


def test_operator_pair_adds_noise_and_shares_prep(rng):
    n, d = 120, 3
    X = torch.tensor(rng.normal(size=(n, d)))
    p = torch.tensor(rng.normal(size=(1, n)))
    tkern = tk.make_kernel("Matern32", d, variance=1.3, dtype=torch.float64)
    acc, cg = tmv.make_streaming_operator_pair(tkern, X, 0.37)
    dense = p @ (tkern.K(X) + 0.37 * torch.eye(n, dtype=torch.float64))
    for op in (acc, cg):
        torch.testing.assert_close(op(p).detach(), dense.detach(), rtol=0,
                                   atol=1e-10)


def test_plain_ls_grad_matches_finite_difference(rng):
    """Kernel 2's plain version against a central difference of the plain
    matvec in the lengthscales (independent of any autodiff)."""
    n, d = 60, 3
    X = torch.tensor(rng.normal(size=(n, d)))
    p = torch.tensor(rng.normal(size=(1, n)))
    g = torch.tensor(rng.normal(size=(1, n)))
    ls = torch.tensor(rng.uniform(0.7, 1.5, size=d))
    rows = tmv.Prepared(X, ls, "mat32")
    acc = tmv.ls_grad_unit(rows, rows, p, g) * (-2.0 / (3.0 * ls))
    eps = 1e-6
    for k in range(d):
        dl = torch.zeros(d, dtype=torch.float64)
        dl[k] = eps
        f = [torch.sum(g * tmv.matvec_unit(tmv.Prepared(X, ls + s * dl,
                                                        "mat32"),
                                           tmv.Prepared(X, ls + s * dl,
                                                        "mat32"), p))
             for s in (1.0, -1.0)]
        fd = (f[0] - f[1]) / (2 * eps)
        np.testing.assert_allclose(float(acc[k]), float(fd), rtol=1e-6)


def test_kernel_shape_limits():
    with pytest.raises(ValueError):
        tmv._dpad(33)
    with pytest.raises(ValueError):
        tmv._bpad(9)
    assert [tmv._bpad(b) for b in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
