"""PyTorch port: parameter transforms and dense kernels against the JAX
package, fp64 on the CPU, inputs from a seeded numpy generator."""

import torch_threads  # noqa: F401  (the test processes' torch thread cap)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cglb_tpu import transforms as jtr
from cglb_tpu.ops import kernels as jk
from cglb_tpu_torch import transforms as ttr
from cglb_tpu_torch.ops import kernels as tk

FAMILIES = ["Matern32", "SquaredExponential"]


def _pair(family, d, rng):
    ls = rng.uniform(0.5, 2.0, size=d)
    jkern = jk.make_kernel(family, d, variance=1.7, lengthscales=ls,
                           dtype=np.float64)
    tkern = tk.make_kernel(family, d, variance=1.7, lengthscales=ls,
                           dtype=torch.float64)
    return jkern, tkern


@pytest.mark.parametrize("family", FAMILIES)
def test_K_and_kdiag_match_jax(rng, family):
    X = rng.normal(size=(40, 3))
    Z = rng.normal(size=(17, 3))
    jkern, tkern = _pair(family, 3, rng)
    Xt, Zt = torch.tensor(X), torch.tensor(Z)
    np.testing.assert_allclose(tkern.K(Xt, Zt).detach().numpy(),
                               np.asarray(jk.K(jkern, jnp.asarray(X),
                                               jnp.asarray(Z))), rtol=1e-12)
    np.testing.assert_allclose(tkern.K(Xt).detach().numpy(),
                               np.asarray(jk.K(jkern, jnp.asarray(X))),
                               rtol=1e-12)
    np.testing.assert_allclose(tkern.kdiag(Xt).detach().numpy(),
                               np.asarray(jk.kdiag(jkern, jnp.asarray(X))),
                               rtol=1e-12)


def test_self_kernel_gradient_finite_at_zero_distance(rng):
    """The zeroed self-distance diagonal and the sqrt guard keep the
    lengthscale gradient finite at r = 0."""
    tkern = tk.make_kernel("Matern32", 2, dtype=torch.float64)
    X = torch.tensor(rng.normal(size=(10, 2)))
    tkern.K(X).sum().backward()
    assert torch.isfinite(tkern.lengthscales.raw.grad).all()


@pytest.mark.parametrize("x", [-30.0, -1.0, 0.0, 0.5, 19.0, 25.0, 60.0])
def test_softplus_matches_jax_beyond_threshold(x):
    """logaddexp form, not torch's softplus (identity above 20)."""
    got = ttr.softplus(torch.tensor(x, dtype=torch.float64))
    want = float(jtr.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(float(got), want, rtol=1e-15)
    y = torch.tensor(abs(x) + 1e-3, dtype=torch.float64)
    np.testing.assert_allclose(float(ttr.softplus(ttr.softplus_inverse(y))),
                               float(y), rtol=1e-12)


def test_param_trainable_flag_and_assign():
    p = ttr.Param.positive(torch.tensor([0.3, 2.0], dtype=torch.float64),
                           1e-6, trainable=False)
    assert not p.trainable and not p.raw.requires_grad
    p.assign(np.array([1.5, 4.0]))
    np.testing.assert_allclose(p.value.detach().numpy(), [1.5, 4.0],
                               rtol=1e-14)
