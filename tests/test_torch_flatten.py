"""PyTorch port: the flatten bridge of the scipy optimizers against the JAX
package's, element for element (fp64 on the CPU)."""

import torch_threads  # noqa: F401  (the test processes' torch thread cap)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cglb_tpu.models import cglb as jc
from cglb_tpu.models import sgpr as js
from cglb_tpu.ops import kernels as jk
from cglb_tpu.struct import replace as jreplace
from cglb_tpu.transforms import Param as JParam
from cglb_tpu.utils import flatten as jfl
from cglb_tpu.utils import training as jtr
from cglb_tpu_torch.models import cglb as tc
from cglb_tpu_torch.models import sgpr as ts
from cglb_tpu_torch.ops import kernels as tk
from cglb_tpu_torch.transforms import Param as TParam
from cglb_tpu_torch.utils import flatten as tfl
from cglb_tpu_torch.utils import training as ttr


def _pair(rng, n=60, d=3, m=7, joint=False):
    """The same SGPR parameters in both packages (and, with ``joint``, the
    same trainable v0), and the data."""
    X = rng.normal(size=(n, d))
    Y = np.sin(X[:, :1]) + 0.1 * rng.normal(size=(n, 1))
    Z = X[:m].copy()
    ls = rng.uniform(0.5, 2.0, size=d)
    jp = js.SGPRParams.create(
        jk.make_kernel("Matern32", d, variance=1.3, lengthscales=ls,
                       dtype=np.float64), Z, noise_variance=0.3,
        dtype=np.float64)
    tp = ts.SGPRParams(
        tk.make_kernel("Matern32", d, variance=1.3, lengthscales=ls,
                       dtype=torch.float64), Z, noise_variance=0.3,
        dtype=torch.float64)
    if joint:
        v0 = 0.1 * rng.normal(size=(1, n))
        jp = jreplace(jp, v0=JParam(raw=jnp.asarray(v0), trainable=True))
        tp.v0 = TParam(torch.tensor(v0), trainable=True)
    return jp, tp, X, Y


def _freeze(jp, tp):
    jp = jtr._freeze_inducing(jp)
    ttr._freeze_inducing(tp)
    return jp, tp


@pytest.mark.parametrize("joint", [False, True])
@pytest.mark.parametrize("frozen", [False, True])
def test_flatten_trainable_equals_jax(rng, joint, frozen):
    """Same order and values, 1e-12, before and after freezing the inducing
    points, with and without the jointly trained v0."""
    jp, tp, X, _ = _pair(rng, joint=joint)
    if frozen:
        jp, tp = _freeze(jp, tp)
    want = jfl.flatten_trainable(jp)
    got = tfl.flatten_trainable(tp)
    assert got.dtype == np.float64 and got.shape == want.shape
    size = 1 + 3 + (0 if frozen else 7 * 3) + 1 + 1 + (60 if joint else 0)
    assert got.shape == (size,)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    assert [n for n, _ in tp.named_params()] == [
        n for n, _ in jfl.tree_params(jp)]


@pytest.mark.parametrize("frozen", [False, True])
def test_unflatten_round_trip_equals_jax(rng, frozen):
    """A new vector lands in the same raw leaves in both packages; the
    port writes into the live module and leaves frozen raws alone."""
    jp, tp, _, _ = _pair(rng)
    z_before = tp.inducing_Z.raw.detach().clone()
    if frozen:
        jp, tp = _freeze(jp, tp)
    x = jfl.flatten_trainable(jp) + rng.normal(size=jfl.flatten_trainable(
        jp).shape)
    jp2 = jfl.make_unflatten(jp)(x)
    out = tfl.make_unflatten(tp)(x)
    assert out is tp
    np.testing.assert_array_equal(tfl.flatten_trainable(tp), x)
    jraw = {n: np.asarray(p.raw) for n, p in jfl.tree_params(jp2)}
    for name, p in tp.named_params():
        np.testing.assert_allclose(p.raw.detach().numpy(), jraw[name],
                                   rtol=1e-12, atol=1e-14, err_msg=name)
    assert torch.equal(tp.inducing_Z.raw, z_before) == frozen
    with pytest.raises(ValueError, match="trainable values"):
        tfl.make_unflatten(tp)(x[:-1])


@pytest.mark.parametrize("joint", [False, True])
@pytest.mark.parametrize("frozen", [False, True])
def test_gradient_vector_equals_jax(rng, joint, frozen):
    """flatten_grads_like of the CGLB loss gradient (no CG step: a huge
    max_error, or the external v): same order, 1e-7 of the largest entry
    (fp64 preconditioner on both sides)."""
    jp, tp, X, Y = _pair(rng, joint=joint)
    if frozen:
        jp, tp = _freeze(jp, tp)
    v = 0.05 * rng.normal(size=(1, X.shape[0]))
    settings = dict(max_error=1e30, precond_dtype="float64",
                    joint_optimization=joint)
    jcfg = jc.CGLBConfig(common_dtype="float64", **settings)

    def jloss(p):
        v0 = p.v0.value if joint else jnp.asarray(v)
        return jc.loss(p, jnp.asarray(X), jnp.asarray(Y), v0, jcfg)

    (_, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    want = jfl.flatten_grads_like(jp, jg)

    tv = tp.v0.value if joint else torch.tensor(v)
    loss, _ = tc.loss(tp, torch.tensor(X), torch.tensor(Y), tv,
                      tc.CGLBConfig(**settings))
    loss.backward()
    got = tfl.flatten_grads_like(tp)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-7 * np.max(np.abs(want)))
    if frozen:
        assert tp.inducing_Z.raw.grad is None


def test_flatten_grads_without_backward_gives_zeros(rng):
    _, tp, _, _ = _pair(rng)
    g = tfl.flatten_grads_like(tp)
    assert g.shape == tfl.flatten_trainable(tp).shape and not g.any()


def test_assign_parameters_warns_and_skips(rng):
    """Missing and unknown keys are warned about; known keys are assigned
    as constrained values (the raws equal the JAX package's)."""
    jp, tp, _, _ = _pair(rng)
    values = {".kernel.variance": np.asarray(2.5),
              ".noise_variance": np.asarray(0.05),
              ".not_a_parameter": np.zeros(2)}
    with pytest.warns(UserWarning) as record:
        tfl.assign_parameters(tp, values)
    text = " ".join(str(w.message) for w in record)
    assert "Cannot load" in text and ".inducing_Z" in text
    assert "Ignoring unknown" in text and ".not_a_parameter" in text
    with pytest.warns(UserWarning):
        jp = jfl.assign_parameters(jp, {k: values[k] for k in list(values)[:2]})
    out = tp.parameter_dict()
    np.testing.assert_allclose(out[".kernel.variance"], 2.5, rtol=1e-12)
    np.testing.assert_allclose(out[".noise_variance"], 0.05, rtol=1e-12)
    np.testing.assert_allclose(tfl.flatten_trainable(tp),
                               jfl.flatten_trainable(jp), rtol=1e-12,
                               atol=1e-14)
