"""PyTorch port: inducing-point selection, datasets, the parameter bridge to
the JAX package, and a short CLI run of both packages side by side."""

import torch_threads  # noqa: F401  (the test processes' torch thread cap)
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from cglb_tpu.experiments import datasets as jds
from cglb_tpu.ops import kernels as jk
from cglb_tpu.utils import flatten as jfl
from cglb_tpu.utils import inducing as jind
from cglb_tpu_torch.experiments import datasets as tds
from cglb_tpu_torch.models import sgpr as ts
from cglb_tpu_torch.ops import kernels as tk
from cglb_tpu_torch.utils import inducing as tind
from cglb_tpu_torch.utils import serialization as tser
from cglb_tpu_torch.utils.flatten import assign_parameters

ANCHOR = "runs/kin40k-2000-scipy4-r4/model.json"


@pytest.fixture()
def no_local_data(monkeypatch, tmp_path):
    monkeypatch.setenv("CGLB_DATA_DIR", str(tmp_path / "no_data_here"))


@pytest.mark.parametrize("family", ["Matern32", "SquaredExponential"])
def test_conditional_variance_same_indices(rng, family):
    X = rng.normal(size=(400, 3))
    ls = rng.uniform(0.5, 2.0, size=3)
    jkern = jk.make_kernel(family, 3, lengthscales=ls, dtype=np.float64)
    tkern = tk.make_kernel(family, 3, lengthscales=ls, dtype=torch.float64)
    _, want = jind.conditional_variance_numpy(
        X, 40, lambda A: np.asarray(jk.kdiag(jkern, jnp.asarray(A))),
        lambda A, z: np.asarray(jk.K(jkern, jnp.asarray(A), jnp.asarray(z))),
        seed=3)
    Z, got = tind.conditional_variance(torch.tensor(X), 40, tkern, seed=3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(Z.numpy(), X[want])


def test_kin40k_stand_in_bit_for_bit(no_local_data):
    a = jds.get_dataset("Wilson_kin40k", split=0)
    b = tds.get_dataset("Wilson_kin40k", split=0)
    assert a.synthetic and b.synthetic and a.name == b.name
    for x, y in zip(a.train + a.test, b.train + b.test):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()
    assert b.train[0].shape == (26800, 8)


def test_from_jax_parameter_dict_on_tpu_run():
    """The TPU run's model.json loads into a port model, and the port's
    parameter_dict writes it back (same keys, same constrained values);
    the raw values equal the JAX package's assign_parameters."""
    saved = tser.load_model_params(ANCHOR)
    params = ts.SGPRParams(tk.Matern32(8, dtype=torch.float64),
                           np.zeros((2048, 8)), dtype=torch.float64)
    assign_parameters(params, saved)
    out = params.parameter_dict()
    assert list(out) == [".kernel.variance", ".kernel.lengthscales",
                         ".inducing_Z", ".noise_variance", ".mean.c"]
    assert set(out) == set(saved)
    for k in saved:
        np.testing.assert_allclose(out[k], saved[k], rtol=1e-12, err_msg=k)

    from cglb_tpu.models import sgpr as js

    jp = js.SGPRParams.create(jk.make_kernel("Matern32", 8,
                                             dtype=np.float64),
                              np.zeros((2048, 8)), dtype=np.float64)
    jp = jfl.assign_parameters(jp, saved)
    jraw = {name: np.asarray(p.raw) for name, p in jfl.tree_params(jp)}
    for name, p in params.named_params():
        np.testing.assert_allclose(p.raw.detach().numpy(), jraw[name],
                                   rtol=1e-12, atol=1e-14, err_msg=name)


def test_cli_adam_matches_jax_cli(no_local_data, tmp_path):
    """3 Adam steps on synth_300x2 through both CLIs (--common-dtype
    float64; the port with --device cpu): same results.json keys, and the
    trained parameters within 1e-6."""
    from cglb_tpu.backend import Jax
    from cglb_tpu.experiments.cli import main as jax_main
    from cglb_tpu_torch.experiments import cli as tcli

    tail = ["train", "-n", "3", "-d", "synth_300x2", "-o", "adam_0.01",
            "cglb", "-m", "cglb", "-k", "Matern32", "-i", "cv", "-M", "12"]
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    try:
        r = CliRunner().invoke(
            jax_main, ["-b", "jax", "-t", "fp64", "-l", str(jdir), "-s", "0",
                       "--common-dtype", "float64"] + tail,
            catch_exceptions=False)
    finally:
        Jax.common_dtype = "mixed"  # class state persists in the process
    assert r.exit_code == 0, r.output
    tcli.main(["-t", "fp64", "-l", str(tdir), "-s", "0", "--device", "cpu",
               "--common-dtype", "float64"] + tail)

    jres = json.loads((jdir / "results.json").read_text())
    tres = json.loads((tdir / "results.json").read_text())
    assert set(jres) == set(tres)
    assert tres["data"] == "synthetic"
    for k in ("elbo", "titsias_upper_bound", "cg_lower_bound", "test/rmse"):
        np.testing.assert_allclose(tres[k], jres[k], rtol=1e-6, err_msg=k)
    assert set(json.loads((tdir / "logs.json").read_text())) == set(
        json.loads((jdir / "logs.json").read_text()))
    jm = tser.load_model_params(jdir / "model.json")
    tm = tser.load_model_params(tdir / "model.json")
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=0, atol=1e-6,
                                   err_msg=k)
