"""PyTorch port: the exact-GP leaves (``gpr -m gpr|exactgp``), ``gpr_metric``
and the ``lbfgs`` / ``lbfgs_native`` / ``staged`` optimizers from the CLI on
``--device cpu``, beside the JAX package's CLI."""

import torch_threads  # noqa: F401  (the test processes' torch thread cap)
import json
import subprocess
from pathlib import Path

import numpy as np
import pytest
from click.testing import CliRunner

from cglb_tpu.backend import Jax
from cglb_tpu.experiments.cli import main as jax_main
from cglb_tpu.utils import native as jax_native
from cglb_tpu_torch.experiments import cli as tcli
from cglb_tpu_torch.utils import serialization as tser

DATA = "synth_200x2"
NATIVE = Path(__file__).resolve().parent.parent / "native"


@pytest.fixture()
def no_local_data(monkeypatch, tmp_path):
    monkeypatch.setenv("CGLB_DATA_DIR", str(tmp_path / "no_data_here"))


@pytest.fixture(scope="module")
def jax_native_library(tmp_path_factory):
    """The JAX package's native library, built once for this module into a
    directory of its own (the Makefile's BUILD) and loaded from there.
    native/build is shared with every test process, which may be building
    it at the same moment in place (not atomically); a loader that reads it
    half-written stays failed for its process, and the JAX half of the
    lbfgs_native cases would then fail."""
    build = tmp_path_factory.mktemp("native_build")
    subprocess.run(["make", "-C", str(NATIVE), f"BUILD={build}"], check=True,
                   capture_output=True, timeout=300)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB_PATH", build / "libcglb_native.so")
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_load_failed", False)
        assert jax_native.native_available()
        yield


def _torch_cli(logdir, *tail):
    tcli.main(["-t", "fp64", "-l", str(logdir), "-s", "0", "--device", "cpu",
               "--common-dtype", "float64"] + list(tail))


def _jax_cli(logdir, *tail):
    try:
        r = CliRunner().invoke(
            jax_main, ["-b", "jax", "-t", "fp64", "-l", str(logdir), "-s",
                       "0", "--common-dtype", "float64"] + list(tail),
            catch_exceptions=False)
    finally:
        Jax.common_dtype = "mixed"  # class state persists in the process
    assert r.exit_code == 0, r.output


def _results(logdir):
    return json.loads((logdir / "results.json").read_text())


@pytest.mark.parametrize("optimizer,leaf", [
    ("staged", ["gpr", "-m", "gpr"]),
    ("adam_0.01", ["gpr", "-m", "gpr"]),
    ("lbfgs", ["gpr", "-m", "gpr"]),
    ("staged", ["gpr", "-m", "exactgp"]),
    ("adam_0.001", ["gpr", "-m", "exactgp"]),
    ("lbfgs", ["cglb", "-m", "cglb", "-i", "cv", "-M", "10"]),
    ("lbfgs_native", ["cglb", "-m", "cglb", "-i", "cv", "-M", "10"]),
    ("lbfgs_native", ["sgpr", "-m", "sgpr", "-i", "cv", "-M", "10"]),
])
def test_cli_exact_gp_and_lbfgs_write_the_jax_cli_keys(no_local_data,
                                                        jax_native_library,
                                                        tmp_path, optimizer,
                                                        leaf):
    """4 iterations through both CLIs with the exact-GP leaves and the
    L-BFGS optimizers: the same keys in results.json, logs.json and
    model.json.  The dense GP is deterministic and both staged schedules
    start alike, so its loss agrees to 1e-2 (the L-BFGS phases take
    different line searches); lbfgs_native drives the same C++ optimizer
    over a deterministic loss in both, 1e-6; the iterative GP's loss is a
    stochastic estimate from each package's own probes: finite, and within
    5 % of each other."""
    tail = ["train", "-n", "4", "-d", DATA, "-o", optimizer, *leaf, "-k",
            "Matern32"]
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    _jax_cli(jdir, *tail)
    _torch_cli(tdir, *tail)
    jres, tres = _results(jdir), _results(tdir)
    assert set(tres) == set(jres)
    assert set(json.loads((tdir / "logs.json").read_text())) == set(
        json.loads((jdir / "logs.json").read_text()))
    assert set(tser.load_model_params(tdir / "model.json")) == set(
        tser.load_model_params(jdir / "model.json"))
    assert all(np.isfinite(v) for v in tres.values() if isinstance(v, float))
    if leaf[0] == "gpr":
        assert {"lml", "loss", "test/rmse", "test/nlpd"} <= set(tres)
        assert tres["lml"] == -tres["loss"]
    rtol = {"gpr": 1e-2, "exactgp": 5e-2, "sgpr": 1e-6, "cglb": 2e-2}[leaf[2]]
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=rtol)
    np.testing.assert_allclose(tres["test/rmse"], jres["test/rmse"],
                               rtol=max(rtol, 1e-4))


def test_cli_gpr_metric_writes_gpr_metric_npy(no_local_data, tmp_path):
    """``gpr_metric -p model.json`` evaluates an exactgp run's parameters as
    a dense GP in both packages: gpr_metric.npy beside the parameter file,
    the same keys, lml to 1e-9 and the predictions to 1e-8; ``metric ... gpr
    -m exactgp -p`` writes metric.npy with the iterative estimate of the
    same lml."""
    _torch_cli(tmp_path / "run", "train", "-n", "3", "-d", DATA, "-o",
               "staged", "gpr", "-m", "exactgp", "-k", "Matern32")
    (tmp_path / "j").mkdir()
    params = tmp_path / "run" / "model.json"
    jparams = tmp_path / "j" / "model.json"
    jparams.write_text(params.read_text())
    gm = ["gpr_metric", "-d", DATA, "-k", "Matern32", "-p"]
    _torch_cli(tmp_path / "tm", *gm, str(params))
    _jax_cli(tmp_path / "jm", *gm, str(jparams))
    got = np.load(tmp_path / "run" / "gpr_metric.npy",
                  allow_pickle=True).item()
    want = np.load(tmp_path / "j" / "gpr_metric.npy",
                   allow_pickle=True).item()
    assert set(got) == set(want) and got["id"] == str(tmp_path / "run")
    np.testing.assert_allclose(got["lml"], want["lml"], rtol=1e-9)
    for key in ("train/rmse", "test/rmse", "train/nlpd", "test/nlpd"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-8)
    _torch_cli(tmp_path / "it", "metric", "-d", DATA, "gpr", "-m", "exactgp",
               "-k", "Matern32", "-p", str(params))
    it = np.load(tmp_path / "it" / "metric.npy", allow_pickle=True).item()
    assert set(it) == set(got)
    # SLQ with 10 probes at N = 134: within 5 % of the dense value
    np.testing.assert_allclose(it["lml"], got["lml"], rtol=5e-2)
    np.testing.assert_allclose(it["test/rmse"], got["test/rmse"], rtol=1e-3)
