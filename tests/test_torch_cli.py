"""PyTorch port: the CLI's new leaves, optimizers, checkpoints and the
``metric`` and ``baseline`` commands on ``--device cpu``, beside the JAX
package's CLI, and checkpoints exchanged between the two packages."""

import torch_threads  # noqa: F401  (the test processes' torch thread cap)
import json

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from cglb_tpu.backend import Jax
from cglb_tpu.experiments.cli import main as jax_main
from cglb_tpu_torch.backend import Torch
from cglb_tpu_torch.experiments import cli as tcli
from cglb_tpu_torch.utils import serialization as tser

DATA = "synth_200x2"
MODEL = ["-k", "Matern32", "-i", "cv", "-M", "10"]


@pytest.fixture()
def no_local_data(monkeypatch, tmp_path):
    monkeypatch.setenv("CGLB_DATA_DIR", str(tmp_path / "no_data_here"))


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


@pytest.mark.parametrize("optimizer,leaf,flags", [
    ("scipy", "cglb", []),
    ("scipy4", "cglb", []),
    ("scipy_tol", "cglb", []),
    ("scipy", "cglbn2m", []),
    ("scipy", "cglbnm2", []),
    ("scipy4", "sgpr", []),
    ("scipy", "sgprn2m", []),
    ("scipy", "cglb", ["--vjoint"]),
    ("scipy_tol", "cglb", ["--vzero"]),
    ("adam_0.01", "cglbnm2", []),
])
def test_cli_writes_the_jax_cli_keys(no_local_data, tmp_path, optimizer,
                                     leaf, flags):
    """6 iterations through both CLIs: the same keys in results.json (the
    opt/* diagnostics and the cg/*_train_* summaries of the per-feval series
    included) and logs.json, the same iteration and evaluation counts where
    the loss has no CG, and the final loss within 1e-3 relative."""
    tail = ["train", "-n", "6", "-d", DATA, "-o", optimizer, leaf, "-m",
            leaf] + MODEL + flags
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    _jax_cli(jdir, *tail)
    _torch_cli(tdir, *tail)
    jres, tres = _results(jdir), _results(tdir)
    assert set(tres) == set(jres)
    assert set(json.loads((tdir / "logs.json").read_text())) == set(
        json.loads((jdir / "logs.json").read_text()))
    assert all(np.isfinite(v) for v in tres.values() if isinstance(v, float))
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=1e-3)
    if optimizer.startswith("scipy"):
        assert tres["opt/num_iters"] == 6
        no_cg = leaf.startswith("sgpr") or flags
        if no_cg:
            assert tres["opt/num_fevals"] == jres["opt/num_fevals"]
            np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=1e-6)
    if leaf.startswith("cglb"):
        assert "cg/steps_train_median" in tres
        assert tres["elbo"] <= tres["titsias_upper_bound"]
    if optimizer.startswith("scipy") and leaf.startswith("cglb"):
        # the summaries come from the per-feval series, one entry a feval
        logs = json.loads((tdir / "logs.json").read_text())
        series = logs["cg/steps-per-feval"]
        assert len(series) == tres["opt/num_fevals"]
        assert tres["cg/steps_train_max"] == max(series)
        assert tres["cg/steps_train_mean"] == pytest.approx(np.mean(series))
    model = tser.load_model_params(tdir / "model.json")
    assert (".v0" in model) == (flags == ["--vjoint"])


def test_cli_vjoint_trains_v0(no_local_data, tmp_path):
    _torch_cli(tmp_path, "train", "-n", "5", "-d", DATA, "-o", "scipy",
               "cglb", "-m", "cglb", *MODEL, "--vjoint")
    v0 = tser.load_model_params(tmp_path / "model.json")[".v0"]
    assert v0.shape == (1, 134) and np.abs(v0).max() > 0
    res = _results(tmp_path)
    assert res["cg/steps"] == 0 and res["cg/steps_train_max"] == 0


def test_cli_metric_writes_metric_npy(no_local_data, tmp_path):
    """``metric ... -p model.json`` evaluates the saved parameters: the same
    keys as the JAX CLI's metric.npy, and the numbers of the training run's
    results.json (the CGLB bound within twice the CG tolerance 1.0)."""
    train = ["train", "-n", "5", "-d", DATA, "-o", "scipy", "cglb", "-m",
             "cglb"] + MODEL
    _torch_cli(tmp_path / "run", *train)
    params = str(tmp_path / "run" / "model.json")
    metric = ["metric", "-d", DATA, "cglb", "-m", "cglb"] + MODEL + [
        "-p", params]
    _torch_cli(tmp_path / "tm", *metric)
    _jax_cli(tmp_path / "jm", *metric)
    got = np.load(tmp_path / "tm" / "metric.npy", allow_pickle=True).item()
    want = np.load(tmp_path / "jm" / "metric.npy", allow_pickle=True).item()
    assert set(got) == set(want)
    assert got["id"] == str(tmp_path / "tm") and got["data"] == "synthetic"
    run = _results(tmp_path / "run")
    for key in ("elbo", "titsias_upper_bound"):
        np.testing.assert_allclose(got[key], run[key], rtol=1e-9)
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9)
    # the predictions solve for v to 1e-3 from a cold start here and from
    # the training run's warm start there
    for key in ("test/rmse", "test/nlpd"):
        np.testing.assert_allclose(got[key], run[key], rtol=5e-3)
        np.testing.assert_allclose(got[key], want[key], rtol=5e-3)
    assert abs(got["cg_lower_bound"] - want["cg_lower_bound"]) <= 2.0


@pytest.mark.parametrize("which", ["mean", "linear"])
def test_cli_baseline_equals_jax(no_local_data, tmp_path, which):
    """Needs no device: runs with the default --device on a machine
    without CUDA."""
    tcli.main(["-l", str(tmp_path / "t"), "baseline", "-d", DATA, which])
    _jax_cli(tmp_path / "j", "baseline", "-d", DATA, which)
    got, want = _results(tmp_path / "t"), _results(tmp_path / "j")
    assert set(got) == set(want) and got["id"] == which
    for key in ("lml", "test/rmse", "test/nlpd"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12)


def test_cli_checkpoint_and_resume(no_local_data, tmp_path):
    """-n 6 --ckpt-every 2 leaves a checkpoint at iteration 6 with the CG
    warm start; --resume -n 10 then runs at most 4 more iterations, from
    the saved parameters and v0."""
    leaf = ["cglb", "-m", "cglb"] + MODEL
    _torch_cli(tmp_path, "train", "-n", "6", "-d", DATA, "-o", "scipy",
               "--ckpt-every", "2", *leaf)
    ckpt = tser.load_checkpoint(tmp_path / "checkpoint.json")
    assert ckpt["extra"] == {"kind": "cglb", "iters_done": 6}
    assert ckpt["v0"].shape == (1, 134) and np.abs(ckpt["v0"]).max() > 0
    first = _results(tmp_path)
    assert first["opt/num_iters"] == 6
    saved = tser.load_model_params(tmp_path / "model.json")
    for key, value in ckpt["params"].items():
        np.testing.assert_array_equal(value, saved[key])

    seen = {}
    real = Torch.optimize.__func__

    def spy(cls, model, datasets, num_steps, *args, **kw):
        seen.update(num_steps=num_steps, v0=model.v0.clone(),
                    offset=kw["checkpoint_offset"],
                    Z=model.params.inducing_Z.value.detach().clone())
        return real(cls, model, datasets, num_steps, *args, **kw)

    Torch.optimize = classmethod(spy)
    try:
        _torch_cli(tmp_path, "train", "-n", "10", "-d", DATA, "-o", "scipy",
                   "--ckpt-every", "2", "--resume", *leaf)
    finally:
        Torch.optimize = classmethod(real)
    assert seen["num_steps"] == 4 and seen["offset"] == 6
    np.testing.assert_array_equal(seen["v0"].numpy(), ckpt["v0"])
    np.testing.assert_allclose(seen["Z"].numpy(),
                               ckpt["params"][".inducing_Z"], rtol=1e-12)
    second = _results(tmp_path)
    assert second["opt/num_iters"] <= 4
    assert second["loss"] <= first["loss"] + 1e-6
    again = tser.load_checkpoint(tmp_path / "checkpoint.json")
    assert again["extra"]["iters_done"] == 6 + second["opt/num_iters"] // 2 * 2
    # a budget already spent runs nothing more
    _torch_cli(tmp_path, "train", "-n", "6", "-d", DATA, "-o", "scipy",
               "--resume", *leaf)
    assert _results(tmp_path)["opt/num_iters"] == 0


def test_cli_scipy_tol_checkpoint_carries_the_level(no_local_data, tmp_path):
    leaf = ["cglb", "-m", "cglb"] + MODEL
    _torch_cli(tmp_path, "train", "-n", "4", "-d", DATA, "-o", "scipy_tol",
               "--ckpt-every", "1", *leaf)
    ckpt = tser.load_checkpoint(tmp_path / "checkpoint.json")
    assert ckpt["extra"]["max_error"] == 1.0
    # a resumed run re-enters the schedule at the saved level
    path = tmp_path / "checkpoint.json"
    ckpt["extra"]["max_error"] = 0.1
    tser.dump_json(ckpt, path)
    _torch_cli(tmp_path, "train", "-n", "7", "-d", DATA, "-o", "scipy_tol",
               "--resume", *leaf)
    levels = _results(tmp_path)["opt/levels"]
    assert levels[0]["max_error"] == 0.1


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("flags", [[], ["--vjoint"]])
def test_checkpoint_written_by_one_package_loads_in_the_other(
        no_local_data, tmp_path, writer, flags):
    """checkpoint.json has one schema: ``params`` (constrained values under
    the dotted names), ``v0`` and ``extra`` (kind, iters_done).  A 4-step run
    of one CLI with --ckpt-every 2 is resumed by the other with -n 4, which
    then has no budget left and reports the loaded state: the same loss."""
    leaf = ["cglb", "-m", "cglb"] + MODEL + flags
    train = ["train", "-n", "4", "-d", DATA, "-o", "scipy", "--ckpt-every",
             "2"]
    write, read = ((_jax_cli, _torch_cli) if writer == "jax"
                   else (_torch_cli, _jax_cli))
    write(tmp_path, *train, *leaf)
    first = _results(tmp_path)
    ckpt = tser.load_checkpoint(tmp_path / "checkpoint.json")
    assert set(ckpt) == {"params", "v0", "extra"}
    assert ckpt["extra"] == {"kind": "cglb", "iters_done": 4}
    assert (".v0" in ckpt["params"]) == bool(flags)
    read(tmp_path, *train, "--resume", *leaf)
    second = _results(tmp_path)
    assert second["opt/num_iters"] == 0
    for key in ("elbo", "titsias_upper_bound", "test/rmse"):
        np.testing.assert_allclose(second[key], first[key], rtol=1e-6)
    np.testing.assert_allclose(second["loss"], first["loss"], rtol=1e-4)


def test_backend_checkpoint_round_trip(no_local_data, tmp_path):
    from cglb_tpu_torch import config as tconfig
    from cglb_tpu_torch import configs as tcfgs
    from cglb_tpu_torch.experiments.datasets import get_dataset

    tconfig.set_default_float("fp64")
    tconfig.set_default_jitter("fp64")
    backend = Torch(device="cpu")
    data = get_dataset(DATA, dtype=np.float64).train
    cfg = tcfgs.CGLBConfig(tcfgs.Matern32Config(),
                           tcfgs.InducingVariableConfig(8), 0.5)
    a = backend.create_model(cfg, data, seed=0)
    backend.optimize(a, None, 3, None, "scipy")
    backend.save_checkpoint(a, tmp_path, extra={"iters_done": 3,
                                                "max_error": 0.5})
    assert not (tmp_path / "checkpoint.json.tmp").exists()
    b = backend.create_model(cfg, data, seed=1)
    backend.load_checkpoint(b, tmp_path / "checkpoint.json")
    assert b.last_checkpoint_extra == {"kind": "cglb", "iters_done": 3,
                                       "max_error": 0.5}
    assert torch.equal(a.v0, b.v0) and b.v0.dtype == torch.float64
    for (name, pa), (_, pb) in zip(a.params.named_params(),
                                   b.params.named_params()):
        torch.testing.assert_close(pa.raw, pb.raw, rtol=1e-12, atol=1e-14,
                                   msg=name)
