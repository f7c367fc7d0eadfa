"""PyTorch port: it stands without jax, click, optax and cglb_tpu; its
device and unported options fail clearly, and the leaves and optimizers of
the exact-GP arm run from the CLI."""

import torch_threads  # noqa: F401  (the test processes' torch thread cap)
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_BLOCKED = """
import sys
for name in ("jax", "click", "optax", "cglb_tpu", "pandas", "matplotlib"):
    sys.modules[name] = None
import cglb_tpu_torch, cglb_tpu_torch.backend
import cglb_tpu_torch.utils.flatten, cglb_tpu_torch.experiments.baselines
import cglb_tpu_torch.utils.profiling, cglb_tpu_torch.utils.tfevents
import cglb_tpu_torch.parallel.mesh, cglb_tpu_torch.parallel.sharded
import cglb_tpu_torch.parallel.streaming
from cglb_tpu_torch.experiments import (names, plotcli, plotting, sweep)
from cglb_tpu_torch.experiments import cli
argv = sys.argv[1:]
cli.main(argv)
cli.main(argv[:argv.index("train")] + [
    "train", "-n", "2", "-d", "synth_150x2", "-o", "adam_0.01", "gpr", "-m",
    "exactgp", "-k", "Matern32"])
assert not any(m == "jax" or m.startswith(("jax.", "cglb_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_port_runs_with_jax_click_optax_blocked(tmp_path):
    """Import the package, its backend, flatten bridge, baselines, CLI,
    experiment tooling and parallel modules, and run a 2-step CPU scipy4
    training with
    checkpoints and then a staged ``gpr -m exactgp`` run, with jax, click,
    optax, cglb_tpu, pandas and matplotlib unimportable."""
    env = dict(os.environ, CGLB_DATA_DIR=str(tmp_path / "no_data_here"),
               PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED, "-l", str(tmp_path), "--device",
         "cpu", "train", "-n", "2", "-d", "synth_150x2", "-o", "scipy4",
         "--ckpt-every", "1", "cglbnm2", "-m", "cglbnm2", "-k", "Matern32",
         "-i", "cv", "-M", "8", "--vjoint"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (tmp_path / "checkpoint.json").exists()
    res = json.loads((tmp_path / "results.json").read_text())
    assert "lml" in res and "elbo" not in res  # the second run's


_PREDICT_BLOCKED = """
import sys
for name in ("jax", "click", "optax", "cglb_tpu"):
    sys.modules[name] = None
import numpy as np
import torch
from cglb_tpu_torch import configs
from cglb_tpu_torch.backend import Torch
from cglb_tpu_torch.experiments.datasets import get_dataset
from cglb_tpu_torch.models.cglb import (cglb_predict_log_density, init_v0,
                                        predict_f)
from cglb_tpu_torch.models.sgpr import sgpr_predict_log_density
from cglb_tpu_torch.utils.inducing import conditional_variance_numpy
from cglb_tpu_torch.utils.logging import StopWatch
from cglb_tpu_torch.utils.native import native_available

b = get_dataset("synth_150x2", dtype=np.float64)
model = Torch(device="cpu").create_model(configs.CGLBConfig(
    configs.Matern32Config(), configs.InducingVariableConfig(8)), b.train)
X, Y = model.data
Xs, Ys = (torch.tensor(a) for a in b.test)
lpd = model.predict_log_density(b.test)
assert lpd.shape == (Xs.shape[0],) and torch.isfinite(lpd).all()
p = model.params
for got in (sgpr_predict_log_density(p, X, Y, Xs, Ys),
            cglb_predict_log_density(p, X, Y, init_v0(X.shape[0]), Xs, Ys)):
    assert got.shape == lpd.shape and got.requires_grad
mean, var = predict_f(p, X, Y, init_v0(X.shape[0]), Xs, full_cov=True)
assert var.shape == (1, Xs.shape[0], Xs.shape[0])
Z, idx = conditional_variance_numpy(
    b.train[0], 5, lambda A: np.ones(len(A)),
    lambda A, B: np.exp(-0.5 * ((A[:, None] - B[None]) ** 2).sum(-1)))
assert Z.shape == (5, 2) and len(set(idx)) == 5
watch = StopWatch()
watch.start()
assert watch.stop() >= 0.0 and not watch.started()
assert callable(native_available)
assert not any(m == "jax" or m.startswith(("jax.", "cglb_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_prediction_names_run_with_jax_blocked(tmp_path):
    """The names this slice added (``Model.predict_log_density``, both
    ``*_predict_log_density``, ``predict_f(full_cov=True)``,
    ``conditional_variance_numpy``, ``StopWatch.stop``,
    ``native_available``) import and run on the CPU with jax, click, optax
    and cglb_tpu unimportable (``native_available`` is not called: it
    would build the native library)."""
    env = dict(os.environ, CGLB_DATA_DIR=str(tmp_path / "no_data_here"),
               PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _PREDICT_BLOCKED],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_no_jax_import_in_port_sources():
    """No jax, click, optax, cglb_tpu or pandas anywhere in the port or
    chip_smoke.py; matplotlib only inside experiments/plotting.py (the
    Plotter imports it when it draws)."""
    pattern = re.compile(
        r"^\s*(import|from) (jax|click|optax|cglb_tpu|pandas)\b", re.M)
    plots = re.compile(r"^\s*(import|from) matplotlib\b", re.M)
    files = list((ROOT / "cglb_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        assert not pattern.search(f.read_text()), f
        if f.name != "plotting.py":
            assert not plots.search(f.read_text()), f


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    from cglb_tpu_torch.backend import Torch

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Torch(device="cuda")


def test_wrappers_take_plain_version_only_on_cpu():
    from cglb_tpu_torch.ops import matvec as tmv

    with pytest.raises(ValueError, match="unsupported device"):
        tmv._on_cpu(torch.empty(1, device="meta"))
    assert tmv._on_cpu(torch.empty(1))


@pytest.mark.parametrize("args,keys", [
    (["--device", "cuda", "--mesh", "4"], {"--mesh 4", "needs 4 cards",
                                           "gloo"}),
    (["--mesh", "-1", "--dispatch-bound", "2"], {"--mesh -1", "needs CUDA"}),
])
def test_unported_options_fail_clearly(tmp_path, capsys, monkeypatch, args,
                                       keys):
    """Every option is ported; a --mesh that cannot run here ends the CLI
    before any rank starts, with a message that names it: more ranks than
    the one visible card under NCCL, or one rank a card on the CPU (with
    --dispatch-bound beside it)."""
    from cglb_tpu_torch.experiments import cli

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit):
        cli.main(["-l", str(tmp_path), "--device", "cpu"] + args + [
            "train", "-n", "1", "-d", "synth_40x1", "cglb", "-m", "cglb",
            "-k", "rbf", "-i", "cv", "-M", "4"])
    message = capsys.readouterr().err
    assert all(word in message for word in keys)
    assert not (tmp_path / "results.json").exists()


@pytest.mark.parametrize("args,keys", [
    (["-o", "lbfgs", "cglb", "-m", "cglb", "-k", "rbf", "-i", "cv", "-M",
      "4"], {"cg_lower_bound", "elbo"}),
    (["-o", "adam_0.01", "gpr", "-m", "gpr", "-k", "rbf"], {"lml"}),
])
def test_lbfgs_and_gpr_leaf_run_from_cli(tmp_path, monkeypatch, args, keys):
    from cglb_tpu_torch.experiments import cli

    monkeypatch.setenv("CGLB_DATA_DIR", str(tmp_path / "no_data_here"))
    argv = (["-l", str(tmp_path), "--device", "cpu", "train", "-n", "1",
             "-d", "synth_40x1"] + args)
    cli.main(argv)
    res = json.loads((tmp_path / "results.json").read_text())
    assert keys <= set(res) and math.isfinite(res["loss"])


def test_gpr_metric_fails_clearly(tmp_path, monkeypatch):
    """Without its parameter file ``gpr_metric`` fails on the file and
    writes nothing."""
    from cglb_tpu_torch.experiments import cli

    monkeypatch.setenv("CGLB_DATA_DIR", str(tmp_path / "no_data_here"))
    with pytest.raises(FileNotFoundError):
        cli.main(["-l", str(tmp_path / "log"), "--device", "cpu",
                  "gpr_metric", "-d", "synth_40x1", "-k", "rbf", "-p",
                  str(tmp_path / "m.json")])
    assert not list(tmp_path.rglob("gpr_metric.npy"))


def test_gpr_metric_runs(tmp_path, monkeypatch):
    """``gpr_metric`` evaluates a saved model as a dense GP and writes
    ``gpr_metric.npy`` beside the parameter file."""
    from cglb_tpu_torch.experiments import cli

    monkeypatch.setenv("CGLB_DATA_DIR", str(tmp_path / "no_data_here"))
    head = ["-l", str(tmp_path / "log"), "--device", "cpu"]
    cli.main(head + ["train", "-n", "1", "-d", "synth_40x1", "-o", "staged",
                     "gpr", "-m", "exactgp", "-k", "rbf"])
    cli.main(head + ["gpr_metric", "-d", "synth_40x1", "-k", "rbf", "-p",
                     str(tmp_path / "log" / "model.json")])
    got = np.load(tmp_path / "log" / "gpr_metric.npy",
                  allow_pickle=True).item()
    assert {"lml", "loss", "test/rmse", "test/nlpd", "id", "data"} <= set(got)
    assert got["id"] == str(tmp_path / "log")


def test_mesh_option_is_refused(tmp_path, monkeypatch, capsys):
    """--mesh on CUDA where no card is visible: refused before any rank
    starts."""
    from cglb_tpu_torch.experiments import cli

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(SystemExit):
        cli.main(["-l", str(tmp_path), "--device", "cuda", "--mesh", "4",
                  "train", "-d", "synth_40x1", "cglb", "-m", "cglb", "-k",
                  "rbf", "-i", "cv"])
    assert "no CUDA device is visible" in capsys.readouterr().err


def test_parallel_modules_import_torch_only():
    """cglb_tpu_torch/parallel imports torch and the port, never jax or
    cglb_tpu."""
    pattern = re.compile(r"^\s*(import|from) (jax|cglb_tpu)\b", re.M)
    files = sorted((ROOT / "cglb_tpu_torch" / "parallel").glob("*.py"))
    assert {f.name for f in files} >= {"mesh.py", "sharded.py",
                                       "streaming.py"}
    for f in files:
        assert not pattern.search(f.read_text()), f


def test_every_port_test_file_takes_the_thread_cap():
    """Each tests/test_torch_*.py imports tests/torch_threads.py, and this
    process runs torch at its cap."""
    import torch_threads

    files = sorted((ROOT / "tests").glob("test_torch_*.py"))
    assert len(files) > 20
    pattern = re.compile(r"^import torch_threads\b", re.M)
    for f in files:
        assert pattern.search(f.read_text()), f
    assert torch.get_num_threads() == torch_threads.THREADS
