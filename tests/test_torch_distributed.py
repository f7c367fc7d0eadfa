"""PyTorch port: ``--mesh`` through the CLI.  One run of ``python -m
cglb_tpu_torch.experiments.cli --device cpu --mesh 2 ...`` (the CLI starts
two gloo ranks of itself) for the module, beside the JAX CLI's ``--mesh 2``
run on its 8-device CPU mesh and the port's one-process run; then what
refuses to run."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from cglb_tpu.backend import Jax
from cglb_tpu.experiments.cli import main as jax_main
from cglb_tpu_torch.experiments import cli as tcli
from cglb_tpu_torch.utils import serialization as tser

ROOT = Path(__file__).resolve().parent.parent
TAIL = ["-t", "fp64", "-s", "0", "train", "-n", "3", "-d", "synth_300x2",
        "cglb", "-k", "Matern32", "-m", "cglb", "-i", "cv", "-M", "12"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """logdirs of the three runs: the port's --mesh 2 (a subprocess, as a
    user types it), the JAX CLI's --mesh 2 and the port's one process (both
    in-process)."""
    tmp = tmp_path_factory.mktemp("cli_mesh")
    env = dict(os.environ, CGLB_DATA_DIR=str(tmp / "no_data_here"),
               PYTHONPATH=str(ROOT))
    env.pop("CGLB_COORDINATOR", None)
    proc = subprocess.run(
        [sys.executable, "-m", "cglb_tpu_torch.experiments.cli",
         "--device", "cpu", "--mesh", "2", "-l", str(tmp / "mesh")] + TAIL,
        cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CGLB_DATA_DIR", str(tmp / "no_data_here"))
        try:
            r = CliRunner().invoke(
                jax_main, ["-b", "jax", "--mesh", "2", "-l",
                           str(tmp / "jax")] + TAIL, catch_exceptions=False)
        finally:
            Jax.mesh_size = 0  # class state persists in the process
        assert r.exit_code == 0, r.output
        tcli.main(["--device", "cpu", "-l", str(tmp / "one")] + TAIL)
    return {"mesh": tmp / "mesh", "jax": tmp / "jax", "one": tmp / "one",
            "stderr": proc.stderr}


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def test_cli_mesh_writes_the_jax_mesh_keys(runs):
    """results.json, logs.json and model.json hold the keys of the JAX
    --mesh 2 run's, and the ranks said what they run on."""
    for name in ("results.json", "logs.json"):
        assert set(_json(runs["mesh"] / name)) == set(
            _json(runs["jax"] / name)), name
    assert set(tser.load_model_params(runs["mesh"] / "model.json")) == set(
        tser.load_model_params(runs["jax"] / "model.json"))
    for rank in (0, 1):
        assert f"rank {rank} of 2, gloo on cpu" in runs["stderr"]


def test_cli_mesh_rank0_alone_writes(runs):
    """One results.json, logs.json, model.json and event file: rank 0's;
    the other rank wrote nothing into the logdir."""
    names = sorted(p.name for p in runs["mesh"].iterdir())
    events = [n for n in names if n.startswith("events.out.tfevents")]
    assert len(events) == 1
    assert sorted(set(names) - set(events)) == [
        "logs.json", "model.json", "results.json"]


def test_cli_mesh_loss_near_jax_and_bracket_holds(runs):
    """The loss within 2e-2 of the JAX --mesh run's (its default mixed
    common terms against the port's fp64), finite metrics, and elbo <=
    cg_lower_bound <= upper."""
    got, want = _json(runs["mesh"] / "results.json"), _json(
        runs["jax"] / "results.json")
    assert all(np.isfinite(v) for v in got.values() if isinstance(v, float))
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-2)
    np.testing.assert_allclose(got["test/rmse"], want["test/rmse"],
                               rtol=2e-2)
    assert got["elbo"] <= got["cg_lower_bound"] <= got["titsias_upper_bound"]


def test_cli_mesh_matches_one_process(runs):
    """The same run in one process: the same iterations and CG steps, and
    every metric to 1e-5.  The fp32 preconditioner's products are summed in
    two parts on two ranks, which moves the scipy iterates in their last
    bits (the loss agrees to 3e-8); the upper bound, whose terms partly
    cancel, moved 2.6e-7 when this bound was set."""
    got, want = _json(runs["mesh"] / "results.json"), _json(
        runs["one"] / "results.json")
    assert got["opt/num_iters"] == want["opt/num_iters"]
    assert got["cg/steps_train_max"] == want["cg/steps_train_max"]
    for key, value in want.items():
        if isinstance(value, float) and not key.startswith("cg/error"):
            np.testing.assert_allclose(got[key], value, rtol=1e-5,
                                       err_msg=key)


def test_cli_mesh_refuses_more_ranks_than_cards(tmp_path, monkeypatch,
                                                capsys):
    """--mesh 2 on CUDA with one visible card fails before any rank starts,
    naming the count and gloo."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit):
        tcli.main(["--device", "cuda", "--mesh", "2", "-l", str(tmp_path)]
                  + TAIL)
    message = capsys.readouterr().err
    assert "--mesh 2 needs 2 cards" in message and "gloo" in message
    assert not (tmp_path / "results.json").exists()


def test_cli_mesh_propagates_a_rank_failure(tmp_path, monkeypatch, capsys):
    """The ranks' own exit code ends the launching CLI: here both ranks
    reject an unknown dataset (argparse, code 2)."""
    monkeypatch.setenv("CGLB_DATA_DIR", str(tmp_path / "no_data_here"))
    monkeypatch.delenv("CGLB_COORDINATOR", raising=False)
    tail = [a if a != "synth_300x2" else "no_such_dataset" for a in TAIL]
    with pytest.raises(SystemExit) as err:
        tcli.main(["--device", "cpu", "--mesh", "2", "-l", str(tmp_path)]
                  + tail)
    assert err.value.code == 2
    assert "exited with code 2" in capsys.readouterr().err
