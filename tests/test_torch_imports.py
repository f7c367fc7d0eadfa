"""PyTorch port: it stands without jax, click, optax and cglb_tpu; its
device and unported options fail clearly."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_BLOCKED = """
import sys
for name in ("jax", "click", "optax", "cglb_tpu"):
    sys.modules[name] = None
import cglb_tpu_torch, cglb_tpu_torch.backend
from cglb_tpu_torch.experiments import cli
cli.main(sys.argv[1:])
assert not any(m == "jax" or m.startswith(("jax.", "cglb_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_port_runs_with_jax_click_optax_blocked(tmp_path):
    """Import the package, its backend and CLI, and run a 2-step CPU
    training with jax, click, optax and cglb_tpu unimportable."""
    env = dict(os.environ, CGLB_DATA_DIR=str(tmp_path / "no_data_here"),
               PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED, "-l", str(tmp_path), "--device",
         "cpu", "train", "-n", "2", "-d", "synth_150x2", "-o", "adam_0.01",
         "cglb", "-m", "cglb", "-k", "Matern32", "-i", "cv", "-M", "8"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (tmp_path / "results.json").exists()


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(import|from) (jax|click|optax|cglb_tpu)\b",
                         re.M)
    files = list((ROOT / "cglb_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        assert not pattern.search(f.read_text()), f


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


@pytest.mark.parametrize("args,match", [
    (["train", "-o", "scipy"], "optimizer 'scipy'"),
    (["train", "-o", "adam_0.01", "--vzero"], "--vzero"),
])
def test_unported_options_fail_clearly(tmp_path, monkeypatch, args, match):
    from cglb_tpu_torch.experiments import cli

    monkeypatch.setenv("CGLB_DATA_DIR", str(tmp_path / "no_data_here"))
    argv = (["-l", str(tmp_path), "--device", "cpu"] + args[:1]
            + ["-n", "1", "-d", "synth_40x1"] + args[1:3]
            + ["cglb", "-m", "cglb", "-k", "rbf", "-i", "cv", "-M", "4"]
            + args[3:])
    with pytest.raises(NotImplementedError, match=match):
        cli.main(argv)


def test_mesh_option_is_refused(tmp_path):
    from cglb_tpu_torch.experiments import cli

    with pytest.raises(SystemExit):
        cli.main(["-l", str(tmp_path), "--device", "cpu", "--mesh", "4",
                  "train", "-d", "synth_40x1", "cglb", "-m", "cglb", "-k",
                  "rbf", "-i", "cv"])
