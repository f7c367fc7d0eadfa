"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names; the references load nothing of the program; without a
card, or in a checkout without the program, the command prints no
result."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import harness, spec

ROOT = Path(__file__).resolve().parents[2]


def test_names_are_compared_whole():
    names = ["cglb_tpu_torch", "cglb_tpu_torch.ops.matvec", "jaxtyping",
             "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "cglb_tpu", "cglb_tpu.models.sgpr", "cglb_tpu_x"]
    assert harness.blocked_modules(names) == [
        "cglb_tpu", "cglb_tpu.models.sgpr", "flax.linen", "jax",
        "jax.numpy", "jaxlib.xla_client"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_root):
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from pathlib import Path\n"
        "from perfbench import harness, spec\n"
        f"cell = spec.find_cell('cglb-tiny.adam', Path({str(tiny_root)!r}))\n"
        "harness.run_cell(cell, 3, 0.2, True, torch.device('cpu'), "
        "time.perf_counter())\n"
        "print(harness.blocked_modules())\n"
        "print('cglb_tpu_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[-3:-1] == ["[]", "True"]


def test_the_references_load_nothing_of_the_program():
    refs = sorted((ROOT / "perfbench" / "reference").glob("*.py"))
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            + "".join(f"import perfbench.reference.{p.stem}\n" for p in refs)
            + "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'cglb_tpu_torch', 'cglb_tpu', 'jax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"
    siblings = {p.stem for p in refs}
    for path in refs:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
                if node.level:  # only the references beside it
                    assert mods[0] in siblings | {""}, (path.name, mods[0])
                    continue
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] in ("torch", "math", "typing",
                                             "__future__"), (path.name, mod)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "cglb-kin40k.adam", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_program_no_result(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "cglb-kin40k.adam", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_command_names_only_the_benchmark():
    bench = spec.load_benchmark()
    assert bench["paths"] == ["perfbench"]
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert not bench["paths"][0].endswith("_torch")
