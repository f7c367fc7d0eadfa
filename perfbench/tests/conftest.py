"""Fixtures of the benchmark's tests: a checkout of the benchmark at a tiny
size, whose cells run on the CPU in seconds."""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the tiny cells: the kin40k cells' mixes and limits on 600 rows of the
# stand-in generator (402 / 198 split) at M 20, the streaming operator
TINY = {"cglb-tiny.adam": ("cglb-tiny", "adam", "cglb-kin40k.adam"),
        "cglb-tiny.predict": ("cglb-tiny", "predict", "cglb-kin40k.predict"),
        "cglb-tiny.predict-rate": ("cglb-tiny", "predict-rate",
                                   "cglb-kin40k.predict-rate")}
# cells on two ranks (gloo on the CPU), checked by the streamed reference
TINY_RANKS = {"cglb-tiny-streamed.adam": ("cglb-tiny-streamed", "adam",
                                          "cglb-kin40k.adam", 2),
              "cglb-tiny-streamed.predict": ("cglb-tiny-streamed", "predict",
                                             "cglb-kin40k.predict", 2)}


def make_tiny_root(dest: Path) -> Path:
    """A checkout holding only the benchmark, with the tiny cells."""
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = dest / "perfbench"
    name = "cglb-tiny"
    cfg = json.loads((base / "configs" / "cglb-kin40k.json").read_text())
    cfg.update(name=name, dataset="synth_600x8", n_train=402, n_test=198,
               num_inducing=20, matvec="streaming",
               start=f"perfbench/data/{name}.model.json")
    start = json.loads((base / "data" / "cglb-kin40k.model.json")
                       .read_text())
    Z = np.random.default_rng(0).normal(size=(20, 8))
    start["params"][".inducing_Z"] = {
        "__ndarray__": Z.tolist(), "dtype": "float64", "shape": [20, 8]}
    (base / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (base / "configs" / f"{name}-streamed.json").write_text(
        json.dumps(dict(cfg, name=f"{name}-streamed",
                        reference="cglb_streamed")))
    (base / "data" / f"{name}.model.json").write_text(json.dumps(start))
    for config in (name, f"{name}-streamed"):
        bench["configs"].append({"name": config, "source": "tiny",
                                 "file": f"perfbench/configs/{config}.json",
                                 "reduced": [], "why": "tests"})
    cells = {k: v + (1,) for k, v in TINY.items()}
    for cell, (config, mix, kin, chips) in {**cells, **TINY_RANKS}.items():
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": mix, "chips": chips,
                                   "why": "tests"})
        (base / "limits" / f"{cell}.json").write_text(
            (base / "limits" / f"{kin}.json").read_text())
        for m in bench["end_to_end"] + bench["per_layer"]:
            if kin in m.get("workloads", ()):
                m["workloads"].append(cell)
    # a reader of the ranks' records (the traced context's chips,
    # rank_calls and rank_counters)
    (base / "metrics" / "ranks_seen.train.py").write_text(
        "def read(ctx):\n"
        "    if len(ctx.rank_calls) == len(ctx.rank_counters) == ctx.chips:\n"
        "        return float(ctx.chips)\n")
    bench["per_layer"].append({
        "name": "ranks_seen.train", "unit": "ranks", "better": "higher",
        "source": "program_counter", "layer": "device",
        "moves": "train_step_ms",
        "workloads": ["cglb-tiny.adam", "cglb-tiny-streamed.adam"]})
    for mix in ("predict", "predict-rate"):
        pred = json.loads((base / "traffic" / f"{mix}.json").read_text())
        pred.update(rows_max=198, trace_seconds=0.2)
        (base / "traffic" / f"{mix}.json").write_text(json.dumps(pred))
    adam = json.loads((base / "traffic" / "adam.json").read_text())
    adam.update(trace_seconds=0.2)
    (base / "traffic" / "adam.json").write_text(json.dumps(adam))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
