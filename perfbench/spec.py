"""The benchmark's files, found by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; each lives in a file of its
own, found by name:

- ``configs/<config>.json``: the configuration as it is run (sizes, model,
  precision, starting parameters, and the module of ``reference/`` that
  checks it);
- ``traffic/<traffic>.json``: the mix's parameters, read by the one general
  generator (``traffic.py``);
- ``limits/<cell>.json``: the cell's compared numbers and their limits;
- ``metrics/<metric>.py``: one reader per per-layer metric, with a
  ``read(ctx)`` that returns a number or None.

A later change adds a configuration, a mix, a cell or a metric by adding
files and entries, and edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List, NamedTuple

__all__ = ["HERE", "ROOT", "Cell", "load_benchmark", "find_cell",
           "metric_reader"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    chips: int
    base: Path


def load_benchmark(root: Path = ROOT) -> Dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path} not found")
    return json.loads(path.read_text())


def _reported(metric: Dict, cell: str, e2e_names: List[str]) -> bool:
    """A metric is read in a cell that its ``workloads`` list; without the
    key, in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the checkout at ``root`` with its
    configuration, mix, limits and the metrics it reports."""
    bench = load_benchmark(root)
    base = Path(root) / HERE.name
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = json.loads((Path(root) / cfg_entry["file"]).read_text())
    traffic = json.loads(
        (base / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((base / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if _reported(m, name, e2e_names)]
    return Cell(name, config, traffic, limits, e2e, per_layer,
                int(w["chips"]), base)


def metric_reader(name: str, base: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py`` (loaded by path: the
    names hold dots)."""
    path = Path(base) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
