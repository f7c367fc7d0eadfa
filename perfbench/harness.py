"""One run of one cell: set-up, the window, the reference, the result line.

``run_cell`` is everything but the look for a card, so that a test can
drive a whole run on the CPU at a small configuration.  ``main`` is the
command: it checks the card first and the modules loaded last.  A cell on
several cards runs as ranks (``ranks.py``): the command started without a
rank is their launcher, and ``run_rank`` is one rank's run, of which rank 0
prints the result line.

The configuration's ``reference`` names the module of ``reference/`` that
checks it (``cglb``, the dense reference, where the key is absent).
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from . import compare, datagen, drive
from .ranks import RANK_VAR, Ranks, launch
from .reference.common import adam_steps
from .spec import HERE, ROOT, Cell, find_cell, metric_reader
from .tracing import top

__all__ = ["run_cell", "run_rank", "report", "reference_module",
           "reference_training", "reference_prediction", "main", "BLOCKED",
           "blocked_modules"]

# top-level module names that no run may load: JAX and the JAX package
# (whose name the program's, cglb_tpu_torch, begins with)
BLOCKED = ("jax", "jaxlib", "flax", "cglb_tpu")


def blocked_modules(names=None) -> List[str]:
    """The loaded modules whose top-level name is blocked, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in BLOCKED)


def _seed(seed: int) -> int:
    """Any whole number as a seed of numpy's and torch's generators."""
    return int(seed) % (1 << 63)


def _data(cfg: Dict, seed: int):
    train, test = datagen.split_dataset(cfg["dataset"], seed)
    if (len(train[0]), len(test[0]), train[0].shape[1]) != (
            cfg["n_train"], cfg["n_test"], cfg["input_dim"]):
        raise ValueError(f"{cfg['dataset']} does not split to the "
                         "configuration's sizes")
    return train, test


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def reference_module(cfg: Dict):
    """The module of ``reference/`` that the configuration names."""
    name = cfg.get("reference", "cglb")
    if not name.isidentifier():
        raise ValueError(f"reference {name!r} is not a module name")
    return importlib.import_module(f"{__package__}.reference.{name}")


def reference_training(cfg: Dict, mix: Dict, train,
                       device: torch.device, values: Dict,
                       dtype=torch.float64):
    """The reference's ``compared_steps`` Adam steps from the
    configuration's start: (losses, first gradient, raw leaves before,
    after)."""
    ref = reference_module(cfg)
    X = torch.as_tensor(train[0], dtype=dtype, device=device)
    Y = torch.as_tensor(train[1], dtype=dtype, device=device)
    raw0 = ref.raw_leaves(values, cfg["positive_lower"], dtype, device)
    steps = int(mix["compared_steps"])
    # CG's warm start: zero at the start, then the previous step's v
    carry = {"v": torch.zeros(Y.shape[1], X.shape[0], dtype=dtype,
                              device=device)}

    def loss_grad(raw, k):
        loss, grad, carry["v"] = ref.loss_and_grad(
            raw, X, Y, carry["v"], cfg)
        return loss, grad
    losses, grad0, raw_c = adam_steps(raw0, loss_grad, steps,
                                      float(cfg["learning_rate"]))
    return losses, grad0, raw0, raw_c


def reference_prediction(cfg: Dict, mix: Dict, train, test,
                         device: torch.device, values: Dict,
                         dtype=torch.float64):
    """(mean, variance, log density) at every test row, numpy."""
    t = [torch.as_tensor(a, dtype=dtype, device=device)
         for a in (*train, *test)]
    return tuple(x.double().cpu().numpy() for x in reference_module(
        cfg).predict(values, *t, cfg, float(mix["cg_tolerance"])))


def _per_layer(cell: Cell, ctx) -> Dict[str, Dict]:
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"], cell.base)(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, started: float,
             program: Optional[Dict] = None,
             ranks: Optional[Ranks] = None) -> Optional[Dict]:
    """One run: the result line's object.  ``started``: the host clock at
    process start (set-up is counted from it).  ``program``: settings of
    the program that differ from the configuration's (the control's
    precision); the reference keeps the configuration's.  ``ranks``: this
    process's rank of a cell on several cards; every rank runs the cell,
    and rank 0 returns the result of them all (the others None)."""
    cfg, mix = cell.config, cell.traffic
    prog_cfg = dict(cfg, **(program or {}))
    seed = _seed(seed)
    cuda = device.type == "cuda"
    t_in = time.perf_counter()
    train, test = _data(cfg, seed)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    mesh = None
    if ranks is not None:
        mesh = drive.make_mesh(cell.chips, device)
        ranks.connect()
    values = drive.start_values(cfg, cell.base.parent)
    model = drive.build_model(prog_cfg, train, device, values, mesh=mesh)
    t_model = time.perf_counter()
    if mix["kind"] == "adam":
        run = drive.run_adam(model, prog_cfg, mix, seconds, trace, device,
                             ranks)
        units, rows = run.steps, None
    elif mix["kind"] == "predict":
        run = drive.run_predict(model, test, prog_cfg, mix, seconds, trace,
                                seed, device, ranks)
        units, rows = run.units, sum(len(r) for r in run.rows[:run.units])
    else:
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del model, mesh
    _free(device)

    # the reference, once the window has closed and the program is freed
    t_ref = time.perf_counter()
    if mix["kind"] == "adam":
        ref = reference_training(cfg, mix, train, device, values)
        numbers = compare.training_numbers(
            run.losses, run.grad0, run.theta0, run.theta_c, *ref)
    else:
        ref = reference_prediction(cfg, mix, train, test, device, values)
        numbers = compare.prediction_numbers(
            run.rows, [m.double().cpu().numpy() for m in run.mean],
            [v.double().cpu().numpy() for v in run.var], run.logdens, *ref)
    del ref
    _free(device)
    print(f"reference and comparison {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    ok, checks = compare.judge(numbers, cell.limits)
    ok = bool(ok and run.failed == 0 and units > 0)
    failed = run.failed
    calls = [c for _, c in run.recorder.calls] if trace else None
    rank_calls, rank_counters = [calls], [run.counters]
    if ranks is not None:
        every = ranks.gather({"ok": ok, "failed": failed, "units": units,
                              "peak": int(peak), "calls": calls,
                              "counters": run.counters,
                              "blocked": blocked_modules()})
        if ranks.rank != 0:
            return None
        steps = [e["units"] for e in every]
        print(f"window steps or requests by rank: {steps}", file=sys.stderr)
        ok = all(e["ok"] for e in every) and len(set(steps)) == 1
        failed = sum(e["failed"] for e in every)
        peak = max(e["peak"] for e in every)
        rank_calls = [e["calls"] for e in every]
        rank_counters = [e["counters"] for e in every]
        blocked = sorted({m for e in every for m in e["blocked"]})

    setup_s = run.setup_end - started
    print(f"set-up {setup_s:.3f} s: start {t_in - started:.3f}, data and "
          f"model {t_model - t_in:.3f}, warm-up {run.setup_end - t_model:.3f}",
          file=sys.stderr)
    e2e = {"setup_s": setup_s,
           "peak_gib": peak / 2 ** 30,
           "train_step_ms": (1e3 * run.seconds / units if units else None),
           "predict_rows_per_s": (rows / run.seconds if rows else None),
           "predict_p95_ms": (1e3 * drive.p95(run.latency[:run.units])
                              if rows else None)}
    result = {"correct": None,
              "attempted": units,
              "failed": failed}
    if trace:
        dt = run.device_trace
        ctx = SimpleNamespace(
            kind=mix["kind"], config=cfg, units=units,
            seconds=run.seconds, rows=(run.rows[:run.units] if rows else None),
            calls=calls, unit_calls=run.recorder.calls,
            counters=run.counters,
            slice_units=run.trace_units, slice_s=dt.window_s,
            slice_calls=[c for _, c in run.slice_recorder.calls],
            trace=dt, chips=len(rank_calls), rank_calls=rank_calls,
            rank_counters=rank_counters)
        result["metrics"] = _per_layer(cell, ctx)
    else:
        result["metrics"] = {
            m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if e2e.get(m["name"]) is not None}
    result["device"] = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name() if cuda else device.type,
        "count": len(rank_calls),
        "memory_peak_bytes": int(peak)}
    if trace:
        dt = run.device_trace
        result["device"].update(busy_s=dt.busy_s(), window_s=dt.window_s)
        result["breakdown"] = {
            "device_ops": top(dt.device_seconds_by_name()),
            "idle_gaps": top(dt.idle_by_host_op())}
    result["correct"] = ok
    result["checks"] = {k: {kk: (vv if math.isfinite(vv) else 1e300)
                            for kk, vv in v.items()}
                        for k, v in checks.items()}
    if ranks is not None:
        result["blocked"] = blocked
    return result


def run_rank(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, started: float, ranks: Ranks) -> int:
    """One rank of a cell on several cards; rank 0 prints the result line
    (to the launcher), the others print nothing on standard output."""
    result = run_cell(cell, seed, seconds, trace, device, started,
                      ranks=ranks)
    ranks.close()
    if ranks.rank != 0:
        return 3 if blocked_modules() else 0
    return report(result, result.pop("blocked"))


def _card() -> str:
    """The card's name and power limit, from nvidia-smi."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def report(result: Dict, blocked: List[str] = ()) -> int:
    """Print the result line, unless a blocked module is loaded here or was
    in another rank (``blocked``): the exit code."""
    found = sorted(set(blocked_modules()) | set(blocked))
    if found:
        print(f"blocked modules loaded: {', '.join(found)}: no result",
              file=sys.stderr)
        return 3
    if "card" not in result:  # a rank's line, passed on, has it
        result["card"] = _card()
    checks = result.pop("checks")
    result["checks"] = checks  # the compared numbers come last
    print(f"card: {result['card']}", file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def main(argv: Optional[List[str]] = None, started: float = None) -> int:
    started = time.perf_counter() if started is None else started
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(
        description="Run one cell of BENCHMARK.json once and print its "
                    "result as the last line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = find_cell(args.workload, ROOT)
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device: no result", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible: no result",
              file=sys.stderr)
        return 2
    if cell.chips == 1:
        return report(run_cell(cell, args.seed, args.seconds,
                                bool(args.trace), torch.device("cuda", 0),
                                started))
    if RANK_VAR not in os.environ:
        return launch([sys.executable, str(HERE / "run.py"), *argv],
                      cell.chips, args.seconds, started, report)
    ranks = Ranks.from_env()
    device = torch.device("cuda", ranks.rank)
    torch.cuda.set_device(device)
    return run_rank(cell, args.seed, args.seconds, bool(args.trace), device,
                    started, ranks)
