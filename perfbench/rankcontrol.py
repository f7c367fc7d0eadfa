"""The readings a cell on several cards sets its limits from: ``control.py``
for a cell whose ``chips`` is above 1, whose program runs as ranks.

    python3 perfbench/rankcontrol.py --workload <cell> --seeds s1 s2 \
        [--variants sound control half_batch ...] [--device cpu]

starts ``chips`` ranks of the same command through the benchmark's own
launcher (``ranks.launch``).  For each seed every rank computes the cell's
reference once (``harness.reference_training``, split over the ranks as in
a run), then runs each variant through the program's timed path
(``drive.run_adam``, the window ``--seconds`` long) and holds it to that
reference: ``sound`` (the program as configured), ``control`` (its fp32
path, as ``control.py`` runs it) or a fault of ``faults.py``, planted in
every rank.  Rank 0 prints each reading on standard error as it is taken,
and the launcher prints them all, one JSON line each, once every rank has
ended: the compared numbers beside the cell's limits, and every rank's
window steps.  Not part of a run of the benchmark;
``tests/test_perfbench_mesh.py`` holds it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Dict, List

import torch

if __package__ in (None, ""):
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from perfbench import compare, drive, harness  # noqa: E402
from perfbench.faults import FAULTS  # noqa: E402
from perfbench.ranks import RANK_VAR, Ranks, launch  # noqa: E402
from perfbench.spec import ROOT, Cell, find_cell  # noqa: E402

__all__ = ["VARIANTS", "reading"]

VARIANTS = ("sound", "control") + tuple(sorted(FAULTS))
# the control's settings (control.py's): the CLI's -t fp32
CONTROL = {"dtype": "float32", "jitter": "fp32"}


def reading(cell: Cell, variant: str, train, values: Dict, ref,
            seconds: float, device: torch.device, mesh,
            ranks: Ranks) -> Dict:
    """One variant's compared numbers against ``ref`` (the seed's
    reference) and the window's steps on this rank."""
    cfg = dict(cell.config, **(CONTROL if variant == "control" else {}))
    planted = (FAULTS[variant]() if variant in FAULTS
               else contextlib.nullcontext())
    with planted:
        model = drive.build_model(cfg, train, device, values, mesh=mesh)
        run = drive.run_adam(model, cfg, cell.traffic, seconds, False,
                             device, ranks)
    del model
    harness._free(device)
    numbers = compare.training_numbers(run.losses, run.grad0, run.theta0,
                                       run.theta_c, *ref)
    return {"numbers": numbers, "steps": run.steps}


def _rank(cell: Cell, seeds: List[int], variants: List[str],
          seconds: float, device: torch.device) -> int:
    r = Ranks.from_env()
    if device.type == "cuda":
        device = torch.device("cuda", r.rank)
        torch.cuda.set_device(device)
    mesh = drive.make_mesh(cell.chips, device)
    r.connect()
    values = drive.start_values(cell.config, cell.base.parent)
    lines = []
    for seed in seeds:
        train, _ = harness._data(cell.config, harness._seed(seed))
        ref = harness.reference_training(cell.config, cell.traffic, train,
                                         device, values)
        harness._free(device)
        for variant in variants:
            got = reading(cell, variant, train, values, ref, seconds,
                          device, mesh, r)
            steps = r.gather(got["steps"])
            if r.rank == 0:
                lines.append({"workload": cell.name, "seed": seed,
                              "variant": variant, "steps": steps,
                              variant: got["numbers"],
                              "limits": cell.limits})
                print(json.dumps(lines[-1]), file=sys.stderr, flush=True)
    r.close()
    if r.rank == 0:
        # the launcher passes the last line on to ``_report``
        print(json.dumps({"metrics": {}, "readings": lines}), flush=True)
    return 0


def _report(result: Dict) -> int:
    for line in result["readings"]:
        print(json.dumps(line), flush=True)
    return 0


def main(argv=None) -> int:
    started = time.perf_counter()
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", choices=VARIANTS,
                    default=["sound", "control", "half_batch",
                             "state_unchanged", "exchange_left_out"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--timeout", type=float, default=3000.0,
                    help="seconds the readings may take once the first "
                         "window has opened")
    args = ap.parse_args(argv)
    cell = find_cell(args.workload, ROOT)
    torch.set_num_threads(1)
    if RANK_VAR in os.environ:
        return _rank(cell, args.seeds, args.variants, args.seconds,
                     torch.device(args.device))
    return launch([sys.executable, os.path.abspath(__file__), *argv],
                  cell.chips, 0.0, started, _report, after_s=args.timeout)


if __name__ == "__main__":
    sys.exit(main())
