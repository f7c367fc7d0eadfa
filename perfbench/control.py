"""The control of ``correct``: the program on its own path one precision
below the configuration's (fp32 for fp64: the CLI's ``-t fp32``), judged by
the cell's own comparison against the fp64 reference.  Its numbers must
fail the cell's limits; they set each limit's upper reading.

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3 \
        [--fault <name> | --sound]

prints one JSON line a seed: the control's numbers (or a planted fault's,
or with ``--sound`` the program's own, at the configuration's precision:
the lower readings) beside the cell's limits, all from one process.  Not
part of a run of the benchmark; ``tests/test_perfbench_faults.py`` holds
it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional

import torch

if __package__ in (None, ""):
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from perfbench.faults import FAULTS  # noqa: E402
from perfbench.harness import run_cell  # noqa: E402
from perfbench.spec import ROOT, Cell, find_cell  # noqa: E402

__all__ = ["control_numbers", "fault_numbers", "sound_numbers"]


def sound_numbers(cell: Cell, seed: int, device: torch.device,
                  seconds: float, program: Optional[Dict] = None) -> Dict:
    """The cell's compared numbers for a run of the program, as configured
    or with the settings ``program`` changed."""
    run = run_cell(cell, seed, seconds, False, device, time.perf_counter(),
                   program=program)
    return {k: v["value"] for k, v in run["checks"].items()}


def control_numbers(cell: Cell, seed: int, device: torch.device,
                    seconds: float) -> Dict:
    """The cell's compared numbers for a run of the program on its fp32
    path (the CLI's ``-t fp32``: fp32 throughout, the fp32 jitter), held
    to the fp64 reference."""
    return sound_numbers(cell, seed, device, seconds,
                         {"dtype": "float32", "jitter": "fp32"})


def fault_numbers(cell: Cell, seed: int, device: torch.device,
                  seconds: float, fault: str) -> Dict:
    """The cell's compared numbers for a run of the program (at the
    configuration's precision) with ``fault`` planted under it."""
    with FAULTS[fault]():
        return sound_numbers(cell, seed, device, seconds)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=2.0)
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--fault", choices=sorted(FAULTS),
                       help="read this planted fault instead of the control")
    which.add_argument("--sound", action="store_true",
                       help="read the program as configured instead")
    args = ap.parse_args(argv)
    cell = find_cell(args.workload, ROOT)
    device = torch.device(args.device)
    for seed in args.seeds:
        if args.fault:
            numbers = fault_numbers(cell, seed, device, args.seconds,
                                    args.fault)
        elif args.sound:
            numbers = sound_numbers(cell, seed, device, args.seconds)
        else:
            numbers = control_numbers(cell, seed, device, args.seconds)
        tag = args.fault or ("sound" if args.sound else "control")
        print(json.dumps({"workload": cell.name, "seed": seed, tag: numbers,
                          "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
