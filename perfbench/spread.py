"""How widely a cell's runs spread: the measurement behind each bound.

    python3 perfbench/spread.py --workload <cell> --seeds 1 2 3 4 5 6 \
        --sets 2 [--seconds <s>] [--trace 0]

runs ``run.py`` once a seed, in ``sets`` sets over the same seeds, each
run a process of its own, one after another.  For each end-to-end metric it
prints each set's median and spread (the distance between the first and
third quartile, ``statistics.quantiles(values, n=4)``, as a share of the
median), the wider spread, and five times it (at least 1 %): the bound
that spread supports.  Every run's result line goes to standard output as
it comes; the summary is the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.path.dirname(HERE)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    sets = []
    for k in range(args.sets):
        runs = []
        for seed in args.seeds:
            proc = subprocess.run(
                [sys.executable, os.path.join(HERE, "run.py"), "--workload",
                 args.workload, "--seed", str(seed), "--seconds",
                 str(seconds), "--trace", str(args.trace)],
                capture_output=True, text=True, cwd=root)
            lines = proc.stdout.strip().splitlines()
            if proc.returncode or not lines:
                print(f"set {k} seed {seed}: rc {proc.returncode}\n"
                      f"{proc.stderr[-3000:]}", file=sys.stderr)
                return 1
            line = json.loads(lines[-1])
            print(json.dumps({"set": k, "seed": seed, **line}), flush=True)
            runs.append(line)
        sets.append(runs)
    summary = {"workload": args.workload, "seconds": seconds,
               "correct": all(r["correct"] for s in sets for r in s),
               "metrics": {}}
    for name in sets[0][0]["metrics"]:
        per_set = [[r["metrics"][name]["value"] for r in s] for s in sets]
        widest = max(spread(v) for v in per_set)
        summary["metrics"][name] = {
            "medians": [statistics.median(v) for v in per_set],
            "spreads": [spread(v) for v in per_set],
            "widest": widest, "bound": max(0.01, 5 * widest)}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
