#!/usr/bin/env python3
"""The benchmark's command: one run of one cell of BENCHMARK.json.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result (JSON).  Without a CUDA
device, or with fewer cards than the cell asks for, it exits non-zero and
prints no result; so it does if JAX or the JAX package got loaded.
"""

import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# one host thread for the CPU-side math libraries: the card does the work,
# and spinning thread pools on a shared host only add jitter to the window
os.environ["OMP_NUM_THREADS"] = "1"

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = _ROOT  # the checkout's root, not this folder

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(started=STARTED))
