"""The time and peak memory of a reference's compared Adam steps at a
configuration's sizes, on one card: what a cell's reference would add to
each of its runs.

    python3 perfbench/reftime.py --config perfbench/configs/<c>.json \
        [--set key=value ...] --share 4 1 [--steps 1] [--seed 1]

builds the configuration's data (``datagen.py``), starts from a seeded
draw: variance 1, lengthscales 1, noise variance 0.1, constant mean 0 and
``num_inducing`` training rows as inducing points, and runs the
configuration's reference (its ``reference`` key, ``--set`` applied) for
``--steps`` Adam steps from CG's zero start, once for each ``--share``: R
takes rank 0's share of R ranks (its tiles and chunks; the partial sums are
not exchanged, and CG runs to its cap, as the whole problem's would at the
configuration's ``max_error`` where it does), 1 the whole problem.  One
JSON line a share: each step's seconds, the seconds inside the matvecs and
their count, CG's steps, and the card's peak.  Not part of a run of the
benchmark.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

if __package__ in (None, ""):
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from perfbench import datagen  # noqa: E402
from perfbench.harness import reference_module  # noqa: E402
from perfbench.reference.common import adam_steps  # noqa: E402


def _values(train, m: int, seed: int):
    X = train[0]
    rng = np.random.default_rng(seed)
    return {".kernel.variance": np.array(1.0),
            ".kernel.lengthscales": np.ones(X.shape[1]),
            ".inducing_Z": X[np.sort(rng.choice(len(X), m, replace=False))],
            ".noise_variance": np.array(0.1), ".mean.c": np.array([0.0])}


def measure(ref, cfg, train, values, share: int, steps: int,
            device: torch.device):
    """One JSON-able record of ``steps`` reference steps as rank 0 of
    ``share`` ranks."""
    saved = {k: getattr(ref, k) for k in ("_ranks", "_sum_ranks", "_matvec",
                                          "pcg")}
    spent = {"matvec_s": 0.0, "matvecs": 0, "cg_steps": []}

    def timed_matvec(*args):
        op = saved["_matvec"](*args)

        def matvec(p):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = op(p)
            torch.cuda.synchronize(device)
            spent["matvec_s"] += time.perf_counter() - t0
            spent["matvecs"] += 1
            return out

        return matvec

    def counted_pcg(*args):
        if share > 1:  # to the cap: the partial sums are no operator
            args = args[:4] + (0.0,) + args[5:]
        out = saved["pcg"](*args)
        spent["cg_steps"].append(out[1])
        return out

    if share > 1:
        ref._ranks = lambda: (0, share)
        ref._sum_ranks = lambda x: x
    ref._matvec, ref.pcg = timed_matvec, counted_pcg
    dt = torch.float64
    X = torch.as_tensor(train[0], dtype=dt, device=device)
    Y = torch.as_tensor(train[1], dtype=dt, device=device)
    raw = ref.raw_leaves(values, cfg["positive_lower"], dt, device)
    carry = {"v": torch.zeros(1, X.shape[0], dtype=dt, device=device)}
    times = []

    def loss_grad(raw, k):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        loss, grad, carry["v"] = ref.loss_and_grad(raw, X, Y, carry["v"],
                                                   cfg)
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
        return loss, grad

    torch.cuda.reset_peak_memory_stats(device)
    try:
        losses, _, _ = adam_steps(raw, loss_grad, steps,
                                  float(cfg["learning_rate"]))
    finally:
        for k, v in saved.items():
            setattr(ref, k, v)
    return {"share": share, "n_train": int(X.shape[0]),
            "num_inducing": int(values[".inducing_Z"].shape[0]),
            "step_s": times, "matvec_s": spent["matvec_s"],
            "matvecs": spent["matvecs"], "cg_steps": spent["cg_steps"],
            "losses": losses,
            "peak_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--set", nargs="*", default=[],
                    help="key=value (JSON) over the configuration")
    ap.add_argument("--share", type=int, nargs="+", default=[1])
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    with open(args.config) as f:
        cfg = json.load(f)
    for item in args.set:
        key, value = item.split("=", 1)
        cfg[key] = json.loads(value)
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    train, _ = datagen.split_dataset(cfg["dataset"], args.seed)
    print(f"data {time.perf_counter() - t0:.1f} s: {train[0].shape}",
          file=sys.stderr, flush=True)
    values = _values(train, int(cfg["num_inducing"]), args.seed)
    ref = reference_module(cfg)
    for share in args.share:
        out = measure(ref, cfg, train, values, share, args.steps, device)
        out.update(reference=ref.__name__, card=torch.cuda.get_device_name(
            device))
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
