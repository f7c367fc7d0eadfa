#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cglb_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                        # the smoke run below
    python3 chip_smoke.py --compare OLD . . OLD  # times of trees, in turns

Phases, each of which fails the run (non-zero exit) on error:

1. device and build: the card's name and power limit (nvidia-smi), then the
   CUDA kernels built from cglb_tpu_torch/csrc with nvcc, and the
   ``-Xptxas -v`` registers and spills of kernels 1 and 2 (narrow and
   wide) and of kernel 3 (per family and type);
2. each kernel against its plain PyTorch version at the main path's shapes
   (N = 26800, D = 8, M = 2048, B = 1, both kernel families; kernel 1 also
   at the prediction shapes 26800 x 13200 and 13200 x 26800): errors
   relative to max |plain|, bitwise-equal repeat launches, median times from
   CUDA events beside each kernel's bound (the larger of its operations over
   the card's peak rate and its bytes over the memory rate), and, for
   context, torch.mv over a materialized fp32 K; then kernel 3 at the
   registry datasets' widths D 9, 17 and 27 (padded to 16, 24, 32; M 2048,
   N 26800, both families) against its plain version, with e and without,
   repeats bitwise, times beside bounds;
3. the main path: the port's CLI trainer in-process,
   ``train -n 5 -d Wilson_kin40k -o adam_0.01 cglb -m cglb -k Matern32 -i cv
   -M 2048`` in fp64, its results.json checked and the kernels' launch
   counts over that run read; then warm Adam steps of the same model timed
   on the host clock and, under torch.profiler, their device time (the
   kernels, copies and fills on the card, not the GPU-side spans of the
   steps' own annotations; at most the profiled window's wall time) and
   kernel launches per step;
4. the anchor: the parameters of the TPU run runs/kin40k-2000-scipy4-r4
   loaded into the port on the same synthetic data; elbo and the upper bound
   must match that run's results.json, the CGLB bound at converged v must lie
   between them, and test rmse/nlpd must agree;
5. the scipy4 protocol run, whole: ``train -n 2000 -d Wilson_kin40k -o scipy4
   cglb -m cglb -k Matern32 -i cv -M 2048`` under a wall-clock guard, with
   its attempts, the frozen inducing points, the bracket at a re-solved v,
   the launches of each kernel and loss / test rmse / nlpd beside the TPU
   run's;
6. the variants, 2 Adam steps each through the CLI: cglbnm2, cglbn2m (with
   its peak device memory), cglb --vjoint (v0 must move), cglb --vzero,
   sgprn2m;
7. ``-o scipy_tol -n 30 -e 1.0``: at least one tightened level, whose CG
   runs on kernel 1's accurate tier only;
8. ``-o scipy -n 6 --ckpt-every 2``, then ``--resume -n 10`` in the same
   directory: at most 4 more iterations, from the saved warm start;
9. the exact-GP arm, whose batches exceed one launch's 8 rows: kernel 1 at
   B = 8 and 10 (26800^2, symmetric) and at B = 64 on the general path
   (26800 x 13200, and 26800 x 40000 as the metrics give it), kernel 2 at
   B = 10, each against its plain version, repeated bitwise, with ms per
   call and per group; then ``train -n 20 --holdout-interval 10 -o adam_0.001
   gpr -m exactgp -k Matern32`` through the CLI (the staged schedule: L-BFGS
   and Adam on 10000 rows, Adam on all 26800): results.json, the launches of
   kernels 1 and 2 (kernel 3: none), seconds per phase and per full-data
   step, CG steps of both solves, and the share of kernels 1-2 in the
   device time of two more such steps under torch.profiler;
10. the exact-GP anchor: the parameters of the TPU run
    runs/compare/Wilson_kin40k/gpr-Matern32-fp64/0 through ``gpr_metric``
    (one dense fp64 Cholesky at 26800) and ``metric ... gpr -m exactgp``: the
    iterative lml over five seeds against the dense one and its mean
    against the TPU run's (the same estimator), the CG mean's rmse / nlpd
    against the dense mean's, and both beside the TPU run's;
11. 3 iterations each of ``-o lbfgs`` and ``-o lbfgs_native`` on cglb
    (M 2048) and 2 of ``-o staged gpr -m gpr`` (dense, 26800 rows), with
    peak device memory;
12. kernel 1's symmetric path in slabs of column blocks: at N 26800 with
    its row-sum budget cut to force at least 3 slabs, against the plain
    version in both tiers, repeats bitwise equal; at houseelectric's
    N_train 1,373,017, D 11, B 1 against the general path (also a kernel:
    the plain version is O(N^2) too slow there), with the times of kernels
    1-2 at that size beside their bounds (counted at D 11), kernels 1-2
    on a ``cglb-houseelectric.mesh4`` rank's general path (442,200 x
    110,550, D 11 at ``coord_plan``'s width, B 1; both tiers of kernel 1
    and kernel 2) against their plain versions in fp64, and kernel 3 on
    one chunk of its common terms (1024 x 65536, D 11, padded to 16)
    against its plain version and beside its bound;
13. the chunked common terms at the main path's shapes: the CGLB loss and
    every gradient with 4096-column chunks, each recomputed in the
    backward, against the one pass, at one fixed v, to 1e-10 relative,
    with the model's fp32 preconditioner (A cast a chunk at a time) and
    with an fp64 one, each build also against its own repeat;
14. houseelectric at full width: ``train -n 3 -d Wilson_houseelectric -o
    adam_0.01 cglb -m cglb -k Matern32 -i cv -M 1024`` in fp64 with
    ``--max-cg-iters 4`` (the cap of the JAX record runs/largen-1m-6step)
    and no metric evaluation inside the 3 steps, on the repository's
    stand-in data at the real shape (N_train 1,373,017, D 11): the chunk
    width and count, per Adam step its seconds, CG steps, kernel launches
    and peak allocated bytes (at most 40 GiB), the loss lower after 3 steps
    than at the start, elbo and cg_lower_bound at most the upper bound,
    finite test rmse and nlpd;
15. input dimensions above 32, where the wide kernels run: kernels 1-3 at D
    40 and 100 (coordinates padded to 40 and 104; kernel 3 is the same
    kernel at every width), both families, N 26800
    (kernels 1 and 2 on K(X, X), the symmetric path, and on two prepared
    sets of the same points, the general path, at B = 1 and 10, kernel 1
    in both tiers; kernel 2 also on the data translated by +100 in every
    coordinate against the untranslated plain gradient, the guard of its
    moment expansion; kernel 3 at M 1024) against their plain versions,
    repeats bitwise equal, times beside bounds counted at D (K(X, X)'s
    pairs once); then ``train -n 3 --holdout-interval -1 -d
    synth_30000x40 -o adam_0.01 cglb -m cglb -k Matern32 -i cv -M 1024``
    through the CLI: kernels 1-3 launched, the loss lower after 3 steps,
    elbo and cg_lower_bound at most the upper bound, finite test metrics;
16. the sweep runner: ``cglb_tpu_torch/experiments/grids/proof.toml`` (the
    points of the TPU sweep runs/sweep-tpu-proof: kin40k, M 128-2048, 100
    scipy steps) with ``-p 1`` in a fresh directory, five results.json and
    five event files; a second call skips all five; ``plotcli
    results_table`` then prints five rows with finite values and test rmse
    at most 0.50, each beside the TPU run's (reported, not asserted);
17. CGLB over ``torch.distributed`` (``cglb_tpu_torch/parallel``), kin40k at
    full width, fp64, fp64 preconditioner for the parity checks: first NCCL
    at world size 1 in this process, then two gloo ranks sharing the card
    (processes of this script, ``--mesh-rank``).  At each rank the sharded
    streaming loss (kernel 3 on the rank's Kuf columns, kernels 1-2 on its
    columns of K(X, X)) against the one-process ``cglb.loss`` on the same
    card: at CG capped at 4 steps from zeros, the loss to 1e-9; at a
    converged v (no CG step), the loss to 1e-9 and every gradient to 1e-7;
    kernels 1-3 launched.  Then, in the two ranks, ``--mesh 2 --dist-backend
    gloo`` with phase 3's command through the CLI: the losses of its
    objective evaluations (five steps and the logger's at step 0) beside
    phase 3's (the one-process run's CG takes the fp32 tier, the sharded
    one the accurate tier: within 1e-4), both ranks' final parameters
    bitwise equal, one results.json and one event file (rank 0's), elbo
    and cg_lower_bound at most the upper bound.  Rank 0's kernels 1-3 on
    its column half (rows all of X, columns its block: kernel 1 and 2 on
    their general path) against their plain versions with phase 2's
    tolerances, and a step's seconds and those kernels' times beside their
    bounds, printed as what they are: two ranks sharing one card, not a
    multi-GPU speed;
18. prediction at the main path's full width, at phase 4's parameters on
    the kin40k stand-in (26800 training and 13200 test rows, D 8, M 2048,
    fp64, Matern32): ``Model.predict_log_density(test, cg_tolerance=1e-6)``
    on the streaming path, with its CG solves (steps, residual, which
    preconditioner ended it), kernel launches (kernels 1 and 3, not 2),
    seconds and -mean(log density), which must lie within 0.01 of the TPU
    run's test/nlpd 0.6470 and of phase 4's metrics_fn value (CG at 1e-3),
    with the residual at most 1e-6; the same through the dense operator
    (K(X, X) in fp64, 5.7 GB), to 1e-4 nats a point; ``sgpr.predict_f``
    and ``cglb.predict_f`` (streaming operator, ``kernel_cross_matvec``)
    with ``full_cov=True`` on all 13200 test rows: [1, 13200, 13200] in
    fp64, symmetric to 1e-12 of its max, its diagonal the marginal
    variance to 1e-10 of max kdiag, CGLB's equal to SGPR's to 1e-9, and
    var + sigma^2 I factors, with seconds and peak allocated bytes; kernel
    3 on K(Xs, Xs) (13200 x 13200, without e) against its plain version to
    1e-12, its diagonal exactly the variance, repeats bitwise equal, timed
    beside its bound (8 bytes an entry written); ConditionalVariance on the
    card against the numpy oracle on the host (26800 rows, M 512, seed 0):
    the same indices, or a tie to 1e-12 where they first differ;
19. the lower solve with many columns (``ops/chol.py`` ``solve_lower``) on
    the main path's L and Kuf (the kin40k model as the CLI builds it, fp64,
    M 2048): at [2048, 26800] and at [2048, S] for S 13200, 8192, 6144,
    4096, 1024 and 64, the blocked solve (``SOLVE_BLOCK`` rows a block, forced at every
    width) and the builtin trsm (``library_ms``) timed forward and forward
    plus backward, beside the bound M^2 K fp64 operations at the tensor
    cores' 67 TFLOP/s (1.68 ms at the full width); the blocked result and
    gradients against the builtin's to 1e-10 relative, and the entry point
    blocked from ``SOLVE_MIN_WIDTH`` columns on; its counters over 3 Adam
    steps (one blocked solve forward and one backward a step) and over
    ``Model.predict_log_density`` requests of 64 to 13200 test rows (A's
    solve, and the projections' two from ``SOLVE_MIN_WIDTH`` rows on).

With ``--protocol-adam`` no phase runs: ``grids/protocol-adam.toml`` (the
command of the TPU run runs/kin40k-2000-adam-r4, 2000 Adam steps) goes
through the sweep runner from the repository root, and its best and final
loss and test rmse are printed beside that run's.

With ``--mesh-rank DIR`` no phase runs: the process is one rank of phase
17's group (from ``CGLB_COORDINATOR``), writing what it saw into DIR.

With ``--compare TREE ...`` no phase runs.  Each tree (a directory holding
a ``cglb_tpu_torch`` package, such as an older commit unpacked with ``git
archive``) is timed in a process of its own, which builds that tree's
kernels: the kernel rows of phase 2 (Matern32, without the plain versions),
phase 15's rows of the wide kernels at D 40 and 100 (Matern32, with their
bounds), kernel 3 at D 9, 17 and 27 (2048 x 26800) and on phase 12's
houseelectric chunk (1024 x 65536, D 11), kernels 1-2 at D 9, 11 and 16
on ``cglb-houseelectric.mesh4``'s shapes (a rank's general path, 442,200
x 110,550, and the symmetric path on 442,200 rows; each tree pads D by its
own ``coord_plan``), and the warm Adam steps of phase 3.  The median of
each row over
the runs of each tree is printed last, beside the card's name and power
limit.

The last three lines are a JSON object with one entry per kernel (kernel 3
one per D: 8, 9, 11, 17, 27, 40, 100, and one on phase 18's K(Xs, Xs)),
the card's name and power limit, and ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository beside it, the script exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

# the kernels' roofline: the benchmark's own counts, read and never copied
from perfbench.counts import (PEAK_BYTES, bound, kuf_bound, ls_grad_bound,
                              matvec_bound)

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

N, D, M, N_TEST = 26800, 8, 2048, 13200
TOL = {  # relative to max |plain|
    "matvec_accurate": 3e-6,
    "matvec_cg": 2e-3,
    "cross_matvec": 3e-6,
    "kuf": 1e-12,
    "backward": 1e-5,
}
# fp64 on the tensor cores (DGEMM): the rate phase 19 holds the solve to
PEAK_FP64_TENSOR = 67e12
ANCHOR = ROOT / "runs" / "kin40k-2000-scipy4-r4"
_HEAD = ["-t", "fp64", "-s", "0", "train"]
_DATA = ["-d", "Wilson_kin40k"]
_MODEL = ["-k", "Matern32", "-i", "cv", "-M", str(M)]
CLI_ARGS = _HEAD + ["-n", "5"] + _DATA + ["-o", "adam_0.01", "cglb", "-m",
                                          "cglb"] + _MODEL
SCIPY4_ARGS = _HEAD + ["-n", "2000"] + _DATA + ["-o", "scipy4", "cglb", "-m",
                                                "cglb"] + _MODEL
# the whole scipy4 run must end within this, or the script fails
SCIPY4_GUARD_S = 420.0
# the TPU run runs/kin40k-2000-scipy4-r4: loss, test rmse, test nlpd
REFERENCE = {"loss": 19274.1, "test/rmse": 0.4620, "test/nlpd": 0.6470}
# houseelectric (experiments/datasets.py: the stand-in at the real shape, N
# 2,049,280, D 11; 1,373,017 training rows), M 1024 as scripts/large_n_aot.py
# and BASELINE.md's houseelectric row, fp64.  Cut: 3 Adam steps, CG capped
# at 4 steps (runs/largen-1m-6step's cap), no metric evaluation inside the
# run (the final one writes results.json).
HOUSE_N, HOUSE_D, HOUSE_M = 1_373_017, 11, 1024
HOUSE_ARGS = ["-t", "fp64", "-s", "0", "--max-cg-iters", "4", "train", "-n",
              "3", "--holdout-interval", "-1", "-d", "Wilson_houseelectric",
              "-o", "adam_0.01", "cglb", "-m", "cglb", "-k", "Matern32",
              "-i", "cv", "-M", str(HOUSE_M)]
HOUSE_PEAK_GIB = 40.0  # allocated by one Adam step (loss, gradient, update)
CHUNKED_TOL = 1e-10  # chunked against one pass, relative to max |one pass|
# the exact-GP arm: the command of the TPU run below, cut from 500 steps
EXACTGP_ARGS = ["-t", "fp64", "-s", "0", "train", "-n", "20",
                "--holdout-interval", "10"] + _DATA + [
                    "-o", "adam_0.001", "gpr", "-m", "exactgp", "-k",
                    "Matern32"]
GPR_ANCHOR = (ROOT / "runs" / "compare" / "Wilson_kin40k"
              / "gpr-Matern32-fp64" / "0")
# iterative against dense at the TPU run's parameters, on the card.  Both CG
# solves stop at their cap of 200 there, unconverged, and SLQ has 25 nodes: the
# iterative lml sits 2.6 % below the dense one (seeds 0-4: -18492 to -18546,
# sd 26, against -18026.87) and the CG mean's test rmse / nlpd 9.7e-3 /
# 4.6e-2 above the dense mean's.  Bounds: about twice what was measured.
# The 5 % on lml is that documented bias and checks little; what holds the
# estimator is "lml_vs_tpu_run": the TPU run's lml comes from the same
# estimator with the same bias (other probes), so the mean over seeds 0-4
# must lie within 100 nats of it, about 4 sd of one estimate.
EXACTGP_TOL = {"lml": 0.05, "test/rmse": 0.02, "test/nlpd": 0.1,
               "lml_vs_tpu_run": 100.0}


# phase 15: input dimensions above 32 (the wide kernels) at N 26800, M 1024,
# batches 1 and 10; then the CLI at D 40 (synth_30000x40: 20100 training
# rows), 3 Adam steps, no metric evaluation inside the run
WIDE_DS = (40, 100)
WIDE_M = 1024
WIDE_B = (1, 10)
WIDE_ARGS = ["-t", "fp64", "-s", "0", "train", "-n", "3",
             "--holdout-interval", "-1", "-d", "synth_30000x40", "-o",
             "adam_0.01", "cglb", "-m", "cglb", "-k", "Matern32", "-i", "cv",
             "-M", str(WIDE_M)]
# kernel 3 at the registry datasets' widths (experiments/datasets.py:
# protein D 9, bike 17, keggundirected 27; kuf_plan pads them to 16, 24,
# 32), at the main path's M x N; houseelectric's D 11 is phase 12's chunk
KUF_DS = (9, 17, 27)
# --compare: kernels 1-2 at D 9 (protein), 11 (houseelectric) and 16, at
# the shapes of cglb-houseelectric.mesh4: a rank's general path (its
# 442,200 rows against its 110,550 columns) and one card's symmetric path
# on the 442,200 rows
MID_DS = (9, 11, 16)
RANK_ROWS, RANK_COLS = 442_200, 110_550
# phase 16: the proof grid (the TPU sweep runs/sweep-tpu-proof's points)
GRIDS = ROOT / "cglb_tpu_torch" / "experiments" / "grids"
PROOF_GRID = GRIDS / "proof.toml"
PROOF_TPU = ROOT / "runs" / "sweep-tpu-proof" / "results_table.md"
PROOF_RMSE = 0.50
# --protocol-adam: the TPU run runs/kin40k-2000-adam-r4's command, whole
ADAM_GRID = GRIDS / "protocol-adam.toml"
ADAM_TPU = ROOT / "runs" / "kin40k-2000-adam-r4"
# phase 17: phase 3's command over two gloo ranks sharing the card
MESH_ARGS = ["--mesh", "2", "--dist-backend", "gloo"] + CLI_ARGS
# sharded against one process: the loss (capped CG, and at a converged v),
# every gradient at that v, relative to max |one process|; the five losses
# of the CLI runs (CG tier against accurate tier in CG)
MESH_TOL = {"loss": 1e-9, "grad": 1e-7, "run_loss": 1e-4}
MESH_CG_CAP = 4
MESH_RANK_TIMEOUT_S = 400.0
# phase 18: prediction at the main path's full width.  The CG tolerance of
# Model.predict_log_density; bounds: test nlpd against the TPU run's and
# metrics_fn's (section 2 of PERF.md: 0.01), the dense path's mean log
# density (nats a point), the covariance's diagonal against the marginal
# variance (of max kdiag), its symmetry (of its max) and CGLB's against
# SGPR's (of its max: LB by two paths); ConditionalVariance at M 512
PREDICT_CG_TOL = 1e-6
PREDICT_TOL = {"nlpd": 0.01, "dense_nats": 1e-4, "diag": 1e-10,
               "sym": 1e-12, "cglb_vs_sgpr": 1e-9}
CV_M = 512


class SmokeFailure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def under_load(fn, reps: int) -> str:
    """The card's SM clock and power draw (nvidia-smi), read 1 s into
    ``reps`` calls of ``fn`` (about 2 s of work) from a second thread."""
    read = []

    def sample():
        time.sleep(1.0)
        read.append(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip().splitlines()[0])

    reader = threading.Thread(target=sample)
    reader.start()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    reader.join(timeout=60)
    return read[0] if read else "not read"


def cuda_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn``: ``reps`` calls enqueued back to back
    between two CUDA events, so that the host's own time per call overlaps
    the device's work; median of three such runs, after one warm-up call."""
    fn()
    per_call = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def rel_err(got: torch.Tensor, want: torch.Tensor):
    """(max |got - want| / max |want|, max |got - want|)."""
    diff = float(torch.max(torch.abs(got.double() - want.double())))
    return diff / float(torch.max(torch.abs(want))), diff


def show(name: str, ms: float, bnd, extra: str = "") -> None:
    print(f"[kernels] {name}: {ms:.4f} ms, bound {bnd[0]:.4f} ms "
          f"({bnd[1]}), {100 * bnd[0] / ms:.1f} % of bound{extra}",
          flush=True)


# --------------------------------------------------------------------------
# phase 1
# --------------------------------------------------------------------------


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
# template arguments of the mangled names: <FAM, DP, B[, Acc], SYM>, and of
# the wide kernels <FAM, B[, Acc], SYM> (DP at run time: "wide")
_STREAMING = re.compile(r"(matvec_kernel|ls_grad_kernel)"
                        r"ILi(\d)ELi(\d+)ELi(\d)E([df]?)Lb(\d)E")
_WIDE = re.compile(r"(matvec_wide_kernel|ls_grad_wide_kernel)"
                   r"ILi(\d)E()Li(\d)E([df]?)Lb(\d)E")
_FAMILY_NAME = {"0": "rbf", "1": "mat32"}
# kernel 3: <FAM, T>
_KUF = re.compile(r"(kuf_tile_kernel)ILi(\d)E([df])E")


def register_report(log: str) -> dict:
    """{(kernel, tier): ["family/DP/B: R regs, spill S/L B", ...]} of
    kernels 1 and 2, narrow and wide, and {("kuf_tile_kernel", "family /
    type"): ["family/type: R regs, spill S/L B", ...]} of kernel 3, from an
    ``-Xptxas -v`` log."""
    out: dict = {}
    name = None
    spill = ""
    for line in log.splitlines():
        entry = _ENTRY.search(line)
        if entry:
            name = (_STREAMING.search(entry.group(1))
                    or _WIDE.search(entry.group(1))
                    or _KUF.search(entry.group(1)))
            continue
        if name is None:
            continue
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if found:
            spill = f"{found.group(1)}/{found.group(2)}"
        found = re.search(r"Used (\d+) registers", line)
        if found and name.re is _KUF:
            kernel, fam, typ = name.groups()
            out.setdefault((kernel, "family/type"), []).append(
                f"{_FAMILY_NAME[fam]}/{'fp64' if typ == 'd' else 'fp32'}: "
                f"{found.group(1)} regs, spill {spill or '0/0'} B")
            name, spill = None, ""
        elif found:
            kernel, fam, dp, b, acc, sym = name.groups()
            dp = dp or "wide"
            tier = {"d": "accurate", "f": "cg", "": "ls_grad"}[acc]
            tier += " symmetric" if sym == "1" else ""
            out.setdefault((kernel, tier), []).append(
                f"{_FAMILY_NAME[fam]}/{dp}/{b}: {found.group(1)} regs, "
                f"spill {spill or '0/0'} B")
            name, spill = None, ""
    return out


def print_registers(log: str) -> dict:
    report = register_report(log)
    for (kernel, tier), rows in sorted(report.items()):
        what = tier if tier == "family/type" else f"{tier} (family/DP/B)"
        print(f"[build] {kernel} {what}: " + "; ".join(rows), flush=True)
    return report


def _sass_loops(listing: str) -> list:
    """[(instructions, {opcode: count})] of each loop (a branch back to an
    earlier address) in one function's ``cuobjdump -sass`` listing."""
    ins = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", listing)]
    at = {a: i for i, (a, _) in enumerate(ins)}
    loops = []
    for i, (a, op) in enumerate(ins):
        target = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
        if target and int(target.group(1), 16) <= a \
                and int(target.group(1), 16) in at:
            body = [o for _, o in ins[at[int(target.group(1), 16)]:i + 1]]
            ops: dict = {}
            for o in body:
                word = o.split()[1 if o.startswith("@") else 0]
                ops[word.split(".")[0]] = ops.get(word.split(".")[0], 0) + 1
            loops.append((len(body), ops))
    return loops


def sass_census() -> None:
    """Instructions a pair and coordinate in the inner loops of the wide
    kernels (Matern32, B 1, symmetric) and of kernel 3 (Matern32, fp64),
    from ``cuobjdump -sass`` of the built library: the t loop (as many FADD
    as FFMA, or DADD as DFMA, one of each per pair and coordinate) and
    kernel 2's moment loop (FFMA only, one per pair and coordinate); the
    listings go to chiprun_out/wide_sass.txt and kuf_sass.txt."""
    from cglb_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("[build] cuobjdump not found: no SASS census", flush=True)
        return
    sass = subprocess.run([tool, "-sass", str(_build.LIB_PATH)], check=True,
                          capture_output=True, text=True,
                          timeout=300).stdout
    kept, kuf = [], []
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if _KUF.search(name) and _KUF.search(name).group(2, 3) == ("1", "d"):
            kuf.append("Function : " + part)
            for length, ops in _sass_loops(part):
                dfma, dadd = ops.get("DFMA", 0), ops.get("DADD", 0)
                if dfma >= 32 and dadd == dfma:
                    print(f"[build] SASS kuf_tile_kernel mat32 fp64 t loop: "
                          f"{length} instructions for {dfma} DFMA, {dadd} "
                          f"DADD, {ops.get('LDS', 0)} LDS: "
                          f"{length / dfma:.3f} instructions an entry and "
                          f"coordinate", flush=True)
            continue
        found = _WIDE.search(name)
        if not found or found.group(2, 4, 6) != ("1", "1", "1"):
            continue
        kept.append("Function : " + part)
        for length, ops in _sass_loops(part):
            ffma, fadd = ops.get("FFMA", 0), ops.get("FADD", 0)
            if ffma < 32 or fadd not in (0, ffma):  # not an inner loop
                continue
            kind = "t loop" if fadd else "moment loop"
            per = length / ffma
            tier = {"d": " accurate", "f": " CG tier", "": ""}[
                found.group(5)]
            print(f"[build] SASS {found.group(1)}{tier} symmetric B 1 "
                  f"{kind}: {length} instructions for {ffma} FFMA, {fadd} "
                  f"FADD, {ops.get('LDS', 0)} LDS: {per:.3f} instructions "
                  f"a pair and coordinate", flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "wide_sass.txt").write_text("".join(kept))
    (OUT / "kuf_sass.txt").write_text("".join(kuf))


def phase_build() -> dict:
    """Build the kernels; returns phase 1's register report."""
    from cglb_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    torch.cuda.synchronize()
    log = _build.LOG_PATH.read_text() if _build.LOG_PATH.exists() else ""
    regs = [line for line in log.splitlines() if "Used " in line
            and "registers" in line]
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke_build.log").write_text(log)
    print(f"[build] kernels loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds():.2f} s); {len(regs)} kernel "
          f"instantiations, register report in chiprun_out/"
          "chip_smoke_build.log", flush=True)
    report = print_registers(log)
    sass_census()
    return report


# --------------------------------------------------------------------------
# phase 2
# --------------------------------------------------------------------------


def _plain_function_grads(X, family, p, var, ls, g, chunk=2048):
    """dp, dvar, dls of sum(g * (var * p @ K(X, X))) by plain autograd,
    column chunk by column chunk (the dense graph would not fit)."""
    from cglb_tpu_torch.ops import kernels as _k

    prof = _k.KERNELS[family](D, dtype=torch.float64, device=X.device)
    p = p.detach().clone().requires_grad_(True)
    var = var.detach().clone().requires_grad_(True)
    ls = ls.detach().clone().requires_grad_(True)
    for c0 in range(0, X.shape[0], chunk):
        xs = X / ls
        xc = xs[c0:c0 + chunk]
        d2 = torch.zeros(X.shape[0], xc.shape[0], dtype=X.dtype,
                         device=X.device)
        for d in range(D):
            diff = xs[:, d, None] - xc[None, :, d]
            d2 = d2 + diff * diff
        kc = var * prof.profile(d2)
        torch.sum(g[:, c0:c0 + chunk] * (p @ kc)).backward()
    return p.grad, var.grad, ls.grad


def kernel_inputs():
    """X [N, D], X_test [N_TEST, D], Z [M, D], p and g [1, N], lengthscales
    and variance on the card, from numpy seed 0."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.normal(size=(N, D)), device=dev)
    Xc = torch.as_tensor(rng.normal(size=(N_TEST, D)), device=dev)
    Z = torch.as_tensor(rng.normal(size=(M, D)), device=dev)
    p = torch.as_tensor(rng.normal(size=(1, N)), device=dev)
    g = torch.as_tensor(rng.normal(size=(1, N)), device=dev)
    ls = torch.as_tensor(rng.uniform(0.5, 2.0, size=D), device=dev)
    var = torch.as_tensor(1.7, dtype=torch.float64, device=dev)
    return X, Xc, Z, p, g, ls, var


def kernel_rows(family: str, inputs) -> dict:
    """{row: (launch, plain version or None, bound)} of the kernel times
    taken at the main path's shapes: kernel 1 on K(X, X) in both tiers, on
    X prepared twice (the general path), and on the prediction shapes;
    kernel 2 on K(X, X), one prepared set and two; kernel 3."""
    from cglb_tpu_torch.ops import kuf as _kuf
    from cglb_tpu_torch.ops import matvec as _mv

    X, Xc, Z, p, g, ls, var = inputs
    rows = _mv.Prepared(X, ls, family)
    rows2 = _mv.Prepared(X, ls, family)
    cols = _mv.Prepared(Xc, ls, family)
    pt = p[:, :N_TEST]
    scale = math.sqrt(_mv.GAMMA[family])
    zg, xg = Z * (scale / ls), X * (scale / ls)

    def matvec(r, c, pp, accurate):
        return lambda: _mv.launch_matvec(r, c, pp, accurate)

    return {
        "streaming_matvec": (
            matvec(rows, rows, p, True),
            lambda: _mv.matvec_unit_plain(rows.xg, rows.xg, p, family),
            matvec_bound(N, N, D, 1, True, symmetric=True)),
        "streaming_matvec_cg": (
            matvec(rows, rows, p, False), None,
            matvec_bound(N, N, D, 1, False, symmetric=True)),
        "streaming_matvec general path": (
            matvec(rows, rows2, p, True), None,
            matvec_bound(N, N, D, 1, True)),
        f"cross matvec {N}x{N_TEST}": (
            matvec(rows, cols, p, True), None,
            matvec_bound(N, N_TEST, D, 1, True)),
        f"cross matvec {N_TEST}x{N}": (
            matvec(cols, rows, pt, True), None,
            matvec_bound(N_TEST, N, D, 1, True)),
        "ls_grad": (
            lambda: _mv.launch_ls_grad(rows, rows, p, g),
            lambda: _mv.ls_grad_unit_plain(rows.xg, rows.xg, p, g, family),
            ls_grad_bound(N, N, D, 1, symmetric=True)),
        "ls_grad general path": (
            lambda: _mv.launch_ls_grad(rows, rows2, p, g), None,
            ls_grad_bound(N, N, D, 1)),
        "kuf": (
            lambda: _kuf.launch_kuf(zg, xg, var, family),
            lambda: _kuf.kuf_unit_plain(zg, xg, var, family),
            kuf_bound(M, N, D)),
    }


def phase_kernels(results: dict) -> None:
    from cglb_tpu_torch.ops import kuf as _kuf
    from cglb_tpu_torch.ops import matvec as _mv

    inputs = kernel_inputs()
    X, Xc, Z, p, g, ls, var = inputs

    for family in ("mat32", "rbf"):
        rows = _mv.Prepared(X, ls, family)
        cols = _mv.Prepared(Xc, ls, family)
        plain = _mv.matvec_unit_plain(rows.xg, rows.xg, p, family)

        acc = _mv.launch_matvec(rows, rows, p, True)
        err, abs_err = rel_err(acc, plain)
        print(f"[kernels] {family} matvec accurate tier: rel err {err:.3e} "
              f"(bound {TOL['matvec_accurate']:g})", flush=True)
        require(err <= TOL["matvec_accurate"], f"{family} accurate matvec")
        cg = _mv.launch_matvec(rows, rows, p, False)
        cg_err, _ = rel_err(cg, plain)
        print(f"[kernels] {family} matvec CG tier: rel err {cg_err:.3e} "
              f"(bound {TOL['matvec_cg']:g})", flush=True)
        require(cg_err <= TOL["matvec_cg"], f"{family} CG-tier matvec")
        pt = p[:, :N_TEST]
        cross = _mv.launch_matvec(rows, cols, p, True)
        cross_t = _mv.launch_matvec(cols, rows, pt, True)
        for shape, got, ref in (
                (f"{N}x{N_TEST}", cross,
                 _mv.matvec_unit_plain(rows.xg, cols.xg, p, family)),
                (f"{N_TEST}x{N}", cross_t,
                 _mv.matvec_unit_plain(cols.xg, rows.xg, pt, family))):
            x_err, _ = rel_err(got, ref)
            print(f"[kernels] {family} cross matvec {shape}: rel err "
                  f"{x_err:.3e} (bound {TOL['cross_matvec']:g})", flush=True)
            require(x_err <= TOL["cross_matvec"],
                    f"{family} cross matvec {shape}")

        # the Function backward (kernel 1 for dp, kernel 2 for dls)
        pv = p.detach().clone().requires_grad_(True)
        vv = var.detach().clone().requires_grad_(True)
        lv = ls.detach().clone().requires_grad_(True)
        prep = _mv.Prepared(X, lv, family)
        out = _mv._StreamingMatvec.apply(pv, vv, lv, prep, prep, True)
        torch.sum(g * out).backward()
        want = _plain_function_grads(X, family, p, var, ls, g)
        for name, got, ref in zip(("dp", "dvar", "dls"),
                                  (pv.grad, vv.grad, lv.grad), want):
            # dp is one more accurate-tier launch of kernel 1 (g K^T)
            tol = TOL["matvec_accurate" if name == "dp" else "backward"]
            e, e_abs = rel_err(got.reshape(ref.shape), ref)
            print(f"[kernels] {family} backward {name}: rel err {e:.3e} "
                  f"(bound {tol:g})", flush=True)
            require(e <= tol, f"{family} backward {name}")
            if name == "dp":
                dp_err = (e, e_abs)

        ls_plain = _mv.ls_grad_unit_plain(rows.xg, rows.xg, p, g, family)
        ls_k = _mv.launch_ls_grad(rows, rows, p, g)
        ls_err, ls_abs = rel_err(ls_k, ls_plain)
        print(f"[kernels] {family} ls-grad kernel vs plain: rel err "
              f"{ls_err:.3e} (bound {TOL['backward']:g})", flush=True)
        require(ls_err <= TOL["backward"], f"{family} ls-grad")

        c = math.sqrt(_mv.GAMMA[family])
        zg, xg = Z * (c / ls), X * (c / ls)
        kuf_k, e_k = _kuf.launch_kuf(zg, xg, var, family)
        kuf_p, e_p = _kuf.kuf_unit_plain(zg, xg, var, family)
        kuf_err, kuf_abs = rel_err(kuf_k, kuf_p)
        e_err, _ = rel_err(e_k, e_p)
        print(f"[kernels] {family} Kuf {M}x{N}: rel err {kuf_err:.3e}, "
              f"residual e {e_err:.3e} (bound {TOL['kuf']:g})", flush=True)
        require(max(kuf_err, e_err) <= TOL["kuf"], f"{family} Kuf")

        # fixed summation order, no atomics: repeat launches are bitwise equal
        repeats = {
            "matvec accurate": (acc, lambda: _mv.launch_matvec(rows, rows, p,
                                                               True)),
            "matvec CG tier": (cg, lambda: _mv.launch_matvec(rows, rows, p,
                                                             False)),
            "cross matvec": (cross, lambda: _mv.launch_matvec(rows, cols, p,
                                                              True)),
            "ls-grad": (ls_k, lambda: _mv.launch_ls_grad(rows, rows, p, g)),
            "Kuf": (kuf_k, lambda: _kuf.launch_kuf(zg, xg, var, family)[0]),
        }
        for name, (first, again) in repeats.items():
            same = torch.equal(first, again())
            print(f"[kernels] {family} {name}: repeat launch bitwise equal "
                  f"{same}", flush=True)
            require(same, f"{family} {name} is not deterministic")

        timings = {
            name: (cuda_ms(fn, 10), None if plain_fn is None
                   else cuda_ms(plain_fn, 3), bnd)
            for name, (fn, plain_fn, bnd) in kernel_rows(family,
                                                         inputs).items()}
        for name, (ms, plain_ms, bnd) in timings.items():
            show(f"{family} {name}", ms, bnd,
                 "" if plain_ms is None else f" (plain {plain_ms:.4f} ms)")
        if family == "mat32":  # the main path's family
            lib_ms = materialized_mv_ms(rows, p)
            print(f"[kernels] context, not a kernel of the port: torch.mv "
                  f"over a materialized fp32 K {N}x{N} (2.87 GB): "
                  f"{lib_ms:.4f} ms (read bound "
                  f"{N * N * 4 / PEAK_BYTES * 1e3:.4f} ms)", flush=True)
            for name, err_abs in (("streaming_matvec", abs_err),
                                  ("ls_grad", ls_abs), ("kuf", kuf_abs)):
                ms, plain_ms, (bound_ms, bound_by) = timings[name]
                results[name] = dict(
                    max_abs_err=err_abs, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
            results["streaming_matvec"]["ms_cg_tier"] = timings[
                "streaming_matvec_cg"][0]
            results["streaming_matvec"]["materialized_mv_ms"] = lib_ms
            results["streaming_matvec"]["dp_rel_err"] = dp_err[0]
            results["streaming_matvec"]["dp_max_abs_err"] = dp_err[1]
        del rows, cols, plain, acc, cg, cross, cross_t, kuf_k, e_k
        del kuf_p, e_p
        del repeats
        torch.cuda.empty_cache()


def materialized_mv_ms(rows, p: torch.Tensor) -> float:
    """torch.mv over K(X, X) materialized in fp32 (unit variance), for
    context: no single PyTorch call computes the streamed p @ K(X, X)."""
    from cglb_tpu_torch.ops import matvec as _mv

    x = rows.xg.float()
    K = torch.empty(x.shape[0], x.shape[0], dtype=torch.float32,
                    device=x.device)
    for c0 in range(0, x.shape[0], 4096):
        K[:, c0:c0 + 4096] = _mv._rho(rows.family, _mv._sq_dist_direct(
            x, x[c0:c0 + 4096]))
    v = p[0].float()
    ms = cuda_ms(lambda: torch.mv(K, v), 10)  # K is symmetric: K p = p K
    del K
    torch.cuda.empty_cache()
    return ms


def kuf_inputs(m: int, n: int, d: int, family: str):
    """Kernel 3's operands at input dimension d: Z [m, d] and X [n, d]
    times sqrt(gamma) / lengthscale (lengthscales sqrt(d / 8) x U(0.5, 2),
    so that Kuf is not near zero at this d) and the variance, on the card,
    from numpy seed d."""
    from cglb_tpu_torch.ops.kernels import GAMMA

    dev = torch.device("cuda")
    rng = np.random.default_rng(d)
    ls = math.sqrt(d / 8) * rng.uniform(0.5, 2.0, size=d)
    c = torch.as_tensor(math.sqrt(GAMMA[family]) / ls, device=dev)
    zg = torch.as_tensor(rng.normal(size=(m, d)), device=dev) * c
    xg = torch.as_tensor(rng.normal(size=(n, d)), device=dev) * c
    return zg, xg, torch.as_tensor(1.7, dtype=torch.float64, device=dev)


def check_kuf(tag: str, zg, xg, var, family: str) -> dict:
    """Kernel 3 against its plain version (Kuf and e, each relative to max
    |plain|), without e equal to with e, repeats bitwise equal; the kernel
    timed (10 calls) beside its bound at the data's d, the card's clock and
    power under it, the plain version timed once: the kernels line's row."""
    from cglb_tpu_torch.ops import kuf as _kuf

    (kuf_p, e_p), plain_ms = once_ms(
        lambda: _kuf.kuf_unit_plain(zg, xg, var, family))
    kuf_k, e_k = _kuf.launch_kuf(zg, xg, var, family)
    err, abs_err = rel_err(kuf_k, kuf_p)
    e_err, _ = rel_err(e_k, e_p)
    again, e_again = _kuf.launch_kuf(zg, xg, var, family)
    alone, none = _kuf.launch_kuf(zg, xg, var, family, with_e=False)
    same = (torch.equal(kuf_k, again) and torch.equal(e_k, e_again)
            and none is None and torch.equal(kuf_k, alone))
    del kuf_p, e_p, kuf_k, e_k, again, e_again, alone
    (m, d), n = zg.shape, xg.shape[0]
    ms = cuda_ms(lambda: _kuf.launch_kuf(zg, xg, var, family), 10)
    load = under_load(lambda: _kuf.launch_kuf(zg, xg, var, family, False),
                      int(2000 / ms))
    bound_ms, bound_by = kuf_bound(m, n, d)
    print(f"{tag} kernel 3 {m}x{n}, D {d} (width {_kuf.kuf_plan(d)}): rel "
          f"err {err:.3e}, residual e {e_err:.3e} (bound {TOL['kuf']:g}); "
          f"without e equal, repeats bitwise equal {same}; plain "
          f"{plain_ms:.2f} ms", flush=True)
    show(f"{family} kuf {m}x{n} D {d}", ms, (bound_ms, bound_by),
         f"; SM clock, power draw under it {load}")
    require(max(err, e_err) <= TOL["kuf"], f"{tag} kernel 3 D {d}")
    require(same, f"{tag} kernel 3 D {d} is not deterministic")
    torch.cuda.empty_cache()
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None, d=d,
                width=_kuf.kuf_plan(d), shape=[m, n], clock_power=load)


def phase_kuf_widths(results: dict, card: str) -> None:
    """Kernel 3 at the registry widths (KUF_DS) at the main path's M x N,
    both families, against its plain version."""
    for d in KUF_DS:
        for family in ("mat32", "rbf"):
            row = check_kuf(f"[kuf] {family} ({card})",
                            *kuf_inputs(M, N, d, family), family)
            if family == "mat32":  # the kernels line holds Matern32's
                results[f"kuf_d{d}"] = row


# --------------------------------------------------------------------------
# phase 3
# --------------------------------------------------------------------------


def _counters():
    from cglb_tpu_torch.ops import kuf as _kuf
    from cglb_tpu_torch.ops import matvec as _mv

    return {"streaming_matvec": _mv.launch_matvec,
            "ls_grad": _mv.launch_ls_grad, "kuf": _kuf.launch_kuf}


def _read_counts() -> dict:
    from cglb_tpu_torch.ops import matvec as _mv

    counts = {name: fn.launches for name, fn in _counters().items()}
    counts["accurate"] = _mv.launch_matvec.accurate_launches
    return counts


def _zero_counts() -> None:
    from cglb_tpu_torch.ops import matvec as _mv

    for fn in _counters().values():
        fn.launches = 0
    _mv.launch_matvec.accurate_launches = 0


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _mark() -> dict:
    """Seconds, kernel launches and peak allocated bytes since the last
    mark (the peak is reset here)."""
    torch.cuda.synchronize()
    out = {"t": time.perf_counter(), "counts": _read_counts(),
           "peak": torch.cuda.max_memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    return out


@contextlib.contextmanager
def _watched(seen: dict, guard_s: float = None, initial_loss: bool = False,
             steps: bool = False):
    """Watch the CLI's training run from outside: ``seen`` gets the model,
    the warm start the optimizer began from, the loss at the initial
    parameters (optional; its launches are recorded to be taken off), the
    inducing points as they were frozen, the optimizer's seconds with and
    without the logger's metric evaluations and the launches of those, and a
    tally of what ran inside the forward of the tolerance-level loss.  With
    ``guard_s`` an objective evaluation that starts later than that many
    seconds after the optimizer did fails the script.  With ``steps`` a
    :func:`_mark` at the start of every objective evaluation and at the end
    of the optimizer, with each evaluation's loss and CG steps: from one
    mark to the next is one Adam step (loss, gradient, update)."""
    from cglb_tpu_torch import backend as _backend
    from cglb_tpu_torch.utils import training as _training

    real_optimize = _backend.Torch.optimize.__func__
    real_freeze = _training._freeze_inducing

    def guarded(make_loss, t0, tally=None):
        def make():
            fn = make_loss()

            def loss(*args):
                if guard_s is not None:
                    require(time.perf_counter() - t0 <= guard_s,
                            f"the run exceeded its {guard_s:g} s guard")
                if steps:
                    seen["marks"].append(_mark())
                before = _read_counts()
                out = fn(*args)
                if steps:
                    seen["step_losses"].append(float(out[0]))
                    seen["step_cg"].append(int(out[1].cg_steps))
                if tally is not None:
                    d = _delta(_read_counts(), before)
                    tally["calls"] += 1
                    tally["accurate"] += d["accurate"]
                    tally["cg_tier"] += d["streaming_matvec"] - d["accurate"]
                    tally["cg_steps"] += out[1].cg_steps
                return out

            return loss

        return make

    def optimize(cls, model, datasets, num_steps, logger, *args, **kw):
        seen["model"] = model
        seen["num_steps"] = num_steps
        seen["v0_start"] = None if model.v0 is None else model.v0.clone()
        seen["metric_launches"] = dict.fromkeys(_read_counts(), 0)
        if initial_loss:
            before = _read_counts()
            v0 = model.v0.clone()
            seen["initial_loss"] = model.loss_value()
            model.v0, model.cg_steps, model.cg_residual_error = v0, 0, 0.0
            seen["initial_loss_launches"] = _delta(_read_counts(), before)
        metrics = logger._metrics_fn

        def counted_metrics():
            before = _read_counts()
            out = metrics()
            d = _delta(_read_counts(), before)
            for k in d:
                seen["metric_launches"][k] += d[k]
            return out

        logger._metrics_fn = counted_metrics
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seen["tol"] = dict.fromkeys(("calls", "accurate", "cg_tier",
                                     "cg_steps"), 0)
        model.loss_fn = guarded(model.loss_fn, t0)
        model.loss_fn_tol = guarded(model.loss_fn_tol, t0, seen["tol"])
        seen.update(marks=[], step_losses=[], step_cg=[])
        before = _read_counts()
        res = real_optimize(cls, model, datasets, num_steps, logger, *args,
                            **kw)
        if steps:
            seen["marks"].append(_mark())
        torch.cuda.synchronize()
        seen["optimize_s"] = time.perf_counter() - t0
        seen["train_s"] = logger.timer.get_elapsed_time()
        seen["optimize_launches"] = _delta(_read_counts(), before)
        logger._metrics_fn = metrics
        del model.loss_fn, model.loss_fn_tol  # back to the class's methods
        return res

    def freeze(params):
        seen.setdefault("frozen_Z", params.inducing_Z.raw.detach().clone())
        return real_freeze(params)

    _backend.Torch.optimize = classmethod(optimize)
    _training._freeze_inducing = freeze
    try:
        yield seen
    finally:
        _backend.Torch.optimize = classmethod(real_optimize)
        _training._freeze_inducing = real_freeze


def run_cli(tail, logdir: str, **watch) -> dict:
    """The port's CLI in-process on the card, in ``logdir``: results.json,
    logs.json, the wall seconds, the kernels' launches over the run (counts
    set to 0 just before, read just after; those of an extra initial-loss
    evaluation taken off) and what :func:`_watched` saw."""
    from cglb_tpu_torch.experiments import cli
    from cglb_tpu_torch.utils.serialization import load_json

    seen: dict = {}
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    with _watched(seen, **watch):
        cli.main(["-l", logdir] + list(tail))
    torch.cuda.synchronize()
    seen["wall_s"] = time.perf_counter() - t0
    launches = _read_counts()
    if "initial_loss_launches" in seen:
        launches = _delta(launches, seen["initial_loss_launches"])
    seen["launches"] = launches
    seen["peak_bytes"] = max([torch.cuda.max_memory_allocated()]
                             + [m["peak"] for m in seen["marks"]])
    seen["res"] = load_json(Path(logdir, "results.json"))
    seen["logs"] = load_json(Path(logdir, "logs.json"))
    require(seen["res"]["data"] == "synthetic", "synthetic stand-in expected")
    return seen


def finite_metrics(res: dict, tag: str) -> dict:
    metrics = {k: v for k, v in res.items() if isinstance(v, float)}
    print(f"[{tag}] results.json: " + json.dumps(metrics), flush=True)
    require(all(math.isfinite(v) for v in metrics.values()),
            f"{tag}: non-finite metric in results.json")
    return metrics


def require_all_launched(launches: dict, tag: str) -> None:
    for name in _counters():
        require(launches[name] > 0,
                f"{tag}: kernel {name} was not launched")


def phase_main_path(results: dict) -> None:
    with tempfile.TemporaryDirectory() as logdir:
        out = run_cli(CLI_ARGS, logdir, steps=True)
    res, launches = out["res"], out["launches"]
    print(f"[main] CLI run ({' '.join(CLI_ARGS)}): {out['wall_s']:.2f} s "
          f"wall, launches {launches}", flush=True)
    finite_metrics(res, "main")
    require(res["elbo"] <= res["titsias_upper_bound"], "elbo > upper")
    require(res["cg_lower_bound"] <= res["titsias_upper_bound"],
            "cg_lower_bound > upper")
    require_all_launched(launches, "main")
    for name in _counters():
        results[name]["launches_adam_cli"] = launches[name]
    results["_main_losses"] = out["step_losses"]


def _device_work(ev, regions) -> bool:
    """A kernel, memcpy or memset on the card: an event of the CUDA device
    that is not the GPU-side span of a user annotation (``annotate``'s
    regions and the program's ``cglb.*`` spans, whose span covers all the
    work inside them)."""
    if ev.device_type != torch.autograd.DeviceType.CUDA:
        return False
    if (getattr(ev, "is_user_annotation", False) or ev.key in regions
            or ev.key.startswith("cglb.")):
        return False
    kind = str(getattr(ev, "activity_type", None) or "").lower()
    return not kind or any(k in kind for k in ("kernel", "memcpy", "memset"))


def profiled_steps(step, steps: int) -> dict:
    """``steps`` calls of ``step``, each a named region, under the port's
    ``utils.profiling.trace`` (torch.profiler with the CUDA activity, a
    Chrome trace written and its size read): per step, the device time of
    all kernels, copies and fills on the card (the regions' own GPU-side
    spans left out: they would count the step twice) and of kernels 1-3
    (self device time of the events whose name holds the kernel's), the
    host-clock seconds of the profiled window, and the launches of kernels
    1-3."""
    from cglb_tpu_torch.utils.profiling import annotate, trace

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    regions = {f"step {i}" for i in range(steps)}
    with tempfile.TemporaryDirectory() as logdir:
        with trace(logdir, device="cuda") as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(steps):
                with annotate(f"step {i}"):
                    step()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        trace_bytes = prof.trace_path.stat().st_size
    tags = {"streaming_matvec": "matvec_kernel", "ls_grad": "ls_grad_kernel",
            "kuf": "kuf_tile_kernel"}
    device = dict.fromkeys(["all"] + list(tags), 0.0)
    for ev in prof.key_averages():
        if not _device_work(ev, regions):
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        device["all"] += us
        for name, tag in tags.items():
            if tag in ev.key:
                device[name] += us
    out = {f"device ms per step, {name}": us / 1e3 / steps
           for name, us in device.items()}
    out["profiled step s"] = window_s / steps
    # one stream: its kernels and copies run one after another, so their
    # sum cannot exceed the window's wall time
    require(out["device ms per step, all"] <= 1e3 * out["profiled step s"],
            "profiler: device time above the profiled window's wall time")
    for name, fn in counters.items():
        out[f"launches per step, {name}"] = fn.launches / steps
    out["trace bytes"] = trace_bytes
    return out


def warm_steps(profile: bool = True) -> dict:
    """Warm Adam steps of the main path's model (built as the CLI builds
    it, metrics excluded): the host-clock wall time of single steps that end
    in a synchronize (median of 5, after one), then (``profile``) over 3
    more steps under the port's profiler the device time of all kernels and
    of kernels 1-3, and the launches of kernels 1-3, per step."""
    from cglb_tpu_torch.utils.training import adam_minimize

    model = _kin40k_model()
    state = model.carry_in()

    def step():
        nonlocal state
        state = adam_minimize(model.loss_fn(), model.params, state, 1,
                              0.01).state

    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out = {"adam step s": statistics.median(times[1:])}
    if profile:
        out.update(profiled_steps(step, 3))
    return out


# --------------------------------------------------------------------------
# phase 4
# --------------------------------------------------------------------------


def anchor_model(matvec: str = "auto", params=None):
    """(Torch facade, a ``cglb`` Model at the parameters of the TPU run
    runs/kin40k-2000-scipy4-r4 on the card (max_error 1e-3), the kin40k
    stand-in).  ``params``: share another model's parameters."""
    from cglb_tpu_torch import config as _config
    from cglb_tpu_torch.backend import Model, Torch
    from cglb_tpu_torch.experiments.datasets import get_dataset
    from cglb_tpu_torch.models.cglb import CGLBConfig
    from cglb_tpu_torch.models.sgpr import SGPRParams
    from cglb_tpu_torch.ops.kernels import Matern32
    from cglb_tpu_torch.utils.serialization import load_json
    from cglb_tpu_torch.utils.flatten import assign_parameters

    _config.set_default_float("fp64")
    _config.set_default_jitter("fp64")
    want = load_json(ANCHOR / "results.json")
    bundle = get_dataset("Wilson_kin40k", split=0)
    require(bundle.synthetic and want["data"] == "synthetic",
            "anchor run and data must both be the synthetic stand-in")
    backend = Torch(device="cuda", matvec=matvec)
    dev = backend.device
    if params is None:
        saved = load_json(ANCHOR / "model.json")
        params = SGPRParams(Matern32(D, device=dev), saved[".inducing_Z"],
                            device=dev)
        assign_parameters(params, saved)
    X, Y = (torch.as_tensor(a, device=dev) for a in bundle.train)
    model = Model("cglb", params, (X, Y), CGLBConfig(max_error=1e-3),
                  matvec=matvec)
    return backend, model, bundle


def phase_anchor() -> dict:
    """Phase 4; returns the port's metrics there."""
    from cglb_tpu_torch.utils.serialization import load_json

    want = load_json(ANCHOR / "results.json")
    backend, model, bundle = anchor_model()
    got = backend.metrics_fn(model, bundle.to_tuple())()
    keys = ("elbo", "titsias_upper_bound", "cg_lower_bound", "test/rmse",
            "test/nlpd", "cg/steps")
    print("[anchor] port: " + json.dumps({k: got[k] for k in keys}),
          flush=True)
    print("[anchor] TPU run: " + json.dumps(
        {k: want[k] for k in keys if k in want}), flush=True)
    for k in ("elbo", "titsias_upper_bound"):
        rel = abs(got[k] - want[k]) / abs(want[k])
        print(f"[anchor] {k}: rel diff {rel:.3e} (bound 1e-6)", flush=True)
        require(rel <= 1e-6, f"anchor {k}")
    require(got["elbo"] <= got["cg_lower_bound"] <= got[
        "titsias_upper_bound"], "bracket elbo <= cg_lb <= upper at "
        "converged v")
    require(abs(got["test/rmse"] - want["test/rmse"])
            <= 1e-2 * want["test/rmse"], "anchor test/rmse")
    require(abs(got["test/nlpd"] - want["test/nlpd"]) <= 0.01,
            "anchor test/nlpd")
    return got


# --------------------------------------------------------------------------
# phases 5-8: the scipy bridge, the variants, checkpoints
# --------------------------------------------------------------------------


def phase_scipy4(results: dict, card: str) -> None:
    """The reference protocol's scipy4 run, whole."""
    from cglb_tpu_torch.utils.serialization import load_json

    with tempfile.TemporaryDirectory() as logdir:
        out = run_cli(SCIPY4_ARGS, logdir, guard_s=SCIPY4_GUARD_S,
                      initial_loss=True)
        saved = load_json(Path(logdir, "model.json"))
    res, launches, model = out["res"], out["launches"], out["model"]
    finite_metrics(res, "scipy4")
    attempts = res["opt/attempts"]
    iters, fevals = res["opt/num_iters"], res["opt/num_fevals"]
    print(f"[scipy4] attempts: {json.dumps(attempts)}", flush=True)
    require(1 <= len(attempts) <= 4, "scipy4: more than 4 attempts")
    require(sum(a["nit"] for a in attempts) == iters,
            "scipy4: the attempts' nit do not sum to opt/num_iters")
    require(sum(a["nfev"] for a in attempts) == fevals,
            "scipy4: the attempts' nfev do not sum to opt/num_fevals")
    require(out["optimize_s"] <= SCIPY4_GUARD_S, "scipy4: guard exceeded")
    if len(attempts) > 2:
        same = np.array_equal(out["frozen_Z"].cpu().numpy(),
                              saved[".inducing_Z"])
        print("[scipy4] inducing_Z bit-identical from the start of attempt "
              f"3 to model.json: {same}", flush=True)
        require(same, "scipy4: frozen inducing points moved")
        require(not model.params.inducing_Z.trainable,
                "scipy4: inducing points still trainable after attempt 2")
    else:
        print(f"[scipy4] {len(attempts)} attempts: the freeze did not "
              "engage", flush=True)
    require_all_launched(launches, "scipy4")
    feval_launches = _delta(out["optimize_launches"], out["metric_launches"])
    per_feval = {k: v / fevals for k, v in feval_launches.items()}
    print(f"[scipy4] {iters} iterations, {fevals} fevals, "
          f"{res['opt/penalty_fevals']} penalty fevals; optimizer "
          f"{out['optimize_s']:.2f} s wall, {out['train_s']:.2f} s without "
          f"the logger's metrics = {out['train_s'] / fevals:.4f} s per "
          f"feval; CLI run {out['wall_s']:.2f} s; CG steps per feval median "
          f"{res['cg/steps_train_median']:g}, mean "
          f"{res['cg/steps_train_mean']:.2f}, max "
          f"{res['cg/steps_train_max']:g} ({card})", flush=True)
    print(f"[scipy4] launches over the CLI run {launches}; in the objective "
          f"evaluations {feval_launches} = per feval "
          + json.dumps({k: round(v, 2) for k, v in per_feval.items()}),
          flush=True)
    print(f"[scipy4] initial loss {out['initial_loss']:.4f}; final loss "
          f"{res['loss']:.4f} / test rmse {res['test/rmse']:.4f} / test "
          f"nlpd {res['test/nlpd']:.4f}; TPU run {REFERENCE['loss']} / "
          f"{REFERENCE['test/rmse']} / {REFERENCE['test/nlpd']}", flush=True)
    require(res["loss"] < out["initial_loss"],
            "scipy4: the final loss is not below the initial loss")
    require(res["test/rmse"] <= 0.47, "scipy4: test rmse above 0.47")
    loss_rel = abs(res["loss"] - REFERENCE["loss"]) / REFERENCE["loss"]
    rmse_diff = abs(res["test/rmse"] - REFERENCE["test/rmse"])
    inside = loss_rel <= 0.01 and rmse_diff <= 0.005
    print(f"[scipy4] parity with the TPU run's optimum: loss rel diff "
          f"{loss_rel:.3e} (1e-2), rmse diff {rmse_diff:.3e} (5e-3): "
          + ("inside" if inside else "OUTSIDE (see ROADMAP.md section 3)"),
          flush=True)

    # The bracket at a re-solved v (max_error 1e-3) from the final
    # parameters.  The run's own preconditioner is applied in fp32, which
    # loses its +I against A A^T once variance / noise grows large, and CG
    # then stalls or diverges: its outcome is printed, and the bracket is
    # held with the fp64 preconditioner, from the same warm start.
    elbo, upper = model.elbo(), model.upper_bound()
    warm = model.v0.clone()
    solved = {}
    for dtype in (model.run_cfg.precond_dtype, "float64"):
        model.v0 = warm.clone()
        model.run_cfg = dataclasses.replace(model.run_cfg, max_error=1e-3,
                                            precond_dtype=dtype)
        solved[dtype] = (-model.loss_value(), model.cg_steps,
                         model.cg_residual_error)
        print(f"[scipy4] re-solve at max_error 1e-3, {dtype} "
              f"preconditioner: cg_lower_bound {solved[dtype][0]:.4f}, "
              f"{solved[dtype][1]} CG steps, residual error "
              f"{solved[dtype][2]:.3e}", flush=True)
    cg_lb, _, residual = solved["float64"]
    print(f"[scipy4] elbo {elbo:.4f} <= cg_lower_bound {cg_lb:.4f} <= upper "
          f"{upper:.4f}", flush=True)
    require(residual <= 1e-3, "scipy4: the re-solve of v did not converge")
    require(elbo <= cg_lb <= upper, "scipy4: the bracket does not hold")
    for name in _counters():
        results[name]["launches_scipy4_run"] = launches[name]
        results[name]["launches_per_scipy_feval"] = per_feval[name]
    results["_scipy4"] = {
        "iterations": iters, "fevals": fevals,
        "optimize_s": out["optimize_s"], "train_s": out["train_s"],
        "loss": res["loss"], "test/rmse": res["test/rmse"],
        "test/nlpd": res["test/nlpd"]}


def _release(out: dict) -> None:
    out.pop("model", None)
    torch.cuda.empty_cache()


def phase_variants() -> None:
    """2 Adam steps of each variant through the CLI."""
    from cglb_tpu_torch.utils.serialization import load_json

    variants = [("cglbnm2", []), ("cglbn2m", []), ("cglb", ["--vjoint"]),
                ("cglb", ["--vzero"]), ("sgprn2m", [])]
    for leaf, flags in variants:
        tag = " ".join([leaf] + flags)
        tail = (_HEAD + ["-n", "2"] + _DATA + ["-o", "adam_0.01", leaf, "-m",
                                               leaf] + _MODEL + flags)
        with tempfile.TemporaryDirectory() as logdir:
            out = run_cli(tail, logdir)
            saved = load_json(Path(logdir, "model.json"))
        res = out["res"]
        finite_metrics(res, tag)
        print(f"[variants] {tag}: loss {res['loss']:.4f}, {out['wall_s']:.2f}"
              f" s wall, peak device memory "
              f"{out['peak_bytes'] / 2 ** 30:.2f} GiB, launches "
              f"{out['launches']}", flush=True)
        require(math.isfinite(res["loss"]), f"{tag}: loss")
        require(out["launches"]["kuf"] > 0, f"{tag}: kernel 3 not launched")
        if flags == ["--vjoint"]:
            moved = float(np.abs(saved[".v0"]).max())
            print(f"[variants] --vjoint: max |v0| after 2 steps {moved:.3e} "
                  "(from zeros)", flush=True)
            require(moved > 0.0, "--vjoint: v0 did not move")
            # the gradient with respect to v is kernel 1's dp launch
            require(out["launches"]["streaming_matvec"] > 0,
                    "--vjoint: kernel 1 not launched")
        _release(out)


def phase_scipy_tol() -> None:
    tail = (_HEAD + ["-n", "30"] + _DATA + ["-o", "scipy_tol", "cglb", "-m",
                                            "cglb"] + _MODEL + ["-e", "1.0"])
    with tempfile.TemporaryDirectory() as logdir:
        out = run_cli(tail, logdir, guard_s=SCIPY4_GUARD_S)
    res, tol = out["res"], out["tol"]
    finite_metrics(res, "scipy_tol")
    levels = res["opt/levels"]
    print("[scipy_tol] levels: " + json.dumps(
        [{"max_error": lv["max_error"], "nit": lv["nit"],
          "nfev": sum(a["nfev"] for a in lv["attempts"])} for lv in levels])
        + f"; inside the tightened levels' loss: {json.dumps(tol)}; "
        f"{out['optimize_s']:.2f} s", flush=True)
    require(len(levels) >= 2, "scipy_tol: no tightened level was reached")
    require(levels[1]["max_error"] < levels[0]["max_error"],
            "scipy_tol: the second level is not tighter")
    require(tol["calls"] > 0 and tol["cg_steps"] > 0,
            "scipy_tol: no CG step ran in a tightened level")
    require(tol["cg_tier"] == 0,
            "scipy_tol: the CG tier ran inside a tightened level")
    # cg_init, every step and the assembly launch the accurate tier
    require(tol["accurate"] >= tol["cg_steps"] + 2 * tol["calls"],
            "scipy_tol: CG did not run on the accurate tier")
    require_all_launched(out["launches"], "scipy_tol")
    _release(out)


def phase_checkpoint() -> None:
    from cglb_tpu_torch.utils.serialization import load_json

    def tail(n, *extra):
        return (_HEAD + ["-n", str(n)] + _DATA
                + ["-o", "scipy", "--ckpt-every", "2", *extra, "cglb", "-m",
                   "cglb"] + _MODEL)

    with tempfile.TemporaryDirectory() as logdir:
        first = run_cli(tail(6), logdir)
        ckpt = load_json(Path(logdir, "checkpoint.json"))
        done = ckpt["extra"]["iters_done"]
        _release(first)
        second = run_cli(tail(10, "--resume"), logdir)
    print(f"[checkpoint] first run {first['res']['opt/num_iters']} "
          f"iterations, checkpoint at {done}; resumed with a budget of "
          f"{second['num_steps']}, ran {second['res']['opt/num_iters']}; "
          f"loss {first['res']['loss']:.4f} -> {second['res']['loss']:.4f}",
          flush=True)
    require(done == 6 and first["res"]["opt/num_iters"] == 6,
            "checkpoint: the first run did not checkpoint at 6 iterations")
    require(second["num_steps"] == 4
            and second["res"]["opt/num_iters"] <= 4,
            "checkpoint: the resumed run took more than the rest of the "
            "budget")
    require(np.array_equal(second["v0_start"].cpu().numpy(), ckpt["v0"])
            and float(np.abs(ckpt["v0"]).max()) > 0.0,
            "checkpoint: the resumed run did not start from the saved v0")
    require(math.isfinite(second["res"]["loss"]), "checkpoint: loss")
    _release(second)


# --------------------------------------------------------------------------
# phases 9-11: the exact-GP arm
# --------------------------------------------------------------------------


def launches_bound_ms(fn, b: int) -> float:
    """Context only: the sum of ``fn(rows)[0]`` over the launches of a batch
    of b rows (8 rows a launch at most).  Each launch computes the distances
    and the profile again, so this exceeds the bound of the function."""
    return sum(fn(min(8, b - b0))[0] for b0 in range(0, b, 8))


def phase_wide_batches(results: dict) -> None:
    """Kernels 1 and 2 at the exact-GP arm's batch widths (Matern32)."""
    from cglb_tpu_torch.ops import matvec as _mv

    X, Xc, _, _, _, ls, _ = kernel_inputs()
    rng = np.random.default_rng(1)
    P = torch.as_tensor(rng.normal(size=(64, N)), device=X.device)
    G = torch.as_tensor(rng.normal(size=(10, N)), device=X.device)
    family = "mat32"
    rows = _mv.Prepared(X, ls, family)
    cols = _mv.Prepared(Xc, ls, family)
    both = _mv.Prepared(torch.cat([X, Xc]), ls, family)
    cases = [("b8", "symmetric B=8", rows, rows, P[:8]),
             ("b10", "symmetric B=10", rows, rows, P[:10]),
             ("b64_general", f"general path B=64 {N}x{N_TEST}", rows, cols,
              P),
             ("b64_metrics", f"general path B=64 {N}x{N + N_TEST}", rows,
              both, P)]
    for key, name, r, c, p in cases:
        b = p.shape[0]
        groups = -(-b // _mv.MAX_BATCH)
        got = _mv.launch_matvec(r, c, p, True)
        err, abs_err = rel_err(got, _mv.matvec_unit_plain(r.xg, c.xg, p,
                                                          family))
        same = torch.equal(got, _mv.launch_matvec(r, c, p, True))
        del got
        ms = cuda_ms(lambda: _mv.launch_matvec(r, c, p, True), 5)
        plain_ms = cuda_ms(
            lambda: _mv.matvec_unit_plain(r.xg, c.xg, p, family), 1)
        # the function p[b, Ni] -> p . rho needs each pair's distance and
        # profile once, however many launches compute it
        def bound_of(rows, r=r, c=c):
            return matvec_bound(r.n, c.n, D, rows, True, symmetric=r is c)

        bnd = bound_of(b)
        show(f"{family} streaming_matvec {name}", ms, bnd,
             f" ({groups} launches, {ms / groups:.4f} ms a group, their own "
             f"bounds sum to {launches_bound_ms(bound_of, b):.4f} ms; plain "
             f"{plain_ms:.4f} ms; rel err {err:.3e}, bound "
             f"{TOL['matvec_accurate']:g}; repeat bitwise equal {same})")
        require(err <= TOL["matvec_accurate"], f"matvec {name}")
        require(same, f"matvec {name} is not deterministic")
        results["streaming_matvec"].update({
            f"ms_{key}": ms, f"plain_ms_{key}": plain_ms,
            f"bound_ms_{key}": bnd[0], f"max_abs_err_{key}": abs_err})
    p, g = P[:10], G
    got = _mv.launch_ls_grad(rows, rows, p, g)
    err, abs_err = rel_err(got, _mv.ls_grad_unit_plain(rows.xg, rows.xg, p,
                                                       g, family))
    same = torch.equal(got, _mv.launch_ls_grad(rows, rows, p, g))
    ms = cuda_ms(lambda: _mv.launch_ls_grad(rows, rows, p, g), 5)
    plain_ms = cuda_ms(
        lambda: _mv.ls_grad_unit_plain(rows.xg, rows.xg, p, g, family), 1)

    def bound_of(rows):
        return ls_grad_bound(N, N, D, rows, symmetric=True)

    bnd = bound_of(10)
    show(f"{family} ls_grad symmetric B=10", ms, bnd,
         f" (2 launches, {ms / 2:.4f} ms a group, their own bounds sum to "
         f"{launches_bound_ms(bound_of, 10):.4f} ms; plain {plain_ms:.4f} ms; "
         f"rel err {err:.3e}, bound {TOL['backward']:g}; repeat bitwise "
         f"equal {same})")
    require(err <= TOL["backward"], "ls_grad B=10")
    require(same, "ls_grad B=10 is not deterministic")
    results["ls_grad"].update({"ms_b10": ms, "plain_ms_b10": plain_ms,
                               "bound_ms_b10": bnd[0],
                               "max_abs_err_b10": abs_err})
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _exactgp_watched(rec: dict):
    """Record every iterative_lml evaluation (rows, CG steps of the solve on
    the training error and of the one on the probes, seconds) and every
    optimizer call of the staged schedule (name, rows, steps, seconds)."""
    from cglb_tpu_torch.models import gpr_iterative as _itgp
    from cglb_tpu_torch.utils import training as _training

    real = (_itgp.iterative_lml, _training.lbfgs_minimize,
            _training.adam_minimize)
    rec.update(evals=[], phases=[])

    def lml(params, X, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real[0](params, X, *args, **kw)
        torch.cuda.synchronize()
        rec["evals"].append({
            "rows": X.shape[0], "cg": out[1].cg_steps,
            "probe_cg": out[1].probe_cg_steps,
            "s": time.perf_counter() - t0})
        return out

    def timed(name, fn):
        def run(loss_fn, params, state, num_steps, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(loss_fn, params, state, num_steps, *args, **kw)
            torch.cuda.synchronize()
            data = kw.get("loss_args") or ()
            rec["phases"].append({
                "optimizer": name, "steps": num_steps,
                "rows": data[0].shape[0] if data else None,
                "s": time.perf_counter() - t0})
            return res

        return run

    _itgp.iterative_lml = lml
    _training.lbfgs_minimize = timed("lbfgs", real[1])
    _training.adam_minimize = timed("adam", real[2])
    try:
        yield rec
    finally:
        (_itgp.iterative_lml, _training.lbfgs_minimize,
         _training.adam_minimize) = real


def phase_exactgp(results: dict, card: str) -> None:
    """The iterative exact GP through the CLI at N_train 26800."""
    rec: dict = {}
    with tempfile.TemporaryDirectory() as logdir, _exactgp_watched(rec):
        out = run_cli(EXACTGP_ARGS, logdir)
    res, launches = out["res"], out["launches"]
    metrics = finite_metrics(res, "exactgp")
    for key in ("lml", "loss", "train/rmse", "test/rmse", "train/nlpd",
                "test/nlpd"):
        require(key in metrics, f"exactgp: results.json lacks {key}")
    require(launches["streaming_matvec"] > 0 and launches["ls_grad"] > 0,
            "exactgp: kernels 1 and 2 were not both launched")
    require(launches["kuf"] == 0, "exactgp: kernel 3 has no place here")
    phases = rec["phases"]
    require([(ph["optimizer"], ph["rows"], ph["steps"]) for ph in phases]
            == [("lbfgs", min(N, 10000), 10), ("adam", min(N, 10000), 10),
                ("adam", N, 20)],
            f"exactgp: unexpected staged phases {phases}")
    full = [e for e in rec["evals"] if e["rows"] == N]
    # the logger's clock is restarted by the full-data phase and paused
    # around its metric evaluations
    full_s = out["train_s"]
    print(f"[exactgp] CLI run ({' '.join(EXACTGP_ARGS)}): "
          f"{out['wall_s']:.2f} s wall ({card}); staged phases "
          + json.dumps([{**ph, "s": round(ph["s"], 3)} for ph in phases])
          + f"; full-data Adam steps {full_s:.3f} s without the logger's "
          f"metrics = {full_s / 20:.4f} s a step", flush=True)
    print(f"[exactgp] {len(full)} evaluations on {N} rows: "
          f"{statistics.median(e['s'] for e in full):.4f} s median; CG steps "
          f"on the error (B=1) {sorted({e['cg'] for e in full})}, on the 10 "
          f"probes {sorted({e['probe_cg'] for e in full})}; on 10000 rows "
          f"{len(rec['evals']) - len(full)} evaluations; launches {launches}; "
          f"peak device memory {out['peak_bytes'] / 2 ** 30:.2f} GiB",
          flush=True)
    require(len(full) >= 20, "exactgp: fewer full-data evaluations than steps")
    step_s = full_s / 20
    for name in _counters():
        results[name]["launches_exactgp_run"] = launches[name]
    # kernels 1 and 2 in a full-data step: two more Adam steps of the run's
    # model, from where the run left it, under the profiler
    from cglb_tpu_torch.utils.training import adam_minimize

    model = out["model"]

    def step():
        model.carry_out(adam_minimize(
            model.loss_fn(), model.params, model.carry_in(), 1, 0.001).state)

    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    prof = profiled_steps(step, 2)
    kernel_ms = (prof["device ms per step, streaming_matvec"]
                 + prof["device ms per step, ls_grad"])
    all_ms = prof["device ms per step, all"]
    print(f"[exactgp] 2 more full-data Adam steps, unprofiled "
          f"{json.dumps(times)} s; 2 under torch.profiler: "
          f"{json.dumps(prof)}; kernels 1-2 {kernel_ms:.2f} ms of "
          f"{all_ms:.2f} ms device time a step = "
          f"{100 * kernel_ms / all_ms:.1f} %, and "
          f"{100 * kernel_ms / (1e3 * min(times)):.1f} % of the faster "
          f"unprofiled step's wall time ({card})", flush=True)
    require(kernel_ms > 0.0 and prof["device ms per step, kuf"] == 0.0,
            "exactgp: the profiler saw no device time of kernels 1-2")
    results["_exactgp"] = {
        "wall_s": out["wall_s"], "full_step_s": step_s,
        "profiled_step_s": min(times),
        "profiled_device_ms_per_step": all_ms,
        "profiled_kernels_1_2_ms_per_step": kernel_ms,
        "eval_s_median": statistics.median(e["s"] for e in full),
        "lml": res["lml"], "test/rmse": res["test/rmse"],
        "test/nlpd": res["test/nlpd"]}
    _release(out)


def phase_gpr_anchor(card: str) -> None:
    """The TPU exact-GP run's parameters, dense and iterative."""
    from cglb_tpu_torch import config as _config
    from cglb_tpu_torch.backend import Torch
    from cglb_tpu_torch.configs import ExactGPConfig, Matern32Config
    from cglb_tpu_torch.experiments import cli
    from cglb_tpu_torch.experiments.datasets import get_dataset
    from cglb_tpu_torch.utils.serialization import load_json

    want = load_json(GPR_ANCHOR / "results.json")
    require(want["data"] == "synthetic", "the anchor run's data")
    keys = ("lml", "train/rmse", "test/rmse", "train/nlpd", "test/nlpd")
    with tempfile.TemporaryDirectory() as tmp:
        params = Path(tmp, "model.json")
        params.write_text((GPR_ANCHOR / "model.json").read_text())
        head = ["-t", "fp64", "-s", "0", "-l", tmp]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cli.main(head + ["gpr_metric"] + _DATA + ["-k", "Matern32", "-p",
                                                  str(params)])
        torch.cuda.synchronize()
        dense_s = time.perf_counter() - t0
        dense_peak = torch.cuda.max_memory_allocated()
        dense = np.load(Path(tmp, "gpr_metric.npy"), allow_pickle=True).item()
        torch.cuda.empty_cache()
        _zero_counts()
        t0 = time.perf_counter()
        cli.main(head + ["metric"] + _DATA + ["gpr", "-m", "exactgp", "-k",
                                              "Matern32", "-p", str(params)])
        torch.cuda.synchronize()
        iter_s = time.perf_counter() - t0
        launches = _read_counts()
        it = np.load(Path(tmp, "metric.npy"), allow_pickle=True).item()
        # the spread of the SLQ estimate over the probes' seed
        lmls = [it["lml"]]
        backend = Torch(device="cuda")
        data = get_dataset(_DATA[1], dtype=_config.default_float(),
                           split=0).train
        for seed in range(1, 5):
            backend.set_seed(seed)
            model = backend.load(backend.create_model(
                ExactGPConfig(Matern32Config()), data), params)
            lmls.append(-model.loss_value())
            del model
        backend.set_seed(0)
    print(f"[gpr-anchor] dense (gpr_metric, {dense_s:.2f} s, peak "
          f"{dense_peak / 2 ** 30:.2f} GiB): "
          + json.dumps({k: dense[k] for k in keys}), flush=True)
    print(f"[gpr-anchor] iterative (metric gpr -m exactgp, {iter_s:.2f} s, "
          f"launches {launches}): " + json.dumps({k: it[k] for k in keys}),
          flush=True)
    print("[gpr-anchor] TPU run (iterative): "
          + json.dumps({k: want[k] for k in keys}), flush=True)
    rel = [abs(v - dense["lml"]) / abs(dense["lml"]) for v in lmls]
    print(f"[gpr-anchor] iterative lml over seeds 0-4 {json.dumps(lmls)}: "
          f"mean {statistics.mean(lmls):.2f}, sd {statistics.stdev(lmls):.2f}"
          f", largest rel diff from dense {max(rel):.3e} (bound "
          f"{EXACTGP_TOL['lml']:g}); the TPU run's {want['lml']:.2f} is "
          f"{abs(want['lml'] - dense['lml']) / abs(dense['lml']):.3e} from "
          f"dense ({card})", flush=True)
    require(max(rel) <= EXACTGP_TOL["lml"], "gpr-anchor: iterative lml")
    off = abs(statistics.mean(lmls) - want["lml"])
    print(f"[gpr-anchor] mean iterative lml is {off:.2f} nats from the TPU "
          f"run's (bound {EXACTGP_TOL['lml_vs_tpu_run']:g})", flush=True)
    require(off <= EXACTGP_TOL["lml_vs_tpu_run"],
            "gpr-anchor: mean iterative lml against the TPU run")
    for k in ("test/rmse", "test/nlpd"):
        diff = abs(it[k] - dense[k])
        print(f"[gpr-anchor] {k}: iterative {it[k]:.5f}, dense "
              f"{dense[k]:.5f}, diff {diff:.3e} (bound {EXACTGP_TOL[k]:g}); "
              f"TPU run {want[k]:.5f}, diff from iterative "
              f"{abs(it[k] - want[k]):.3e}", flush=True)
        require(diff <= EXACTGP_TOL[k], f"gpr-anchor: {k}")
    # the CG mean is deterministic (200 CG steps from zeros), but the
    # unconverged iterate moves with the operator's rounding, which differs
    # between the two chips: 3.5e-3 apart when this bound was set
    require(abs(it["test/rmse"] - want["test/rmse"]) <= 1e-2,
            "gpr-anchor: test/rmse against the TPU run")
    require(launches["streaming_matvec"] > 0 and launches["kuf"] == 0,
            "gpr-anchor: launches")
    torch.cuda.empty_cache()


def phase_optimizers() -> None:
    """A few iterations of the remaining optimizers at kin40k width."""
    cglb = ["cglb", "-m", "cglb"] + _MODEL
    runs = [("lbfgs", "3", cglb), ("lbfgs_native", "3", cglb),
            ("staged", "2", ["gpr", "-m", "gpr", "-k", "Matern32"])]
    for optimizer, n, leaf in runs:
        tag = f"-o {optimizer} {' '.join(leaf[:3])}"
        tail = _HEAD + ["-n", n] + _DATA + ["-o", optimizer] + leaf
        with tempfile.TemporaryDirectory() as logdir:
            out = run_cli(tail, logdir)
        res = out["res"]
        finite_metrics(res, tag)
        print(f"[optimizers] {tag} -n {n}: loss {res['loss']:.4f}, test rmse "
              f"{res['test/rmse']:.4f}, {out['wall_s']:.2f} s wall, "
              f"optimizer {out['train_s']:.2f} s without the logger's "
              f"metrics, peak device memory "
              f"{out['peak_bytes'] / 2 ** 30:.2f} GiB, launches "
              f"{out['launches']}", flush=True)
        if leaf[0] == "cglb":
            require_all_launched(out["launches"], tag)
        else:  # dense: no kernel of the port on this path
            require(not any(out["launches"].values()), f"{tag}: launches")
        _release(out)


# --------------------------------------------------------------------------
# phases 12-14: houseelectric scale
# --------------------------------------------------------------------------


def once_ms(fn):
    """(result, milliseconds) of one call between two CUDA events: the
    calls timed this way take seconds."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _launches_of(fn):
    """(fn(), kernel 1 launches it made)."""
    from cglb_tpu_torch.ops import matvec as _mv

    before = _mv.launch_matvec.launches
    out = fn()
    return out, _mv.launch_matvec.launches - before


def phase_slabs(results: dict, card: str) -> None:
    from cglb_tpu_torch.models import sgpr as _sgpr
    from cglb_tpu_torch.ops import matvec as _mv

    family = "mat32"
    X, _, _, p, _, ls, _ = kernel_inputs()
    rows = _mv.Prepared(X, ls, family)
    plain = _mv.matvec_unit_plain(rows.xg, rows.xg, p, family)
    one_slab = _mv.launch_matvec(rows, rows, p, True)
    budget = _mv.ROW_PARTIAL_BYTES
    _mv.ROW_PARTIAL_BYTES = 4 * N * 50  # 50 column blocks' row sums
    try:
        acc, slabs = _launches_of(lambda: _mv.launch_matvec(rows, rows, p,
                                                            True))
        cg = _mv.launch_matvec(rows, rows, p, False)
        same = (torch.equal(acc, _mv.launch_matvec(rows, rows, p, True))
                and torch.equal(cg, _mv.launch_matvec(rows, rows, p, False)))
    finally:
        _mv.ROW_PARTIAL_BYTES = budget
    err, _ = rel_err(acc, plain)
    cg_err, _ = rel_err(cg, plain)
    vs_one, _ = rel_err(acc, one_slab)
    print(f"[slabs] {family} symmetric {N}^2 in {slabs} slabs: accurate rel "
          f"err {err:.3e} (bound {TOL['matvec_accurate']:g}), CG tier "
          f"{cg_err:.3e} (bound {TOL['matvec_cg']:g}), against one slab "
          f"{vs_one:.3e}; repeats bitwise equal {same}", flush=True)
    require(slabs >= 3, "slabs: fewer than 3 slabs were forced")
    require(err <= TOL["matvec_accurate"], "slabs: accurate tier")
    require(cg_err <= TOL["matvec_cg"], "slabs: CG tier")
    require(same, "slabs: repeat launches differ")
    del X, rows, plain, one_slab, acc, cg
    torch.cuda.empty_cache()

    # houseelectric's training size, coordinates padded to coord_plan's width
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    Xh = torch.as_tensor(rng.normal(size=(HOUSE_N, HOUSE_D)), device=dev)
    lsh = torch.as_tensor(rng.uniform(0.5, 2.0, size=HOUSE_D), device=dev)
    ph = torch.as_tensor(rng.normal(size=(1, HOUSE_N)), device=dev)
    gh = torch.as_tensor(rng.normal(size=(1, HOUSE_N)), device=dev)
    rows = _mv.Prepared(Xh, lsh, family)
    rows2 = _mv.Prepared(Xh, lsh, family)
    torch.cuda.reset_peak_memory_stats()
    # the first calls also plan the slabs and segments on the host (cached):
    # the timed calls are the repeats
    sym, slabs = _launches_of(lambda: _mv.launch_matvec(rows, rows, ph, True))
    peak = torch.cuda.max_memory_allocated()
    again, ms = once_ms(lambda: _mv.launch_matvec(rows, rows, ph, True))
    sym_cg = _mv.launch_matvec(rows, rows, ph, False)
    cg_again, cg_ms = once_ms(lambda: _mv.launch_matvec(rows, rows, ph,
                                                        False))
    same = torch.equal(sym, again) and torch.equal(sym_cg, cg_again)
    general, general_ms = once_ms(
        lambda: _mv.launch_matvec(rows, rows2, ph, True))
    err, abs_err = rel_err(sym, general)
    cg_err, _ = rel_err(sym_cg, general)
    _mv.launch_ls_grad(rows, rows, ph, gh)
    _, ls_ms = once_ms(lambda: _mv.launch_ls_grad(rows, rows, ph, gh))
    width = _sgpr.chunk_width(HOUSE_N, HOUSE_M)
    scale = math.sqrt(_mv.GAMMA[family])
    zg = torch.as_tensor(rng.normal(size=(HOUSE_M, HOUSE_D)),
                         device=dev) * (scale / lsh)
    xg = Xh[:width] * (scale / lsh)
    var = torch.as_tensor(1.7, dtype=torch.float64, device=dev)
    results["kuf_d11"] = check_kuf(f"[slabs] {family} one chunk ({card})",
                                   zg, xg, var, family)
    del zg, xg
    bounds = {
        "accurate": matvec_bound(HOUSE_N, HOUSE_N, HOUSE_D, 1, True, True),
        "cg": matvec_bound(HOUSE_N, HOUSE_N, HOUSE_D, 1, False, True),
        "ls_grad": ls_grad_bound(HOUSE_N, HOUSE_N, HOUSE_D, 1, True)}
    print(f"[slabs] {family} symmetric {HOUSE_N}^2, D {HOUSE_D} (DP "
          f"{rows.plan.width}), "
          f"B 1, in {slabs} slabs: accurate rel err {err:.3e} against the "
          f"general path (bound {TOL['matvec_accurate']:g}), CG tier "
          f"{cg_err:.3e} (bound {TOL['matvec_cg']:g}); repeat bitwise equal "
          f"{same}; peak allocated {peak / 2 ** 30:.2f} GiB; general path "
          f"{general_ms:.1f} ms ({card})", flush=True)
    show(f"{family} streaming_matvec {HOUSE_N}^2 accurate", ms,
         bounds["accurate"])
    show(f"{family} streaming_matvec {HOUSE_N}^2 CG tier", cg_ms,
         bounds["cg"])
    show(f"{family} ls_grad {HOUSE_N}^2", ls_ms, bounds["ls_grad"])
    require(err <= TOL["matvec_accurate"], "houseelectric matvec accurate")
    require(cg_err <= TOL["matvec_cg"], "houseelectric matvec CG tier")
    require(same, "houseelectric matvec repeat launches differ")
    results["streaming_matvec"].update({
        "ms_houseelectric": ms, "ms_cg_tier_houseelectric": cg_ms,
        "bound_ms_houseelectric": bounds["accurate"][0],
        "bound_ms_cg_tier_houseelectric": bounds["cg"][0],
        "max_abs_err_houseelectric": abs_err, "slabs_houseelectric": slabs,
        "general_ms_houseelectric": general_ms})
    results["ls_grad"].update({"ms_houseelectric": ls_ms,
                               "bound_ms_houseelectric": bounds["ls_grad"][0]})
    del rows, rows2, sym, again, sym_cg, cg_again, general
    torch.cuda.empty_cache()
    _rank_split_against_plain(Xh, lsh, family, card)
    del Xh
    torch.cuda.empty_cache()


def _rank_split_against_plain(Xh, lsh, family: str, card: str) -> None:
    """Kernels 1-2 on a cglb-houseelectric.mesh4 rank's general path (its
    RANK_ROWS rows against RANK_COLS of them as columns), at the width
    coord_plan gives D 11, against the plain versions in fp64: both tiers
    of kernel 1 and kernel 2, B 1.  The plain sums go in row blocks of
    RANK_COLS, so no temporary passes a few GiB.  With it, the symmetric
    path's check against the general path above is a check against plain."""
    from cglb_tpu_torch.ops import matvec as _mv

    rng = np.random.default_rng(1)
    dev = Xh.device
    rows = _mv.Prepared(Xh[:RANK_ROWS], lsh, family)
    cols = _mv.Prepared(Xh[RANK_COLS:2 * RANK_COLS], lsh, family)
    p = torch.as_tensor(rng.normal(size=(1, RANK_ROWS)), device=dev)
    g = torch.as_tensor(rng.normal(size=(1, RANK_COLS)), device=dev)
    by_width = (dict(_mv.launch_matvec.launches_by_width),
                dict(_mv.launch_ls_grad.launches_by_width))
    acc = _mv.launch_matvec(rows, cols, p, True)
    cg = _mv.launch_matvec(rows, cols, p, False)
    ls = _mv.launch_ls_grad(rows, cols, p, g)
    width = rows.plan.width
    at_width = (_mv.launch_matvec.launches_by_width[width]
                - by_width[0].get(width, 0),
                _mv.launch_ls_grad.launches_by_width[width]
                - by_width[1].get(width, 0))
    plain = plain_ls = 0
    for r0 in range(0, RANK_ROWS, RANK_COLS):
        xr, pr = rows.xg[r0:r0 + RANK_COLS], p[:, r0:r0 + RANK_COLS]
        plain = plain + _mv.matvec_unit_plain(xr, cols.xg, pr, family)
        plain_ls = plain_ls + _mv.ls_grad_unit_plain(xr, cols.xg, pr, g,
                                                     family)
    err, _ = rel_err(acc, plain)
    cg_err, _ = rel_err(cg, plain)
    ls_err, _ = rel_err(ls, plain_ls)
    print(f"[slabs] {family} rank split {RANK_ROWS} x {RANK_COLS}, D "
          f"{HOUSE_D} (DP {width}), B 1, general path against plain fp64: "
          f"kernel 1 accurate rel err {err:.3e} (bound "
          f"{TOL['matvec_accurate']:g}), CG tier {cg_err:.3e} (bound "
          f"{TOL['matvec_cg']:g}); kernel 2 {ls_err:.3e} (bound "
          f"{TOL['backward']:g}); launches at width {width}: {at_width} "
          f"({card})", flush=True)
    require(err <= TOL["matvec_accurate"], "rank split: kernel 1 accurate")
    require(cg_err <= TOL["matvec_cg"], "rank split: kernel 1 CG tier")
    require(ls_err <= TOL["backward"], "rank split: kernel 2")
    require(at_width == (2, 1), "rank split: a launch at another width")
    del rows, cols, acc, cg, ls, plain, plain_ls


def _kin40k_model():
    """The main path's CGLB model, built as the CLI builds it."""
    from cglb_tpu_torch import config as _config
    from cglb_tpu_torch.backend import Torch
    from cglb_tpu_torch.configs import (CGLBConfig, InducingVariableConfig,
                                        Matern32Config)
    from cglb_tpu_torch.experiments.datasets import get_dataset

    _config.set_default_float("fp64")
    _config.set_default_jitter("fp64")
    return Torch(device="cuda").create_model(
        CGLBConfig(Matern32Config(), InducingVariableConfig(M)),
        get_dataset("Wilson_kin40k", split=0).train, seed=0)


def phase_chunked(card: str) -> None:
    from cglb_tpu_torch.models import cglb as _cglb
    from cglb_tpu_torch.ops import matvec as _mv

    model = _kin40k_model()
    params, (X, Y), cfg = model.params, model.data, model.run_cfg

    def operator():
        return _mv.make_streaming_operator(params.kernel, X,
                                           params.noise_variance.value)

    with torch.no_grad():  # one v for every evaluation, from a CG solve
        _, aux = _cglb.loss(params, X, Y, model.v0,
                            dataclasses.replace(cfg, max_error=1e-3),
                            matvec=operator())

    def evaluate(fixed, **kw):
        params.zero_grad(set_to_none=True)
        before = _read_counts()
        loss, _ = _cglb.loss(params, X, Y, aux.v, fixed, matvec=operator(),
                             **kw)
        loss.backward()
        return (float(loss.detach()), {name: prm.raw.grad.clone()
                              for name, prm in params.named_params()},
                _delta(_read_counts(), before))

    # the model's own fp32 preconditioner (chunked: A cast to fp32 a chunk
    # inside the recompute, its cotangent back through that cast), and fp64;
    # each build evaluated twice, to tell reordering from run-to-run spread
    chunked_kw = dict(chunk_size=4096, remat_common_terms=True)
    for dtype in (cfg.precond_dtype, "float64"):
        fixed = dataclasses.replace(cfg, vzero=True, precond_dtype=dtype)
        one, one_grads, _ = evaluate(fixed)
        chunked, grads, launches = evaluate(fixed, **chunked_kw)
        errs = {"loss": abs(chunked - one) / abs(one)}
        for name, g in grads.items():
            errs[name] = rel_err(g, one_grads[name])[0]
        repeats = {}
        for label, kw, first in (("one pass", {}, one_grads),
                                 ("chunked", chunked_kw, grads)):
            _, again, _ = evaluate(fixed, **kw)
            repeats[label] = max(rel_err(g, first[name])[0]
                                 for name, g in again.items())
        print(f"[chunked] kin40k CGLB loss and gradients, {dtype} "
              f"preconditioner, chunks of 4096 columns recomputed in the "
              f"backward, against one pass: "
              + json.dumps({k: f"{v:.3e}" for k, v in errs.items()})
              + f" (bound {CHUNKED_TOL:g}); each against its own repeat: "
              + json.dumps({k: f"{v:.3e}" for k, v in repeats.items()})
              + f"; launches {launches} ({card})", flush=True)
        require(max(errs.values()) <= CHUNKED_TOL,
                f"chunked against one pass ({dtype} preconditioner)")
        require(launches["kuf"] == 2 * -(-N // 4096),
                "chunked: kernel 3 not launched once a chunk and again in "
                "the backward")
    del model, params, X, Y
    torch.cuda.empty_cache()


def phase_houseelectric(results: dict, card: str) -> None:
    from cglb_tpu_torch.models import sgpr as _sgpr

    torch.cuda.empty_cache()
    width = _sgpr.chunk_width(HOUSE_N, HOUSE_M)
    chunks = -(-HOUSE_N // width)
    with tempfile.TemporaryDirectory() as logdir:
        out = run_cli(HOUSE_ARGS, logdir, steps=True)
    res, marks, losses = out["res"], out["marks"], out["step_losses"]
    require(out["model"].data[0].shape == (HOUSE_N, HOUSE_D),
            "houseelectric: training data of the wrong shape")
    require(len(marks) == 4 and len(losses) == 3,
            "houseelectric: not 3 objective evaluations")
    steps = []
    for a, b in zip(marks, marks[1:]):
        steps.append({"s": b["t"] - a["t"],
                      "launches": _delta(b["counts"], a["counts"]),
                      "peak_gib": b["peak"] / 2 ** 30})
    slabs = results["streaming_matvec"]["slabs_houseelectric"]
    metrics = finite_metrics(res, "houseelectric")
    print(f"[houseelectric] CLI run ({' '.join(HOUSE_ARGS)}) at N_train "
          f"{HOUSE_N}, D {HOUSE_D}, M {HOUSE_M}: chunks of {width} columns, "
          f"{chunks} chunks; {out['wall_s']:.2f} s wall, optimizer "
          f"{out['optimize_s']:.2f} s ({card})", flush=True)
    for i, st in enumerate(steps):
        k1 = st["launches"]["streaming_matvec"]
        print(f"[houseelectric] Adam step {i}: {st['s']:.3f} s, loss "
              f"{losses[i]:.4f}, CG steps {out['step_cg'][i]}, launches "
              f"{st['launches']} (kernel 1: {k1 / slabs:g} matvecs of "
              f"{slabs} slabs), peak allocated {st['peak_gib']:.2f} GiB",
              flush=True)
    print(f"[houseelectric] results.json loss {res['loss']:.4f}, elbo "
          f"{res['elbo']:.4f}, cg_lower_bound {res['cg_lower_bound']:.4f}, "
          f"upper {res['titsias_upper_bound']:.4f}, test rmse "
          f"{res['test/rmse']:.5f}, nlpd {res['test/nlpd']:.5f}; launches "
          f"over the run {out['launches']}; peak allocated over the run "
          f"{out['peak_bytes'] / 2 ** 30:.2f} GiB", flush=True)
    peak = max(st["peak_gib"] for st in steps)
    require(all(math.isfinite(v) for v in losses), "houseelectric: loss")
    require(losses[-1] < losses[0] and res["loss"] < losses[0],
            "houseelectric: the loss did not fall")
    require(res["elbo"] <= res["titsias_upper_bound"]
            and res["cg_lower_bound"] <= res["titsias_upper_bound"],
            "houseelectric: a bound above the upper bound")
    require("test/rmse" in metrics and "test/nlpd" in metrics,
            "houseelectric: test rmse / nlpd")
    for st in steps:
        require(all(st["launches"][k] > 0 for k in _counters()),
                "houseelectric: a kernel was not launched in a step")
        require(st["launches"]["kuf"] >= 2,
                "houseelectric: kernel 3 ran in fewer than 2 chunks")
    require(peak <= HOUSE_PEAK_GIB,
            f"houseelectric: a step allocated {peak:.2f} GiB")
    for name in _counters():
        results[name]["launches_houseelectric_run"] = out["launches"][name]
        results[name]["launches_per_houseelectric_step"] = statistics.mean(
            st["launches"][name] for st in steps)
    results["_houseelectric"] = {
        "chunk_width": width, "chunks": chunks,
        "step_s": [st["s"] for st in steps],
        "step_peak_gib": [st["peak_gib"] for st in steps],
        "step_losses": losses, "step_cg_steps": out["step_cg"],
        "wall_s": out["wall_s"], **{k: res[k] for k in (
            "loss", "elbo", "cg_lower_bound", "titsias_upper_bound",
            "test/rmse", "test/nlpd")}}
    _release(out)


# --------------------------------------------------------------------------
# phases 15-16: any input dimension; the sweep and the plot CLI
# --------------------------------------------------------------------------


def wide_inputs(d: int):
    """X [N, d], Z [WIDE_M, d], p [10, N], g [1, N], lengthscales sqrt(d)
    x U(0.5, 2) (so that K is not near-diagonal at this d), the variance and
    g [10, N] for kernel 2 at B 10, on the card, from numpy seed d."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(d)
    X = torch.as_tensor(rng.normal(size=(N, d)), device=dev)
    Z = torch.as_tensor(rng.normal(size=(WIDE_M, d)), device=dev)
    P = torch.as_tensor(rng.normal(size=(max(WIDE_B), N)), device=dev)
    g = torch.as_tensor(rng.normal(size=(1, N)), device=dev)
    ls = torch.as_tensor(math.sqrt(d) * rng.uniform(0.5, 2.0, size=d),
                         device=dev)
    var = torch.as_tensor(1.7, dtype=torch.float64, device=dev)
    G = torch.as_tensor(rng.normal(size=(max(WIDE_B), N)), device=dev)
    return X, Z, P, g, ls, var, G


def _wide_g(b: int, g, G):
    return g if b == 1 else G[:b]


def wide_rows(d: int, family: str, inputs) -> dict:
    """{row: (launch, bound)} of the wide kernels at input dimension d:
    kernel 1 on K(X, X) (one prepared set: the symmetric path) in both
    tiers and on two prepared sets of the same points (the general path),
    kernel 2 on both, at B 1 and 10, and kernel 3.  Bounds at the data's d,
    K(X, X)'s pairs counted once, two sets' as the general function.  Only
    entry points that every tree since PR 6 has (``--compare``)."""
    from cglb_tpu_torch.ops import kuf as _kuf
    from cglb_tpu_torch.ops import matvec as _mv

    X, Z, P, g, ls, var, G = inputs
    rows = _mv.Prepared(X, ls, family)
    rows2 = _mv.Prepared(X, ls, family)
    c = math.sqrt(_mv.GAMMA[family])
    zg, xg = Z * (c / ls), X * (c / ls)

    def mv(r, c_, b, accurate):
        return lambda: _mv.launch_matvec(r, c_, P[:b], accurate)

    def lsg(r, c_, b):
        return lambda: _mv.launch_ls_grad(r, c_, P[:b], _wide_g(b, g, G))

    out = {}
    for b in WIDE_B:
        out[f"kernel 1 accurate K(X, X) B {b}"] = (
            mv(rows, rows, b, True), matvec_bound(N, N, d, b, True, True))
        out[f"kernel 1 CG tier K(X, X) B {b}"] = (
            mv(rows, rows, b, False), matvec_bound(N, N, d, b, False, True))
        out[f"kernel 1 accurate, two prepared sets, B {b}"] = (
            mv(rows, rows2, b, True), matvec_bound(N, N, d, b, True))
        out[f"kernel 2 K(X, X) B {b}"] = (
            lsg(rows, rows, b), ls_grad_bound(N, N, d, b, True))
        out[f"kernel 2 two prepared sets, B {b}"] = (
            lsg(rows, rows2, b), ls_grad_bound(N, N, d, b))
    out[f"kernel 3 {WIDE_M}x{N}"] = (
        lambda: _kuf.launch_kuf(zg, xg, var, family), kuf_bound(WIDE_M, N, d))
    return out


def _wide_family(d: int, family: str, inputs, card: str) -> dict:
    """Kernels 1-3 of one family at input dimension d > 32 against their
    plain versions (each timed once, as it is computed), repeats bitwise,
    kernel 2 also on the data translated by +100 in every coordinate
    against the untranslated plain gradient, then the kernels' times beside
    their bounds: {"times": {row: (ms, bound)}}, the errors and plain times
    of kernels 1-2's kernels-line rows and kernel 3's row (check_kuf)."""
    from cglb_tpu_torch.ops import matvec as _mv

    X, Z, P, g, ls, var, G = inputs
    rows = _mv.Prepared(X, ls, family)
    rows2 = _mv.Prepared(X, ls, family)
    require(rows.plan.wide, f"D {d}: not the wide plan")
    tag = f"[wide] {family} D {d} (width {rows.plan.width})"
    out = {}
    for b in WIDE_B:
        p = P[:b]
        plain, plain_ms = once_ms(
            lambda: _mv.matvec_unit_plain(rows.xg, rows.xg, p, family))
        for accurate in (True, False):
            tier = "accurate" if accurate else "CG tier"
            tol = TOL["matvec_accurate" if accurate else "matvec_cg"]
            sym = _mv.launch_matvec(rows, rows, p, accurate)
            gen = _mv.launch_matvec(rows, rows2, p, accurate)
            e_sym, abs_sym = rel_err(sym, plain)
            e_gen, _ = rel_err(gen, plain)
            same = (torch.equal(sym, _mv.launch_matvec(rows, rows, p,
                                                       accurate))
                    and torch.equal(gen, _mv.launch_matvec(rows, rows2, p,
                                                           accurate)))
            print(f"{tag} kernel 1 {tier} B {b}: rel err K(X, X) "
                  f"{e_sym:.3e}, two prepared sets {e_gen:.3e} (bound "
                  f"{tol:g}); repeats bitwise equal {same}; plain "
                  f"{plain_ms:.1f} ms", flush=True)
            require(max(e_sym, e_gen) <= tol, f"{tag} kernel 1 {tier} B {b}")
            require(same, f"{tag} kernel 1 {tier} B {b} is not deterministic")
            if b == 1 and accurate:
                out["matvec"] = (abs_sym, plain_ms)
        del plain
        gb = _wide_g(b, g, G)
        ls_plain, ls_plain_ms = once_ms(
            lambda: _mv.ls_grad_unit_plain(rows.xg, rows.xg, p, gb, family))
        sym = _mv.launch_ls_grad(rows, rows, p, gb)
        gen = _mv.launch_ls_grad(rows, rows2, p, gb)
        e_sym, ls_abs = rel_err(sym, ls_plain)
        e_gen, _ = rel_err(gen, ls_plain)
        same = (torch.equal(sym, _mv.launch_ls_grad(rows, rows, p, gb))
                and torch.equal(gen, _mv.launch_ls_grad(rows, rows2, p, gb)))
        line = (f"{tag} kernel 2 B {b}: rel err K(X, X) {e_sym:.3e}, two "
                f"prepared sets {e_gen:.3e}")
        errs = [e_sym, e_gen]
        if b == 1:  # the expansion's cancellation guard
            far = _mv.Prepared(X + 100.0, ls, family)
            far2 = _mv.Prepared(X + 100.0, ls, family)
            e_far, _ = rel_err(_mv.launch_ls_grad(far, far, p, gb), ls_plain)
            e_far2, _ = rel_err(_mv.launch_ls_grad(far, far2, p, gb),
                                ls_plain)
            line += (f"; translated by +100 against the untranslated plain "
                     f"gradient: K(X, X) {e_far:.3e}, two sets {e_far2:.3e}")
            errs += [e_far, e_far2]
            out["ls_grad"] = (ls_abs, ls_plain_ms)
            out["translated"] = max(e_far, e_far2)
            del far, far2
        print(f"{line} (bound {TOL['backward']:g}); repeats bitwise equal "
              f"{same}; plain {ls_plain_ms:.1f} ms", flush=True)
        require(max(errs) <= TOL["backward"], f"{tag} kernel 2 B {b}")
        require(same, f"{tag} kernel 2 B {b} is not deterministic")
        del ls_plain
    c = math.sqrt(_mv.GAMMA[family])
    out["kuf"] = check_kuf(tag, Z * (c / ls), X * (c / ls), var, family)
    del rows, rows2

    out["times"] = {}
    for name, (fn, bnd) in wide_rows(d, family, inputs).items():
        ms = cuda_ms(fn, 3)
        show(f"{family} D {d} {name}", ms, bnd, f" ({card})")
        out["times"][name] = (ms, bnd)
    torch.cuda.empty_cache()
    return out


def phase_wide(results: dict, card: str) -> None:
    """Kernels 1-3 at D 40 and 100, both families, at N 26800 (M 1024)."""
    for d in WIDE_DS:
        inputs = wide_inputs(d)
        for family in ("mat32", "rbf"):
            got = _wide_family(d, family, inputs, card)
            if family != "mat32":  # the kernels line holds Matern32's
                continue
            times = got["times"]
            results[f"kuf_d{d}"] = got["kuf"]
            rows = {
                "streaming_matvec_wide": (got["matvec"], times[
                    "kernel 1 accurate K(X, X) B 1"]),
                "ls_grad_wide": (got["ls_grad"],
                                 times["kernel 2 K(X, X) B 1"])}
            for name, ((abs_err, plain_ms), (ms, bnd)) in rows.items():
                if d == WIDE_DS[0]:
                    results[name] = dict(
                        max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
                        d=d)
                else:
                    results[name].update({
                        f"max_abs_err_d{d}": abs_err, f"ms_d{d}": ms,
                        f"plain_ms_d{d}": plain_ms, f"bound_ms_d{d}": bnd[0]})
            b10 = max(WIDE_B)
            results["streaming_matvec_wide"].update({
                f"ms_cg_tier_d{d}": times["kernel 1 CG tier K(X, X) B 1"][0],
                f"ms_b{b10}_d{d}": times[
                    f"kernel 1 accurate K(X, X) B {b10}"][0],
                f"ms_general_d{d}": times[
                    "kernel 1 accurate, two prepared sets, B 1"][0]})
            results["ls_grad_wide"].update({
                f"ms_b{b10}_d{d}": times[f"kernel 2 K(X, X) B {b10}"][0],
                f"ms_general_d{d}": times[
                    "kernel 2 two prepared sets, B 1"][0],
                f"translated_rel_err_d{d}": got["translated"]})
        del inputs
        torch.cuda.empty_cache()


def phase_wide_cli(results: dict, card: str) -> None:
    """The CLI trainer at D 40: the wide kernels on the main path."""
    with tempfile.TemporaryDirectory() as logdir:
        out = run_cli(WIDE_ARGS, logdir, steps=True)
    res, losses, launches = out["res"], out["step_losses"], out["launches"]
    require(out["model"].data[0].shape[1] == 40, "wide: data not at D 40")
    metrics = finite_metrics(res, "wide")
    print(f"[wide] CLI run ({' '.join(WIDE_ARGS)}): {out['wall_s']:.2f} s "
          f"wall; step losses {losses}, CG steps {out['step_cg']}; final "
          f"loss {res['loss']:.4f}, elbo {res['elbo']:.4f}, cg_lower_bound "
          f"{res['cg_lower_bound']:.4f}, upper "
          f"{res['titsias_upper_bound']:.4f}, test rmse "
          f"{res['test/rmse']:.5f}, nlpd {res['test/nlpd']:.5f}; launches "
          f"{launches} ({card})", flush=True)
    require(len(losses) == 3, "wide: not 3 objective evaluations")
    require(losses[-1] < losses[0] and res["loss"] < losses[0],
            "wide: the loss did not fall")
    require(res["elbo"] <= res["titsias_upper_bound"]
            and res["cg_lower_bound"] <= res["titsias_upper_bound"],
            "wide: a bound above the upper bound")
    require("test/rmse" in metrics and "test/nlpd" in metrics,
            "wide: test rmse / nlpd")
    require_all_launched(launches, "wide")
    for name in ("streaming_matvec", "ls_grad"):
        results[f"{name}_wide"]["launches"] = launches[name]
    results["kuf_d40"]["launches_wide_run"] = launches["kuf"]
    results["_wide"] = {"step_losses": losses, "wall_s": out["wall_s"],
                        **{k: res[k] for k in (
                            "loss", "elbo", "cg_lower_bound",
                            "titsias_upper_bound", "test/rmse",
                            "test/nlpd")}}
    _release(out)


def _port_env() -> dict:
    """The environment of a subprocess that imports this checkout's
    package from any directory."""
    path = [str(ROOT)] + [p for p in os.environ.get(
        "PYTHONPATH", "").split(os.pathsep) if p]
    return dict(os.environ, PYTHONPATH=os.pathsep.join(path))


def _module(args, cwd, timeout: float) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m"] + list(args), cwd=cwd,
                          env=_port_env(), capture_output=True, text=True,
                          timeout=timeout)


def _tpu_table(path: Path) -> dict:
    """uid -> (loss, test rmse, test nlpd) of a results_table.md of the JAX
    package (pandas markdown, index ('dataset', 'uid'))."""
    out = {}
    for m in re.finditer(r"'([^']+)'\) *\| *([-\d.]+) *\| *([-\d.]+) *\| "
                         r"*([-\d.]+) *\|", path.read_text()):
        out[m.group(1)] = tuple(float(v) for v in m.groups()[1:])
    return out


def phase_sweep(card: str) -> None:
    """grids/proof.toml through the port's sweep runner (-p 1) in a fresh
    directory, again (every point skipped), then plotcli results_table."""
    t0 = time.perf_counter()
    sweep = ["cglb_tpu_torch.experiments.sweep", str(PROOF_GRID), "-p", "1"]
    with tempfile.TemporaryDirectory() as work:
        first = _module(sweep, work, 900)
        first_s = time.perf_counter() - t0
        OUT.mkdir(exist_ok=True)
        (OUT / "chip_smoke_sweep.log").write_text(first.stdout + first.stderr)
        require(first.returncode == 0, f"sweep: rc {first.returncode} "
                f"(chiprun_out/chip_smoke_sweep.log): {first.stderr[-2000:]}")
        root = Path(work, "runs", "sweep-proof")
        results = sorted(root.glob("*/*/*/results.json"))
        events = sorted(root.glob("*/*/*/events.out.tfevents.*"))
        print(f"[sweep] {PROOF_GRID.relative_to(ROOT)} -p 1: rc "
              f"{first.returncode}, {len(results)} results.json, "
              f"{len(events)} event files, {first_s:.1f} s", flush=True)
        require(len(results) == 5 and len(events) == 5,
                "sweep: not five results and five event files")
        for path in results:
            require(json.loads(path.read_text())["data"] == "synthetic",
                    "sweep: synthetic stand-in expected")
        second = _module(sweep, work, 300)
        skipped = second.stdout.count("[skip]")
        ran = second.stdout.count("[run")
        print(f"[sweep] second call: rc {second.returncode}, {skipped} "
              f"skipped, {ran} run", flush=True)
        require(second.returncode == 0 and skipped == 5 and ran == 0,
                "sweep: the second call did not skip all five points")
        table = _module(["cglb_tpu_torch.experiments.plotcli", "-r",
                         str(root), "results_table", "-f", "csv"], work, 300)
        require(table.returncode == 0,
                f"plotcli results_table: {table.stderr[-2000:]}")
    rows = list(csv.DictReader(io.StringIO(table.stdout)))
    tpu = _tpu_table(PROOF_TPU)
    print(f"[sweep] plotcli results_table: {len(rows)} rows; port (this "
          f"card) against the TPU runs of {PROOF_TPU.relative_to(ROOT)}, "
          "reported, not asserted:", flush=True)
    require(len(rows) == 5, "plotcli: not five rows")
    for row in rows:
        got = tuple(float(row[k]) for k in ("loss", "test/rmse", "test/nlpd"))
        want = tpu.get(row["uid"])
        print(f"[sweep]   {row['uid']}: loss {got[0]:.4f}, test rmse "
              f"{got[1]:.4f}, nlpd {got[2]:.4f}; TPU "
              + ("none" if want is None else
                 f"{want[0]:.4f} / {want[1]:.4f} / {want[2]:.4f}"),
              flush=True)
        require(all(math.isfinite(v) for v in got), "plotcli: a value is "
                "not finite")
        require(got[1] <= PROOF_RMSE, f"sweep: test rmse above {PROOF_RMSE}")
    print(f"[sweep] phase {time.perf_counter() - t0:.1f} s ({card})",
          flush=True)


def protocol_adam(card: str) -> int:
    """grids/protocol-adam.toml through the port's sweep runner, from the
    repository root (its logdir is under runs/, which git ignores): the
    whole 2000-step Adam run, its best and final loss and test rmse beside
    the TPU run's (reported), its logs copied to chiprun_out/."""
    from cglb_tpu_torch.utils.serialization import load_json

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "cglb_tpu_torch.experiments.sweep",
         str(ADAM_GRID), "--restart"], cwd=ROOT, env=_port_env(),
        timeout=1800)
    wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"protocol Adam run: rc {proc.returncode}")
    (logdir,) = sorted(ROOT.glob("runs/protocol-adam/*/*/*/"))
    res = load_json(logdir / "results.json")
    logs = load_json(logdir / "logs.json")
    tpu = load_json(ADAM_TPU / "logs.json")
    finite_metrics(res, "protocol-adam")
    OUT.mkdir(exist_ok=True)
    for name in ("results.json", "logs.json"):
        shutil.copy(logdir / name, OUT / f"protocol-adam-{name}")

    def summary(lg):
        return {"records": len(lg["loss"]), "best loss": min(lg["loss"]),
                "final loss": lg["loss"][-1],
                "best test rmse": min(lg["test/rmse"]),
                "final test rmse": lg["test/rmse"][-1]}

    train_s = logs["elapsed_time"][-1]
    print(f"[protocol-adam] {wall:.1f} s wall; train s {train_s:.1f} at the "
          f"last record; port {json.dumps(summary(logs))}; "
          f"TPU run {ADAM_TPU.relative_to(ROOT)} "
          f"{json.dumps(summary(tpu))}; final results.json loss "
          f"{res['loss']:.4f}, test rmse {res['test/rmse']:.4f}, nlpd "
          f"{res['test/nlpd']:.4f}, elbo {res['elbo']:.4f}, cg_lower_bound "
          f"{res['cg_lower_bound']:.4f}, upper "
          f"{res['titsias_upper_bound']:.4f} ({card})", flush=True)
    require(len(logs["loss"]) == 100, "protocol-adam: not 100 records")
    require(logs["loss"][-1] < logs["loss"][0], "protocol-adam: the loss "
            "did not fall")
    require(res["elbo"] <= res["titsias_upper_bound"]
            and res["cg_lower_bound"] <= res["titsias_upper_bound"],
            "protocol-adam: a bound above the upper bound")
    return 0



# --------------------------------------------------------------------------
# phase 17: CGLB over torch.distributed
# --------------------------------------------------------------------------


def mesh_parity(mesh, tag: str) -> dict:
    """The kin40k model's sharded streaming loss against the one-process
    ``cglb.loss`` on this card, both on kernel 1's accurate tier with the
    fp64 preconditioner: at CG capped at MESH_CG_CAP steps from zeros (the
    loss), and at a converged v where CG takes no step (the loss and every
    gradient).  Returns the errors and the sharded evaluations' launches."""
    from cglb_tpu_torch.models import cglb as _cglb
    from cglb_tpu_torch.ops import matvec as _mv
    from cglb_tpu_torch.parallel import sharded as _sh

    model = _kin40k_model()
    params, (X, Y) = model.params, model.data
    base = dataclasses.replace(model.run_cfg, precond_dtype="float64")
    capped = dataclasses.replace(base, max_error=1e-30,
                                 max_cg_iters=MESH_CG_CAP)
    fixed = dataclasses.replace(base, max_error=1e30)

    def one_process(cfg, v):
        op = _mv.make_streaming_operator(params.kernel, X,
                                         params.noise_variance.value)
        return _cglb.loss(params, X, Y, v, cfg, matvec=op)

    def sharded(cfg, v):
        return _sh.sharded_cglb_loss(params, X, Y, v, cfg, mesh,
                                     matvec="streaming")

    def evaluate(fn, cfg, v):
        params.zero_grad(set_to_none=True)
        before = _read_counts()
        loss, aux = fn(cfg, v)
        loss.backward()
        torch.cuda.synchronize()
        return (float(loss.detach()), aux.cg_steps,
                {name: prm.raw.grad.clone()
                 for name, prm in params.named_params()},
                _delta(_read_counts(), before))

    with torch.no_grad():
        _, solved = one_process(dataclasses.replace(base, max_error=1e-8,
                                                    max_cg_iters=200),
                                model.v0)
    out = {"solve_cg_steps": solved.cg_steps,
           "solve_residual_error": solved.cg_residual_error}
    require(solved.cg_residual_error <= 1e-8,
            f"{tag}: the solve for v did not converge: {out}")
    v0 = torch.zeros_like(model.v0)
    for label, cfg, v in (("capped", capped, v0), ("converged", fixed,
                                                   solved.v)):
        l1, s1, g1, _ = evaluate(one_process, cfg, v)
        ls, ss, gs, launches = evaluate(sharded, cfg, v)
        require(s1 == ss, f"{tag}: {label}: CG steps {ss} sharded against "
                f"{s1} in one process")
        out[f"{label}_loss_rel"] = abs(ls - l1) / abs(l1)
        out[f"{label}_cg_steps"] = ss
        out[f"{label}_launches"] = launches
        require(out[f"{label}_loss_rel"] <= MESH_TOL["loss"],
                f"{tag}: {label} loss {ls!r} against {l1!r}")
        require_all_launched(launches, f"{tag}: {label}")
        if label == "converged":
            out["grad_rel"] = {name: rel_err(g, g1[name])[0]
                               for name, g in gs.items()}
            require(max(out["grad_rel"].values()) <= MESH_TOL["grad"],
                    f"{tag}: gradients {out['grad_rel']}")
    del model, params, X, Y
    torch.cuda.empty_cache()
    return out


def mesh_rank(outdir: Path) -> int:
    """One rank of phase 17's gloo group: its parity check, then phase 3's
    command with ``--mesh 2 --dist-backend gloo`` through the CLI
    (in-process, joining the group), its step losses and seconds, launches
    and final parameters; rank 0 then checks kernels 1-3 on its column
    half (B 1) against their plain versions and times them while the other
    rank waits.  Writes rank<r>.json and
    rank<r>_params.npz into ``outdir``."""
    from cglb_tpu_torch.experiments import cli
    from cglb_tpu_torch.ops import kuf as _kuf
    from cglb_tpu_torch.ops import matvec as _mv
    from cglb_tpu_torch.ops.kernels import GAMMA
    from cglb_tpu_torch.parallel import mesh as _pm

    mesh = _pm.data_mesh(2, "cuda", "gloo")
    tag = f"mesh rank {mesh.rank}"
    rec = {"rank": mesh.rank, "mesh": mesh.describe(),
           "parity": mesh_parity(mesh, tag)}
    seen: dict = {}
    _zero_counts()
    t0 = time.perf_counter()
    with _watched(seen, steps=True):
        cli.main(["-l", str(outdir / "run")] + MESH_ARGS)
    torch.cuda.synchronize()
    rec["wall_s"] = time.perf_counter() - t0
    rec["launches"] = _read_counts()
    marks = seen["marks"]
    rec["step_s"] = [b["t"] - a["t"] for a, b in zip(marks, marks[1:])]
    rec["step_losses"] = seen["step_losses"]
    rec["step_cg"] = seen["step_cg"]
    model = seen["model"]
    np.savez(outdir / f"rank{mesh.rank}_params.npz",
             **{name: p.raw.detach().cpu().numpy()
                for name, p in model.params.named_params()})
    mesh.barrier()
    if mesh.rank == 0:  # the other rank waits in the next barrier
        X = model.data[0]
        ls = model.params.kernel.lengthscales.value.detach()
        c0, c1 = mesh.cols(X.shape[0])
        rows = _mv.Prepared(X, ls, "mat32")
        cols = _mv.Prepared(X[c0:c1], ls, "mat32")
        p = torch.randn(1, X.shape[0], dtype=torch.float64,
                        device=X.device)
        g = torch.randn(1, c1 - c0, dtype=torch.float64, device=X.device)
        scale = math.sqrt(GAMMA["mat32"]) / ls
        zg = model.params.inducing_Z.value.detach() * scale
        xg = X[c0:c1] * scale
        var = model.params.kernel.variance.value.detach()
        rec["half_cols"] = c1 - c0
        # kernels 1-3 on the general path at the rank's shapes, each
        # against its plain version with phase 2's tolerances
        kuf_k, e_k = _kuf.launch_kuf(zg, xg, var, "mat32")
        kuf_p, e_p = _kuf.kuf_unit_plain(zg, xg, var, "mat32")
        rec["half_err"] = {
            "streaming_matvec": rel_err(
                _mv.launch_matvec(rows, cols, p, True),
                _mv.matvec_unit_plain(rows.xg, cols.xg, p, "mat32"))[0],
            "ls_grad": rel_err(
                _mv.launch_ls_grad(rows, cols, p, g),
                _mv.ls_grad_unit_plain(rows.xg, cols.xg, p, g, "mat32"))[0],
            "kuf": max(rel_err(kuf_k, kuf_p)[0], rel_err(e_k, e_p)[0])}
        del kuf_k, e_k, kuf_p, e_p
        rec["half_tol"] = {"streaming_matvec": TOL["matvec_accurate"],
                           "ls_grad": TOL["backward"], "kuf": TOL["kuf"]}
        rec["half_ms"] = {
            "streaming_matvec": cuda_ms(
                lambda: _mv.launch_matvec(rows, cols, p, True), 10),
            "ls_grad": cuda_ms(
                lambda: _mv.launch_ls_grad(rows, cols, p, g), 10),
            "kuf": cuda_ms(lambda: _kuf.launch_kuf(zg, xg, var, "mat32"),
                           10)}
    mesh.barrier()
    (outdir / f"rank{mesh.rank}.json").write_text(json.dumps(rec))
    _pm.shutdown()
    return 0


def phase_mesh(results: dict, card: str) -> None:
    from cglb_tpu_torch.parallel import mesh as _pm
    from cglb_tpu_torch.utils.serialization import load_json

    t0 = time.perf_counter()
    env = {"CGLB_COORDINATOR": f"localhost:{_pm.free_port()}",
           "CGLB_NUM_PROCESSES": "1", "CGLB_PROCESS_ID": "0"}
    os.environ.update(env)
    try:
        mesh = _pm.data_mesh(1, "cuda")
        print(f"[mesh] {mesh.describe()}", flush=True)
        require(mesh.backend == "nccl", "mesh: NCCL expected on CUDA")
        one = mesh_parity(mesh, "mesh NCCL world 1")
    finally:
        _pm.shutdown()
        for key in env:
            os.environ.pop(key)
    print(f"[mesh] NCCL, world size 1, kin40k sharded streaming loss "
          f"against one process ({card}): " + json.dumps(one), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        outdir = Path(tmp)
        _pm.run_ranks([sys.executable, str(ROOT / "chip_smoke.py"),
                       "--mesh-rank", str(outdir)], 2, env=_port_env(),
                      timeout_s=MESH_RANK_TIMEOUT_S)
        ranks = [json.loads((outdir / f"rank{r}.json").read_text())
                 for r in range(2)]
        params = [np.load(outdir / f"rank{r}_params.npz") for r in range(2)]
        run = outdir / "run"
        written = sorted(f.name for f in run.iterdir())
        res = load_json(run / "results.json")
    for rec in ranks:
        print(f"[mesh] {rec['mesh']}: parity " + json.dumps(rec["parity"])
              + f"; CLI run launches {rec['launches']}", flush=True)
        require_all_launched(rec["launches"], f"mesh rank {rec['rank']} run")
    same = all(np.array_equal(params[0][k], params[1][k])
               for k in params[0].files)
    print(f"[mesh] --mesh 2 run: the ranks' final parameters bitwise "
          f"equal: {same}; written: {written}", flush=True)
    require(same, "mesh: the ranks' parameters differ")
    require(sum(name == "results.json" for name in written) == 1
            and sum(name.startswith("events.out.tfevents") for name in
                    written) == 1 and "checkpoint.json" not in written,
            f"mesh: unexpected files {written}")
    finite_metrics(res, "mesh")
    require(res["elbo"] <= res["titsias_upper_bound"], "mesh: elbo > upper")
    require(res["cg_lower_bound"] <= res["titsias_upper_bound"],
            "mesh: cg_lower_bound > upper")
    losses, main = ranks[0]["step_losses"], results["_main_losses"]
    require(ranks[1]["step_losses"] == losses,
            "mesh: the ranks' step losses differ")
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, main)]
    print(f"[mesh] --mesh 2 run losses {losses} (CG steps "
          f"{ranks[0]['step_cg']}); phase 3's one-process losses {main}; "
          f"relative gaps {gaps} (bound {MESH_TOL['run_loss']:g})",
          flush=True)
    require(len(losses) == len(main) >= 5
            and max(gaps) <= MESH_TOL["run_loss"],
            "mesh: the run's losses moved from the one-process run's")
    # the last four intervals between evaluations are steps 2-5 (the
    # logger's evaluation after step 1 sits between the first two)
    step_s = statistics.median(ranks[0]["step_s"][-4:])
    cols = ranks[0]["half_cols"]
    half_err, half_tol = ranks[0]["half_err"], ranks[0]["half_tol"]
    print(f"[mesh] kernels on rank 0's column half (26800 x {cols}, B 1, "
          f"general path) against their plain versions: rel err "
          f"{json.dumps(half_err)} (bounds {json.dumps(half_tol)})",
          flush=True)
    for name, err in half_err.items():
        require(err <= half_tol[name],
                f"mesh: {name} on the column half against its plain version")
    half = {"streaming_matvec": (ranks[0]["half_ms"]["streaming_matvec"],
                                 matvec_bound(N, cols, D, 1, True)),
            "ls_grad": (ranks[0]["half_ms"]["ls_grad"],
                        ls_grad_bound(N, cols, D, 1)),
            "kuf": (ranks[0]["half_ms"]["kuf"], kuf_bound(M, cols, D))}
    print(f"[mesh] two ranks sharing one card, not a multi-GPU speed "
          f"({card}): a step of the --mesh 2 run {step_s:.4f} s (median of "
          f"steps 2-5, rank 0's clock); phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, (ms, bnd) in half.items():
        show(f"{name} on rank 0's column half (26800 x {cols}, B 1, general "
             "path), the other rank idle", ms, bnd)
    for name in _counters():
        results[name]["launches_mesh_run"] = sum(
            rec["launches"][name] for rec in ranks)
    results["_mesh"] = {
        "losses": losses, "max_rel_gap": max(gaps), "step_s": step_s,
        "half_cols": cols, "half_err": half_err, "nccl_world1": one,
        "half": {name: {"ms": ms, "bound_ms": bnd[0], "bound_by": bnd[1]}
                 for name, (ms, bnd) in half.items()}}


# --------------------------------------------------------------------------
# phase 18: prediction at the main path's full width
# --------------------------------------------------------------------------


@contextlib.contextmanager
def _cg_solves():
    """Record (steps, residual error, preconditioner dtype) of every
    preconditioned CG solve inside the block (the prediction's fp32 solve,
    and its fp64 one where the fp32 one failed)."""
    from cglb_tpu_torch.ops import cg as _cg

    real, solves = _cg.preconditioned_cg, []

    def recorded(matvec, b, v0, precond, *args, **kwargs):
        v, stats = real(matvec, b, v0, precond, *args, **kwargs)
        solves.append((stats.steps, stats.residual_error,
                       str(precond.A.dtype).replace("torch.", "")))
        return v, stats

    _cg.preconditioned_cg = recorded
    try:
        yield solves
    finally:
        _cg.preconditioned_cg = real


def _predict_log_density(model, bundle) -> dict:
    """Model.predict_log_density(test, cg_tolerance=1e-6): the values, its
    CG solves, kernel launches (counts zeroed first), seconds, peak
    allocated bytes."""
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _cg_solves() as solves:
        lpd = model.predict_log_density(bundle.test,
                                        cg_tolerance=PREDICT_CG_TOL)
    torch.cuda.synchronize()
    return {"lpd": lpd, "seconds": time.perf_counter() - t0,
            "solves": solves, "launches": _read_counts(),
            "peak": torch.cuda.max_memory_allocated()}


def _full_cov(fn) -> dict:
    """fn() -> (mean, [1, S, S] covariance) under no_grad, with its seconds
    and peak allocated bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        _, var = fn()
    torch.cuda.synchronize()
    return {"var": var, "seconds": time.perf_counter() - t0,
            "peak": torch.cuda.max_memory_allocated()}


def _check_cov(tag: str, var, marginal, kvar: float, sigma_sq) -> dict:
    """The [1, S, S] covariance: fp64, symmetric to PREDICT_TOL["sym"] of
    its max, its diagonal the marginal variance to PREDICT_TOL["diag"] of
    max kdiag (= the kernel variance), and var + sigma^2 I factors."""
    n = N_TEST
    require(var.shape == (1, n, n) and var.dtype == torch.float64,
            f"{tag}: covariance of shape {tuple(var.shape)}, {var.dtype}")
    cov = var[0]
    vmax = float(cov.abs().max())
    sym = float((cov - cov.T).abs().max()) / vmax
    diag = float((torch.diagonal(cov) - marginal).abs().max()) / kvar
    eye = torch.eye(n, dtype=cov.dtype, device=cov.device)
    _, info = torch.linalg.cholesky_ex(cov + sigma_sq * eye)
    del eye
    factors = int(info) == 0
    print(f"[predict] {tag} covariance [1, {n}, {n}]: symmetric to "
          f"{sym:.3e} of its max (bound {PREDICT_TOL['sym']:g}), diagonal "
          f"against the marginal variance {diag:.3e} of max kdiag (bound "
          f"{PREDICT_TOL['diag']:g}), cholesky(var + sigma^2 I) "
          f"{'succeeds' if factors else f'fails (info {int(info)})'}",
          flush=True)
    require(sym <= PREDICT_TOL["sym"], f"{tag}: covariance not symmetric")
    require(diag <= PREDICT_TOL["diag"],
            f"{tag}: covariance diagonal is not the marginal variance")
    require(factors, f"{tag}: var + sigma^2 I is not positive definite")
    return {"symmetric_rel": sym, "diagonal_rel": diag}


def _check_kss(Xs, params, card: str) -> dict:
    """Kernel 3 on K(Xs, Xs), all N_TEST test rows, without e: against
    its plain version, the diagonal exactly the variance, repeats bitwise
    equal; timed beside its bound (8 bytes an entry written)."""
    from cglb_tpu_torch.ops import kuf as _kuf
    from cglb_tpu_torch.ops.kernels import GAMMA

    with torch.no_grad():
        ls = params.kernel.lengthscales.value
        var = params.kernel.variance.value
        xg = (Xs * (math.sqrt(GAMMA["mat32"]) / ls)).contiguous()
    (plain, _), plain_ms = once_ms(
        lambda: _kuf.kuf_unit_plain(xg, xg, var, "mat32", with_e=False))
    kss, none = _kuf.launch_kuf(xg, xg, var, "mat32", with_e=False)
    err, abs_err = rel_err(kss, plain)
    del plain
    exact = torch.equal(torch.diagonal(kss), var.detach().expand(N_TEST))
    same = torch.equal(kss, _kuf.launch_kuf(xg, xg, var, "mat32", False)[0])
    symmetric = torch.equal(kss, kss.T)
    del kss
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: _kuf.launch_kuf(xg, xg, var, "mat32", False), 10)
    bound_ms, bound_by = kuf_bound(N_TEST, N_TEST, D, with_e=False)
    print(f"[predict] kernel 3 on K(Xs, Xs) {N_TEST}x{N_TEST}, D {D}, "
          f"without e ({card}): rel err {err:.3e} (bound {TOL['kuf']:g}); "
          f"diagonal exactly var {exact}; repeats bitwise equal {same}; "
          f"bitwise symmetric {symmetric}; plain {plain_ms:.2f} ms",
          flush=True)
    show(f"mat32 kuf K(Xs, Xs) {N_TEST}x{N_TEST} D {D} (no e: 8 B an entry "
         "written)", ms, (bound_ms, bound_by))
    require(none is None and err <= TOL["kuf"], "kernel 3 on K(Xs, Xs)")
    require(exact, "kernel 3 on K(Xs, Xs): diagonal is not exactly var")
    require(same, "kernel 3 on K(Xs, Xs) is not deterministic")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None, d=D,
                width=D, shape=[N_TEST, N_TEST], with_e=False,
                bitwise_symmetric=symmetric)


def _numpy_kernel(kernel):
    """(kernel_diag, kernel_cross) in numpy for ``conditional_variance_
    numpy``: the port's stationary kernel at its values, by the formula of
    ``ops/kernels.py`` (scaled norms, the clamped expansion, Matern32's
    sqrt(d2 + 1e-36)).  Plain numpy: the torch CPU ops cost some 50 ms a
    column there against the card's threads."""
    with torch.no_grad():
        var = float(kernel.variance.value)
        ls = kernel.lengthscales.value.cpu().numpy()

    def diag(A):
        return np.full(A.shape[0], var)

    def cross(A, B):
        As, Bs = A / ls, B / ls
        d2 = np.maximum(np.sum(As * As, -1)[:, None]
                        + np.sum(Bs * Bs, -1)[None, :] - 2.0 * (As @ Bs.T),
                        0.0)
        if kernel.family == "rbf":
            return var * np.exp(-0.5 * d2)
        s3r = math.sqrt(3.0) * np.sqrt(d2 + 1e-36)
        return var * (1.0 + s3r) * np.exp(-s3r)

    return diag, cross


def _check_conditional_variance(X, kernel) -> dict:
    """ConditionalVariance on the card against the numpy oracle on the
    host (the same kernel in numpy), CV_M points, seed 0.  Where the picks
    first differ, both candidates' conditional variances given the points
    picked before are computed on the host: they must tie to 1e-12
    relative."""
    from cglb_tpu_torch.utils.inducing import (conditional_variance,
                                               conditional_variance_numpy)

    diag, cross = _numpy_kernel(kernel)
    Xh = X.cpu().numpy()
    t0 = time.perf_counter()
    with torch.no_grad():
        _, idx = conditional_variance(X, CV_M, kernel, seed=0)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, oidx = conditional_variance_numpy(Xh, CV_M, diag, cross, seed=0)
    host_s = time.perf_counter() - t0
    same = np.array_equal(idx, oidx)
    print(f"[predict] conditional_variance on the card ({card_s:.2f} s) "
          f"and conditional_variance_numpy on the host ({host_s:.2f} s), "
          f"{N} rows, M {CV_M}, seed 0: the same indices {same}",
          flush=True)
    out = {"same_indices": same, "card_s": card_s, "host_s": host_s}
    if not same:
        k = int(np.flatnonzero(idx != oidx)[0])
        S = Xh[idx[:k]]
        cand = Xh[[idx[k], oidx[k]]]
        kx = cross(S, cand)
        Kss = cross(S, S) + 1e-12 * np.eye(k)
        cv = (diag(cand) - np.sum(kx * np.linalg.solve(Kss, kx), 0)).tolist()
        rel = abs(cv[0] - cv[1]) / max(abs(cv[0]), abs(cv[1]))
        print(f"[predict] first difference at step {k}: card picks "
              f"{idx[k]} (conditional variance {cv[0]!r}), host picks "
              f"{oidx[k]} ({cv[1]!r}), relative gap {rel:.3e} (a tie "
              "below 1e-12)", flush=True)
        require(rel <= 1e-12, "conditional_variance: the card and the host "
                f"pick differently at step {k} without a tie")
        out.update(first_difference=k, tie_rel=rel)
    return out


def phase_predict(results: dict, card: str, anchor_nlpd: float) -> None:
    """Prediction at kin40k's full width on kernels 1 and 3 (docstring,
    phase 18); ``anchor_nlpd``: phase 4's metrics_fn test/nlpd (CG at
    1e-3)."""
    from cglb_tpu_torch.models import cglb as _cglb
    from cglb_tpu_torch.models import sgpr as _sgpr
    from cglb_tpu_torch.ops import matvec as _mv

    t_phase = time.perf_counter()
    _, model, bundle = anchor_model()
    require(model.streaming, "phase 18: the model is not streaming")
    got = _predict_log_density(model, bundle)
    nlpd = -float(got["lpd"].mean())
    steps, residual, precond = got["solves"][-1]
    launches = got["launches"]
    print(f"[predict] Model.predict_log_density(test, cg_tolerance "
          f"{PREDICT_CG_TOL:g}), streaming ({card}): CG solves (steps, "
          f"residual error, preconditioner) {got['solves']}: ended by the "
          f"{precond} one, {steps} steps, residual {residual:.3e}; "
          f"launches {launches}; {got['seconds']:.3f} s, peak "
          f"{got['peak'] / 2**30:.2f} GiB; -mean(log density) {nlpd!r} "
          f"(TPU run's test/nlpd {REFERENCE['test/nlpd']}, metrics_fn at "
          f"1e-3 {anchor_nlpd!r})", flush=True)
    require(got["lpd"].shape == (N_TEST,)
            and bool(torch.isfinite(got["lpd"]).all()),
            "predict_log_density: not [S] finite values")
    require(residual <= PREDICT_CG_TOL,
            "predict_log_density: CG ended above its tolerance")
    require(launches["streaming_matvec"] > 0 and launches["kuf"] > 0,
            "predict_log_density: kernel 1 or 3 was not launched")
    require(launches["ls_grad"] == 0,
            "predict_log_density launched kernel 2: it is not gradient-free")
    require(abs(nlpd - REFERENCE["test/nlpd"]) <= PREDICT_TOL["nlpd"],
            "predict_log_density: test nlpd off the TPU run's")
    require(abs(nlpd - anchor_nlpd) <= PREDICT_TOL["nlpd"],
            "predict_log_density: test nlpd off metrics_fn's")

    # the dense plain path: K(X, X) + sigma^2 I materialized in fp64
    _, dense, _ = anchor_model("dense", model.params)
    dgot = _predict_log_density(dense, bundle)
    dense_nlpd = -float(dgot["lpd"].mean())
    gap = abs(nlpd - dense_nlpd)
    worst = float((got["lpd"] - dgot["lpd"]).abs().max())
    print(f"[predict] dense operator (fp64 K {N}x{N}): CG solves "
          f"{dgot['solves']}; {dgot['seconds']:.3f} s, peak "
          f"{dgot['peak'] / 2**30:.2f} GiB; -mean(log density) "
          f"{dense_nlpd!r}: mean gap {gap:.3e} nats a point (bound "
          f"{PREDICT_TOL['dense_nats']:g}), largest pointwise {worst:.3e}",
          flush=True)
    require(dgot["solves"][-1][1] <= PREDICT_CG_TOL,
            "dense predict_log_density: CG ended above its tolerance")
    require(gap <= PREDICT_TOL["dense_nats"],
            "predict_log_density: kernel path and dense path disagree")
    del dense, dgot
    torch.cuda.empty_cache()

    # full covariance at every test row, SGPR then CGLB on kernels 1 and 3
    p, (X, Y) = model.params, model.data
    Xs = torch.as_tensor(bundle.test[0], device=X.device)
    with torch.no_grad():
        kvar = float(p.kernel.variance.value)
        sigma_sq = p.noise_variance.value
        _, marginal = _sgpr.predict_f(p, X, Y, Xs)
    sg = _full_cov(lambda: _sgpr.predict_f(p, X, Y, Xs, full_cov=True))
    print(f"[predict] sgpr.predict_f(full_cov=True) {N_TEST} rows ({card}):"
          f" {sg['seconds']:.3f} s, peak {sg['peak'] / 2**30:.2f} GiB",
          flush=True)
    sgpr_checks = _check_cov("sgpr", sg["var"], marginal[:, 0], kvar,
                             sigma_sq)
    operator = _mv.make_streaming_operator(p.kernel, X, sigma_sq)

    def cglb_predict(full_cov: bool):
        return _cglb.predict_f(
            p, X, Y, _cglb.init_v0(N, 1, X.dtype, X.device), Xs,
            model.run_cfg, full_cov=full_cov, matvec=operator,
            cross_matvec=lambda v: _mv.kernel_cross_matvec(p.kernel, X, Xs,
                                                           v))

    cg = _full_cov(lambda: cglb_predict(True))
    with torch.no_grad():
        _, cglb_marginal = cglb_predict(False)
    gap_cov = float((cg["var"] - sg["var"]).abs().max()) / float(
        sg["var"].abs().max())
    print(f"[predict] cglb.predict_f(full_cov=True), streaming operator and "
          f"kernel_cross_matvec ({card}): {cg['seconds']:.3f} s, peak "
          f"{cg['peak'] / 2**30:.2f} GiB; against SGPR's covariance "
          f"{gap_cov:.3e} of its max (bound {PREDICT_TOL['cglb_vs_sgpr']:g})",
          flush=True)
    cglb_checks = _check_cov("cglb", cg["var"], cglb_marginal[:, 0], kvar,
                             sigma_sq)
    require(gap_cov <= PREDICT_TOL["cglb_vs_sgpr"],
            "cglb and sgpr covariances disagree")
    del sg["var"], cg["var"], marginal, cglb_marginal, operator
    torch.cuda.empty_cache()

    results["kuf_kss"] = _check_kss(Xs, p, card)
    cv = _check_conditional_variance(X, p.kernel)
    for name in _counters():
        results[name]["launches_predict_run"] = launches[name]
    results["_predict"] = {
        "nlpd": nlpd, "dense_nlpd": dense_nlpd, "dense_gap": gap,
        "dense_pointwise_max": worst, "metrics_fn_nlpd": anchor_nlpd,
        "tpu_nlpd": REFERENCE["test/nlpd"], "cg_solves": got["solves"],
        "seconds": got["seconds"], "peak_bytes": got["peak"],
        "launches": launches,
        "full_cov": {"sgpr_s": sg["seconds"], "sgpr_peak": sg["peak"],
                     "cglb_s": cg["seconds"], "cglb_peak": cg["peak"],
                     "cglb_vs_sgpr": gap_cov, "sgpr": sgpr_checks,
                     "cglb": cglb_checks},
        "conditional_variance": cv,
        "phase_s": time.perf_counter() - t_phase}
    print(f"[predict] phase 18 took {results['_predict']['phase_s']:.1f} s "
          f"({card})", flush=True)


# phase 19: the widths of B at which the lower solve is timed; the solve's
# results against the builtin's (relative to max |builtin|)
SOLVE_WIDTHS = (N, N_TEST, 8192, 6144, 4096, 1024, 64)
SOLVE_TOL = 1e-10


def phase_solve(results: dict, card: str) -> None:
    from cglb_tpu_torch.models import sgpr as _sgpr
    from cglb_tpu_torch.ops import chol as _chol
    from cglb_tpu_torch.ops.kuf import kuf as _kuf

    model = _kin40k_model()
    params, (X, _) = model.params, model.data
    with torch.no_grad():
        L = _sgpr._kuu_chol(params, _sgpr._jitter(None))
        Kuf = _kuf(params.kernel, params.inducing_Z.value, X)
    block, width = _chol.SOLVE_BLOCK, _chol.SOLVE_MIN_WIDTH

    def builtin(Lx, B):
        return torch.linalg.solve_triangular(Lx, B, upper=False)

    def blocked(Lx, B):
        return _chol._BlockedLowerSolve.apply(Lx, B, block)

    rows = {}
    for k in SOLVE_WIDTHS:
        B = Kuf[:, :k].contiguous()
        G = torch.randn(k, M, dtype=B.dtype, device=B.device).T
        Lg, Bg = L.clone().requires_grad_(), B.clone().requires_grad_()

        def both(solve):
            return torch.autograd.grad(solve(Lg, Bg), (Lg, Bg), G)

        reps = max(3, min(30, N // k))
        with torch.no_grad():
            err = rel_err(blocked(L, B), builtin(L, B))[0]
        grads = both(blocked), both(builtin)
        gerr = max(rel_err(g, w)[0] for g, w in zip(*grads))
        before = _chol.solve_lower.blocked_calls
        with torch.no_grad():
            _chol.solve_lower(L, B)
        engaged = _chol.solve_lower.blocked_calls == before + 1
        row = {"ms": cuda_ms(lambda: blocked(L, B), reps),
               "library_ms": cuda_ms(lambda: builtin(L, B), reps),
               "with_backward_ms": cuda_ms(lambda: both(blocked), reps),
               "library_with_backward_ms": cuda_ms(lambda: both(builtin),
                                                   reps),
               "bound_ms": M * M * k / PEAK_FP64_TENSOR * 1e3,
               "rel_err": err, "grad_rel_err": gerr, "entry_blocked": engaged}
        rows[f"{M}x{k}"] = row
        share = 100 * row["bound_ms"] / row["ms"]
        print(f"[solve] L^-1 B, B [{M}, {k}], blocks of {block} rows: "
              f"{row['ms']:.4f} ms (library {row['library_ms']:.4f}), with "
              f"the backward {row['with_backward_ms']:.4f} ms (library "
              f"{row['library_with_backward_ms']:.4f}), bound "
              f"{row['bound_ms']:.4f} ms, {share:.1f} % of bound; against "
              f"the library {err:.3e}, gradients "
              f"{gerr:.3e}; the entry point "
              f"{'blocked' if engaged else 'builtin'} ({card})", flush=True)
        require(err <= SOLVE_TOL and gerr <= SOLVE_TOL,
                f"blocked solve against the builtin at [{M}, {k}]")
        require(engaged == (k >= width),
                f"solve_lower at [{M}, {k}]: blocked from {width} columns")
        del B, G, Lg, Bg, grads
        torch.cuda.empty_cache()
    del L, Kuf
    torch.cuda.empty_cache()

    # the counters on the main paths: an Adam step (A forward and its
    # backward) and prediction requests (A, and from ``width`` columns on
    # the two solves of the projections)
    from cglb_tpu_torch.experiments.datasets import get_dataset
    from cglb_tpu_torch.utils.training import adam_minimize

    def counted(fn):
        before = (_chol.solve_lower.blocked_calls,
                  _chol.solve_lower.blocked_backward_calls)
        fn()
        torch.cuda.synchronize()
        return (_chol.solve_lower.blocked_calls - before[0],
                _chol.solve_lower.blocked_backward_calls - before[1])

    state = model.carry_in()

    def step():
        nonlocal state
        state = adam_minimize(model.loss_fn(), params, state, 1, 0.01).state

    per_step = [counted(step) for _ in range(3)]
    Xs, Ys = get_dataset("Wilson_kin40k", split=0).test
    per_request = {s: counted(lambda s=s: model.predict_log_density(
        (Xs[:s], Ys[:s]))) for s in (64, 4096, 8192, N_TEST)}
    print(f"[solve] blocked solves (forward, backward): per Adam step "
          f"{per_step}; per prediction request by rows {per_request} "
          f"({card})", flush=True)
    require(all(c == (1, 1) for c in per_step),
            "an Adam step: not one blocked solve forward and one backward")
    require(all(c == (1 + 2 * (s >= width), 0)
                for s, c in per_request.items()),
            "a prediction request: not A's blocked solve plus the two "
            "projection solves from the engaging width on")
    results["_solve"] = {"block": block, "min_width": width, "rows": rows,
                         "per_step": per_step,
                         "per_request": {str(s): c for s, c in
                                         per_request.items()}}
    del model, params, X
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# --compare: kernel and step times of source trees, in turns
# --------------------------------------------------------------------------

_RESULT = "RESULT "


def times_of_tree(tree: Path) -> int:
    """Print the kernel rows' times and the warm steps of the package in
    ``tree`` as one RESULT line (this process only)."""
    sys.path.insert(0, str(tree))
    import cglb_tpu_torch
    from cglb_tpu_torch.models import sgpr as _sgpr
    from cglb_tpu_torch.ops import kuf as _kuf

    require(Path(cglb_tpu_torch.__file__).resolve().is_relative_to(tree),
            f"no cglb_tpu_torch package in {tree}")
    out = {"tree": str(tree)}
    for name, (fn, _, _) in kernel_rows("mat32", kernel_inputs()).items():
        out[f"{name} ms"] = cuda_ms(fn, 10)
    torch.cuda.empty_cache()
    for d in WIDE_DS:  # phase 15's rows: the wide kernels
        inputs = wide_inputs(d)
        for name, (fn, bnd) in wide_rows(d, "mat32", inputs).items():
            out[f"D {d} {name} ms"] = cuda_ms(fn, 3)
            out[f"D {d} {name} bound ms"] = bnd[0]
        del inputs
        torch.cuda.empty_cache()
    # kernel 3 at the registry widths and at phase 12's houseelectric chunk
    for m, n, d in [(M, N, d) for d in KUF_DS] + [
            (HOUSE_M, _sgpr.chunk_width(HOUSE_N, HOUSE_M), HOUSE_D)]:
        zg, xg, var = kuf_inputs(m, n, d, "mat32")
        name = f"kernel 3 {m}x{n} D {d}"
        out[f"{name} ms"] = cuda_ms(
            lambda: _kuf.launch_kuf(zg, xg, var, "mat32"), 10)
        out[f"{name} bound ms"] = kuf_bound(m, n, d)[0]
        del zg, xg
        torch.cuda.empty_cache()
    for d in MID_DS:
        for name, (fn, bnd) in mid_rows(d).items():
            out[f"D {d} {name} ms"] = cuda_ms(fn, 3)
            out[f"D {d} {name} bound ms"] = bnd[0]
        torch.cuda.empty_cache()
    # unprofiled: an older tree may lack the profiling module
    out.update(warm_steps(profile=False))
    print(_RESULT + json.dumps(out), flush=True)
    return 0


def mid_rows(d: int) -> dict:
    """{row: (launch, bound)} of kernels 1-2 at input dimension d on the
    MID_DS shapes, B 1, accurate tier (the mesh's operator runs no other):
    kernel 1's general and symmetric paths, kernel 2's general path.
    Bounds at the data's d.  Only entry points that every tree since PR 6
    has; each tree pads d by its own coord_plan."""
    from cglb_tpu_torch.ops import matvec as _mv

    dev = torch.device("cuda")
    rng = np.random.default_rng(d)
    X = torch.as_tensor(rng.normal(size=(RANK_ROWS, d)), device=dev)
    ls = torch.as_tensor(math.sqrt(d) * rng.uniform(0.5, 2.0, size=d),
                         device=dev)
    p = torch.as_tensor(rng.normal(size=(1, RANK_ROWS)), device=dev)
    g = torch.as_tensor(rng.normal(size=(1, RANK_COLS)), device=dev)
    rows = _mv.Prepared(X, ls, "mat32")
    cols = _mv.Prepared(X[RANK_COLS:2 * RANK_COLS], ls, "mat32")
    shape = f"{RANK_ROWS}x{RANK_COLS}"
    return {
        f"kernel 1 general {shape}": (
            lambda: _mv.launch_matvec(rows, cols, p, True),
            matvec_bound(RANK_ROWS, RANK_COLS, d, 1, True)),
        f"kernel 1 symmetric {RANK_ROWS}": (
            lambda: _mv.launch_matvec(rows, rows, p, True),
            matvec_bound(RANK_ROWS, RANK_ROWS, d, 1, True, True)),
        f"kernel 2 general {shape}": (
            lambda: _mv.launch_ls_grad(rows, cols, p, g),
            ls_grad_bound(RANK_ROWS, RANK_COLS, d, 1)),
    }


def compare(trees, card: str) -> int:
    results: dict = {}
    for tree in trees:
        proc = subprocess.run(
            [sys.executable, __file__, "--times-of",
             str(Path(tree).resolve())],
            capture_output=True, text=True, timeout=1200)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith(_RESULT)]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            return 1
        res = json.loads(lines[-1][len(_RESULT):])
        print(f"[compare] {json.dumps(res)}", flush=True)
        results.setdefault(res.pop("tree"), []).append(res)
    OUT.mkdir(exist_ok=True)  # every run's rows (the printed medians are long)
    (OUT / "compare.json").write_text(json.dumps(
        {"card": card, "runs": results}, indent=1))
    print(f"[compare] medians over the runs of each tree ({card}):")
    for tree, runs in results.items():
        print(f"[compare] {tree}: " + ", ".join(
            f"{k} {statistics.median(r[k] for r in runs)!r}"
            for k in runs[0]), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", nargs="+", metavar="TREE",
                    help="time these source trees in turns instead")
    ap.add_argument("--times-of", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-rank", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--protocol-adam", action="store_true",
                    help="run the whole Adam protocol grid instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if args.times_of:
        return times_of_tree(args.times_of)
    sys.path.insert(0, str(ROOT))
    import cglb_tpu_torch  # noqa: F401  (fails without the repository)

    if args.mesh_rank:
        return mesh_rank(args.mesh_rank)
    card = nvidia_smi()
    print(f"[device] {card}", flush=True)
    if args.compare:
        return compare(args.compare, card)
    if args.protocol_adam:
        return protocol_adam(card)
    t0 = time.perf_counter()
    registers = phase_build()
    kernels: dict = {}
    phase_kernels(kernels)
    phase_kuf_widths(kernels, card)
    phase_main_path(kernels)
    steps = warm_steps()
    print(f"[main] warm Adam steps ({card}): {json.dumps(steps)}",
          flush=True)
    print(f"[main] device time a step (kernels, copies and fills; "
          f"torch.profiler) {steps['device ms per step, all']:.3f} ms "
          f"against {1e3 * steps['adam step s']:.3f} ms a step on the host "
          f"clock, {1e3 * steps['profiled step s']:.3f} ms profiled",
          flush=True)
    # the main path builds its common terms in one pass: one Kuf a step
    require(steps["launches per step, kuf"] == 1,
            "main path: the common terms were chunked")
    for name in _counters():
        kernels[name]["launches_per_step"] = steps[
            f"launches per step, {name}"]
    anchor = phase_anchor()
    phase_scipy4(kernels, card)
    phase_variants()
    phase_scipy_tol()
    phase_checkpoint()
    phase_wide_batches(kernels)
    phase_exactgp(kernels, card)
    phase_gpr_anchor(card)
    phase_optimizers()
    phase_slabs(kernels, card)
    phase_chunked(card)
    phase_houseelectric(kernels, card)
    phase_wide(kernels, card)
    phase_wide_cli(kernels, card)
    phase_sweep(card)
    phase_mesh(kernels, card)
    phase_predict(kernels, card, anchor["test/nlpd"])
    phase_solve(kernels, card)
    for name in _counters():  # over the six main paths
        kernels[name]["launches"] = (
            kernels[name]["launches_adam_cli"]
            + kernels[name]["launches_scipy4_run"]
            + kernels[name]["launches_exactgp_run"]
            + kernels[name]["launches_houseelectric_run"]
            + kernels[name]["launches_mesh_run"]
            + kernels[name]["launches_predict_run"])

    # kernel 3 is one kernel at every width: each of its rows (by D, and
    # on phase 18's K(Xs, Xs)) carries its launches over the main paths,
    # the D 40 CLI run's included
    kuf_rows = ["kuf"] + [f"kuf_d{d}" for d in sorted(
        (11,) + KUF_DS + WIDE_DS)] + ["kuf_kss"]
    kernels["kuf"].update(d=D, width=D, shape=[M, N])
    kuf_launches = (kernels["kuf"]["launches"]
                    + kernels["kuf_d40"]["launches_wide_run"])
    kuf_regs = "; ".join(registers.get(("kuf_tile_kernel", "family/type"),
                                       []))
    for name in kuf_rows:
        kernels[name].update(launches=kuf_launches, registers=kuf_regs)
    wide = "cglb_tpu_torch/csrc/matvec_wide.cuh"
    kuf = ("cglb_tpu_torch/csrc/kuf.cu", "cglb_tpu/ops/kuf_pallas.py:186")
    sources = {"streaming_matvec": ("cglb_tpu_torch/csrc/matvec_kernels.cuh",
                                    "cglb_tpu/ops/matvec_pallas.py:164"),
               "ls_grad": ("cglb_tpu_torch/csrc/matvec_kernels.cuh",
                           "cglb_tpu/ops/matvec_pallas.py:190"),
               "streaming_matvec_wide": (wide,
                                         "cglb_tpu/ops/matvec_pallas.py:164"),
               "ls_grad_wide": (wide, "cglb_tpu/ops/matvec_pallas.py:190"),
               **{name: kuf for name in kuf_rows}}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         **kernels[name]} for name, (src, rep) in sources.items()],
        "scipy4_run": kernels["_scipy4"], "exactgp_run": kernels["_exactgp"],
        "houseelectric_run": kernels["_houseelectric"],
        "wide_run": kernels["_wide"], "mesh_run": kernels["_mesh"],
        "predict_run": kernels["_predict"], "solve": kernels["_solve"]}
    print(f"[done] every phase passed in {time.perf_counter() - t0:.1f} s "
          f"({card})", flush=True)
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
