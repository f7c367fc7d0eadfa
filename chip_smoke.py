#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cglb_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                        # the smoke run below
    python3 chip_smoke.py --compare OLD . . OLD  # times of trees, in turns

Phases, each of which fails the run (non-zero exit) on error:

1. device and build: the card's name and power limit (nvidia-smi), then the
   CUDA kernels built from cglb_tpu_torch/csrc with nvcc, and the
   ``-Xptxas -v`` registers and spills of kernels 1 and 2;
2. each kernel against its plain PyTorch version at the main path's shapes
   (N = 26800, D = 8, M = 2048, B = 1, both kernel families; kernel 1 also
   at the prediction shapes 26800 x 13200 and 13200 x 26800): errors
   relative to max |plain|, bitwise-equal repeat launches, median times from
   CUDA events beside each kernel's bound (the larger of its operations over
   the card's peak rate and its bytes over the memory rate), and, for
   context, torch.mv over a materialized fp32 K;
3. the main path: the port's CLI trainer in-process,
   ``train -n 5 -d Wilson_kin40k -o adam_0.01 cglb -m cglb -k Matern32 -i cv
   -M 2048`` in fp64, its results.json checked and the kernels' launch
   counts over that run read; then warm Adam steps of the same model timed
   on the host clock and, under torch.profiler, their device time and
   kernel launches per step;
4. the anchor: the parameters of the TPU run runs/kin40k-2000-scipy4-r4
   loaded into the port on the same synthetic data; elbo and the upper bound
   must match that run's results.json, the CGLB bound at converged v must lie
   between them, and test rmse/nlpd must agree.

With ``--compare TREE ...`` no phase runs.  Each tree (a directory holding
a ``cglb_tpu_torch`` package, such as an older commit unpacked with ``git
archive``) is timed in a process of its own, which builds that tree's
kernels: the kernel rows of phase 2 (Matern32, without the plain versions)
and the warm Adam steps of phase 3.  The median of each row over the runs
of each tree is printed last, beside the card's name and power limit.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository beside it, the script exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

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
# H100 SXM data sheet, dense, at the 700 W limit: fp32 and fp64 outside the
# tensor cores, and HBM3
PEAK_FLOPS = {"fp32": 67e12, "fp64": 34e12}
PEAK_BYTES = 3.35e12
ANCHOR = ROOT / "runs" / "kin40k-2000-scipy4-r4"
CLI_ARGS = ["-t", "fp64", "-s", "0", "train", "-n", "5", "-d",
            "Wilson_kin40k", "-o", "adam_0.01", "cglb", "-m", "cglb", "-k",
            "Matern32", "-i", "cv", "-M", str(M)]


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


def bound(flops: float, dtype: str, nbytes: float):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the operations over the peak rate of their type and the bytes (each
    input read once, each output written once) over the memory rate."""
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


def matvec_bound(ni: int, nj: int, d: int, b: int, accurate: bool,
                 symmetric: bool = False):
    """Kernel 1 per pair: d subtractions and d FMAs for t (3d flops), about
    4 for the profile, one FMA per batch row (2b); fp32.  Symmetric (one
    point set): n(n+1)/2 pairs, each feeding both sides (4b).  Bytes: both
    coordinate sets and p in fp32, the output in fp64 or fp32."""
    flops = (ni * (ni + 1) // 2 * (3 * d + 4 + 4 * b) if symmetric
             else ni * nj * (3 * d + 4 + 2 * b))
    return bound(flops, "fp32",
                 (ni + nj) * d * 4 + b * ni * 4 + b * nj * (8 if accurate
                                                             else 4))


def ls_grad_bound(ni: int, nj: int, d: int, b: int, symmetric: bool = False):
    """Kernel 2 per pair: d subtractions, d products df * df and d additions
    for t (3d), about 3 for rho', 2b + 1 for p.g and m (symmetric: n(n+1)/2
    pairs and 4b + 1), and one FMA per dimension for m * df^2 (2d); fp32.
    Bytes: coordinates, p, g."""
    flops = (ni * (ni + 1) // 2 * (5 * d + 3 + 4 * b + 1) if symmetric
             else ni * nj * (5 * d + 3 + 2 * b + 1))
    return bound(flops, "fp32",
                 (ni + nj) * d * 4 + b * (ni + nj) * 4 + d * 8)


def kuf_bound(m: int, n: int, d: int):
    """Kernel 3: writes Kuf and e in fp64 (16 bytes an entry) and reads Z
    and X; about 3d + 6 fp64 operations an entry."""
    return bound(m * n * (3 * d + 6), "fp64", (m + n) * d * 8 + m * n * 16)


def show(name: str, ms: float, bnd, extra: str = "") -> None:
    print(f"[kernels] {name}: {ms:.4f} ms, bound {bnd[0]:.4f} ms "
          f"({bnd[1]}), {100 * bnd[0] / ms:.1f} % of bound{extra}",
          flush=True)


# --------------------------------------------------------------------------
# phase 1
# --------------------------------------------------------------------------


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
# template arguments of the mangled names: <FAM, DP, B[, Acc], SYM>
_STREAMING = re.compile(r"(matvec_kernel|ls_grad_kernel)"
                        r"ILi(\d)ELi(\d+)ELi(\d)E([df]?)Lb(\d)E")
_FAMILY_NAME = {"0": "rbf", "1": "mat32"}


def register_report(log: str) -> dict:
    """{(kernel, tier): ["family/DP/B: R regs, spill S/L B", ...]} of
    kernels 1 and 2 from an ``-Xptxas -v`` log."""
    out: dict = {}
    name = None
    spill = ""
    for line in log.splitlines():
        entry = _ENTRY.search(line)
        if entry:
            name = _STREAMING.search(entry.group(1))
            continue
        if name is None:
            continue
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if found:
            spill = f"{found.group(1)}/{found.group(2)}"
        found = re.search(r"Used (\d+) registers", line)
        if found:
            kernel, fam, dp, b, acc, sym = name.groups()
            tier = {"d": "accurate", "f": "cg", "": "ls_grad"}[acc]
            tier += " symmetric" if sym == "1" else ""
            out.setdefault((kernel, tier), []).append(
                f"{_FAMILY_NAME[fam]}/{dp}/{b}: {found.group(1)} regs, "
                f"spill {spill or '0/0'} B")
            name, spill = None, ""
    return out


def print_registers(log: str) -> None:
    for (kernel, tier), rows in sorted(register_report(log).items()):
        print(f"[build] {kernel} {tier} (family/DP/B): " + "; ".join(rows),
              flush=True)


def phase_build() -> None:
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
    print_registers(log)


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
            e, _ = rel_err(got.reshape(ref.shape), ref)
            print(f"[kernels] {family} backward {name}: rel err {e:.3e} "
                  f"(bound {TOL['backward']:g})", flush=True)
            require(e <= TOL["backward"], f"{family} backward {name}")

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


# --------------------------------------------------------------------------
# phase 3
# --------------------------------------------------------------------------


def _counters():
    from cglb_tpu_torch.ops import kuf as _kuf
    from cglb_tpu_torch.ops import matvec as _mv

    return {"streaming_matvec": _mv.launch_matvec,
            "ls_grad": _mv.launch_ls_grad, "kuf": _kuf.launch_kuf}


def phase_main_path(results: dict) -> None:
    from cglb_tpu_torch.experiments import cli
    from cglb_tpu_torch.utils.serialization import load_json

    with tempfile.TemporaryDirectory() as logdir:
        counters = _counters()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        cli.main(["-l", logdir] + CLI_ARGS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        res = load_json(Path(logdir, "results.json"))
    print(f"[main] CLI run ({' '.join(CLI_ARGS)}): {wall:.2f} s wall, "
          f"launches {launches}", flush=True)
    metrics = {k: v for k, v in res.items() if isinstance(v, float)}
    print("[main] results.json: " + json.dumps(metrics), flush=True)
    require(all(math.isfinite(v) for v in metrics.values()),
            "non-finite metric in results.json")
    require(res["data"] == "synthetic", "kin40k stand-in expected")
    require(res["elbo"] <= res["titsias_upper_bound"], "elbo > upper")
    require(res["cg_lower_bound"] <= res["titsias_upper_bound"],
            "cg_lower_bound > upper")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the main path")
        results[name]["launches"] = count
    results["_cli_wall_s"] = wall


def warm_steps() -> dict:
    """Warm Adam steps of the main path's model (built as the CLI builds
    it, metrics excluded): the host-clock wall time of single steps that end
    in a synchronize (median of 5, after one), then over 3 more steps under
    torch.profiler the device time of all kernels and of kernels 1-3, and
    the launches of kernels 1-3, per step."""
    from cglb_tpu_torch import config as _config
    from cglb_tpu_torch.backend import Torch
    from cglb_tpu_torch.configs import (CGLBConfig, InducingVariableConfig,
                                        Matern32Config)
    from cglb_tpu_torch.experiments.datasets import get_dataset
    from cglb_tpu_torch.utils.training import adam_minimize

    _config.set_default_float("fp64")
    _config.set_default_jitter("fp64")
    model = Torch(device="cuda").create_model(
        CGLBConfig(Matern32Config(), InducingVariableConfig(M)),
        get_dataset("Wilson_kin40k", split=0).train, seed=0)
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
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    steps = 3
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    tags = {"streaming_matvec": "matvec_kernel", "ls_grad": "ls_grad_kernel",
            "kuf": "kuf_kernel"}
    device = dict.fromkeys(["all"] + list(tags), 0.0)
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        device["all"] += us
        for name, tag in tags.items():
            if tag in ev.key:
                device[name] += us
    for name, us in device.items():
        out[f"device ms per step, {name}"] = us / 1e3 / steps
    for name, fn in counters.items():
        out[f"launches per step, {name}"] = fn.launches / steps
    return out


# --------------------------------------------------------------------------
# phase 4
# --------------------------------------------------------------------------


def phase_anchor() -> None:
    from cglb_tpu_torch import config as _config
    from cglb_tpu_torch.backend import Model, Torch
    from cglb_tpu_torch.experiments.datasets import get_dataset
    from cglb_tpu_torch.models.cglb import CGLBConfig
    from cglb_tpu_torch.models.sgpr import SGPRParams
    from cglb_tpu_torch.ops.kernels import Matern32
    from cglb_tpu_torch.utils.serialization import load_json
    from cglb_tpu_torch.utils.training import from_jax_parameter_dict

    _config.set_default_float("fp64")
    _config.set_default_jitter("fp64")
    want = load_json(ANCHOR / "results.json")
    saved = load_json(ANCHOR / "model.json")
    bundle = get_dataset("Wilson_kin40k", split=0)
    require(bundle.synthetic and want["data"] == "synthetic",
            "anchor run and data must both be the synthetic stand-in")
    backend = Torch(device="cuda")
    dev = backend.device
    params = SGPRParams(Matern32(D, device=dev), saved[".inducing_Z"],
                        device=dev)
    from_jax_parameter_dict(params, saved)
    X, Y = (torch.as_tensor(a, device=dev) for a in bundle.train)
    model = Model("cglb", params, (X, Y), CGLBConfig(max_error=1e-3))
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


# --------------------------------------------------------------------------
# --compare: kernel and step times of source trees, in turns
# --------------------------------------------------------------------------

_RESULT = "RESULT "


def times_of_tree(tree: Path) -> int:
    """Print the kernel rows' times and the warm steps of the package in
    ``tree`` as one RESULT line (this process only)."""
    sys.path.insert(0, str(tree))
    import cglb_tpu_torch

    require(Path(cglb_tpu_torch.__file__).resolve().is_relative_to(tree),
            f"no cglb_tpu_torch package in {tree}")
    out = {"tree": str(tree)}
    for name, (fn, _, _) in kernel_rows("mat32", kernel_inputs()).items():
        out[f"{name} ms"] = cuda_ms(fn, 10)
    torch.cuda.empty_cache()
    out.update(warm_steps())
    print(_RESULT + json.dumps(out), flush=True)
    return 0


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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if args.times_of:
        return times_of_tree(args.times_of)
    sys.path.insert(0, str(ROOT))
    import cglb_tpu_torch  # noqa: F401  (fails without the repository)

    card = nvidia_smi()
    print(f"[device] {card}", flush=True)
    if args.compare:
        return compare(args.compare, card)
    phase_build()
    kernels: dict = {}
    phase_kernels(kernels)
    phase_main_path(kernels)
    steps = warm_steps()
    print(f"[main] warm Adam steps ({card}): {json.dumps(steps)}",
          flush=True)
    for name in _counters():
        kernels[name]["launches_per_step"] = steps[
            f"launches per step, {name}"]
    phase_anchor()

    sources = {"streaming_matvec": ("cglb_tpu_torch/csrc/matvec_kernels.cuh",
                                    "cglb_tpu/ops/matvec_pallas.py:164"),
               "ls_grad": ("cglb_tpu_torch/csrc/matvec_kernels.cuh",
                           "cglb_tpu/ops/matvec_pallas.py:190"),
               "kuf": ("cglb_tpu_torch/csrc/kuf.cu",
                       "cglb_tpu/ops/kuf_pallas.py:186")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         **kernels[name]} for name, (src, rep) in sources.items()]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
