#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cglb_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on error:

1. device and build: the card's name and power limit (nvidia-smi), then the
   CUDA kernels built from cglb_tpu_torch/csrc with nvcc;
2. each kernel against its plain PyTorch version at the main path's shapes
   (N = 26800, D = 8, M = 2048, B = 1, both kernel families): errors
   relative to max |plain| and median times from CUDA events;
3. the main path: the port's CLI trainer in-process,
   ``train -n 5 -d Wilson_kin40k -o adam_0.01 cglb -m cglb -k Matern32 -i cv
   -M 2048`` in fp64, its results.json checked, the kernels' launch counts
   over that run read, and the training step timed;
4. the anchor: the parameters of the TPU run runs/kin40k-2000-scipy4-r4
   loaded into the port on the same synthetic data; elbo and the upper bound
   must match that run's results.json, the CGLB bound at converged v must lie
   between them, and test rmse/nlpd must agree.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository beside it, the script exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import math
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
    """Median milliseconds of ``fn`` over ``reps`` runs (CUDA events),
    after one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got: torch.Tensor, want: torch.Tensor):
    """(max |got - want| / max |want|, max |got - want|)."""
    diff = float(torch.max(torch.abs(got.double() - want.double())))
    return diff / float(torch.max(torch.abs(want))), diff


# --------------------------------------------------------------------------
# phase 1
# --------------------------------------------------------------------------


def phase_build() -> None:
    from cglb_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    torch.cuda.synchronize()
    log = _build.LOG_PATH.read_text() if _build.LOG_PATH.exists() else ""
    regs = [line.split("ptxas info    : ")[-1] for line in log.splitlines()
            if "registers" in line]
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke_build.log").write_text(log)
    print(f"[build] kernels loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds():.2f} s); {len(regs)} kernel "
          f"instantiations, register report in chiprun_out/"
          "chip_smoke_build.log", flush=True)


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


def phase_kernels(results: dict) -> None:
    from cglb_tpu_torch.ops import kuf as _kuf
    from cglb_tpu_torch.ops import matvec as _mv

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.normal(size=(N, D)), device=dev)
    Xc = torch.as_tensor(rng.normal(size=(N_TEST, D)), device=dev)
    Z = torch.as_tensor(rng.normal(size=(M, D)), device=dev)
    p = torch.as_tensor(rng.normal(size=(1, N)), device=dev)
    g = torch.as_tensor(rng.normal(size=(1, N)), device=dev)
    ls = torch.as_tensor(rng.uniform(0.5, 2.0, size=D), device=dev)
    var = torch.as_tensor(1.7, dtype=torch.float64, device=dev)

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
        cross = _mv.launch_matvec(rows, cols, p, True)
        x_err, _ = rel_err(cross, _mv.matvec_unit_plain(rows.xg, cols.xg, p,
                                                        family))
        print(f"[kernels] {family} cross matvec {N}x{N_TEST}: rel err "
              f"{x_err:.3e} (bound {TOL['cross_matvec']:g})", flush=True)
        require(x_err <= TOL["cross_matvec"], f"{family} cross matvec")

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

        timings = {
            "streaming_matvec": (
                cuda_ms(lambda: _mv.launch_matvec(rows, rows, p, True), 10),
                cuda_ms(lambda: _mv.matvec_unit_plain(rows.xg, rows.xg, p,
                                                      family), 3)),
            "streaming_matvec_cg": (
                cuda_ms(lambda: _mv.launch_matvec(rows, rows, p, False), 10),
                None),
            "ls_grad": (
                cuda_ms(lambda: _mv.launch_ls_grad(rows, rows, p, g), 10),
                cuda_ms(lambda: _mv.ls_grad_unit_plain(rows.xg, rows.xg, p,
                                                       g, family), 3)),
            "kuf": (
                cuda_ms(lambda: _kuf.launch_kuf(zg, xg, var, family), 10),
                cuda_ms(lambda: _kuf.kuf_unit_plain(zg, xg, var, family),
                        3)),
        }
        for name, (ms, plain_ms) in timings.items():
            print(f"[kernels] {family} {name}: {ms:.4f} ms"
                  + ("" if plain_ms is None else
                     f" (plain {plain_ms:.4f} ms)"), flush=True)
        if family == "mat32":  # the main path's family
            results["streaming_matvec"] = dict(
                max_abs_err=abs_err, ms=timings["streaming_matvec"][0],
                plain_ms=timings["streaming_matvec"][1])
            results["ls_grad"] = dict(
                max_abs_err=ls_abs, ms=timings["ls_grad"][0],
                plain_ms=timings["ls_grad"][1])
            results["kuf"] = dict(
                max_abs_err=kuf_abs, ms=timings["kuf"][0],
                plain_ms=timings["kuf"][1])
        del rows, cols, plain, acc, cg, cross, kuf_k, e_k, kuf_p, e_p
        torch.cuda.empty_cache()


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


def time_training_step(steps: int = 3) -> list:
    """Wall seconds of single Adam steps of the main path (model built the
    same way as the CLI builds it, metrics excluded)."""
    from cglb_tpu_torch import config as _config
    from cglb_tpu_torch.backend import Torch
    from cglb_tpu_torch.configs import (CGLBConfig, InducingVariableConfig,
                                        Matern32Config)
    from cglb_tpu_torch.experiments.datasets import get_dataset
    from cglb_tpu_torch.utils.training import adam_minimize

    _config.set_default_float("fp64")
    _config.set_default_jitter("fp64")
    backend = Torch(device="cuda")
    bundle = get_dataset("Wilson_kin40k", split=0)
    model = backend.create_model(
        CGLBConfig(Matern32Config(), InducingVariableConfig(M)),
        bundle.train, seed=0)
    times = []
    state = model.carry_in()
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = adam_minimize(model.loss_fn(), model.params, state, 1, 0.01)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        state = res.state
    return times


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import cglb_tpu_torch  # noqa: F401  (fails without the repository)

    card = nvidia_smi()
    print(f"[device] {card}", flush=True)
    phase_build()
    kernels: dict = {}
    phase_kernels(kernels)
    phase_main_path(kernels)
    steps = time_training_step()
    print(f"[main] Adam step wall times (s): "
          f"{', '.join(f'{t:.3f}' for t in steps)}; median "
          f"{statistics.median(steps):.3f} s ({card})", flush=True)
    phase_anchor()

    sources = {"streaming_matvec": ("cglb_tpu_torch/csrc/matvec.cu",
                                    "cglb_tpu/ops/matvec_pallas.py:164"),
               "ls_grad": ("cglb_tpu_torch/csrc/matvec.cu",
                           "cglb_tpu/ops/matvec_pallas.py:190"),
               "kuf": ("cglb_tpu_torch/csrc/kuf.cu",
                       "cglb_tpu/ops/kuf_pallas.py:186")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": kernels[name]["launches"],
         "max_abs_err": kernels[name]["max_abs_err"],
         "ms": kernels[name]["ms"], "plain_ms": kernels[name]["plain_ms"]}
        for name, (src, rep) in sources.items()]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
