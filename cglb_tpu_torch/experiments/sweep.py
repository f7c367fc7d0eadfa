"""Sweep runner of the port: expands TOML grid files into CLI runs.

The counterpart of ``cglb_tpu/experiments/sweep.py``, on argparse:

    python3 -m cglb_tpu_torch.experiments.sweep GRID.toml [-p N]
        [--dry-run] [--restart]

A grid file holds one ``[sweep]`` table or several ``[[sweep]]`` blocks;
each block's ``[sweep.grid]`` lists are crossed over its scalar keys, and a
``uid`` is built from the grid point (``dataset=Wilson_pol/M=2048/999``)
unless the block sets one:

    [sweep]
    cmd = "python3 -m cglb_tpu_torch.experiments.cli -b torch -t fp64 -l {logdir}/{dataset}/cglb-Matern32-fp64-M{M}/{seed} -s {seed} train -n {num_steps} -d {dataset} -o scipy cglb -m cglb -k Matern32 -i cv -M {M}"
    logdir = "./logdir"
    num_steps = 2000

    [sweep.grid]
    dataset = ["Wilson_kin40k", "Wilson_pol"]
    M = [1024, 2048]
    seed = [999, 888, 777]

Each point's command runs as a subprocess (no shell).  A leading ``python``
or ``python3`` is the running interpreter, or the point's ``python`` key,
which the command may also name as ``{python}``.  A point whose ``-l``
directory holds ``results.json`` is skipped (``--restart`` runs it again); one
whose directory holds ``checkpoint.json`` but no results was killed, and is
resumed (``--resume`` right after the ``train`` group token).

Lanes.  A point runs on the card unless its command says ``--device cpu``
or its block says ``platform = "cpu"``; nothing moves a point to the CPU on
its own, so without a card a card point fails (the CLI raises).  Card
points run at most one per card, pinned with ``CUDA_VISIBLE_DEVICES`` when
there are several; CPU points, which see no card, share the ``-p`` pool.
With ``-p`` above 1, one point of each group of points equal up to the seed
runs first and alone, so that the kernels are built once (into
``cglb_tpu_torch/_build``) before runs start together.

The exit code is the number of points that failed (at most 255).
"""

from __future__ import annotations

import argparse
import itertools
import os
import shlex
import subprocess
import sys
import threading
import tomllib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

__all__ = ["expand_grid", "run_sweep", "main", "detect_accelerators",
           "compile_group_key"]


def expand_grid(spec: Dict) -> List[Dict]:
    """Cross product of each block's [sweep.grid] lists merged over its
    scalar keys; the blocks' points are concatenated in order."""
    sweeps = spec.get("sweep", spec)
    if isinstance(sweeps, dict):
        sweeps = [sweeps]
    points = []
    for block in sweeps:
        sweep = dict(block)
        grid = sweep.pop("grid", {})
        keys = list(grid.keys())
        for combo in itertools.product(*(grid[k] for k in keys)):
            point = dict(sweep)
            point.update(dict(zip(keys, combo)))
            point.setdefault("uid", "/".join(
                f"{k}={v}" if k != "seed" else str(v)
                for k, v in zip(keys, combo)))
            points.append(point)
    return points


def _render(point: Dict) -> str:
    """The point's command: its template filled from the point, with a
    leading python / python3 as the point's interpreter."""
    python = str(point.get("python", sys.executable))
    values = {"python": python}
    values.update({k: v for k, v in point.items() if k != "cmd"})
    toks = shlex.split(point["cmd"].format(**values))
    if toks and toks[0] in ("python", "python3"):
        toks[0] = python
    return shlex.join(toks)


def detect_accelerators() -> Tuple[int, str]:
    """(number of cards, "gpu"), or (0, "cpu") without one."""
    import torch

    n = torch.cuda.device_count()
    return (n, "gpu") if n > 0 else (0, "cpu")


def compile_group_key(point: Dict) -> tuple:
    """Points sharing this key differ only by seed (and uid), so they run
    the same kernels at the same shapes."""
    return tuple((k, str(v)) for k, v in sorted(point.items())
                 if k not in ("seed", "uid"))


def _point_lane(point: Dict, cmd: str) -> str:
    """"cpu" where the block says platform = "cpu" or the command says
    --device cpu, else "gpu"."""
    if str(point.get("platform", "")).lower() == "cpu":
        return "cpu"
    toks = shlex.split(cmd)
    for a, b in zip(toks, toks[1:]):
        if a == "--device" and b == "cpu":
            return "cpu"
    return "cpu" if "--device=cpu" in toks else "gpu"


def _logdir(cmd: str) -> Optional[str]:
    toks = shlex.split(cmd)
    if "-l" in toks and toks.index("-l") + 1 < len(toks):
        return toks[toks.index("-l") + 1]
    return None


def _with_resume(cmd: str) -> str:
    """``--resume`` right after the ``train`` group token (not after an
    option value that happens to read "train", such as ``-d train``)."""
    toks = shlex.split(cmd)
    idx = next((i for i, t in enumerate(toks) if t == "train"
                and (i == 0 or not toks[i - 1].startswith("-"))), None)
    if idx is None or "--resume" in toks:
        return cmd
    toks.insert(idx + 1, "--resume")
    return shlex.join(toks)


def run_sweep(grid_file, num_proc: int = 1, dry_run: bool = False,
              restart: bool = False, runner=None,
              accel: Optional[Tuple[int, str]] = None) -> int:
    """Run the grid's points; the number of points that failed.
    ``runner(cmd, env, lane) -> returncode`` replaces the subprocess (tests),
    ``accel`` the detected (cards, platform)."""
    with open(grid_file, "rb") as f:
        points = expand_grid(tomllib.load(f))
    jobs = []  # (cmd, point)
    for point in points:
        cmd = _render(point)
        logdir = _logdir(cmd)
        if not restart and logdir is not None:
            if Path(logdir, "results.json").exists():
                print(f"[skip] {cmd}", flush=True)
                continue
            if Path(logdir, "checkpoint.json").exists():
                cmd = _with_resume(cmd)
                print(f"[resume] {cmd}", flush=True)
        jobs.append((cmd, point))
    if dry_run:
        for cmd, _ in jobs:
            print(cmd)
        return 0
    if not jobs:
        return 0

    if accel is None:
        accel = detect_accelerators()
    cards = max(accel[0], 0)
    # card lane: at most one run per card (two runs on one card would share
    # it and distort each other's times); each takes a free card's index
    card_sem = threading.Semaphore(max(cards, 1))
    slot_lock = threading.Lock()
    free_slots = list(range(max(cards, 1)))

    def _run(job) -> int:
        cmd, point = job
        lane = _point_lane(point, cmd)
        env = dict(os.environ)
        slot = None
        if lane == "cpu":
            env["CUDA_VISIBLE_DEVICES"] = ""
        else:
            card_sem.acquire()
            with slot_lock:
                slot = free_slots.pop()
            if cards > 1:
                env["CUDA_VISIBLE_DEVICES"] = str(slot)
        try:
            print(f"[run:{lane}] {cmd}", flush=True)
            if runner is not None:
                rc = runner(cmd, env, lane)
            else:
                rc = subprocess.run(shlex.split(cmd), env=env).returncode
            if rc != 0:
                print(f"[fail rc={rc}] {cmd}", file=sys.stderr, flush=True)
                return 1
            return 0
        finally:
            if slot is not None:
                with slot_lock:
                    free_slots.append(slot)
                card_sem.release()

    if num_proc <= 1:
        return sum(_run(job) for job in jobs)
    # one point of each group first and alone: the first run of the
    # package builds its kernels, and runs started together would each
    # build them
    seen, warm, rest = set(), [], []
    for job in jobs:
        key = compile_group_key(job[1])
        (rest if key in seen else warm).append(job)
        seen.add(key)
    failed = sum(_run(job) for job in warm)
    with ThreadPoolExecutor(max_workers=num_proc) as pool:
        failed += sum(pool.map(_run, rest))
    return failed


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="cglb_tpu_torch.experiments.sweep")
    ap.add_argument("grid_file")
    ap.add_argument("-p", "--num-proc", type=int, default=1)
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--restart", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="re-run grid points that already have results.json")
    args = ap.parse_args(argv)
    if not Path(args.grid_file).is_file():
        ap.error(f"no grid file {args.grid_file!r}")
    failed = run_sweep(args.grid_file, args.num_proc, args.dry_run,
                       args.restart)
    sys.exit(min(failed, 255))


if __name__ == "__main__":
    main()
