"""A cell on several cards: the launcher that starts its ranks, and what the
ranks share while they run.

A cell whose ``chips`` is above 1 runs as that many processes of the same
command, one card a rank, meeting through the program's own launch contract
(``CGLB_COORDINATOR``, ``CGLB_NUM_PROCESSES``, ``CGLB_PROCESS_ID``; the
program's ``parallel/mesh.py`` forms the NCCL group from them).  The
command run without ``CGLB_PROCESS_ID`` is the launcher (:func:`launch`):

- rank 0's standard output comes to the launcher, which prints rank 0's
  result line once every rank has exited with 0 (and checks its own
  modules, as every rank does); the other ranks' standard output goes to
  standard error;
- a rank that exits non-zero, or ranks still running past the deadline,
  end the run: every rank is killed and waited for, the exit code is
  non-zero and no result is printed.  The deadline is ``SETUP_S`` for
  rank 0's window to open (the first run in a checkout builds the kernels)
  and ``2 --seconds + AFTER_S`` after it opened (the window, the traced
  slice and the reference, which is kept shorter than the window);
- a rank dies with the launcher (the parent-death signal), so a launcher
  ended from outside leaves no rank behind;
- ``setup_s`` runs from the launcher's start to rank 0's window opening,
  which rank 0 tells the launcher by the line ``OPENED`` on its standard
  output.

Inside a run (:class:`Ranks`), rank 0's clock decides when the window and
the traced slice close: before each step or request, rank 0's decision is
broadcast over a host-side (gloo) group, so no card's stream is
synchronized for it and every rank runs the same steps.
"""

from __future__ import annotations

import ctypes
import datetime
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["RANK_VAR", "OPENED", "SETUP_S", "AFTER_S", "Ranks", "launch"]

# the program's launch contract (cglb_tpu_torch/parallel/mesh.py)
RANK_VAR = "CGLB_PROCESS_ID"
WORLD_VAR = "CGLB_NUM_PROCESSES"
COORDINATOR_VAR = "CGLB_COORDINATOR"
# rank 0's line to the launcher when its window opens
OPENED = "perfbench: window opened"
# seconds for rank 0's window to open (a first run builds the kernels), and
# after it opened the seconds beyond twice the window
SETUP_S = 1080.0
AFTER_S = 240.0
# the host-side group's timeout: a rank waiting longer at a decision fails
HOST_TIMEOUT_S = 600.0
_PR_SET_PDEATHSIG = 1


class Ranks:
    """This process's rank among ``world`` ranks of a cell; ``connect``
    (once the program's group exists) opens the host-side group."""

    def __init__(self, rank: int, world: int):
        self.rank = rank
        self.world = world
        self.group = None

    @classmethod
    def from_env(cls) -> "Ranks":
        return cls(int(os.environ[RANK_VAR]), int(os.environ[WORLD_VAR]))

    def connect(self) -> None:
        self.group = dist.new_group(
            backend="gloo",
            timeout=datetime.timedelta(seconds=HOST_TIMEOUT_S))

    def agree(self, value: int) -> int:
        """Rank 0's ``value``, on every rank."""
        t = torch.tensor([int(value)], dtype=torch.int64)
        dist.broadcast(t, 0, group=self.group)
        return int(t)

    def opened(self) -> None:
        """Every rank is ready (the cards idle): the window opens; rank 0
        tells the launcher."""
        dist.barrier(group=self.group)
        if self.rank == 0:
            print(OPENED, flush=True)

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def close(self) -> None:
        """Leave the host-side group and the ranks' group."""
        dist.destroy_process_group(self.group)
        dist.destroy_process_group()

    def gather(self, obj: Any) -> Optional[List[Any]]:
        """Every rank's ``obj``, in rank order, on rank 0 (None elsewhere)."""
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.group)
        return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _die_with_parent() -> None:
    """In the child before exec: SIGKILL when the launcher's thread ends."""
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl(_PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)


def _stop(procs: Sequence[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def launch(cmd: Sequence[str], world: int, seconds: float, started: float,
           report: Callable[[Dict], int], setup_s: float = SETUP_S,
           after_s: float = AFTER_S) -> int:
    """Run ``cmd`` as ``world`` ranks; once every rank has exited with 0,
    hand rank 0's result, its ``setup_s`` counted from ``started`` (the
    host clock at the launcher's start), to ``report``, which prints it and
    gives the exit code.  Otherwise the first failing rank's code, or 124
    past the deadline."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("CGLB_DIST", "TORCHELASTIC_RUN_ID")}
    env[COORDINATOR_VAR] = f"localhost:{_free_port()}"
    env[WORLD_VAR] = str(world)
    procs: List[subprocess.Popen] = []
    lines: List[str] = []
    opened: List[float] = []

    def read(stream):
        for line in stream:
            line = line.rstrip("\n")
            if line == OPENED and not opened:
                opened.append(time.perf_counter())
            else:
                lines.append(line)

    reader = None
    try:
        for rank in range(world):
            procs.append(subprocess.Popen(
                list(cmd), env={**env, RANK_VAR: str(rank)},
                stdout=subprocess.PIPE if rank == 0 else 2,
                text=True, preexec_fn=_die_with_parent))
        reader = threading.Thread(target=read, args=(procs[0].stdout,),
                                  daemon=True)
        reader.start()
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                print(f"rank {bad[0][0]} exited with code {bad[0][1]}: "
                      "every rank ended, no result", file=sys.stderr)
                return bad[0][1] if bad[0][1] > 0 else 1
            if all(c == 0 for c in codes):
                break
            now = time.perf_counter()
            late = (now - started > setup_s if not opened
                    else now - opened[0] > 2 * seconds + after_s)
            if late:
                print(f"ranks still running {now - started:.1f} s after the "
                      "start: every rank ended, no result", file=sys.stderr)
                return 124
            time.sleep(0.05)
    finally:
        _stop(procs)
        if reader is not None:
            reader.join(timeout=10)
        if procs:
            procs[0].stdout.close()
    if not lines or not opened:
        print("rank 0 printed no result", file=sys.stderr)
        return 1
    for line in lines[:-1]:
        print(line, file=sys.stderr)
    result = json.loads(lines[-1])
    if "setup_s" in result["metrics"]:
        result["metrics"]["setup_s"]["value"] = opened[0] - started
    print(f"set-up {opened[0] - started:.3f} s from the launcher's start",
          file=sys.stderr)
    return report(result)
