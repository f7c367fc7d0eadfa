"""The rank mesh over ``torch.distributed``: each rank's column block and the
collectives of the sharded CGLB loss.

Counterpart of ``cglb_tpu/parallel/mesh.py``.  The JAX package lays a 1-D
``jax.sharding.Mesh`` over its devices and XLA inserts the collectives; here
each rank is a process (one card, or the CPU) and the sharded functions call
the collectives themselves.  Layout (``cglb_tpu/parallel/sharded.py:9-14``):
everything [., N] is split by columns into contiguous blocks, rank r holding
[r c, min(N, (r + 1) c)) with c = ceil(N / R) (N need not divide); everything
M x M is replicated.

Every rank computes the same replicated loss, so the collectives carry the
backward rules of tensor-parallel training:

- :meth:`DataMesh.enter`: a replicated value entering a rank's shard;
  identity forward, all-reduce backward (each rank holds only its shard's
  part of the cotangent);
- :meth:`DataMesh.reduce`: a shard's partial sum leaves by an all-reduce;
  identity backward (the cotangent of a replicated value is replicated);
- :meth:`DataMesh.gather`: a shard's columns leave by an all-gather; the
  backward takes the rank's columns of the replicated cotangent;
- :meth:`DataMesh.shard`: the rank's columns of a replicated value; the
  backward all-gathers the cotangent.

The all-reduce is an all-gather of the partials summed in rank order: every
rank holds the same bits, in an order fixed from run to run.  So the CG stop
test, read on every rank from replicated values, takes the same branch
everywhere, and the parameters every rank steps stay bitwise equal.

Bootstrap (:func:`maybe_initialize_distributed`), the JAX package's
environment contract: ``CGLB_DIST=auto`` (or a launch by ``torchrun``) reads
the ``env://`` variables; ``CGLB_COORDINATOR=host:port`` with
``CGLB_NUM_PROCESSES`` and ``CGLB_PROCESS_ID`` meet over ``tcp://``;
otherwise nothing happens.  :func:`run_ranks` starts such ranks on one host.
The backend is NCCL on CUDA and gloo on the CPU; gloo on CUDA only where the
caller asks for it (ranks sharing a card, which NCCL refuses), and then
every collective goes through the host, since gloo has no all-gather of CUDA
tensors (:meth:`DataMesh.describe` says so).
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import time
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["DataMesh", "data_mesh", "maybe_initialize_distributed",
           "in_launched_rank", "plan_ranks", "resolve_backend", "run_ranks",
           "RankFailed", "free_port", "shutdown", "TIMEOUT_S"]

# a rank that never arrives, or a collective that never completes, fails the
# run after this many seconds instead of hanging it
TIMEOUT_S = 120.0


def _env_mode() -> Optional[str]:
    if (os.environ.get("CGLB_DIST", "").lower() == "auto"
            or "TORCHELASTIC_RUN_ID" in os.environ):
        return "env"
    if os.environ.get("CGLB_COORDINATOR"):
        return "tcp"
    return None


def in_launched_rank() -> bool:
    """True when the environment makes this process a rank of a group
    (torchrun, ``CGLB_DIST=auto`` or ``CGLB_COORDINATOR``)."""
    return _env_mode() is not None or dist.is_initialized()


def _env_ranks(mode: str) -> Tuple[int, int, int]:
    """(rank, world size, local rank) from the environment."""
    if mode == "env":
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        rank = int(os.environ["CGLB_PROCESS_ID"])
        world = int(os.environ["CGLB_NUM_PROCESSES"])
    return rank, world, int(os.environ.get("LOCAL_RANK", rank))


def resolve_backend(device, backend: Optional[str] = None) -> str:
    """NCCL for CUDA and gloo for the CPU unless ``backend`` asks for gloo
    (on CUDA: ranks that may share a card)."""
    dev = torch.device(device)
    if backend is None:
        return "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown distributed backend {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs CUDA devices")
    return backend


def _rank_device(device, backend: str, local_rank: int) -> torch.device:
    """The card of a rank: one of its own under NCCL (more ranks on a host
    than cards raise), shared round-robin under gloo."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.device("cpu")
    count = torch.cuda.device_count()
    if count < 1:
        raise RuntimeError("CUDA devices requested but none is visible")
    if backend == "nccl" and local_rank >= count:
        raise ValueError(
            f"local rank {local_rank} needs a card of its own under NCCL and "
            f"{count} are visible (ask for gloo to share cards)")
    return torch.device("cuda", local_rank % count)


def plan_ranks(size: int, device, backend: Optional[str] = None) -> int:
    """The number of ranks ``--mesh size`` starts on this host (-1: one a
    card).  Raises where NCCL would need more cards than are visible: ranks
    share a card only under an explicit gloo."""
    dev = torch.device(device)
    backend = resolve_backend(dev, backend)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if count < 1:
            raise RuntimeError("--mesh on CUDA, but no CUDA device is visible")
        size = count if size == -1 else size
        if backend == "nccl" and size > count:
            raise ValueError(
                f"--mesh {size} needs {size} cards under NCCL and {count} "
                "are visible (--dist-backend gloo lets ranks share cards)")
    elif size == -1:
        raise ValueError("--mesh -1 (one rank a card) needs CUDA; give the "
                         "number of CPU ranks")
    if size < 1:
        raise ValueError(f"--mesh {size}: at least one rank")
    return size


def maybe_initialize_distributed(device="cuda",
                                 backend: Optional[str] = None) -> bool:
    """Join the process group the environment describes; True when a group
    exists afterwards.  Idempotent.  ``device`` is the card unless the
    caller asks for the CPU.  A failing backend (NCCL included) raises."""
    if dist.is_initialized():
        return True
    mode = _env_mode()
    if mode is None:
        return False
    backend = resolve_backend(device, backend)
    rank, world, local = _env_ranks(mode)
    if backend == "nccl":  # bind the rank to its card before the group
        torch.cuda.set_device(_rank_device(device, backend, local))
    init = ("env://" if mode == "env"
            else f"tcp://{os.environ['CGLB_COORDINATOR']}")
    dist.init_process_group(
        backend, init_method=init, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def shutdown() -> None:
    """Leave the process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, n, dim):
        ctx.mesh, ctx.n, ctx.dim = mesh, n, dim
        return mesh.all_gather(x, n, dim)

    @staticmethod
    def backward(ctx, g):
        c0, c1 = ctx.mesh.cols(ctx.n)
        return g.narrow(ctx.dim, c0, c1 - c0), None, None, None


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.n, ctx.dim = mesh, x.shape[dim], dim
        c0, c1 = mesh.cols(x.shape[dim])
        return x.narrow(dim, c0, c1 - c0).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.n, ctx.dim), None, None


def _tracks(x) -> bool:
    return (isinstance(x, torch.Tensor) and x.requires_grad
            and torch.is_grad_enabled())


@dataclass(frozen=True)
class DataMesh:
    """One rank's view of a 1-D data mesh: its rank, the world size, its
    device, the backend and the process group (None: the default one)."""

    rank: int
    world: int
    device: torch.device
    backend: str
    group: Any = None

    @property
    def host_staged(self) -> bool:
        """gloo on CUDA tensors: every collective goes through the host."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def describe(self) -> str:
        via = (", collectives staged through the host (gloo has no CUDA "
               "all-gather)" if self.host_staged else "")
        return (f"rank {self.rank} of {self.world}, {self.backend} on "
                f"{self.device}{via}")

    # -- layout --

    def cols(self, n: int) -> Tuple[int, int]:
        """[c0, c1): this rank's block of n columns, ceil(n / R) wide (the
        last ranks' may be narrower).  Raises on every rank alike when some
        rank would hold none."""
        per = -(-n // self.world)
        if (self.world - 1) * per >= n:
            raise ValueError(f"{n} columns over {self.world} ranks leave a "
                             "rank without columns")
        c0 = self.rank * per
        return c0, min(n, c0 + per)

    # -- collectives on plain tensors (no autograd) --

    def _gathered(self, x: torch.Tensor):
        x = x.contiguous()
        if self.host_staged:
            x = x.cpu()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x, group=self.group)
        return parts

    def all_gather(self, x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
        """The ranks' blocks of ``x`` along ``dim`` joined into n."""
        per = -(-n // self.world)
        xm = x.movedim(dim, 0)
        if xm.shape[0] < per:
            pad = xm.new_zeros((per - xm.shape[0],) + tuple(xm.shape[1:]))
            xm = torch.cat([xm, pad])
        out = torch.cat(self._gathered(xm))[:n]
        return out.to(x.device).movedim(0, dim)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of ``x`` over the ranks, added in rank order."""
        parts = self._gathered(x.reshape(-1))
        out = parts[0]
        for part in parts[1:]:
            out = out + part
        return out.reshape(x.shape).to(x.device)

    def check_same(self, value: float, what: str) -> None:
        """Raise on every rank when ranks hold different ``value``s."""
        t = torch.tensor([float(value)], dtype=torch.float64,
                         device=self.device)
        seen = [float(p) for p in self._gathered(t)]
        if any(v != seen[0] for v in seen):
            raise RuntimeError(f"{what} differ across ranks: {seen}")

    def barrier(self) -> None:
        self.check_same(0.0, "barrier")

    # -- collectives with the backward rules of the module docstring --

    def enter(self, x):
        """A replicated value entering this rank's shard computation."""
        return _Enter.apply(x, self) if _tracks(x) else x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """A shard's partial sum, summed over the ranks."""
        return _Reduce.apply(x, self) if _tracks(x) else self.all_reduce(x)

    def gather(self, x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
        """A shard's block along ``dim``, joined over the ranks into n."""
        if _tracks(x):
            return _Gather.apply(x, self, n, dim)
        return self.all_gather(x, n, dim)

    def shard(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of a replicated value along ``dim``."""
        if _tracks(x):
            return _Shard.apply(x, self, dim)
        c0, c1 = self.cols(x.shape[dim])
        return x.narrow(dim, c0, c1 - c0)


def data_mesh(n: Optional[int] = None, device="cuda",
              backend: Optional[str] = None) -> DataMesh:
    """This rank's :class:`DataMesh` over the process group, joining the
    group the environment describes first.  ``n`` (None or -1: the group's
    size) must equal the group's size; ``device`` is the card unless the
    caller asks for the CPU."""
    maybe_initialize_distributed(device, backend)
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: launch the ranks under torchrun, or set "
            "CGLB_COORDINATOR, CGLB_NUM_PROCESSES and CGLB_PROCESS_ID (the "
            "CLI's --mesh starts them itself)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n not in (None, -1) and n != world:
        raise ValueError(f"a mesh of {n} ranks requested in a group of "
                         f"{world}")
    group_backend = str(dist.get_backend())
    resolve_backend(device, group_backend)
    local = int(os.environ.get("LOCAL_RANK", rank))
    return DataMesh(rank=rank, world=world,
                    device=_rank_device(device, group_backend, local),
                    backend=group_backend)


class RankFailed(RuntimeError):
    """A rank started by :func:`run_ranks` exited with a non-zero code."""

    def __init__(self, rank: int, returncode: int):
        super().__init__(f"rank {rank} exited with code {returncode}")
        self.rank = rank
        self.returncode = returncode


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(cmd: Sequence[str], world: int, env: dict = None,
              timeout_s: Optional[float] = None) -> None:
    """Run ``cmd`` as ``world`` ranks on this host, meeting over a free
    local TCP port (the ``CGLB_COORDINATOR`` contract), and wait for them.
    The first rank to exit non-zero raises :class:`RankFailed`; past
    ``timeout_s`` :class:`TimeoutError`.  Either way every rank still running
    is killed before this returns."""
    base = dict(os.environ if env is None else env)
    base.pop("CGLB_DIST", None)
    base["CGLB_COORDINATOR"] = f"localhost:{free_port()}"
    base["CGLB_NUM_PROCESSES"] = str(world)
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    procs = []
    try:
        for rank in range(world):
            procs.append(subprocess.Popen(
                list(cmd), env={**base, "CGLB_PROCESS_ID": str(rank)}))
        while True:
            codes = [p.poll() for p in procs]
            for rank, code in enumerate(codes):
                if code not in (None, 0):
                    raise RankFailed(rank, code)
            if all(code == 0 for code in codes):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout_s:g} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
