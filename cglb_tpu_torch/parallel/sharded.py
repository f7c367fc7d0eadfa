"""Data-sharded CGLB over the ranks of a ``DataMesh``.

Counterpart of ``cglb_tpu/parallel/sharded.py`` on its fp64 route.  Layout
(``sharded.py:9-14`` there):

    X, Y          [N, D]   replicated on every rank (houseelectric's X is
                           120 MB); each rank reads its block of rows
    Kuf, A        [M, N]   sharded by columns: kernel 3 on the rank's block
                           (by column chunks inside the block), A A^T summed
                           over the ranks
    K(X,X)+s2I    [N, N]   sharded by columns: the dense block below
                           ``Model.STREAMING_THRESHOLD`` rows, else kernels
                           1-2 on the block (``parallel/streaming.py``)
    v, r, p       [B, N]   replicated: CG runs on every rank, its matvec and
                           preconditioner gather their blocks
    M x M                  replicated

The bound is ``models/cglb.bound`` itself with the mesh passed in; the
collectives and their backward rules are ``parallel/mesh.py``'s.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..models import cglb as _cglb
from ..models.cglb import CGLBAux, CGLBConfig
from ..ops.kernels import k_columns
from .mesh import DataMesh
from .streaming import make_sharded_streaming_operator

__all__ = ["shard_data", "make_sharded_operator", "sharded_operator",
           "sharded_cglb_loss", "sharded_train_step"]


def shard_data(mesh: DataMesh, X, Y) -> Tuple[torch.Tensor, torch.Tensor]:
    """X and Y whole on the rank's device.  The JAX package's name: no
    rows are split here, since what is sharded is the [M, N] and [N, N]
    work inside the loss, by columns."""
    return (torch.as_tensor(X, device=mesh.device),
            torch.as_tensor(Y, device=mesh.device))


def make_sharded_operator(mesh: DataMesh, kernel, X, sigma_sq) -> Callable:
    """Column-sharded dense operator: the rank's [N, N / R] block of
    K + sigma^2 I, formed once; p in and the result out replicated."""
    n = X.shape[0]
    c0, c1 = mesh.cols(n)
    block = k_columns(kernel, X, c0, c1,
                      mesh.enter(kernel.lengthscales.value),
                      mesh.enter(kernel.variance.value))
    eye = torch.zeros_like(block)
    eye[c0:c1].fill_diagonal_(1.0)
    block = block + mesh.enter(sigma_sq) * eye

    def matvec(p):
        return mesh.gather(mesh.enter(p) @ block, n, 1)

    return matvec


def sharded_operator(mesh: DataMesh, kernel, X, sigma_sq,
                     matvec: str) -> Callable:
    """The "dense" or "streaming" column-sharded operator."""
    if matvec == "streaming":
        return make_sharded_streaming_operator(mesh, kernel, X, sigma_sq)
    if matvec == "dense":
        return make_sharded_operator(mesh, kernel, X, sigma_sq)
    raise ValueError(f"unknown sharded matvec mode {matvec!r}")


def sharded_cglb_loss(params, X, Y, v0, cfg: CGLBConfig, mesh: DataMesh,
                      jitter: float = None, matvec: str = "dense",
                      max_error=None, chunk_size: int = None
                      ) -> Tuple[torch.Tensor, CGLBAux]:
    """The CGLB loss with everything [M, N] and K's columns sharded over
    the mesh; the same math and CG as ``models.cglb.loss``, whose value
    every rank returns.

    matvec: "dense" forms the rank's block of K; "streaming" runs kernels
    1-2 on it (K never stored).  max_error: the CG tolerance of this call
    (the levels of ``-o scipy_tol``); the sharded operator is always the
    accurate tier, so tight tolerances need no tier switch.  chunk_size:
    columns per chunk of the common terms inside the rank's block."""
    op = sharded_operator(mesh, params.kernel, X,
                          params.noise_variance.value, matvec)
    return _cglb.loss(params, X, Y, v0, cfg, jitter, matvec=op,
                      max_error=max_error, chunk_size=chunk_size, mesh=mesh)


def sharded_train_step(mesh: DataMesh, cfg: CGLBConfig,
                       optimizer: torch.optim.Optimizer,
                       matvec: str = "dense") -> Callable:
    """step(params, v0, X, Y) -> (aux, loss): the sharded loss, its
    gradient and one step of ``optimizer`` (built on the trainable raws of
    ``params``, e.g. ``torch.optim.Adam``), on every rank alike; aux.v is the
    next warm start."""

    def step(params, v0, X, Y):
        optimizer.zero_grad(set_to_none=True)
        loss, aux = sharded_cglb_loss(params, X, Y, v0, cfg, mesh,
                                      matvec=matvec)
        loss.backward()
        optimizer.step()
        return aux, loss.detach()

    return step
