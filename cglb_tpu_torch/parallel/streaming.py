"""Column-sharded streaming operator: kernel 1 (and kernel 2 in the backward)
on each rank's block of K(X, X).

Counterpart of ``cglb_tpu/parallel/streaming.py``.  The columns of K(X, X)
are split over the ranks (``DataMesh.cols``); each rank runs kernel 1 on its
block against every row,

    out[:, cols_r] = p @ K(X_all, X_cols_r)      (K never stored)

and the blocks are all-gathered, so p and the result are replicated.  That
is kernel 1's general path (rows and columns are different prepared sets):
each rank does N * N / R pairs, where one card's symmetric path does
N^2 / 2, so two ranks do no less kernel-1 work each than one card (the JAX
package has the same shape, ``streaming.py:5-10``).  The accurate tier
only, as the JAX package's sharded operator always contracts at HIGHEST
(``sharded.py:148-150``).  The coordinates are prepared once per operator.

Gradients (``ops/matvec._StreamingMatvec``): dp = g K^T from kernel 1 with
rows and columns swapped, dvar from the block's output, dls from kernel 2
on the block; p, var and ls enter the shard through ``DataMesh.enter``, so
each cotangent is all-reduced, and the gather's backward hands each rank the
cotangent of its columns.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.matvec import Prepared, _StreamingMatvec, kernel_cross_matvec
from .mesh import DataMesh

__all__ = ["make_sharded_streaming_operator", "sharded_cross_matvec"]


def make_sharded_streaming_operator(mesh: DataMesh, kernel, X, sigma_sq
                                    ) -> Callable:
    """p [B, N] -> p (K + sigma^2 I) [B, N], K's columns sharded over the
    mesh; differentiable in p and the kernel parameters."""
    var = kernel.variance.value
    ls = kernel.lengthscales.value
    n = X.shape[0]
    c0, c1 = mesh.cols(n)
    rows = Prepared(X, ls, kernel.family)
    cols = Prepared(X[c0:c1], ls, kernel.family)

    def matvec(p):
        out = _StreamingMatvec.apply(mesh.enter(p), mesh.enter(var),
                                     mesh.enter(ls), rows, cols, True)
        return mesh.gather(out, n, 1) + sigma_sq * p

    return matvec


@torch.no_grad()
def sharded_cross_matvec(mesh: DataMesh, kernel, X, Xnew, v) -> torch.Tensor:
    """v [B, N] -> v K(X, Xnew) [B, S] for prediction: kernel 1 on the
    rank's rows of X, summed over the ranks."""
    c0, c1 = mesh.cols(X.shape[0])
    return mesh.reduce(kernel_cross_matvec(kernel, X[c0:c1], Xnew,
                                           v[:, c0:c1].contiguous()))
