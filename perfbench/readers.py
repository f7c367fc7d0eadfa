"""What the per-layer metrics read, shared by their files in ``metrics/``.

Each reader takes the run's context (``harness.run_cell``): ``kind`` (the
mix's), ``config``, the untraced window (``units``, ``seconds``, ``rows``,
``calls`` and ``unit_calls`` from the launch recorder, ``counters``: the
program's launch counters over it) and the traced slice after it
(``slice_units``, ``slice_s``, ``slice_calls``, ``trace``: the device
trace).  On several ranks these are rank 0's, and ``chips`` (the number of
ranks), ``rank_calls`` and ``rank_counters`` (every rank's window launch
records and counters, in rank order) count the whole step; on one rank
``chips`` is 1 and the lists hold its own.  A reader that finds nothing to
read returns None.
"""

from __future__ import annotations

import re
from collections import Counter

from . import counts

__all__ = ["LINALG_KERNELS", "OUR_KERNELS", "cg_matvecs", "linalg_ms",
           "kernel_roofline", "idle_share", "mfu"]

# the library's dense linear algebra on the card: cuBLAS (gemm, trsm, syrk
# and their xmma / nvjet / cutlass kernels), cuSOLVER and MAGMA (potrf,
# trtri, ...)
LINALG_KERNELS = re.compile(
    r"gemm|gemv|trsm|trsv|syrk|herk|potrf|potrs|trtri|getrf|geqrf|syevd|"
    r"steqr|cublas|cusolver|xmma|nvjet|cutlass|magma", re.IGNORECASE)
# kernels 1-3 of the program (csrc/): matvec_kernel, matvec_wide_kernel,
# ls_grad_kernel, ls_grad_wide_kernel, kuf_tile_kernel
OUR_KERNELS = re.compile(r"(matvec|ls_grad|kuf)\w*_kernel")


def cg_matvecs(ctx, kind):
    """Kernel-1 launches per step or request over the window."""
    if ctx.kind != kind or not ctx.units:
        return None
    return ctx.counters["matvec"] / ctx.units


def linalg_ms(ctx, kind):
    """Device ms of the library's dense linear algebra per step or request
    in the traced slice."""
    if ctx.kind != kind or not ctx.slice_units or not ctx.trace.device:
        return None
    us = sum(d for name, _, d in ctx.trace.device
             if LINALG_KERNELS.search(name) and not OUR_KERNELS.search(name))
    return us / 1e3 / ctx.slice_units


def kernel_roofline(ctx, kind):
    """Kernels 1-3 in the traced slice: the sum of each call's bound time
    over the sum of their device time, in %."""
    if ctx.kind != kind or not ctx.slice_calls:
        return None
    bound_ms = sum(counts.call_bound_ms(c) for c in ctx.slice_calls)
    dev_ms = sum(d for name, _, d in ctx.trace.device
                 if OUR_KERNELS.search(name)) / 1e3
    return 100.0 * bound_ms / dev_ms if dev_ms > 0 else None


def idle_share(ctx, kind):
    """The share of the traced slice in which nothing ran on the card."""
    if ctx.kind != kind or ctx.slice_s <= 0 or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.slice_s)


def _per_unit(ctx, pick):
    """Calls that ``pick`` accepts, per step or request of the window."""
    n = Counter({u: 0 for u, _ in ctx.unit_calls})
    for unit, c in ctx.unit_calls:
        n[unit] += int(pick(c))
    return n


def mfu(ctx, kind):
    """The operations the window's steps or requests need (``counts``),
    over its host-clock time and 67 TFLOP/s, in %."""
    if ctx.kind != kind or not ctx.unit_calls or ctx.seconds <= 0:
        return None
    cfg = ctx.config
    flops = counts.kernel_flops(ctx.calls)
    if cfg["model"] == "cglb":
        n, m = cfg["n_train"], cfg["num_inducing"]
        if kind == "adam":
            # preconditioner applies: one a CG-tier matvec (the start's
            # and the iterations'), one more at the start, one in the bound
            cg_tier = _per_unit(ctx, lambda c: c.kind == "matvec"
                                and not c.accurate)
            flops += sum(counts.cglb_step_dense_flops(n, m, k + 2)
                         for k in cg_tier.values())
        else:
            # one apply a symmetric (CG) matvec; requests are numbered
            # from 0 in the window
            sym = _per_unit(ctx, lambda c: c.kind == "matvec"
                            and c.symmetric)
            flops += sum(counts.cglb_predict_dense_flops(
                n, m, len(rows), sym[i]) for i, rows in enumerate(ctx.rows))
    return 100.0 * flops / (ctx.seconds * counts.STEP_PEAK_FLOPS)
