"""Streaming kernel matvec: out = p @ K(X_rows, X_cols), K never stored.

Counterpart of ``cglb_tpu/ops/matvec_pallas.py``.  Two CUDA kernels
(``csrc/matvec_kernels.cuh``, entry points in ``csrc/matvec.cu``) do the
work on the card; above 32 input dimensions the wide kernels of
``csrc/matvec_wide.cuh`` do, streaming the coordinates through shared
memory in chunks (:func:`coord_plan`):

- kernel 1, :func:`launch_matvec`: out[b, j] = sum_i p[b, i] rho(t_ij), with
  t = gamma * d2 from coordinates prepared once per objective evaluation
  (x sqrt(gamma) / lengthscale, fp32).  Accurate tier: fp64 accumulation;
  CG tier: plain fp32.
- kernel 2, :func:`launch_ls_grad`: the lengthscale cotangent,
  sum_ij (sum_b p_bi g_bj) rho'(d2)_ij (xs_i - xs_j)_d^2, reduced in fp64.

A batch wider than ``MAX_BATCH`` rows (the instantiated widths) goes out in
groups of at most that many, one launch each: kernel 1's groups are
concatenated, kernel 2's partial cotangents added in fp64 in group order.
Each launch splits the rows into segments (:func:`plan_segments`, from the
card's SM count and the kernel's resident blocks per SM) and sums the
segments' partials in a fixed order (:func:`reduce_segments`), so that the
grid fills the card and the result is deterministic.  When the rows and
columns are the same :class:`Prepared` object (the training operator, its
gradient, the prediction CG) the kernels take each unordered pair once;
kernel 1 then launches its column blocks in slabs (:func:`plan_slabs`) so
that its per-block row sums stay within ``ROW_PARTIAL_BYTES`` at any N.

Beside each is its plain PyTorch version in the working dtype
(:func:`matvec_unit_plain`, :func:`ls_grad_unit_plain`).  The dispatchers
take the plain version only for tensors on the CPU; a CUDA tensor launches
the kernel, and a build or launch error raises.

Differentiability follows the ``custom_vjp`` of matvec_pallas.py:341-375
(``_StreamingMatvec``): forward var * out; dp = g K^T by the same kernel with
rows and columns swapped; dvar = <out, g> / var; dls from kernel 2.  The
scaled coordinates enter the Function detached, so the lengthscale gradient
is counted once, by kernel 2.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Callable, NamedTuple, Tuple

import torch

from . import _build
from .kernels import GAMMA

__all__ = ["Prepared", "kernel_matvec", "kernel_cross_matvec",
           "make_streaming_operator", "make_streaming_operator_pair",
           "matvec_unit", "matvec_unit_plain", "ls_grad_unit",
           "ls_grad_unit_plain", "launch_matvec", "launch_ls_grad",
           "CoordPlan", "coord_plan", "Geometry", "Slab", "plan_segments",
           "plan_slabs", "reduce_segments", "MAX_BATCH", "ROW_PARTIAL_BYTES",
           "WIDE_CHUNK"]

# rows of p one launch takes (the widest instantiation); wider batches are
# launched in groups
MAX_BATCH = 8
_FAMILY_CODE = {"rbf": 0, "mat32": 1}
# columns per plain-version chunk: bounds its [Ni, chunk] temporaries
_PLAIN_CHUNK = 4096
# row segments of one launch at most: bounds the partials (kernel 1 writes
# segments x B x Nc of them)
_MAX_SEGMENTS = 32
# bytes of kernel 1's fp32 row sums one symmetric launch may write (one
# float per column block and row): the column blocks go out in slabs that
# fit it, reduced one after another.  Every block fits one slab up to the
# kin40k shapes (26800 rows at B = 8: 180 MB), so those launches are
# unchanged; at houseelectric's 1,373,017 rows (D 11, DP 12) a slab takes
# at most 97 blocks at B = 1 where all 10,727 would take 58.9 GB.
ROW_PARTIAL_BYTES = 1 << 29
# coordinate widths of the narrow kernels 1-2 (csrc/matvec_kernels.cuh
# run_family): d pads to the first that holds it
NARROW_WIDTHS = (8, 12, 32)
# above 32 input dimensions the coordinates are padded to a multiple of
# this (the wide kernels' chunks, csrc/matvec_wide.cuh)
WIDE_CHUNK = 8


class CoordPlan(NamedTuple):
    """How the CUDA kernels 1-2 take d input dimensions: coordinates
    zero-padded to ``width`` columns; ``wide`` above 32, where the kernels
    stream the coordinates in chunks (kernels 1-2 on both paths, as below
    32)."""
    width: int
    wide: bool


def coord_plan(d: int) -> CoordPlan:
    """The first of the instantiated widths 8, 12 and 32 that holds d (D 11
    at 12, D 16 at 32); above 32 the next multiple of WIDE_CHUNK (D 40 at
    40, D 100 at 104), with no upper limit but kernel 2's shared memory (12
    bytes a coordinate: about 13000)."""
    if d < 1:
        raise ValueError(f"input dimension {d} < 1")
    for width in NARROW_WIDTHS:
        if d <= width:
            return CoordPlan(width, False)
    return CoordPlan(-(-d // WIDE_CHUNK) * WIDE_CHUNK, True)


def _bpad(b: int) -> int:
    """Batch width one launch is instantiated for."""
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"batch {b} outside 1..{MAX_BATCH} of one launch of "
                         "the streaming kernels")
    return 1 << (b - 1).bit_length()


def _groups(b: int):
    """Row ranges of at most MAX_BATCH rows covering a batch of b >= 1."""
    if b < 1:
        raise ValueError(f"batch {b} < 1 for the streaming kernels")
    return [(b0, min(b0 + MAX_BATCH, b)) for b0 in range(0, b, MAX_BATCH)]


class Prepared:
    """One point set's coordinates x sqrt(gamma) / lengthscale (detached,
    working dtype) and, for the CUDA kernels, their fp32 copy zero-padded
    to the width of :func:`coord_plan`.  Built once per objective
    evaluation."""

    def __init__(self, X: torch.Tensor, ls: torch.Tensor, family: str):
        self.family = family
        self.xg = (X * (math.sqrt(GAMMA[family]) / ls)).detach()
        self.plan = coord_plan(self.xg.shape[1])
        self._packed = None
        self._shifted = {}

    @property
    def n(self) -> int:
        return self.xg.shape[0]

    def packed(self) -> torch.Tensor:
        if self._packed is None:
            n, d = self.xg.shape
            out = torch.zeros(n, self.plan.width, dtype=torch.float32,
                              device=self.xg.device)
            out[:, :d] = self.xg
            self._packed = out
        return self._packed

    def block_shifted(self, block: int) -> torch.Tensor:
        """:meth:`packed` with each run of ``block`` points shifted by its
        first point (in fp32, as the kernel shifts the rows it pairs with
        them): the columns of the wide kernel 2's moment expansion, whose
        terms then stay the size of the distances however far the points
        lie from the origin."""
        if block not in self._shifted:
            x = self.packed()
            first = torch.arange(self.n, device=x.device) // block * block
            self._shifted[block] = x - x[first]
        return self._shifted[block]


# --------------------------------------------------------------------------
# plain versions (working dtype, any device)
# --------------------------------------------------------------------------


def _sq_dist_direct(xr: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """[Nr, Nc] sum_d (xr_id - xc_jd)^2 by direct differences."""
    t = torch.zeros(xr.shape[0], xc.shape[0], dtype=xr.dtype,
                    device=xr.device)
    for d in range(xr.shape[1]):
        diff = xr[:, d, None] - xc[None, :, d]
        t += diff * diff
    return t


def _rho(family: str, t: torch.Tensor) -> torch.Tensor:
    if family == "rbf":
        return torch.exp(-t)
    s = torch.sqrt(t)
    return (1.0 + s) * torch.exp(-s)


def _drho_dd2(family: str, t: torch.Tensor) -> torch.Tensor:
    if family == "rbf":
        return -0.5 * torch.exp(-t)
    return -1.5 * torch.exp(-torch.sqrt(t))


def matvec_unit_plain(xr, xc, p, family: str) -> torch.Tensor:
    """Plain version of kernel 1: p [B, Nr] @ rho(t(xr, xc)) [B, Nc], in
    p's dtype, chunked over columns."""
    xr, xc = xr.to(p.dtype), xc.to(p.dtype)
    outs = []
    for c0 in range(0, xc.shape[0], _PLAIN_CHUNK):
        t = _sq_dist_direct(xr, xc[c0:c0 + _PLAIN_CHUNK])
        outs.append(p @ _rho(family, t))
    return torch.cat(outs, dim=1)


def ls_grad_unit_plain(xr, xc, p, g, family: str) -> torch.Tensor:
    """Plain version of kernel 2: [D] sum_ij m_ij (xr_i - xc_j)_d^2 with
    m = (p^T g) * rho'(d2)(t), in p's dtype."""
    xr, xc, g = xr.to(p.dtype), xc.to(p.dtype), g.to(p.dtype)
    acc = torch.zeros(xr.shape[1], dtype=p.dtype, device=p.device)
    for c0 in range(0, xc.shape[0], _PLAIN_CHUNK):
        xcc = xc[c0:c0 + _PLAIN_CHUNK]
        m = (p.T @ g[:, c0:c0 + _PLAIN_CHUNK]) * _drho_dd2(
            family, _sq_dist_direct(xr, xcc))
        for d in range(xr.shape[1]):
            diff = xr[:, d, None] - xcc[None, :, d]
            acc[d] += torch.sum(m * diff * diff)
    return acc


# --------------------------------------------------------------------------
# launch geometry: the row range split into segments (pure Python)
# --------------------------------------------------------------------------


class Geometry(NamedTuple):
    """What a kernel instantiation launches with on one card."""
    block_cols: int  # output columns per block (32 lanes x columns a lane)
    stage_rows: int  # rows per staged tile; segments are whole tiles
    slots: int       # blocks resident at once: blocks per SM x SM count


@functools.lru_cache(maxsize=256)
def plan_segments(ni: int, nj: int, geo: Geometry,
                  symmetric: bool = False,
                  blocks: Tuple[int, int] = None) -> Tuple[int, int]:
    """(segments, seg_rows) for ni rows and nj columns: the grid is the
    column blocks ``blocks`` = [cb0, cb1) (default: all ceil(nj /
    block_cols) of them) by ``segments`` row segments of ``seg_rows`` rows
    (a multiple of stage_rows; the last may be shorter).

    Picks the split with the least estimated time, counted in staged tiles
    per slot: whole waves of the blocks that have rows (symmetric: column
    block c takes only the rows below the end of its columns), each its
    segment's tiles plus about one tile of fixed cost (pipeline fill, the
    block's reduction), at most ``_MAX_SEGMENTS`` segments, the fewest
    segments among equals."""
    cb0, cb1 = blocks or (0, -(-nj // geo.block_cols))
    tiles = -(-ni // geo.stage_rows)
    best = None
    for s in range(1, min(tiles, _MAX_SEGMENTS) + 1):
        per = -(-tiles // s)  # tiles per segment
        segments = -(-tiles // per)
        seg_rows = per * geo.stage_rows
        if symmetric:  # column block c has rows below min(ni, c1) only
            active = sum(-(-min(ni, (c + 1) * geo.block_cols) // seg_rows)
                         for c in range(cb0, cb1))
        else:
            active = (cb1 - cb0) * segments
        cost = -(-active // geo.slots) * (per + 1)
        if best is None or cost < best[0]:
            best = (cost, segments, seg_rows)
    return best[1], best[2]


class Slab(NamedTuple):
    """One launch of kernel 1's symmetric path: column blocks [cb0, cb1)
    against rows [0, row_end), row_end = min(n, cb1 * block_cols), the rows
    those blocks take; its row sums are [cb1 - cb0, B, row_end] fp32."""
    cb0: int
    cb1: int
    row_end: int
    segments: int
    seg_rows: int


def _slab_bytes(cb0: int, cb1: int, n: int, block_cols: int,
                bp: int) -> int:
    return (cb1 - cb0) * bp * min(n, cb1 * block_cols) * 4


@functools.lru_cache(maxsize=64)
def plan_slabs(n: int, geo: Geometry, bp: int,
               budget: int) -> Tuple[Slab, ...]:
    """Kernel 1's symmetric launches for n points at batch width bp: the
    column blocks in order, each slab the most that keeps its row sums
    within ``budget`` bytes (at least one block), with its row split."""
    blocks = -(-n // geo.block_cols)
    slabs, cb0 = [], 0
    while cb0 < blocks:
        lo, hi = cb0 + 1, blocks  # the largest cb1 within the budget
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if _slab_bytes(cb0, mid, n, geo.block_cols, bp) <= budget:
                lo = mid
            else:
                hi = mid - 1
        row_end = min(n, lo * geo.block_cols)
        slabs.append(Slab(cb0, lo, row_end, *plan_segments(
            row_end, n, geo, True, (cb0, lo))))
        cb0 = lo
    return tuple(slabs)


def reduce_segments(partials: torch.Tensor, dtype=None) -> torch.Tensor:
    """Sum [segments, ...] partials over the segments in a fixed order
    (a deterministic torch.sum, no atomics), in their dtype or ``dtype``."""
    if partials.shape[0] == 1 and dtype in (None, partials.dtype):
        return partials[0]
    return torch.sum(partials, dim=0, dtype=dtype)


# --------------------------------------------------------------------------
# CUDA launchers (kernels 1 and 2)
# --------------------------------------------------------------------------


_GEOMETRY: dict = {}


def _geometry(lib, family: str, dp: int, bp: int, accurate: bool,
              ls_grad: bool, symmetric: bool,
              device: torch.device) -> Geometry:
    """The instantiation's tile and occupancy (cglb_matvec_geometry) times
    the card's SM count; cached per library, instantiation and card."""
    key = (lib._handle, family, dp, bp, accurate, ls_grad, symmetric,
           device.index)
    if key not in _GEOMETRY:
        geo = (ctypes.c_int * 3)()
        with torch.cuda.device(device):
            _build.check(lib.cglb_matvec_geometry(
                _FAMILY_CODE[family], dp, bp, int(accurate), int(ls_grad),
                int(symmetric), geo), "cglb_matvec_geometry")
            sms = torch.cuda.get_device_properties(
                device).multi_processor_count
        if geo[2] < 1:
            raise RuntimeError("a streaming kernel cannot be resident on "
                               f"{torch.cuda.get_device_name(device)}")
        _GEOMETRY[key] = Geometry(geo[0], geo[1], geo[2] * sms)
    return _GEOMETRY[key]


def _same_device(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if t.data_ptr() % 16:
            raise ValueError("the streaming kernels need 16-byte aligned "
                             "tensors")


def _padded(a: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """a as a contiguous, 16-byte aligned fp32 [rows, cols], zero-padded."""
    a = a.to(torch.float32)
    if (a.shape == (rows, cols) and a.is_contiguous()
            and a.data_ptr() % 16 == 0):
        return a
    out = torch.zeros(rows, cols, dtype=torch.float32, device=a.device)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def launch_matvec(rows: Prepared, cols: Prepared, p: torch.Tensor,
                  accurate: bool) -> torch.Tensor:
    """Kernel 1 on the card: [B, Nc] in fp64 (accurate) or fp32 (CG), from
    per-segment partials summed by :func:`reduce_segments`.  When rows and
    cols are the same prepared set the symmetric path takes each pair once
    and adds the per-column-block row sums, at any width.  B > MAX_BATCH:
    one launch per group of rows, concatenated."""
    if p.ndim != 2 or p.shape[1] != rows.n:
        raise ValueError(f"p of shape {tuple(p.shape)} for {rows.n} rows")
    groups = _groups(p.shape[0])
    if len(groups) == 1:
        return _launch_matvec_group(rows, cols, p, accurate)
    return torch.cat([_launch_matvec_group(rows, cols, p[b0:b1], accurate)
                      for b0, b1 in groups], dim=0)


def _launch_matvec_group(rows: Prepared, cols: Prepared, p: torch.Tensor,
                         accurate: bool) -> torch.Tensor:
    xr, xc = rows.packed(), cols.packed()
    B = p.shape[0]
    bp = _bpad(B)
    ldp = -(-rows.n // 4) * 4
    pf = _padded(p, bp, ldp)
    _same_device(xr, xc, pf)
    lib = _build.load()
    dp = xr.shape[1]
    symmetric = rows is cols
    acc = torch.float64 if accurate else torch.float32
    geo = _geometry(lib, rows.family, dp, bp, accurate, False, symmetric,
                    p.device)

    def launch(cb0, row_end, ncols, segments, seg_rows, row_part):
        part = torch.empty(segments, bp, ncols, device=p.device, dtype=acc)
        rc = lib.cglb_matvec(
            xr.data_ptr(), rows.n, xc.data_ptr(), cols.n, pf.data_ptr(), ldp,
            bp, dp, _FAMILY_CODE[rows.family], int(accurate), seg_rows,
            segments, row_end, cb0, ncols, part.data_ptr(),
            None if row_part is None else row_part.data_ptr(),
            torch.cuda.current_stream(p.device).cuda_stream)
        _build.check(rc, "cglb_matvec")
        launch_matvec.launches += 1
        launch_matvec.accurate_launches += int(accurate)
        launch_matvec.launches_by_width[dp] += 1
        return part

    if not symmetric:
        segments, seg_rows = plan_segments(rows.n, cols.n, geo)
        return reduce_segments(launch(0, rows.n, cols.n, segments, seg_rows,
                                      None))[:B]
    # symmetric: slab by slab, each slab's column sums reduced into its
    # columns of out, then its row sums added to the rows it took, in slab
    # order (a slab's rows end where its columns end, so a later slab's
    # columns are untouched until it writes them)
    n, bc = rows.n, geo.block_cols
    slabs = plan_slabs(n, geo, bp, ROW_PARTIAL_BYTES)
    out = None
    for slab in slabs:
        j0, j1 = slab.cb0 * bc, min(n, slab.cb1 * bc)
        row_part = torch.empty(slab.cb1 - slab.cb0, bp, slab.row_end,
                               device=p.device, dtype=torch.float32)
        part = launch(slab.cb0, slab.row_end, j1 - j0, slab.segments,
                      slab.seg_rows, row_part)
        if len(slabs) == 1:  # its column sums are all of out
            out = reduce_segments(part)
        else:
            if out is None:
                out = torch.empty(bp, n, device=p.device, dtype=acc)
            torch.sum(part, dim=0, out=out[:, j0:j1])
        out[:, :slab.row_end] += reduce_segments(row_part, acc)
    return out[:B]


launch_matvec.launches = 0
launch_matvec.accurate_launches = 0  # those of the accurate tier among them
# launches by coordinate width (coord_plan: 12 for D 9-12, 32 for D 13-32)
launch_matvec.launches_by_width = collections.Counter()


def launch_ls_grad(rows: Prepared, cols: Prepared, p: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """Kernel 2 on the card: [D] fp64, summed over its per-block partials
    by a deterministic torch.sum (no atomics); symmetric (each pair once,
    m_ij + m_ji) when rows and cols are the same prepared set.  B >
    MAX_BATCH: one launch per group of rows, added in fp64 in group order."""
    if p.ndim != 2 or g.shape != (p.shape[0], cols.n) \
            or p.shape[1] != rows.n:
        raise ValueError(f"shapes p {tuple(p.shape)}, g {tuple(g.shape)}")
    acc = None
    for b0, b1 in _groups(p.shape[0]):
        part = _launch_ls_grad_group(rows, cols, p[b0:b1], g[b0:b1])
        acc = part if acc is None else acc + part
    return acc


def _launch_ls_grad_group(rows: Prepared, cols: Prepared, p: torch.Tensor,
                          g: torch.Tensor) -> torch.Tensor:
    xr, xc = rows.packed(), cols.packed()
    B = p.shape[0]
    symmetric = rows is cols
    bp = _bpad(B)
    ldp = -(-rows.n // 4) * 4
    ldg = ldp if symmetric else cols.n  # symmetric: g is staged like p
    pf, gf = _padded(p, bp, ldp), _padded(g, bp, ldg)
    _same_device(xr, xc, pf, gf)
    lib = _build.load()
    dp = xr.shape[1]
    geo = _geometry(lib, rows.family, dp, bp, True, True, symmetric,
                    p.device)
    segments, seg_rows = plan_segments(rows.n, cols.n, geo, symmetric)
    partial = torch.empty(segments * -(-cols.n // geo.block_cols), dp,
                          dtype=torch.float64, device=p.device)
    xs = cols.block_shifted(geo.block_cols) if cols.plan.wide else None
    if xs is not None:
        _same_device(xr, xs)
    rc = lib.cglb_ls_grad(
        xr.data_ptr(), rows.n, xc.data_ptr(), cols.n,
        None if xs is None else xs.data_ptr(), pf.data_ptr(), ldp,
        gf.data_ptr(), ldg, bp, dp, _FAMILY_CODE[rows.family],
        int(symmetric), seg_rows, segments, partial.data_ptr(),
        torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(rc, "cglb_ls_grad")
    launch_ls_grad.launches += 1
    launch_ls_grad.launches_by_width[dp] += 1
    return torch.sum(partial, dim=0)[:rows.xg.shape[1]]


launch_ls_grad.launches = 0
launch_ls_grad.launches_by_width = collections.Counter()  # as kernel 1's


# --------------------------------------------------------------------------
# dispatchers: the kernel for CUDA tensors, the plain version on the CPU
# --------------------------------------------------------------------------


def _on_cpu(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return False
    if t.device.type == "cpu":
        return True
    raise ValueError(f"unsupported device {t.device}")


def matvec_unit(rows: Prepared, cols: Prepared, p: torch.Tensor,
                accurate: bool = True) -> torch.Tensor:
    """Unit-variance p [B, Nr] @ rho(rows, cols) [B, Nc] in p's dtype."""
    if _on_cpu(p):
        return matvec_unit_plain(rows.xg, cols.xg, p, rows.family)
    return launch_matvec(rows, cols, p, accurate).to(p.dtype)


def ls_grad_unit(rows: Prepared, cols: Prepared, p: torch.Tensor,
                 g: torch.Tensor) -> torch.Tensor:
    """[D] sum_ij (sum_b p_bi g_bj) rho'(d2)_ij (xg_i - xg_j)_d^2."""
    if _on_cpu(p):
        return ls_grad_unit_plain(rows.xg, cols.xg, p, g, rows.family)
    return launch_ls_grad(rows, cols, p, g).to(p.dtype)


class _StreamingMatvec(torch.autograd.Function):
    """p [B, Nr] -> var * p @ rho(rows, cols) [B, Nc]; differentiable in p,
    var and ls (the preps are detached; dls comes from kernel 2)."""

    @staticmethod
    def forward(ctx, p, var, ls, rows: Prepared, cols: Prepared,
                accurate: bool):
        out = var * matvec_unit(rows, cols, p, accurate)
        ctx.save_for_backward(p, var, ls, out)
        ctx.rows, ctx.cols = rows, cols
        return out

    @staticmethod
    def backward(ctx, g):
        p, var, ls, out = ctx.saved_tensors
        rows, cols = ctx.rows, ctx.cols
        g = g.contiguous()
        dp = dvar = dls = None
        if ctx.needs_input_grad[0]:
            # dp = g K^T: swap the row and column spaces
            dp = var * matvec_unit(cols, rows, g, accurate=True)
        if ctx.needs_input_grad[1]:
            dvar = torch.sum(out * g) / var
        if ctx.needs_input_grad[2]:
            # d(d2)/d(ls_d) = -(2/ls_d)(xs_i - xs_j)_d^2 and the kernel sums
            # over gamma-scaled coordinates: (xg diff)^2 = gamma (xs diff)^2
            acc = ls_grad_unit(rows, cols, p, g)
            dls = acc * (-2.0 * var / (GAMMA[rows.family] * ls))
        return dp, dvar, dls, None, None, None


def _streaming(kernel, rows: Prepared, cols: Prepared, p, accurate=True):
    return _StreamingMatvec.apply(p, kernel.variance.value,
                                  kernel.lengthscales.value, rows, cols,
                                  accurate)


def kernel_matvec(kernel, X: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """p [B, N] -> p @ K(X, X) [B, N], streamed; differentiable in the
    kernel parameters and p."""
    prep = Prepared(X, kernel.lengthscales.value, kernel.family)
    return _streaming(kernel, prep, prep, p)


def kernel_cross_matvec(kernel, X_rows, X_cols, p) -> torch.Tensor:
    """p [B, Nr] -> p @ K(X_rows, X_cols) [B, Nc], streamed (rectangular:
    the prediction cross-covariance product)."""
    ls = kernel.lengthscales.value
    rows = Prepared(X_rows, ls, kernel.family)
    cols = Prepared(X_cols, ls, kernel.family)
    return _streaming(kernel, rows, cols, p)


def make_streaming_operator_pair(kernel, X, sigma_sq
                                 ) -> Tuple[Callable, Callable]:
    """(accurate_matvec, cg_matvec) for (K + sigma^2 I) sharing one prep.

    The accurate tier serves the bound assembly, prediction and gradients;
    the CG tier (fp32 accumulation) only the training CG loop, where any
    proposed v gives a valid bound because the assembly re-evaluates the
    residual with the accurate tier.  The diagonal sigma^2 p is added in the
    working dtype outside the kernel."""
    var = kernel.variance.value
    ls = kernel.lengthscales.value
    prep = Prepared(X, ls, kernel.family)

    def make(accurate: bool):
        def matvec(p):
            return (_StreamingMatvec.apply(p, var, ls, prep, prep, accurate)
                    + sigma_sq * p)

        return matvec

    return make(True), make(False)


def make_streaming_operator(kernel, X, sigma_sq) -> Callable:
    return make_streaming_operator_pair(kernel, X, sigma_sq)[0]
