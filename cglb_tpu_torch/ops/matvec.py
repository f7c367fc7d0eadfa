"""Streaming kernel matvec: out = p @ K(X_rows, X_cols), K never stored.

Counterpart of ``cglb_tpu/ops/matvec_pallas.py``.  Two CUDA kernels
(``csrc/matvec.cu``) do the work on the card:

- kernel 1, :func:`launch_matvec`: out[b, j] = sum_i p[b, i] rho(t_ij), with
  t = gamma * d2 from coordinates prepared once per objective evaluation
  (x sqrt(gamma) / lengthscale, fp32).  Accurate tier: fp64 accumulation;
  CG tier: plain fp32.
- kernel 2, :func:`launch_ls_grad`: the lengthscale cotangent,
  sum_ij (sum_b p_bi g_bj) rho'(d2)_ij (xs_i - xs_j)_d^2, reduced in fp64.

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

import math
from typing import Callable, Tuple

import torch

from . import _build
from .kernels import GAMMA

__all__ = ["Prepared", "kernel_matvec", "kernel_cross_matvec",
           "make_streaming_operator", "make_streaming_operator_pair",
           "matvec_unit", "matvec_unit_plain", "ls_grad_unit",
           "ls_grad_unit_plain", "launch_matvec", "launch_ls_grad",
           "MAX_BATCH"]

MAX_BATCH = 8
_FAMILY_CODE = {"rbf": 0, "mat32": 1}
# columns per plain-version chunk: bounds its [Ni, chunk] temporaries
_PLAIN_CHUNK = 4096


def _dpad(d: int) -> int:
    """Coordinate width the CUDA kernels are instantiated for."""
    if d <= 8:
        return 8
    if d <= 32:
        return 32
    raise ValueError(f"input dimension {d} > 32 is not supported by the "
                     "streaming kernels")


def _bpad(b: int) -> int:
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"batch {b} outside 1..{MAX_BATCH} of the streaming "
                         "kernels")
    return 1 << (b - 1).bit_length()


class Prepared:
    """One point set's coordinates x sqrt(gamma) / lengthscale (detached,
    working dtype) and, for the CUDA kernels, their fp32 copy zero-padded
    to the instantiated width.  Built once per objective evaluation."""

    def __init__(self, X: torch.Tensor, ls: torch.Tensor, family: str):
        self.family = family
        self.xg = (X * (math.sqrt(GAMMA[family]) / ls)).detach()
        self._packed = None

    @property
    def n(self) -> int:
        return self.xg.shape[0]

    def packed(self) -> torch.Tensor:
        if self._packed is None:
            n, d = self.xg.shape
            out = torch.zeros(n, _dpad(d), dtype=torch.float32,
                              device=self.xg.device)
            out[:, :d] = self.xg
            self._packed = out
        return self._packed


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
# CUDA launchers (kernels 1 and 2)
# --------------------------------------------------------------------------


def _same_device(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")


def _padded_batch(a: torch.Tensor, b_pad: int) -> torch.Tensor:
    a = a.to(torch.float32)
    if a.shape[0] == b_pad:
        return a.contiguous()
    out = torch.zeros(b_pad, a.shape[1], dtype=torch.float32, device=a.device)
    out[:a.shape[0]] = a
    return out


def launch_matvec(rows: Prepared, cols: Prepared, p: torch.Tensor,
                  accurate: bool) -> torch.Tensor:
    """Kernel 1 on the card: [B, Nc] in fp64 (accurate) or fp32 (CG)."""
    xr, xc = rows.packed(), cols.packed()
    _same_device(xr, xc, p)
    if p.shape[1] != rows.n:
        raise ValueError(f"p has {p.shape[1]} columns, rows has {rows.n}")
    B = p.shape[0]
    bp = _bpad(B)
    pf = _padded_batch(p, bp)
    out = torch.empty(bp, cols.n, device=p.device,
                      dtype=torch.float64 if accurate else torch.float32)
    lib = _build.load()
    rc = lib.cglb_matvec(
        xr.data_ptr(), rows.n, xc.data_ptr(), cols.n, pf.data_ptr(), bp,
        xr.shape[1], _FAMILY_CODE[rows.family], int(accurate),
        out.data_ptr(), torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(rc, "cglb_matvec")
    launch_matvec.launches += 1
    return out[:B]


launch_matvec.launches = 0


def launch_ls_grad(rows: Prepared, cols: Prepared, p: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """Kernel 2 on the card: [D] fp64, summed over its per-block partials
    by a deterministic torch.sum (no atomics)."""
    xr, xc = rows.packed(), cols.packed()
    _same_device(xr, xc, p, g)
    B = p.shape[0]
    if g.shape != (B, cols.n) or p.shape[1] != rows.n:
        raise ValueError(f"shapes p {tuple(p.shape)}, g {tuple(g.shape)}")
    bp = _bpad(B)
    pf, gf = _padded_batch(p, bp), _padded_batch(g, bp)
    lib = _build.load()
    dp = xr.shape[1]
    partial = torch.empty(lib.cglb_ls_grad_blocks(cols.n), dp,
                          dtype=torch.float64, device=p.device)
    rc = lib.cglb_ls_grad(
        xr.data_ptr(), rows.n, xc.data_ptr(), cols.n, pf.data_ptr(),
        gf.data_ptr(), bp, dp, _FAMILY_CODE[rows.family], partial.data_ptr(),
        torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(rc, "cglb_ls_grad")
    launch_ls_grad.launches += 1
    return torch.sum(partial, dim=0)[:rows.xg.shape[1]]


launch_ls_grad.launches = 0


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
