"""Fused Kuf builder: Kuf = var * rho(gamma * d2(Z/ls, X/ls)) in fp64.

Counterpart of ``cglb_tpu/ops/kuf_pallas.py``.  Kernel 3
(``csrc/kuf.cu``, :func:`launch_kuf`) computes the squared distance by
direct differences and the profile in one fp64 pass, over chunks of 8
coordinates (:func:`kuf_plan`), and on request also e = exp(-sqrt(t))
(Matern32) or rho (RBF), the backward's residual.  It takes the scaled
coordinates coordinate-major (:func:`kuf_operands`).  Beside it is the
plain PyTorch version :func:`kuf_unit_plain`, taken only for tensors on
the CPU.

The backward (``_Kuf``) is plain torch, as the JAX one is XLA-only
(kuf_pallas.py:285-314): with dt = g * var * drho/dt,

    T = dt @ [xg, xg^2, 1]   ->  dZ  = 2 (zg * R - U) * sqrt(gamma) / ls
                                 dls = -(2/ls) sum_m (zg^2 R - 2 zg U + V)
    dvar = sum g * rho

and a zero cotangent for X, which is data.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _build
from .kernels import GAMMA
from .matvec import _on_cpu

__all__ = ["kuf", "kuf_of", "kuf_unit", "kuf_unit_plain", "launch_kuf",
           "kuf_plan", "kuf_operands", "KUF_CHUNK", "KUF_TILE"]

_FAMILY_CODE = {"rbf": 0, "mat32": 1}
# drho/dt = C * e  (e from _profile: exp(-sqrt t) for Matern32, rho for RBF)
_DRHO_DT = {"rbf": -1.0, "mat32": -0.5}
# kernel 3's coordinates a stage and rows x columns a block (csrc/kuf.cu
# kChunk, kBM x kBN)
KUF_CHUNK = 8
KUF_TILE = (64, 64)


def kuf_plan(d: int) -> int:
    """Kernel 3's coordinate width for d input dimensions: d rounded up to
    a multiple of KUF_CHUNK, as the TPU kernel's ``_dsub``
    (kuf_pallas.py:111): D <= 8 at 8, 9-16 at 16, 17-24 at 24, 25-32 at 32,
    40 at 40, 100 at 104.  Kernels 1-2 keep ``matvec.coord_plan``."""
    if d < 1:
        raise ValueError(f"input dimension {d} < 1")
    return -(-d // KUF_CHUNK) * KUF_CHUNK


def _coordinate_major(a: torch.Tensor, width: int, multiple: int
                      ) -> torch.Tensor:
    """a [n, d] as a^T zero-padded to [width, n rounded up to multiple]."""
    n, d = a.shape
    out = torch.zeros(width, -(-n // multiple) * multiple, dtype=a.dtype,
                      device=a.device)
    out[:d, :n] = a.T
    return out


def kuf_operands(zg: torch.Tensor, xg: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(zt, xt, width): what kernel 3 reads, zg [M, d] and xg [N, d]
    transposed to [width, MP] and [width, NP] (width = kuf_plan(d), MP and
    NP the next multiples of the block's rows and columns), zero-padded."""
    width = kuf_plan(zg.shape[1])
    return (_coordinate_major(zg, width, KUF_TILE[0]),
            _coordinate_major(xg, width, KUF_TILE[1]), width)


def kuf_unit_plain(zg, xg, var, family: str, with_e: bool = True
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of kernel 3: (var * rho, e) from scaled coordinates."""
    t = torch.zeros(zg.shape[0], xg.shape[0], dtype=zg.dtype,
                    device=zg.device)
    for d in range(zg.shape[1]):
        diff = zg[:, d, None] - xg[None, :, d]
        t += diff * diff
    if family == "rbf":
        rho = torch.exp(-t)
        e = rho
    else:
        s = torch.sqrt(t)
        e = torch.exp(-s)
        rho = (1.0 + s) * e
    return var * rho, (e if with_e else None)


def launch_kuf(zg, xg, var, family: str, with_e: bool = True
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel 3 on the card, in zg's dtype (fp64 or fp32)."""
    dtype = zg.dtype
    if dtype not in (torch.float64, torch.float32):
        raise ValueError(f"unsupported dtype {dtype}")
    if xg.dtype != dtype or xg.device != zg.device:
        raise ValueError("zg and xg differ in dtype or device")
    if xg.shape[1] != zg.shape[1]:
        raise ValueError("zg and xg differ in input dimension")
    m, n = zg.shape[0], xg.shape[0]
    zt, xt, width = kuf_operands(zg, xg)
    varp = var.detach().to(zg.device, dtype).reshape(1).contiguous()
    out = torch.empty(m, n, dtype=dtype, device=zg.device)
    e = torch.empty(m, n, dtype=dtype, device=zg.device) if with_e else None
    lib = _build.load()
    fn = lib.cglb_kuf_f64 if dtype == torch.float64 else lib.cglb_kuf_f32
    rc = fn(zt.data_ptr(), m, zt.shape[1], xt.data_ptr(), n, xt.shape[1],
            width, _FAMILY_CODE[family], varp.data_ptr(), out.data_ptr(),
            None if e is None else e.data_ptr(),
            torch.cuda.current_stream(zg.device).cuda_stream)
    _build.check(rc, "cglb_kuf")
    launch_kuf.launches += 1
    return out, e


launch_kuf.launches = 0


def kuf_unit(zg, xg, var, family: str, with_e: bool = True):
    """(Kuf, e): the kernel for CUDA tensors, the plain version on the CPU."""
    if _on_cpu(zg):
        return kuf_unit_plain(zg, xg, var, family, with_e)
    return launch_kuf(zg, xg, var, family, with_e)


class _Kuf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Z, ls, var, X, family: str):
        c = math.sqrt(GAMMA[family]) / ls
        need_e = any(ctx.needs_input_grad[:3])
        out, e = kuf_unit((Z * c).detach(), (X * c).detach(), var, family,
                          with_e=need_e)
        ctx.family = family
        ctx.save_for_backward(Z, ls, var, X, out, e)
        return out

    @staticmethod
    def backward(ctx, g):
        Z, ls, var, X, out, e = ctx.saved_tensors
        family = ctx.family
        sg = math.sqrt(GAMMA[family])
        D = Z.shape[1]
        dt = g * e * (_DRHO_DT[family] * var)
        xg = X * (sg / ls)
        rhs = torch.cat([xg, xg * xg, torch.ones_like(xg[:, :1])], dim=1)
        T = dt @ rhs
        U, V, R = T[:, :D], T[:, D:2 * D], T[:, 2 * D:]
        zg = Z * (sg / ls)
        dZ = 2.0 * (zg * R - U) * (sg / ls)
        dls = -(2.0 / ls) * torch.sum(zg * zg * R - 2.0 * zg * U + V, dim=0)
        dvar = torch.sum(g * out) / var
        return dZ, dls, dvar, None, None


def kuf(kernel, Z: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Kuf = k(Z, X) [M, N]; differentiable in the kernel parameters and Z
    (X is data: zero cotangent)."""
    return kuf_of(Z, kernel.lengthscales.value, kernel.variance.value, X,
                  kernel.family)


def kuf_of(Z, ls, var, X, family: str) -> torch.Tensor:
    """:func:`kuf` from the parameter values themselves (the sharded common
    terms pass them in through ``DataMesh.enter``)."""
    return _Kuf.apply(Z, ls, var, X, family)
