"""CGLB: the lower bound on the GP log marginal likelihood via
preconditioned CG (Artemev, Burt & van der Wilk, ICML 2021).

Counterpart of ``cglb_tpu/models/cglb.py``:

    bound = -0.5 N D log 2pi
          + logdet_bound                     (Jensen)
          - ub                               (CG quad-form bound)

    quad:  v ~= (K + sigma^2 I)^-1 err by warm-started preconditioned CG
           under torch.no_grad; lb = sum v (r + 0.5 K v) and
           ub = lb + 0.5 r^T P r are re-assembled differentiably from the
           detached v.

The warm start ``v0`` ([D, N]) is an explicit input and output
(``CGLBAux.v``); callers thread it through their loop.  The n2m and nm2
log-det variants, vzero and the jointly optimized v (``v_is_external`` in the
JAX package) are not ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .. import config as _config
from ..ops import cg as _cg
from ..ops import chol as _chol
from ..ops import preconditioners as _pc
from ..ops.kuf import kuf as _kuf
from ..ops.operators import make_dense_operator
from .gaussian import mean_apply
from .sgpr import CommonTerms, SGPRParams, common_terms

__all__ = ["CGLBConfig", "CGLBAux", "init_v0", "bound", "loss",
           "PredictCache", "predict_prepare", "predict_from_cache",
           "predict_f"]


@dataclass(frozen=True)
class CGLBConfig:
    """CGLB knobs (cglb_tpu/models/cglb.py:47-73)."""

    max_error: float = 1.0
    max_cg_iters: int = 100
    restart_cg_iters: int = 40
    logdet_variant: str = "jensen"
    # dtype of the Nystrom preconditioner apply inside CG
    precond_dtype: str = "float32"


class CGLBAux(NamedTuple):
    v: torch.Tensor           # [D, N] new warm start
    cg_steps: int
    cg_residual_error: float


def init_v0(N: int, output_dim: int = 1, dtype=None, device=None):
    return torch.zeros(output_dim, N, dtype=dtype or _config.torch_dtype(),
                       device=device)


def _logdet_bound(params: SGPRParams, ct: CommonTerms, X, Y,
                  variant: str) -> torch.Tensor:
    """Jensen upper bound on 0.5 log|K + sigma^2 I|, negated."""
    if variant != "jensen":
        raise NotImplementedError(
            f"logdet variant {variant!r} is not ported yet "
            "(ROADMAP.md, queue 1: the logdet variants)")
    N, D = Y.shape
    sigma_sq = params.noise_variance.value
    kd = params.kernel.kdiag(X)
    # tr(K - Q)/sigma^2 >= 0; clamped against cancellation as Q -> K
    trace = torch.clamp(torch.sum(kd) / sigma_sq - torch.trace(ct.AAT),
                        min=0.0)
    logdiag_LB = torch.sum(torch.log(torch.diagonal(ct.LB)))
    # log|K+s2I| <= log|Q+s2I| + N log(1 + tr(K-Q)/(s2 N))
    return (-D * logdiag_LB - 0.5 * N * D * torch.log(sigma_sq)
            - 0.5 * D * N * torch.log(1.0 + trace / N))


def _make_precond(ct: CommonTerms, sigma_sq, cfg: CGLBConfig,
                  consistent_ct: bool = True) -> _pc.NystromPreconditioner:
    """Nystrom preconditioner in cfg.precond_dtype.

    LB is re-derived from the SAME cast A the preconditioner applies: the
    Woodbury identity is positive only when both factors describe the same
    A.  ct.LB is reused only when it was computed from exactly this A
    (``consistent_ct``) in the same dtype."""
    pd = _config.torch_dtype(cfg.precond_dtype)
    if consistent_ct and ct.A.dtype == pd:
        return _pc.NystromPreconditioner(A=ct.A, LB=ct.LB, sigma_sq=sigma_sq)
    A = ct.A.to(pd)
    eye = torch.eye(A.shape[0], dtype=pd, device=A.device)
    LB, Ci = _chol.chol_inv(A @ A.T + eye)
    return _pc.NystromPreconditioner(A=A, LB=LB, sigma_sq=sigma_sq, Ci=Ci)


def _quad_form_bound(params: SGPRParams, ct: CommonTerms, X, Y, v0,
                     cfg: CGLBConfig, matvec=None, max_error=None,
                     matvec_cg=None) -> Tuple[torch.Tensor, CGLBAux]:
    """-ub on 0.5 err^T (K+s2I)^-1 err, plus the new warm start.

    matvec_cg: an optional cheaper operator for the CG iterations only.  The
    bound is assembled from the accurate ``matvec``, and lb(v) is a valid
    lower bound for every v, so an inexact v only loosens it."""
    sigma_sq = params.noise_variance.value
    err_t = (Y - mean_apply(params.mean, X)).T  # [D, N]
    if matvec is None:
        matvec = make_dense_operator(params.kernel, X, sigma_sq)
    P = _make_precond(ct, sigma_sq, cfg)

    v, stats = _cg.preconditioned_cg(
        matvec_cg if matvec_cg is not None else matvec, err_t.detach(), v0,
        P, cfg.max_error if max_error is None else max_error,
        cfg.max_cg_iters, cfg.restart_cg_iters)

    Kv = matvec(v)
    r = err_t - Kv
    _, rz = _pc.mat_vec(P, r)
    lb = torch.sum(v * (r + 0.5 * Kv))
    ub = lb + 0.5 * torch.sum(rz)
    return -ub, CGLBAux(v=v, cg_steps=stats.steps,
                        cg_residual_error=stats.residual_error)


def bound(params: SGPRParams, X, Y, v0, cfg: CGLBConfig = CGLBConfig(),
          jitter: float = None, matvec: Optional[Callable] = None,
          matvec_cg: Optional[Callable] = None,
          max_error: Optional[float] = None) -> Tuple[torch.Tensor, CGLBAux]:
    """The CGLB lower bound on log p(Y|X) and the CG aux."""
    N, D = Y.shape
    ct = common_terms(params, X, jitter)
    b = -0.5 * N * D * math.log(2.0 * math.pi)
    b = b + _logdet_bound(params, ct, X, Y, cfg.logdet_variant)
    quad, aux = _quad_form_bound(params, ct, X, Y, v0, cfg, matvec,
                                 max_error=max_error, matvec_cg=matvec_cg)
    return b + quad, aux


def loss(params: SGPRParams, X, Y, v0, cfg: CGLBConfig = CGLBConfig(),
         jitter: float = None, matvec: Optional[Callable] = None,
         matvec_cg: Optional[Callable] = None,
         max_error: Optional[float] = None) -> Tuple[torch.Tensor, CGLBAux]:
    """Training loss = -bound; aux carries the warm start and CG stats."""
    b, aux = bound(params, X, Y, v0, cfg, jitter, matvec,
                   matvec_cg=matvec_cg, max_error=max_error)
    return -b, aux


class PredictCache(NamedTuple):
    """Batch-independent prediction state: one CG solve and one
    common-terms build serve every prediction batch."""

    v: torch.Tensor   # [D, N] CG solution at the prediction tolerance
    c: torch.Tensor   # [M, D] LB^-1 (A @ res) / sigma, res = err - (K+s2)v
    L: torch.Tensor   # [M, M] chol(Kuu + jitter I)
    LB: torch.Tensor  # [M, M]


@torch.no_grad()
def predict_prepare(params: SGPRParams, X, Y, v0,
                    cfg: CGLBConfig = CGLBConfig(),
                    cg_tolerance: Optional[float] = 1e-3,
                    jitter: float = None,
                    matvec: Optional[Callable] = None) -> PredictCache:
    """Common terms, the CG solve at ``cg_tolerance`` (None reuses v0 as
    is) and the [M, D] residual projection, once."""
    sigma_sq = params.noise_variance.value
    sigma = torch.sqrt(sigma_sq)
    err = Y - mean_apply(params.mean, X)
    ct = common_terms(params, X, jitter)
    if matvec is None:
        matvec = make_dense_operator(params.kernel, X, sigma_sq)
    if cg_tolerance is None:
        v = v0
    else:
        P = _make_precond(ct, sigma_sq, cfg)
        v, _ = _cg.preconditioned_cg(matvec, err.T, v0, P, cg_tolerance,
                                     cfg.max_cg_iters, cfg.restart_cg_iters)
    res = err - matvec(v).T  # [N, D]
    c = torch.linalg.solve_triangular(ct.LB, ct.A @ res, upper=False) / sigma
    return PredictCache(v=v, c=c, L=ct.L, LB=ct.LB)


@torch.no_grad()
def predict_from_cache(params: SGPRParams, cache: PredictCache, X, Xnew,
                       cross_matvec: Optional[Callable] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-batch posterior from a PredictCache: O(S M + S N), no CG.

    cross_matvec: optional p [B, N] -> p K(X, Xnew) [B, S] (the streaming
    kernel), which avoids materializing the [S, N] cross kernel."""
    v, c = cache.v, cache.c
    if cross_matvec is not None:
        cg_mean = cross_matvec(v).T  # [S, D]
    else:
        cg_mean = params.kernel.K(Xnew, X) @ v.T
    Kus = _kuf(params.kernel, params.inducing_Z.value, Xnew)
    tmp1 = torch.linalg.solve_triangular(cache.L, Kus, upper=False)
    tmp2 = torch.linalg.solve_triangular(cache.LB, tmp1, upper=False)
    var = (params.kernel.kdiag(Xnew) + torch.sum(torch.square(tmp2), dim=0)
           - torch.sum(torch.square(tmp1), dim=0))
    D = v.shape[0]
    mean = tmp2.T @ c + cg_mean + mean_apply(params.mean, Xnew)
    return mean, var[:, None].expand(-1, D)


def predict_f(params: SGPRParams, X, Y, v0, Xnew,
              cfg: CGLBConfig = CGLBConfig(),
              cg_tolerance: Optional[float] = 1e-3, jitter: float = None,
              matvec: Optional[Callable] = None,
              cross_matvec: Optional[Callable] = None):
    """CGLB posterior: SGPR mean on the CG residual + K(s, f) v."""
    cache = predict_prepare(params, X, Y, v0, cfg, cg_tolerance, jitter,
                            matvec)
    return predict_from_cache(params, cache, X, Xnew,
                              cross_matvec=cross_matvec)
