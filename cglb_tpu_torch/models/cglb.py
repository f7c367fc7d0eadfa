"""CGLB: the lower bound on the GP log marginal likelihood via
preconditioned CG (Artemev, Burt & van der Wilk, ICML 2021).

Counterpart of ``cglb_tpu/models/cglb.py``:

    bound = -0.5 N D log 2pi
          + logdet_bound                     (Jensen, or the nm2 / n2m variants)
          - ub                               (CG quad-form bound)

    quad:  v ~= (K + sigma^2 I)^-1 err by warm-started preconditioned CG
           under torch.no_grad; lb = sum v (r + 0.5 K v) and
           ub = lb + 0.5 r^T P r are re-assembled differentiably from the
           detached v.

The warm start ``v0`` ([D, N]) is an explicit input and output
(``CGLBAux.v``); callers thread it through their loop.  With ``vzero`` or
``joint_optimization`` (``v_is_external``) no CG runs: the bound is assembled
at ``v0`` as given, and the gradient flows into it when it is a trainable
``Param``'s value.  The n2m variant materializes K(X, X): O(N^2) memory, an
ablation.

Above ``sgpr.CHUNK_THRESHOLD_ELEMENTS`` (or with an explicit ``chunk_size``)
the common terms go by column chunks (models/sgpr.py), A is kept only in the
preconditioner's dtype and, by default there, each chunk is recomputed in
the backward (``remat_common_terms``, cglb_tpu/models/cglb.py:222-265); the
predictor's A @ res then comes from ``sgpr.kuf_weighted``.

With ``mesh`` (a ``parallel.mesh.DataMesh``; ``parallel/sharded.py`` is the
entry point) the same functions run column-sharded over the ranks: the common
terms, the preconditioner's A and the n2m trace hold the rank's columns and
are summed or gathered through the mesh, the matvec is the caller's sharded
operator, and CG runs on every rank on replicated vectors; its step counts
are compared across the ranks at the end of every solve.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .. import config as _config
from ..ops import cg as _cg
from ..ops import chol as _chol
from ..ops import preconditioners as _pc
from ..ops.kuf import kuf as _kuf
from ..ops.operators import make_dense_operator
from .gaussian import mean_apply
from .sgpr import (CommonTerms, SGPRParams, common_terms, kuf_weighted,
                   n2m_log_trace)

__all__ = ["CGLBConfig", "CGLBAux", "init_v0", "bound", "loss",
           "PredictCache", "predict_prepare", "predict_from_cache",
           "predict_f"]


@dataclass(frozen=True)
class CGLBConfig:
    """CGLB knobs (cglb_tpu/models/cglb.py:47-73)."""

    max_error: float = 1.0
    max_cg_iters: int = 100
    restart_cg_iters: int = 40
    joint_optimization: bool = False
    vzero: bool = False
    logdet_variant: str = "jensen"
    # dtype of the Nystrom preconditioner apply inside CG
    precond_dtype: str = "float32"

    @property
    def v_is_external(self) -> bool:
        """True when v is not produced by CG (vzero, or v optimized jointly
        with the parameters)."""
        return self.joint_optimization or self.vzero


class CGLBAux(NamedTuple):
    v: torch.Tensor           # [D, N] new warm start
    cg_steps: int
    cg_residual_error: float


def init_v0(N: int, output_dim: int = 1, dtype=None, device=None):
    return torch.zeros(output_dim, N, dtype=dtype or _config.torch_dtype(),
                       device=device)


def _logdet_bound(params: SGPRParams, ct: CommonTerms, X, Y,
                  variant: str, mesh=None) -> torch.Tensor:
    """Upper bounds on 0.5 log|K + sigma^2 I| (negated), three variants."""
    N, D = Y.shape
    sigma_sq = params.noise_variance.value
    kd = params.kernel.kdiag(X)
    # tr(K - Q)/sigma^2 >= 0; clamped against cancellation as Q -> K
    trace = torch.clamp(torch.sum(kd) / sigma_sq - torch.trace(ct.AAT),
                        min=0.0)
    logdiag_LB = torch.sum(torch.log(torch.diagonal(ct.LB)))
    if variant == "jensen":
        # log|K+s2I| <= log|Q+s2I| + N log(1 + tr(K-Q)/(s2 N))
        return (-D * logdiag_LB - 0.5 * N * D * torch.log(sigma_sq)
                - 0.5 * D * N * torch.log(1.0 + trace / N))
    log_det_q = logdiag_LB + 0.5 * N * torch.log(sigma_sq)
    if variant == "nm2":
        # log|Q| + tr(K-Q)/sigma^2
        return -(log_det_q + 0.5 * trace)
    if variant == "n2m":
        # log|Q| + n log(tr(Q^-1 K)/n); K(X, X) is materialized
        return -(log_det_q + 0.5 * n2m_log_trace(params, ct, X, mesh))
    raise ValueError(f"unknown logdet variant {variant!r}")


def _make_precond(ct: CommonTerms, sigma_sq, cfg: CGLBConfig,
                  consistent_ct: bool = True,
                  mesh=None) -> _pc.NystromPreconditioner:
    """Nystrom preconditioner in cfg.precond_dtype.

    LB is re-derived from the SAME cast A the preconditioner applies: the
    Woodbury identity is positive only when both factors describe the same
    A.  ct.LB is reused only when it was computed from exactly this A
    (``consistent_ct``) and both are in that dtype (a chunked build gives A
    in the preconditioner's fp32 beside an fp64 LB)."""
    pd = _config.torch_dtype(cfg.precond_dtype)
    if consistent_ct and ct.A.dtype == pd and ct.LB.dtype == pd:
        return _pc.NystromPreconditioner(A=ct.A, LB=ct.LB, sigma_sq=sigma_sq,
                                         mesh=mesh)
    A = ct.A.to(pd)
    eye = torch.eye(A.shape[0], dtype=pd, device=A.device)
    AAT = A @ A.T
    if mesh is not None:
        AAT = mesh.reduce(AAT)
    LB, Ci = _chol.chol_inv(AAT + eye)
    return _pc.NystromPreconditioner(A=A, LB=LB, sigma_sq=sigma_sq, Ci=Ci,
                                     mesh=mesh)


def _same_steps(mesh, stats: _cg.CGStats) -> None:
    """Every rank ran the same CG iterations (a mismatch would leave the
    ranks' collectives out of step)."""
    if mesh is not None:
        mesh.check_same(stats.steps, "CG steps")


def _quad_form_bound(params: SGPRParams, ct: CommonTerms, X, Y, v0,
                     cfg: CGLBConfig, matvec=None, max_error=None,
                     matvec_cg=None, mesh=None
                     ) -> Tuple[torch.Tensor, CGLBAux]:
    """-ub on 0.5 err^T (K+s2I)^-1 err, plus the new warm start.

    matvec_cg: an optional cheaper operator for the CG iterations only.  The
    bound is assembled from the accurate ``matvec``, and lb(v) is a valid
    lower bound for every v, so an inexact v only loosens it."""
    sigma_sq = params.noise_variance.value
    err_t = (Y - mean_apply(params.mean, X)).T  # [D, N]
    if matvec is None:
        matvec = make_dense_operator(params.kernel, X, sigma_sq)
    P = _make_precond(ct, sigma_sq, cfg, mesh=mesh)

    if cfg.v_is_external:
        v = v0  # fixed zeros, or a trainable value the gradient flows into
        stats = _cg.CGStats(steps=0, residual_error=0.0)
    else:
        v, stats = _cg.preconditioned_cg(
            matvec_cg if matvec_cg is not None else matvec, err_t.detach(),
            v0, P, cfg.max_error if max_error is None else max_error,
            cfg.max_cg_iters, cfg.restart_cg_iters)
        _same_steps(mesh, stats)

    Kv = matvec(v)
    r = err_t - Kv
    _, rz = _pc.mat_vec(P, r)
    lb = torch.sum(v * (r + 0.5 * Kv))
    ub = lb + 0.5 * torch.sum(rz)
    return -ub, CGLBAux(v=v.detach(), cg_steps=stats.steps,
                        cg_residual_error=stats.residual_error)


def _common_terms(params: SGPRParams, X, cfg: CGLBConfig, jitter,
                  chunk_size, remat, mesh=None) -> CommonTerms:
    """The common terms; where they go by column chunks (models/sgpr.py
    decides), A is built in the preconditioner's dtype, except for n2m,
    whose trace needs A in fp64."""
    a_dtype = (None if cfg.logdet_variant == "n2m"
               else _config.torch_dtype(cfg.precond_dtype))
    return common_terms(params, X, jitter, chunk_size=chunk_size,
                        remat=remat, a_dtype=a_dtype, mesh=mesh)


def bound(params: SGPRParams, X, Y, v0, cfg: CGLBConfig = CGLBConfig(),
          jitter: float = None, matvec: Optional[Callable] = None,
          matvec_cg: Optional[Callable] = None,
          max_error: Optional[float] = None,
          remat_common_terms: bool = True,
          chunk_size: Optional[int] = None,
          mesh=None) -> Tuple[torch.Tensor, CGLBAux]:
    """The CGLB lower bound on log p(Y|X) and the CG aux.

    chunk_size: columns per chunk of the common terms (default: by size,
    models/sgpr.py ``chunk_width``; under a mesh, of the rank's columns).
    remat_common_terms: where they are chunked, recompute each chunk in the
    backward instead of storing its Kuf, e and A (chunked by size, storing
    them would hold what chunking saves).  mesh: column-sharded over its
    ranks; ``matvec`` must then be a sharded operator
    (``parallel/sharded.py``)."""
    if mesh is not None and matvec is None:
        raise ValueError("a mesh needs the sharded operator as matvec")
    N, D = Y.shape
    ct = _common_terms(params, X, cfg, jitter, chunk_size,
                       remat_common_terms, mesh)
    b = -0.5 * N * D * math.log(2.0 * math.pi)
    b = b + _logdet_bound(params, ct, X, Y, cfg.logdet_variant, mesh)
    quad, aux = _quad_form_bound(params, ct, X, Y, v0, cfg, matvec,
                                 max_error=max_error, matvec_cg=matvec_cg,
                                 mesh=mesh)
    return b + quad, aux


def loss(params: SGPRParams, X, Y, v0, cfg: CGLBConfig = CGLBConfig(),
         jitter: float = None, matvec: Optional[Callable] = None,
         matvec_cg: Optional[Callable] = None,
         max_error: Optional[float] = None,
         remat_common_terms: bool = True,
         chunk_size: Optional[int] = None,
         mesh=None) -> Tuple[torch.Tensor, CGLBAux]:
    """Training loss = -bound; aux carries the warm start and CG stats."""
    b, aux = bound(params, X, Y, v0, cfg, jitter, matvec,
                   matvec_cg=matvec_cg, max_error=max_error,
                   remat_common_terms=remat_common_terms,
                   chunk_size=chunk_size, mesh=mesh)
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
                    matvec: Optional[Callable] = None,
                    mesh=None) -> PredictCache:
    """Common terms, the CG solve at ``cg_tolerance`` (None, vzero and the
    joint v reuse v0 as is) and the [M, D] residual projection, once.
    Where CG with an fp32 preconditioner ends above the tolerance, the solve
    runs again from v0 with the fp64 one: at a large variance / noise ratio
    the fp32 apply loses the +I of B = I + A A^T and CG diverges where the
    fp64 one converges in a few steps (chip_smoke.py phase 5 prints both
    solves at the end of the kin40k scipy4 run), and a v that far off makes
    the predictive mean wrong.  Where the common terms were
    chunked and A is held in the preconditioner's dtype, A @ res is
    ``kuf_weighted``'s, so that no fp64 [M, N] is held.  With ``mesh`` as
    in :func:`bound` (``matvec`` its sharded operator)."""
    if mesh is not None and matvec is None:
        raise ValueError("a mesh needs the sharded operator as matvec")
    sigma_sq = params.noise_variance.value
    sigma = torch.sqrt(sigma_sq)
    err = Y - mean_apply(params.mean, X)
    ct = _common_terms(params, X, cfg, jitter, None, False, mesh)
    if matvec is None:
        matvec = make_dense_operator(params.kernel, X, sigma_sq)
    if cg_tolerance is None or cfg.v_is_external:
        v = v0
    else:
        # the configured preconditioner, then fp64 if that one failed
        for dtype in dict.fromkeys((cfg.precond_dtype, "float64")):
            P = _make_precond(ct, sigma_sq, replace(cfg, precond_dtype=dtype),
                              mesh=mesh)
            v, stats = _cg.preconditioned_cg(matvec, err.T, v0, P,
                                             cg_tolerance, cfg.max_cg_iters,
                                             cfg.restart_cg_iters)
            _same_steps(mesh, stats)
            if stats.residual_error <= cg_tolerance:
                break
    res = err - matvec(v).T  # [N, D]
    if ct.A.dtype == X.dtype:
        Ares = (ct.A @ res if mesh is None
                else mesh.reduce(ct.A @ mesh.shard(res, 0)))
    else:  # chunked, A in the preconditioner's dtype
        Ares = kuf_weighted(params, ct.L, X, res, sigma, mesh=mesh)
    c = torch.linalg.solve_triangular(ct.LB, Ares, upper=False) / sigma
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
