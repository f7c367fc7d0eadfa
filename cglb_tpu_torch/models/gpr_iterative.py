"""Iterative exact-GP regression: a CG quadratic term and a stochastic
Lanczos quadrature log-det, on kernel matvecs.

Counterpart of ``cglb_tpu/models/gpr_iterative.py``:

    lml ~= -0.5 y^T alpha - 0.5 logdet_SLQ - N/2 log 2pi
    alpha      : CG solve of (K + s2 I) alpha = y
    logdet_SLQ : (N/P) sum_i e1^T log(T_i) e1            (batched Lanczos)

The operator is dense at N <= 4096 and streamed otherwise (kernels 1 and 2,
ops/matvec.py): the batch is 1 row per output in the CG on the training
error, ``num_probes`` rows in the probe solves and SLQ, and
``pred_lanczos_steps`` rows in the prediction's cross product.

Gradients use the detached-solve surrogate: with alpha and the probe solves
W = K^-1 Z computed under ``torch.no_grad``,

    d lml / dtheta = 0.5 alpha^T dK alpha - 0.5 (1/P) sum_i w_i^T dK z_i

is realized by differentiable surrogate terms ``matvec(alpha)`` and
``matvec(Z)`` (live in the kernel parameters and the noise only), offset so
that the forward number comes from SLQ.

The Rademacher probes come from an explicit ``torch.Generator`` on the
data's device; every function that draws them also takes them ready-made
(``probes``), so that a test can hand this package and the JAX package one
Z.

Prediction: posterior mean by CG; variance by the rank-t Lanczos
(LOVE-style) approximation K^-1 ~= Q^T T^-1 Q, var(s) ~= k_ss -
||T^{-1/2} Q k_fs||^2.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..ops import cg as _cg
from ..ops import matvec as _mv
from ..ops import preconditioners as _pc
from ..ops.operators import make_dense_operator
from .gaussian import mean_apply, predict_log_density
from .gpr import GPRParams

__all__ = ["IterGPConfig", "IterAux", "DENSE_LIMIT", "make_generator",
           "rademacher", "lanczos", "slq_logdet", "iterative_lml",
           "iterative_loss", "IterPredictCache", "predict_prepare",
           "predict_from_cache", "predict_f_iterative",
           "iterative_predict_log_density"]

# K(X, X) is materialized up to this N and streamed above it
DENSE_LIMIT = 4096


@dataclass(frozen=True)
class IterGPConfig:
    """Knobs of the iterative objective (gpytorch-like defaults)."""

    num_probes: int = 10
    lanczos_steps: int = 25
    cg_tolerance: float = 1e-4
    max_cg_iters: int = 200
    pred_lanczos_steps: int = 64


def make_generator(state, device) -> torch.Generator:
    """A generator on ``device`` from a carried state (``get_state()`` of an
    earlier one), an integer seed, or None (seed 0)."""
    gen = torch.Generator(device=device)
    if isinstance(state, torch.Tensor):
        gen.set_state(state)
    else:
        gen.manual_seed(int(state or 0))
    return gen


def rademacher(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    """+-1 with equal probability, on the generator's device."""
    bits = torch.randint(0, 2, tuple(shape), generator=generator,
                         device=generator.device)
    return (2 * bits - 1).to(dtype)


def _probes(generator, probes, shape, dtype) -> torch.Tensor:
    """``probes`` as given, else Rademacher rows from ``generator``."""
    if probes is not None:
        return probes
    if generator is None:
        raise ValueError("either a generator or ready-made probes")
    return rademacher(generator, shape, dtype)


def _operator(params: GPRParams, X) -> Callable:
    sigma_sq = params.noise_variance.value
    if X.shape[0] <= DENSE_LIMIT:
        return make_dense_operator(params.kernel, X, sigma_sq)
    return _mv.make_streaming_operator(params.kernel, X, sigma_sq)


def lanczos(matvec: Callable, V0: torch.Tensor, steps: int,
            reorth: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched Lanczos tridiagonalization of the SPD operator.

    V0: [P, N] start vectors (need not be normalized).  Returns (alphas
    [P, t], betas [P, t-1], Q [t, P, N]) with K ~= Q^T T Q per probe.

    reorth=True reorthogonalizes against all stored vectors: required when
    t approaches the operator's effective rank (the prediction variance);
    the three-term recurrence suffices for SLQ log-dets.  A host loop of
    ``steps`` iterations that never reads the device."""
    P, N = V0.shape
    q = V0 / torch.linalg.norm(V0, dim=1, keepdim=True)
    Qbuf = torch.zeros(steps, P, N, dtype=V0.dtype, device=V0.device)
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros(P, dtype=V0.dtype, device=V0.device)
    alphas, betas = [], []
    for idx in range(steps):
        Qbuf[idx] = q
        w = matvec(q)
        alpha = torch.sum(w * q, dim=1)
        w = w - alpha[:, None] * q - beta_prev[:, None] * q_prev
        if reorth:
            # project every stored vector out (rows past idx are zero)
            coeffs = torch.einsum("tpn,pn->tp", Qbuf, w)
            w = w - torch.einsum("tp,tpn->pn", coeffs, Qbuf)
        beta = torch.linalg.norm(w, dim=1)
        q_prev, q = q, w / torch.clamp(beta, min=1e-300)[:, None]
        beta_prev = beta
        alphas.append(alpha)
        betas.append(beta)
    # the last beta is unused
    return (torch.stack(alphas, dim=1),
            torch.stack(betas[:-1], dim=1) if steps > 1
            else torch.zeros(P, 0, dtype=V0.dtype, device=V0.device),
            Qbuf)


def _tridiag(alphas: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """[..., t, t] symmetric tridiagonal matrices."""
    return (torch.diag_embed(alphas) + torch.diag_embed(betas, offset=1)
            + torch.diag_embed(betas, offset=-1))


def _tridiag_logquad(alphas, betas) -> torch.Tensor:
    """[P] e1^T log(T) e1 per probe, by one batched eigendecomposition of
    the t x t tridiagonals."""
    evals, evecs = torch.linalg.eigh(_tridiag(alphas, betas))
    evals = torch.clamp(evals, min=1e-300)
    return torch.sum(torch.square(evecs[:, 0, :]) * torch.log(evals), dim=1)


def slq_logdet(matvec: Callable, N: int, generator: torch.Generator,
               num_probes: int, steps: int, dtype,
               probes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stochastic Lanczos quadrature estimate of log|K| from Rademacher
    probes [num_probes, N] (drawn from ``generator`` unless given)."""
    Z = _probes(generator, probes, (num_probes, N), dtype)
    alphas, betas, _ = lanczos(matvec, Z, steps)
    # ||z||^2 = N for Rademacher probes
    return torch.mean(_tridiag_logquad(alphas, betas)) * N


class IterAux(NamedTuple):
    alpha: torch.Tensor       # [D, N] solve of (K + s2 I) alpha = err^T
    cg_steps: int
    logdet: torch.Tensor
    probe_cg_steps: int       # of the solve against the probes


def iterative_lml(params: GPRParams, X, Y,
                  generator: Optional[torch.Generator] = None,
                  cfg: IterGPConfig = IterGPConfig(),
                  probes: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, IterAux]:
    """Estimated exact-GP log marginal likelihood with surrogate gradients.
    The probe solves and SLQ share one Z."""
    N, D = Y.shape
    err_t = (Y - mean_apply(params.mean, X)).T  # [D, N]
    matvec = _operator(params, X)
    Z = _probes(generator, probes, (cfg.num_probes, N), X.dtype)

    # ---- detached solves ----
    with torch.no_grad():
        identity = _pc.IdentityPreconditioner()
        alpha, stats = _cg.preconditioned_cg(
            matvec, err_t, torch.zeros_like(err_t), identity,
            max_error=cfg.cg_tolerance, max_iters=cfg.max_cg_iters)
        W, probe_stats = _cg.preconditioned_cg(
            matvec, Z, torch.zeros_like(Z), identity,
            max_error=cfg.cg_tolerance, max_iters=cfg.max_cg_iters)
        logdet_val = slq_logdet(matvec, N, None, Z.shape[0],
                                cfg.lanczos_steps, X.dtype, probes=Z)

    # ---- differentiable surrogates (detached solves, live kernel) ----
    # quad: value 2 y^T a - a^T K a ~= y^T K^-1 y; grad -a^T dK a
    quad_sur = 2.0 * torch.sum(err_t * alpha) - torch.sum(
        alpha * matvec(alpha))
    # logdet: value offset to the SLQ estimate; grad (1/P) sum w^T dK z
    tr_sur = torch.mean(torch.sum(W * matvec(Z), dim=1))
    logdet_sur = logdet_val + (tr_sur - tr_sur.detach())

    lml = (-0.5 * quad_sur - 0.5 * D * logdet_sur
           - 0.5 * N * D * math.log(2.0 * math.pi))
    return lml, IterAux(alpha=alpha, cg_steps=stats.steps, logdet=logdet_val,
                        probe_cg_steps=probe_stats.steps)


def iterative_loss(params: GPRParams, X, Y,
                   generator: Optional[torch.Generator] = None,
                   cfg: IterGPConfig = IterGPConfig(),
                   probes: Optional[torch.Tensor] = None):
    lml, aux = iterative_lml(params, X, Y, generator, cfg, probes)
    return -lml, aux


class IterPredictCache(NamedTuple):
    """Batch-independent prediction state: the CG solve and the Lanczos
    factor serve every prediction batch."""

    alpha: torch.Tensor  # [D, N] CG solution
    Rm: torch.Tensor     # [t, N] T^{-1/2} Q


@torch.no_grad()
def predict_prepare(params: GPRParams, X, Y,
                    cfg: IterGPConfig = IterGPConfig()) -> IterPredictCache:
    """The CG solve for the mean (at cg_tolerance / 100) and one
    reorthogonalized Lanczos run started at the training error."""
    N = Y.shape[0]
    err_t = (Y - mean_apply(params.mean, X)).T
    matvec = _operator(params, X)
    alpha, _ = _cg.preconditioned_cg(
        matvec, err_t, torch.zeros_like(err_t), _pc.IdentityPreconditioner(),
        max_error=cfg.cg_tolerance * 1e-2, max_iters=cfg.max_cg_iters)
    t = min(cfg.pred_lanczos_steps, N)
    alphas, betas, Qs = lanczos(matvec, err_t[:1], t, reorth=True)
    evals, evecs = torch.linalg.eigh(_tridiag(alphas[0], betas[0]))
    evals = torch.clamp(evals, min=1e-12)
    # R = T^{-1/2} Q: var(s) = kss - ||R ksf||^2
    Rm = (evecs / torch.sqrt(evals)[None, :]).T @ Qs[:, 0, :]
    return IterPredictCache(alpha=alpha, Rm=Rm)


@torch.no_grad()
def predict_from_cache(params: GPRParams, cache: IterPredictCache, X, Xnew
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-batch posterior: two cross products p -> p K(X, Xnew), streamed
    above DENSE_LIMIT training rows."""
    if X.shape[0] > DENSE_LIMIT:
        def cross(p):
            return _mv.kernel_cross_matvec(params.kernel, X, Xnew, p)
    else:
        Kfs = params.kernel.K(Xnew, X).T

        def cross(p):
            return p @ Kfs
    f_mean = cross(cache.alpha).T + mean_apply(params.mean, Xnew)  # [S, D]
    RK = cross(cache.Rm)  # [t, S]
    var = torch.clamp(params.kernel.kdiag(Xnew) - torch.sum(RK * RK, dim=0),
                      min=1e-12)
    return f_mean, var[:, None].expand(-1, cache.alpha.shape[0])


def predict_f_iterative(params: GPRParams, X, Y, Xnew,
                        cfg: IterGPConfig = IterGPConfig()
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean by CG; variance by rank-t Lanczos (LOVE-style)."""
    return predict_from_cache(params, predict_prepare(params, X, Y, cfg), X,
                              Xnew)


def iterative_predict_log_density(params: GPRParams, X, Y, Xnew, Ynew,
                                  cfg: IterGPConfig = IterGPConfig()):
    f_mean, f_var = predict_f_iterative(params, X, Y, Xnew, cfg)
    return predict_log_density(f_mean, f_var, params.noise_variance.value,
                               Ynew)
