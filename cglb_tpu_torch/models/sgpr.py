"""SGPR: parameters, common terms, Titsias ELBO and upper bound, prediction.

Counterpart of ``cglb_tpu/models/sgpr.py`` on its fp64 route
(``_kuf_terms``, :604-654):

    L  = chol(Kuu + jitter I)                [M, M]
    A  = L^-1 Kuf / sigma                    [M, N]
    B  = A A^T + I,  LB = chol(B)            [M, M]

Kuf comes from kernel 3 (ops/kuf.py).  Up to CHUNK_THRESHOLD_ELEMENTS
Kuf elements (kin40k: M = 2048, N = 26800, 439 MB in fp64) in one pass;
above, over column chunks (``_kuf_terms(chunk_size, remat)``, :139-213 of
the JAX module): each chunk's Kuf, A and partial products are formed and
dropped in turn, A A^T and A W are summed over the chunks in order, A is
kept only in the dtype its consumer asks for (the CGLB preconditioner's
fp32), and with ``remat`` the backward recomputes each chunk
(``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint`` on the
``lax.map`` body) instead of storing its Kuf, e and A.  ``kuf_weighted``
(:565-601) forms A @ W by chunks for the CGLB predictor.  The JAX package's
``mixed`` gram, df32 and int8 paths work around fp64 emulation on the TPU
and are not ported; the backend treats ``common_dtype="mixed"`` as fp64.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import config as _config
from ..ops import chol as _chol
from ..ops.kernels import k_columns
from ..ops.kuf import kuf as _kuf
from ..ops.kuf import kuf_of
from ..transforms import Param, ParamModule
from .gaussian import ConstantMean, mean_apply

__all__ = ["SGPRParams", "CommonTerms", "common_terms", "elbo", "elbo_n2m",
           "n2m_log_trace", "upper_bound", "SGPRPredictCache",
           "predict_prepare", "predict_from_cache", "predict_f",
           "kuf_weighted", "chunk_width", "CHUNK_THRESHOLD_ELEMENTS",
           "CHUNK_ELEMENTS"]

# Above this many Kuf elements (N x M) the common terms go by column chunks.
# Unchunked, a loss and its gradient hold about six [M, N] tensors at once
# (Kuf and kernel 3's residual e, the triangular solve's output A, the fp32
# copy for the preconditioner, their cotangents in the backward), some 50
# bytes an element: 13 GiB at 2^28 elements, which leaves an 80 GB card
# room for the rest.  kin40k at M 2048 (55M elements) stays in one pass;
# houseelectric at M 1024 (1.41G elements: 11.2 GB for one fp64 [M, N])
# is chunked.  (The JAX package's 32M threshold was set for a 16 GB TPU
# that emulates fp64 with [8, M, N] temporaries: it would chunk kin40k.)
CHUNK_THRESHOLD_ELEMENTS = 1 << 28
# Kuf elements of one chunk: a chunk's [M, width] fp64 blocks are 512 MiB,
# and its forward or its recompute in the backward holds a few of them.
CHUNK_ELEMENTS = 1 << 26


def _solve_lower(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


class SGPRParams(ParamModule):
    """Kernel, inducing points, noise variance and constant mean."""

    def __init__(self, kernel: nn.Module, Z, noise_variance: float = 1.0,
                 output_dim: int = 1, dtype: torch.dtype = None,
                 variance_lower: float = None,
                 trainable_inducing: bool = True, device=None):
        super().__init__()
        dtype = dtype or _config.torch_dtype()
        lower = (variance_lower if variance_lower is not None
                 else _config.positive_lower_bound(dtype))
        self.kernel = kernel
        self.inducing_Z = Param(torch.as_tensor(Z), dtype=dtype,
                                device=device, trainable=trainable_inducing)
        self.noise_variance = Param.positive(noise_variance, lower,
                                             dtype=dtype, device=device)
        self.mean = ConstantMean(output_dim, dtype=dtype, device=device)
        # the CG vector as a trainable Param when it is optimized jointly
        # with the parameters (set by the backend; registered last, as in
        # the JAX package's leaf order)
        self.v0 = None

    @property
    def num_inducing(self) -> int:
        return self.inducing_Z.raw.shape[0]


class CommonTerms(NamedTuple):
    A: torch.Tensor     # [M, N]  L^-1 Kuf / sigma
    AAT: torch.Tensor   # [M, M]
    B: torch.Tensor     # [M, M]  AAT + I
    LB: torch.Tensor    # [M, M]  chol(B)
    L: torch.Tensor     # [M, M]  chol(Kuu + jitter I)


def _jitter(jitter):
    return jitter if jitter is not None else _config.default_jitter()


def _kuu_chol(params: SGPRParams, jitter: float) -> torch.Tensor:
    """chol(Kuu + jitter I) with the 1000x-jitter retry (sgpr.py:106-123)."""
    Z = params.inducing_Z.value
    return _chol.chol_retry(params.kernel.K(Z), jitter)


def chunk_width(N: int, M: int, chunk_size: int = None):
    """Columns per chunk of the [M, N] common terms: ``chunk_size`` when
    given, else CHUNK_ELEMENTS / M above CHUNK_THRESHOLD_ELEMENTS; None for
    one unchunked pass."""
    if chunk_size is None and N * M > CHUNK_THRESHOLD_ELEMENTS:
        chunk_size = max(CHUNK_ELEMENTS // M, 1)
    if chunk_size is None or N <= chunk_size:
        return None
    return int(chunk_size)


def _chunks(N: int, width: int):
    return [(c0, min(c0 + width, N)) for c0 in range(0, N, width)]


def _kuf_terms(params: SGPRParams, L, X, sigma_scale, W=None,
               chunk_size: int = None, remat: bool = False, a_dtype=None,
               with_a: bool = True, mesh=None):
    """A = L^-1 Kuf / sigma_scale (None unless ``with_a``), A A^T and
    optionally A @ W.

    Over column chunks (:func:`chunk_width`): A A^T and A W summed over the
    chunks in order, A assembled from its chunks in ``a_dtype`` (default
    X's; one pass keeps X's); ``remat`` recomputes each chunk in the
    backward instead of storing its Kuf, e and A.  The last chunk is
    narrower where the width does not divide N.  A consumer that needs A in
    X's dtype after a chunked build reads it from :func:`kuf_weighted`.

    With ``mesh`` (a ``parallel.mesh.DataMesh``) each rank takes its block of
    X's and W's columns (chunked inside the block), A is the rank's columns
    and A A^T and A W are summed over the ranks
    (``cglb_tpu/parallel/sharded.py:73-129``)."""
    M = params.num_inducing
    kern = params.kernel
    Z, ls, var = (params.inducing_Z.value, kern.lengthscales.value,
                  kern.variance.value)
    if mesh is not None:
        c0, c1 = mesh.cols(X.shape[0])
        X = X[c0:c1]
        W = None if W is None else mesh.shard(W, 0)
        Z, ls, var, L, sigma_scale = (mesh.enter(t) for t in (
            Z, ls, var, L, sigma_scale))
    N = X.shape[0]
    width = chunk_width(N, M, chunk_size)
    a_dtype = X.dtype if width is None else (a_dtype or X.dtype)

    def terms(xc, wc):
        kuf = kuf_of(Z, ls, var, xc, kern.family)
        a = _solve_lower(L, kuf) / sigma_scale
        return (a.to(a_dtype) if with_a else None, a @ a.T,
                None if wc is None else a @ wc)

    if width is None:
        A, AAT, AW = terms(X, W)
    else:
        parts, AAT, AW = [], None, None
        for c0, c1 in _chunks(N, width):
            wc = None if W is None else W[c0:c1]
            if remat and torch.is_grad_enabled():
                a, aat, aw = checkpoint(terms, X[c0:c1], wc,
                                        use_reentrant=False)
            else:
                a, aat, aw = terms(X[c0:c1], wc)
            parts.append(a)
            AAT = aat if AAT is None else AAT + aat
            if W is not None:
                AW = aw if AW is None else AW + aw
        # column-major, as the one pass's triangular solve leaves A: the
        # fp32 products on it (the preconditioner's) then round as they do
        # there
        A = torch.cat([a.mT for a in parts]).mT if with_a else None
    if mesh is not None:
        AAT = mesh.reduce(AAT)
        AW = None if AW is None else mesh.reduce(AW)
    return A, AAT, AW


def kuf_weighted(params: SGPRParams, L, X, W, sigma_scale,
                 chunk_size: int = None, mesh=None) -> torch.Tensor:
    """A @ W = L^-1 (Kuf @ W) / sigma_scale by column chunks of Kuf (sums
    in chunk order), then one [M, D] solve: no [M, N] beyond a chunk's.
    With ``mesh``: over the rank's columns, Kuf @ W summed over the ranks
    (the predictor's, outside autograd)."""
    M = params.num_inducing
    Z = params.inducing_Z.value
    if mesh is not None:
        c0, c1 = mesh.cols(X.shape[0])
        X, W = X[c0:c1], mesh.shard(W, 0)
    N = X.shape[0]
    width = chunk_width(N, M, chunk_size) or N
    U = None
    for c0, c1 in _chunks(N, width):
        u = _kuf(params.kernel, Z, X[c0:c1]) @ W[c0:c1]
        U = u if U is None else U + u
    if mesh is not None:
        U = mesh.reduce(U)
    return _solve_lower(L, U) / sigma_scale


def common_terms(params: SGPRParams, X, jitter: float = None,
                 chunk_size: int = None, remat: bool = False,
                 a_dtype=None, mesh=None) -> CommonTerms:
    """Reference semantics: cglb/backend/tensorflow/models.py:58-75.
    ``chunk_size``, ``remat``, ``a_dtype`` and ``mesh`` as in
    :func:`_kuf_terms` (with a mesh, A is the rank's columns)."""
    jitter = _jitter(jitter)
    M = params.num_inducing
    sigma = torch.sqrt(params.noise_variance.value)
    L = _kuu_chol(params, jitter)
    A, AAT, _ = _kuf_terms(params, L, X, sigma, chunk_size=chunk_size,
                           remat=remat, a_dtype=a_dtype, mesh=mesh)
    B = AAT + torch.eye(M, dtype=X.dtype, device=X.device)
    LB = _chol.cholesky(B)
    return CommonTerms(A=A, AAT=AAT, B=B, LB=LB, L=L)


def elbo(params: SGPRParams, X, Y, jitter: float = None,
         mesh=None) -> torch.Tensor:
    """Titsias (2009) collapsed ELBO (``mesh``: A A^T and A err summed over
    the ranks' columns)."""
    jitter = _jitter(jitter)
    err = Y - mean_apply(params.mean, X)
    N, D = Y.shape
    M = params.num_inducing
    sigma_sq = params.noise_variance.value
    sigma = torch.sqrt(sigma_sq)
    L = _kuu_chol(params, jitter)
    _, AAT, Aerr = _kuf_terms(params, L, X, sigma, W=err, remat=True,
                              with_a=False, mesh=mesh)
    LB = _chol.cholesky(AAT + torch.eye(M, dtype=X.dtype, device=X.device))
    c = _solve_lower(LB, Aerr) / sigma

    bound = -0.5 * N * D * math.log(2.0 * math.pi)
    bound = bound - D * torch.sum(torch.log(torch.diagonal(LB)))
    bound = bound - 0.5 * N * D * torch.log(sigma_sq)
    bound = bound - 0.5 * torch.sum(torch.square(err)) / sigma_sq
    bound = bound + 0.5 * torch.sum(torch.square(c))
    # trace correction: -0.5 D (sum kdiag / sigma^2 - tr(AAT))
    kd = params.kernel.kdiag(X)
    bound = bound - 0.5 * D * (torch.sum(kd) / sigma_sq - torch.trace(AAT))
    return bound


def n2m_log_trace(params: SGPRParams, ct: CommonTerms, X,
                  mesh=None) -> torch.Tensor:
    """N log(tr(Q^-1 (K + s2 I)) / N) of the n2m variants, with
    C = LB^-1 A and tr(Q^-1 (K + s2 I)) = (tr(K + s2 I) - tr(C (K + s2 I)
    C^T)) / s2.  The s2 I part of both traces is added in closed form, so
    K + s2 I is not formed beside K.  With ``mesh`` (ct.A the rank's
    columns) each rank forms its columns of K and of C, and the traces are
    summed over the ranks."""
    N = X.shape[0]
    sigma_sq = params.noise_variance.value
    if mesh is None:
        K = params.kernel.K(X)
        C = _solve_lower(ct.LB, ct.A)
        trace_k = torch.trace(K)
        trace_ckc = torch.sum((C @ K) * C)
        trace_cc = torch.sum(C * C)
    else:
        c0, c1 = mesh.cols(N)
        kern = params.kernel
        Kc = k_columns(kern, X, c0, c1, mesh.enter(kern.lengthscales.value),
                       mesh.enter(kern.variance.value))
        Cc = _solve_lower(mesh.enter(ct.LB), ct.A)
        # all of C enters the rank's product C @ Kc
        C = mesh.enter(mesh.gather(Cc, N, 1))
        trace_k = mesh.reduce(torch.trace(Kc[c0:c1]))
        trace_ckc = mesh.reduce(torch.sum((C @ Kc) * Cc))
        trace_cc = mesh.reduce(torch.sum(Cc * Cc))
    trace_kff = trace_k + N * sigma_sq
    trace_qrest = trace_ckc + sigma_sq * trace_cc
    # trace_kff - trace_qrest >= N sigma^2 mathematically (K >= Q); clamped
    # at that minimum so that cancellation at large M can neither NaN the
    # log nor blow the N-scaled term up
    floor = N * sigma_sq
    return N * (torch.log(torch.maximum(trace_kff - trace_qrest, floor))
                - math.log(N) - torch.log(sigma_sq))


def elbo_n2m(params: SGPRParams, X, Y, jitter: float = None,
             mesh=None) -> torch.Tensor:
    """SGPRN2M: the SGPR bound with the trace term replaced by the N^2 M
    log-trace term -0.5 n log(tr(Q^-1 K)/n).  Materializes K(X, X): O(N^2)
    memory, an ablation (``mesh``: the rank's columns of it)."""
    ct = common_terms(params, X, jitter, mesh=mesh)
    err = Y - mean_apply(params.mean, X)
    N, D = Y.shape
    sigma_sq = params.noise_variance.value
    sigma = torch.sqrt(sigma_sq)
    Aerr = (ct.A @ err if mesh is None
            else mesh.reduce(ct.A @ mesh.shard(err, 0)))
    c = _solve_lower(ct.LB, Aerr) / sigma

    bound = -0.5 * N * D * math.log(2.0 * math.pi)
    bound = bound - D * torch.sum(torch.log(torch.diagonal(ct.LB)))
    bound = bound - 0.5 * N * D * torch.log(sigma_sq)
    bound = bound - 0.5 * torch.sum(torch.square(err)) / sigma_sq
    bound = bound + 0.5 * torch.sum(torch.square(c))
    return bound - 0.5 * n2m_log_trace(params, ct, X, mesh)


def upper_bound(params: SGPRParams, X, Y, jitter: float = None,
                mesh=None) -> torch.Tensor:
    """Titsias trace upper bound on the log marginal likelihood (``mesh``
    as in :func:`elbo`)."""
    jitter = _jitter(jitter)
    M = params.num_inducing
    N = X.shape[0]
    sigma_sq = params.noise_variance.value
    eye_m = torch.eye(M, dtype=X.dtype, device=X.device)
    err = Y - mean_apply(params.mean, X)
    one = torch.ones((), dtype=X.dtype, device=X.device)
    L = _kuu_chol(params, jitter)
    _, AAT0, A0err = _kuf_terms(params, L, X, one, W=err, remat=True,
                                with_a=False, mesh=mesh)
    LB = _chol.cholesky(eye_m + AAT0 / sigma_sq)
    # trace slack tr(Kff) - tr(Qff) >= 0, clamped against cancellation
    cslack = torch.clamp(
        torch.sum(params.kernel.kdiag(X)) - torch.trace(AAT0), min=0.0)
    corrected_noise = sigma_sq + cslack

    const = -0.5 * N * torch.log(2.0 * math.pi * sigma_sq)
    logdet = -torch.sum(torch.log(torch.diagonal(LB)))
    LC = _chol.cholesky(eye_m + AAT0 / corrected_noise)
    v = _solve_lower(LC, A0err / corrected_noise)
    quad = (-0.5 * torch.sum(torch.square(err)) / corrected_noise
            + 0.5 * torch.sum(torch.square(v)))
    return const + logdet + quad


class SGPRPredictCache(NamedTuple):
    c: torch.Tensor   # [M, D] LB^-1 (A @ err) / sigma
    L: torch.Tensor
    LB: torch.Tensor


@torch.no_grad()
def predict_prepare(params: SGPRParams, X, Y, jitter: float = None
                    ) -> SGPRPredictCache:
    """The batch-independent half of predict_f."""
    jitter = _jitter(jitter)
    err = Y - mean_apply(params.mean, X)
    sigma = torch.sqrt(params.noise_variance.value)
    M = params.num_inducing
    L = _kuu_chol(params, jitter)
    _, AAT, Aerr = _kuf_terms(params, L, X, sigma, W=err, with_a=False)
    LB = _chol.cholesky(AAT + torch.eye(M, dtype=X.dtype, device=X.device))
    c = _solve_lower(LB, Aerr) / sigma
    return SGPRPredictCache(c=c, L=L, LB=LB)


def _cache_solves(params: SGPRParams, cache, Xnew):
    """tmp1 = L^-1 Kus, tmp2 = LB^-1 tmp1 (Kus from kernel 3)."""
    Kus = _kuf(params.kernel, params.inducing_Z.value, Xnew)  # [M, S]
    tmp1 = _solve_lower(cache.L, Kus)
    tmp2 = _solve_lower(cache.LB, tmp1)
    return tmp1, tmp2


def _marginal_var(params: SGPRParams, Xnew, tmp1, tmp2, D: int):
    var = (params.kernel.kdiag(Xnew) + torch.sum(torch.square(tmp2), dim=0)
           - torch.sum(torch.square(tmp1), dim=0))
    return var[:, None].expand(-1, D)


@torch.no_grad()
def predict_from_cache(params: SGPRParams, cache: SGPRPredictCache, Xnew
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-batch SGPR posterior mean and marginal variance: O(S M^2)."""
    tmp1, tmp2 = _cache_solves(params, cache, Xnew)
    f_mean = tmp2.T @ cache.c + mean_apply(params.mean, Xnew)
    return f_mean, _marginal_var(params, Xnew, tmp1, tmp2, cache.c.shape[1])


def predict_f(params: SGPRParams, X, Y, Xnew, jitter: float = None):
    cache = predict_prepare(params, X, Y, jitter)
    return predict_from_cache(params, cache, Xnew)
