"""PyTorch port: the blocked lower solve (ops/chol.py ``solve_lower``)
against ``torch.linalg.solve_triangular``, on the CPU.

The internal routine runs at small block sizes here (the card's 256 rows
need M >= 512): forward and transposed solves, fp64 and fp32, its autograd
Function by ``gradcheck`` and against the builtin's gradients, the shape
rule, the counters, and the CGLB loss with the blocked path engaged against
the same call on the builtin.  L is the factor of a Matern32 Kuu plus a
1e-6 jitter: well conditioned at lengthscale 0.5 (kappa(Kuu) 50 at 100
points, 5e3 at 600), kappa(Kuu) about 1.8e6 at lengthscale 8."""

import torch_threads  # noqa: F401  (the test processes' torch thread cap)
import gc
import weakref

import numpy as np
import pytest
import torch

from cglb_tpu_torch.models import cglb as tc
from cglb_tpu_torch.models import sgpr as ts
from cglb_tpu_torch.ops import chol
from cglb_tpu_torch.ops import kernels as tk
from test_torch_models import _data, _params

KAPPA = {0.5: (10.0, 1e4), 8.0: (1e5, 1e7)}  # lengthscale: kappa(Kuu) range
RTOL = {0.5: 1e-12, 8.0: 1e-9}


def _factor(m, ls, dtype=torch.float64, seed=0):
    """chol(Kuu + 1e-6 I) of a Matern32 kernel on m points in 3-D."""
    rng = np.random.default_rng(seed)
    Z = torch.tensor(rng.normal(size=(m, 3)), dtype=dtype)
    kern = tk.make_kernel("Matern32", 3, variance=1.0, lengthscales=ls,
                          dtype=dtype)
    with torch.no_grad():
        K = kern.K(Z) + 1e-6 * torch.eye(m, dtype=dtype)
    lo, hi = KAPPA[ls]
    assert lo < float(torch.linalg.cond(K.double())) < hi
    return torch.linalg.cholesky(K)


def _rhs(m, k, layout, dtype=torch.float64, seed=1):
    g = torch.Generator().manual_seed(seed)
    if layout == "row-major":
        return torch.randn(m, k, generator=g, dtype=dtype)
    if layout == "column-major":
        return torch.randn(k, m, generator=g, dtype=dtype).T
    # every other column of a wider block: neither dimension has stride 1
    return torch.randn(m, 2 * k, generator=g, dtype=dtype)[:, ::2]


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("ls", [0.5, 8.0])
@pytest.mark.parametrize("m,block", [(96, 16), (100, 16), (100, 64)])
@pytest.mark.parametrize("k", [1, 3, 40, 300])
@pytest.mark.parametrize("transpose", [False, True])
def test_blocked_solve_matches_builtin(ls, m, block, k, transpose):
    """L^-1 B (and L^-T B) to 1e-12 relative on a well-conditioned L and to
    1e-9 at kappa(Kuu) about 1e6; M a multiple of the block and not (a
    short last block, and one of more than the inverses' 64-row base), K
    of 1, of D, and below and above the widths the card engages at scale;
    column-major like the builtin's result."""
    L = _factor(m, ls)
    B = _rhs(m, k, "row-major")
    got = chol._blocked_solve(L, B, block, transpose=transpose)
    want = torch.linalg.solve_triangular(L.T if transpose else L, B,
                                         upper=transpose)
    assert got.shape == (m, k) and got.stride() == (1, m)
    assert _rel(got, want) <= RTOL[ls]


@pytest.mark.parametrize("layout", ["row-major", "column-major", "strided"])
def test_blocked_solve_any_layout(layout):
    """B and L in any layout, B with no unit stride among them."""
    L = _factor(100, 0.5)
    B = _rhs(100, 40, layout)
    want = torch.linalg.solve_triangular(L, B, upper=False)
    for Lx in (L, L.T.contiguous().T, L.contiguous()):
        assert _rel(chol._blocked_solve(Lx, B, 16), want) <= 1e-12


def test_block_inverses():
    """The diagonal blocks' inverses, doubled from the 64-row base up to
    256 rows, against a trsm of each block against I."""
    L = _factor(600, 0.5)
    inv = chol._block_inverses(L, 2, 256)
    for i in range(2):
        blk = L[256 * i:256 * (i + 1), 256 * i:256 * (i + 1)]
        want = torch.linalg.solve_triangular(
            blk, torch.eye(256, dtype=L.dtype), upper=False)
        assert _rel(inv[i], want) <= 1e-13
        assert torch.equal(inv[i].triu(1), torch.zeros_like(inv[i]))


def test_fp32_stays_fp32():
    """fp32 inputs give an fp32 result, within fp32 rounding of the
    fp64 solve."""
    L = _factor(100, 0.5)
    B = _rhs(100, 40, "row-major")
    got = chol._blocked_solve(L.float(), B.float(), 16)
    assert got.dtype == torch.float32
    want = torch.linalg.solve_triangular(L, B, upper=False)
    assert _rel(got.double(), want) <= 1e-5
    builtin = torch.linalg.solve_triangular(L.float(), B.float(), upper=False)
    assert _rel(got, builtin) <= 1e-5


def test_gradcheck():
    """The Function's dL and dB by finite differences in fp64."""
    L = _factor(100, 0.5)[:13, :13].clone().requires_grad_()
    B = _rhs(13, 4, "row-major").requires_grad_()
    assert torch.autograd.gradcheck(
        lambda L, B: chol._BlockedLowerSolve.apply(L, B, 4), (L, B))


@pytest.mark.parametrize("ls", [0.5, 8.0])
def test_gradients_match_builtin(ls):
    """dL (lower triangle) and dB against the builtin's backward, at the
    relative tolerances of the forward."""
    L0 = _factor(100, ls)
    B0 = _rhs(100, 40, "row-major")
    G = _rhs(100, 40, "column-major", seed=2)
    grads = []
    for solve in (lambda L, B: chol._BlockedLowerSolve.apply(L, B, 16),
                  lambda L, B: torch.linalg.solve_triangular(L, B,
                                                             upper=False)):
        L, B = L0.clone().requires_grad_(), B0.clone().requires_grad_()
        grads.append(torch.autograd.grad(solve(L, B), (L, B), G))
    (gL, gB), (wL, wB) = grads
    assert torch.equal(gL.triu(1), torch.zeros_like(gL))
    assert _rel(gL, wL) <= RTOL[ls] and _rel(gB, wB) <= RTOL[ls]


@pytest.mark.parametrize("grad", [False, True])
def test_result_freed_without_the_cycle_collector(grad):
    """The result (and the buffer it views) goes with its last reference,
    with or without a graph: no reference cycle holds an [M, K] until the
    cycle collector runs (the card would hold one a step until then)."""
    L = _factor(100, 0.5).requires_grad_(grad)
    B = _rhs(100, 40, "row-major").requires_grad_(grad)
    gc.disable()
    try:
        with torch.set_grad_enabled(grad):
            X = chol._BlockedLowerSolve.apply(L, B, 16)
        refs = [weakref.ref(X), weakref.ref(X._base)]
        if grad:
            torch.autograd.grad(X.sum(), (L, B))
        del X
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def test_gradient_of_b_alone():
    """With only B requiring a gradient, dB as the builtin gives it."""
    L = _factor(100, 0.5)
    B = _rhs(100, 40, "row-major").requires_grad_()
    G = _rhs(100, 40, "row-major", seed=2)
    (gB,) = torch.autograd.grad(chol._BlockedLowerSolve.apply(L, B, 16), B,
                                G)
    want = torch.linalg.solve_triangular(L.T, G, upper=True)
    assert _rel(gB, want) <= 1e-12


@pytest.mark.parametrize("l_shape,b_shape,block", [
    ((2048, 2048), (2048, 26800), 256),
    ((2048, 2048), (2048, 13200), 256),
    ((2048, 2048), (2048, 6144), 256),
    ((512, 512), (512, 6144), 256),
    ((2048, 2048), (2048, 6143), None),
    ((2048, 2048), (2048, 4096), None),
    ((2048, 2048), (2048, 1), None),
    ((2048, 2048), (2048, 8), None),
    ((511, 511), (511, 26800), None),
    ((3, 2048, 2048), (3, 2048, 26800), None),
    ((2048, 2048), (2048,), None)])
def test_shape_rule(l_shape, b_shape, block):
    """Blocked at M >= 2 blocks and K >= SOLVE_MIN_WIDTH; the builtin for
    vectors, narrow B, small M and batches.  The rule reads shapes only."""
    L = torch.empty(l_shape, device="meta")
    B = torch.empty(b_shape, device="meta")
    assert (chol.SOLVE_BLOCK, chol.SOLVE_MIN_WIDTH) == (256, 6144)
    assert chol._solve_block(L, B) == block


@pytest.fixture()
def small_blocks(monkeypatch):
    """The blocked path engaged at CPU sizes: blocks of 8 rows from 64
    columns."""
    monkeypatch.setattr(chol, "SOLVE_BLOCK", 8)
    monkeypatch.setattr(chol, "SOLVE_MIN_WIDTH", 64)


def _counts():
    return (chol.solve_lower.calls, chol.solve_lower.blocked_calls,
            chol.solve_lower.blocked_backward_calls)


def test_counters(rng, small_blocks):
    """The common terms' A at an engaging shape: one blocked solve forward
    and one backward.  A vector solve and kuf_weighted's [M, D] solve go to
    the builtin and add only to ``calls``."""
    X, _, Z = _data(rng, n=200, m=24)
    _, tp = _params("Matern32", X, Z)
    Xt = torch.tensor(X)
    L = ts._kuu_chol(tp, 1e-6)
    before = _counts()
    A, _, _ = ts._kuf_terms(tp, L, Xt, 0.7)
    assert np.subtract(_counts(), before).tolist() == [1, 1, 0]
    A.sum().backward()
    assert np.subtract(_counts(), before).tolist() == [1, 1, 1]

    before = _counts()
    with torch.no_grad():
        chol.solve_lower(L, torch.ones(24, 1, dtype=L.dtype))
        ts.kuf_weighted(tp, L, Xt, torch.ones(200, 2, dtype=L.dtype), 0.7)
    assert np.subtract(_counts(), before).tolist() == [2, 0, 0]


@pytest.mark.parametrize("family", ["Matern32", "SquaredExponential"])
def test_cglb_loss_blocked_matches_builtin(rng, monkeypatch, family):
    """The CGLB loss and its gradient with A = L^-1 Kuf / sigma and its
    backward blocked, against the same call on the builtin, both at one
    converged v (CG takes no step): 1e-9 relative on the loss, 1e-7 of the
    largest entry on each gradient."""
    X, Y, Z = _data(rng, n=300, m=40)
    Xt, Yt = torch.tensor(X), torch.tensor(Y)
    _, tp = _params(family, X, Z)
    tight = tc.CGLBConfig(max_error=1e-14, max_cg_iters=1000,
                          precond_dtype="float64")
    with torch.no_grad():
        _, aux = tc.loss(tp, Xt, Yt, tc.init_v0(300), tight)
    cfg = tc.CGLBConfig(max_error=1e30, precond_dtype="float64")
    results = []
    for block, width in ((8, 64), (chol.SOLVE_BLOCK, chol.SOLVE_MIN_WIDTH)):
        monkeypatch.setattr(chol, "SOLVE_BLOCK", block)
        monkeypatch.setattr(chol, "SOLVE_MIN_WIDTH", width)
        _, tp = _params(family, X, Z)
        before = chol.solve_lower.blocked_backward_calls
        loss, taux = tc.loss(tp, Xt, Yt, aux.v, cfg)
        loss.backward()
        assert taux.cg_steps == 0
        results.append((float(loss.detach()),
                        {n: p.raw.grad.clone() for n, p in tp.named_params()},
                        chol.solve_lower.blocked_backward_calls - before))
    (got, ggot, nblocked), (want, gwant, nbuiltin) = results
    assert (nblocked, nbuiltin) == (1, 0)
    np.testing.assert_allclose(got, want, rtol=1e-9)
    for name, w in gwant.items():
        np.testing.assert_allclose(ggot[name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-7 * float(w.abs().max()),
                                   err_msg=name)
