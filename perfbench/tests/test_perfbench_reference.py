"""The plain references against closed forms at a tiny size (CPU)."""

import math

import numpy as np
import pytest
import torch

from perfbench.reference import cglb as ref_cglb
from perfbench.reference import common

torch.set_default_dtype(torch.float64)
CFG = {"positive_lower": 1e-6, "jitter": 1e-6, "precond_dtype": "float64",
       "max_error": 1e-12, "max_cg_iters": 500, "restart_cg_iters": 40}


def _data(n=60, d=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    X = torch.randn(n, d, generator=g)
    Y = torch.sin(X.sum(1, keepdim=True)) + 0.1 * torch.randn(n, 1,
                                                               generator=g)
    return X, Y


def _values(X, m=None):
    Z = X if m is None else X[:m]
    return {".kernel.variance": np.array(0.8),
            ".kernel.lengthscales": np.array([1.3, 0.9, 1.1]),
            ".inducing_Z": Z.numpy().copy(),
            ".noise_variance": np.array(0.05), ".mean.c": np.array([0.2])}


def _exact_nll(values, X, Y):
    v = {k: torch.as_tensor(a) for k, a in values.items()}
    K = common.dense_ky(X, v[".kernel.variance"], v[".kernel.lengthscales"],
                        v[".noise_variance"])
    L = torch.linalg.cholesky(K)
    err = Y - v[".mean.c"]
    alpha = torch.cholesky_solve(err, L)
    return float(0.5 * (err * alpha).sum() + torch.log(torch.diagonal(L)).sum()
                 + 0.5 * len(X) * math.log(2 * math.pi))


def test_matern32_closed_form():
    a, b = torch.tensor([[0.0, 0.0]]), torch.tensor([[3.0, 4.0]])
    ls = torch.tensor([1.0, 2.0])
    r = math.sqrt(9 + 4)
    want = 0.7 * (1 + math.sqrt(3) * r) * math.exp(-math.sqrt(3) * r)
    assert float(common.matern32(a, b, 0.7, ls)) == pytest.approx(want,
                                                                  rel=1e-12)
    X, _ = _data()
    K = common.dense_ky(X, 0.7, ls.repeat(2)[:3], 0.1, block=7)
    assert torch.allclose(K, K.T, atol=1e-14)
    assert torch.allclose(torch.diagonal(K), torch.full((60,), 0.8))


def test_pcg_solves_and_stops_at_its_cap():
    X, Y = _data()
    K = common.dense_ky(X, 1.0, torch.ones(3), 0.1)

    def identity(r):
        return r, torch.sum(r * r, 1)

    zero = torch.zeros_like(Y.T)
    v, _, _ = ref_cglb.pcg(lambda p: p @ K, identity, Y.T, zero, 1e-20,
                           1000, 40)
    assert torch.allclose(v.T, torch.linalg.solve(K, Y), atol=1e-9)
    _, steps, _ = ref_cglb.pcg(lambda p: p @ K, identity, Y.T, zero, 1e-20,
                               7, 40)
    assert steps == 7


def test_cglb_at_z_equal_x_is_the_exact_gp():
    """With every row an inducing point Q = K, so the Jensen log-det bound
    is log|K + s2 I| and, at a converged v, the loss is the exact negative
    log marginal likelihood (the jitter, 1e-10 here, aside); its gradient
    matches finite differences."""
    X, Y = _data()
    values = _values(X)
    raw = ref_cglb.raw_leaves(values, 1e-6, torch.float64, "cpu")
    v0 = torch.zeros(1, len(X))
    cfg = dict(CFG, jitter=1e-10)
    loss, grad, _ = ref_cglb.loss_and_grad(raw, X, Y, v0, cfg, block=16)
    assert loss == pytest.approx(_exact_nll(values, X, Y), rel=1e-6)
    for k in (".kernel.variance", ".noise_variance", ".mean.c"):
        h = 1e-6
        up = {kk: t.clone() for kk, t in raw.items()}
        up[k] = up[k] + h
        dn = {kk: t.clone() for kk, t in raw.items()}
        dn[k] = dn[k] - h
        fd = (ref_cglb.loss_and_grad(up, X, Y, v0, cfg)[0]
              - ref_cglb.loss_and_grad(dn, X, Y, v0, cfg)[0]) / (2 * h)
        assert float(grad[k].sum()) == pytest.approx(fd, rel=1e-4, abs=1e-6)


def test_cglb_prediction_at_z_equal_x_is_the_exact_gp():
    X, Y = _data()
    Xs, Ys = _data(n=25, seed=1)
    values = _values(X)
    mean, var, logdens = ref_cglb.predict(values, X, Y, Xs, Ys,
                                          dict(CFG, precond_dtype="float32"),
                                          1e-12)
    v = {k: torch.as_tensor(a) for k, a in values.items()}
    K = common.dense_ky(X, v[".kernel.variance"], v[".kernel.lengthscales"],
                        v[".noise_variance"])
    Ks = common.matern32(Xs, X, v[".kernel.variance"],
                         v[".kernel.lengthscales"])
    want_mean = Ks @ torch.linalg.solve(K, Y - v[".mean.c"]) + v[".mean.c"]
    want_var = v[".kernel.variance"] - torch.sum(
        Ks * torch.linalg.solve(K, Ks.T).T, 1)
    assert torch.allclose(mean, want_mean[:, 0], atol=1e-8)
    assert torch.allclose(var, want_var, atol=1e-5)  # jitter 1e-6 in Kuu
    tot = want_var + v[".noise_variance"]
    want_ld = -0.5 * (math.log(2 * math.pi) + torch.log(tot)
                      + (Ys[:, 0] - want_mean[:, 0]) ** 2 / tot)
    assert torch.allclose(logdens, want_ld, atol=1e-4)


def test_adam_matches_torch_adam():
    w0 = torch.tensor([1.0, -2.0, 0.5])

    def loss_grad(raw, k):
        w = raw["w"]
        return float((w ** 2).sum()), {"w": 2 * w + k}

    losses, g0, after = common.adam_steps({"w": w0}, loss_grad, 3, 0.1)
    w = w0.clone().requires_grad_(True)
    opt = torch.optim.Adam([w], lr=0.1)
    for k in range(3):
        opt.zero_grad()
        w.grad = (2 * w + k).detach()
        opt.step()
    assert torch.allclose(after["w"], w.detach(), atol=1e-15)
    assert torch.equal(g0["w"], 2 * w0)
