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


# the streamed reference (reference/cglb_streamed.py) against the dense one,
# at blocks and chunks smaller than N, with CG held to six steps so that
# both take the same steps
STREAMED_CFG = dict(CFG, max_error=1e-30, max_cg_iters=6)
_RANK = """
import sys, torch, torch.distributed as dist
sys.path.insert(0, {root!r})
from perfbench.reference import cglb_streamed as s
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="tcp://localhost:{port}",
                        world_size=2, rank=rank)
c = torch.load({case!r})
loss, grad, v = s.loss_and_grad(c["raw"], c["X"], c["Y"], c["v0"], c["cfg"],
                                block=32, chunk=40)
pred = s.predict(c["values"], c["X"], c["Y"], c["Xs"], c["Ys"], c["cfg"],
                 1e-30, block=32, chunk=40)
torch.save({{"loss": loss, "grad": grad, "v": v, "pred": pred}},
           {out!r} + str(rank))
dist.destroy_process_group()
"""


def _streamed_case():
    X, Y = _data(n=150)
    Xs, Ys = _data(n=70, seed=1)
    values = {k: torch.as_tensor(a) for k, a in _values(X, m=20).items()}
    raw = ref_cglb.raw_leaves(values, 1e-6, torch.float64, "cpu")
    return dict(X=X, Y=Y, Xs=Xs, Ys=Ys, values=values, raw=raw,
                v0=torch.zeros(1, len(X)), cfg=STREAMED_CFG)


def _streamed_on_two_ranks(case, tmp_path):
    import socket
    import subprocess
    import sys
    from pathlib import Path

    torch.save(case, tmp_path / "case.pt")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    code = _RANK.format(root=str(Path(__file__).resolve().parents[2]),
                        port=port, case=str(tmp_path / "case.pt"),
                        out=str(tmp_path / "out"))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)])
             for r in range(2)]
    try:
        assert [p.wait(timeout=120) for p in procs] == [0, 0]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    outs = [torch.load(tmp_path / f"out{r}") for r in range(2)]
    # the same bits on every rank
    assert outs[0]["loss"] == outs[1]["loss"]
    for a, b in zip(outs[0]["pred"], outs[1]["pred"]):
        assert torch.equal(a, b)
    for k in outs[0]["grad"]:
        assert torch.equal(outs[0]["grad"][k], outs[1]["grad"][k])
    o = outs[0]
    return o["loss"], o["grad"], o["v"], o["pred"]


@pytest.mark.parametrize("ranks", [1, 2])
def test_streamed_equals_dense(ranks, tmp_path):
    from perfbench.reference import cglb_streamed

    c = _streamed_case()
    loss, grad, v = ref_cglb.loss_and_grad(c["raw"], c["X"], c["Y"], c["v0"],
                                           c["cfg"], block=16)
    pred = ref_cglb.predict(c["values"], c["X"], c["Y"], c["Xs"], c["Ys"],
                            c["cfg"], 1e-30)
    if ranks == 1:
        s_loss, s_grad, s_v = cglb_streamed.loss_and_grad(
            c["raw"], c["X"], c["Y"], c["v0"], c["cfg"], block=32, chunk=40)
        s_pred = cglb_streamed.predict(c["values"], c["X"], c["Y"], c["Xs"],
                                       c["Ys"], c["cfg"], 1e-30, block=32,
                                       chunk=40)
    else:
        s_loss, s_grad, s_v, s_pred = _streamed_on_two_ranks(c, tmp_path)
    assert abs(s_loss - loss) <= 1e-12 * abs(loss)
    median = float(np.median([float(g.norm()) for g in grad.values()]))
    for k in grad:  # compare.py's measure: the leaf or the median leaf
        gap = float((s_grad[k] - grad[k]).norm())
        assert gap <= 1e-12 * max(float(grad[k].norm()), median), k
    assert float((s_v - v).norm()) <= 1e-12 * float(v.norm())
    for a, b in zip(s_pred, pred):  # mean, variance, log density
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name,precond,share", [
    ("cglb-kin40k.adam", "float64", 100), ("cglb-kin40k.adam", None, 4),
    ("cglb-kin40k.predict", None, 100)])
def test_streamed_equals_dense_on_the_card(cuda_device, name, precond, share):
    """At kin40k's configuration, the streamed reference held to the dense
    one by the cell's own comparison: every number within ``1 / share`` of
    its limit (predict-rate has predict's reference and limits).  Training
    with the configured fp32 preconditioner is held to a quarter: r's fp32
    roundings flip under any other order of K's sums, and two dense runs
    that differ only so read up to a ninth of ``change_gap``'s limit apart
    (PERF.md); with an fp64 preconditioner, to a hundredth."""
    import sys
    import time

    from perfbench import compare, drive, harness, spec

    cell = spec.find_cell(name)
    cfg, mix = cell.config, cell.traffic
    if precond:
        cfg = dict(cfg, precond_dtype=precond)
    streamed = dict(cfg, reference="cglb_streamed")
    values = drive.start_values(cfg)
    for seed in (3700000005, 3700000006):
        train, test = harness._data(cfg, seed)
        refs, took = [], []
        for c in (streamed, cfg):
            t0 = time.perf_counter()
            refs.append(harness.reference_training(
                c, mix, train, cuda_device, values) if mix["kind"] == "adam"
                else harness.reference_prediction(
                    c, mix, train, test, cuda_device, values))
            took.append(time.perf_counter() - t0)
        if mix["kind"] == "adam":
            numbers = compare.training_numbers(*refs[0], *refs[1])
        else:
            numbers = compare.prediction_numbers(
                [np.arange(len(test[0]))], *([x] for x in refs[0]), *refs[1])
        print(f"{name} {precond or cfg['precond_dtype']} {seed}: streamed "
              f"{took[0]:.2f} s, dense {took[1]:.2f} s, numbers {numbers}",
              file=sys.stderr)
        for k, limit in cell.limits.items():
            assert numbers[k] <= limit / share, (k, numbers[k], limit)
