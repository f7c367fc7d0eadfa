"""PyTorch port on the card: each CUDA kernel against its plain version at
small shapes, including the padded widths (D > 8, B not a power of two),
rectangular matvecs and the symmetric path (one prepared point set),
bitwise-equal repeat launches, kernel 1's gradient with respect to its
vector, the sharded loss over NCCL at world size 1, one evaluation of the
scipy bridge against the CPU, short CLI runs
that must launch all three, the grouped launches above 8 rows, and the
iterative exact GP with the L-BFGS optimizers.

Marked ``cuda``; skipped without a card.  This file imports neither jax nor
cglb_tpu, so it runs where they are absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from cglb_tpu_torch.ops import kernels as tk
from cglb_tpu_torch.ops import kuf as tkuf
from cglb_tpu_torch.ops import matvec as tmv

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.abs().max())


# Shapes on the kernels' edges: Nc not a multiple of a block's columns,
# Ni below one staged tile, several row segments, B in {3, 8}, D in {9, 32},
# rectangular both ways.
SHAPES = [(300, 300, 3, 1), (257, 131, 20, 3), (1000, 77, 8, 8),
          (50, 333, 8, 3), (2100, 129, 9, 8), (129, 2500, 32, 2),
          (5000, 4100, 8, 1), (700, 30, 32, 3)]


@pytest.mark.parametrize("family", ["mat32", "rbf"])
@pytest.mark.parametrize("nr,nc,d,b", SHAPES)
def test_matvec_and_ls_grad_kernels_match_plain(dev, family, nr, nc, d, b):
    rng = np.random.default_rng(0)
    ls = torch.tensor(rng.uniform(0.5, 2.0, size=d), device=dev)
    rows = tmv.Prepared(torch.tensor(rng.normal(size=(nr, d)), device=dev),
                        ls, family)
    cols = tmv.Prepared(torch.tensor(rng.normal(size=(nc, d)), device=dev),
                        ls, family)
    p = torch.tensor(rng.normal(size=(b, nr)), device=dev)
    g = torch.tensor(rng.normal(size=(b, nc)), device=dev)
    want = tmv.matvec_unit_plain(rows.xg, cols.xg, p, family)
    assert _rel(tmv.launch_matvec(rows, cols, p, True), want) < 3e-6
    assert _rel(tmv.launch_matvec(rows, cols, p, False), want) < 2e-3
    got = tmv.launch_ls_grad(rows, cols, p, g)
    want = tmv.ls_grad_unit_plain(rows.xg, cols.xg, p, g, family)
    assert _rel(got, want) < 1e-5


# one prepared point set: the symmetric path (each pair once)
SYMMETRIC_SHAPES = [(300, 3, 1), (50, 8, 3), (1000, 8, 8), (2100, 9, 2),
                    (129, 32, 4), (5000, 8, 1), (700, 32, 8)]


@pytest.mark.parametrize("family", ["mat32", "rbf"])
@pytest.mark.parametrize("n,d,b", SYMMETRIC_SHAPES)
def test_symmetric_matvec_and_ls_grad_kernels_match_plain(dev, family, n, d,
                                                          b):
    rng = np.random.default_rng(4)
    ls = torch.tensor(rng.uniform(0.5, 2.0, size=d), device=dev)
    rows = tmv.Prepared(torch.tensor(rng.normal(size=(n, d)), device=dev),
                        ls, family)
    p = torch.tensor(rng.normal(size=(b, n)), device=dev)
    g = torch.tensor(rng.normal(size=(b, n)), device=dev)
    want = tmv.matvec_unit_plain(rows.xg, rows.xg, p, family)
    assert _rel(tmv.launch_matvec(rows, rows, p, True), want) < 3e-6
    assert _rel(tmv.launch_matvec(rows, rows, p, False), want) < 2e-3
    got = tmv.launch_ls_grad(rows, rows, p, g)
    want = tmv.ls_grad_unit_plain(rows.xg, rows.xg, p, g, family)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("family", ["mat32", "rbf"])
@pytest.mark.parametrize("n,d,b", [(5000, 8, 1), (3000, 11, 3), (2100, 32, 8)])
def test_symmetric_matvec_in_slabs_matches_plain(dev, monkeypatch, family, n,
                                                 d, b):
    """Kernel 1's symmetric path with its row-sum budget cut so that the
    column blocks go out in at least 3 slabs: both tiers within their
    bounds of the plain version, repeat launches bitwise equal, one count
    per slab launch."""
    rng = np.random.default_rng(5)
    ls = torch.tensor(rng.uniform(0.5, 2.0, size=d), device=dev)
    rows = tmv.Prepared(torch.tensor(rng.normal(size=(n, d)), device=dev),
                        ls, family)
    p = torch.tensor(rng.normal(size=(b, n)), device=dev)
    want = tmv.matvec_unit_plain(rows.xg, rows.xg, p, family)
    monkeypatch.setattr(tmv, "ROW_PARTIAL_BYTES", 4 * tmv._bpad(b) * n)
    before = tmv.launch_matvec.launches
    got = tmv.launch_matvec(rows, rows, p, True)
    slabs = tmv.launch_matvec.launches - before
    assert slabs >= 3
    assert _rel(got, want) < 3e-6
    assert torch.equal(got, tmv.launch_matvec(rows, rows, p, True))
    cg = tmv.launch_matvec(rows, rows, p, False)
    assert _rel(cg, want) < 2e-3
    assert torch.equal(cg, tmv.launch_matvec(rows, rows, p, False))


@pytest.mark.parametrize("family", ["mat32", "rbf"])
@pytest.mark.parametrize("nr,nc,d,b", [(5000, 4100, 8, 1), (129, 2500, 32, 3),
                                       (5000, 0, 8, 1), (129, 0, 32, 3)])
def test_matvec_and_ls_grad_kernels_are_deterministic(dev, family, nr, nc, d,
                                                      b):
    """Two launches on the same inputs give bitwise-equal results (fixed
    summation order, no atomics), in both tiers and in kernel 2; nc = 0
    takes the symmetric path (columns are the rows)."""
    rng = np.random.default_rng(3)
    ls = torch.tensor(rng.uniform(0.5, 2.0, size=d), device=dev)
    rows = tmv.Prepared(torch.tensor(rng.normal(size=(nr, d)), device=dev),
                        ls, family)
    cols = rows if nc == 0 else tmv.Prepared(
        torch.tensor(rng.normal(size=(nc, d)), device=dev), ls, family)
    nc = cols.n
    p = torch.tensor(rng.normal(size=(b, nr)), device=dev)
    g = torch.tensor(rng.normal(size=(b, nc)), device=dev)
    for accurate in (True, False):
        assert torch.equal(tmv.launch_matvec(rows, cols, p, accurate),
                           tmv.launch_matvec(rows, cols, p, accurate))
    assert torch.equal(tmv.launch_ls_grad(rows, cols, p, g),
                       tmv.launch_ls_grad(rows, cols, p, g))


@pytest.mark.parametrize("family", ["mat32", "rbf"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("m,n,d", [(33, 70, 2), (64, 513, 17)])
def test_kuf_kernel_matches_plain(dev, family, dtype, tol, m, n, d):
    rng = np.random.default_rng(1)
    c = math.sqrt(tk.GAMMA[family])
    zg = torch.tensor(rng.normal(size=(m, d)) * c, device=dev, dtype=dtype)
    xg = torch.tensor(rng.normal(size=(n, d)) * c, device=dev, dtype=dtype)
    var = torch.tensor(1.3, device=dev, dtype=dtype)
    kuf, e = tkuf.launch_kuf(zg, xg, var, family)
    kuf_p, e_p = tkuf.kuf_unit_plain(zg, xg, var, family)
    assert _rel(kuf, kuf_p) < tol and _rel(e, e_p) < tol


def test_function_gradients_on_the_card_match_cpu(dev):
    """The streaming and Kuf Functions on the card against the same
    Functions on the CPU (plain versions)."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(400, 3))
    Z = rng.normal(size=(16, 3))
    p = rng.normal(size=(1, 400))
    grads = []
    for device in ("cpu", dev):
        kern = tk.make_kernel("Matern32", 3, variance=1.4,
                              lengthscales=[0.7, 1.1, 1.6],
                              dtype=torch.float64, device=device)
        Xt = torch.tensor(X, device=device)
        Zt = torch.tensor(Z, device=device, requires_grad=True)
        pt = torch.tensor(p, device=device, requires_grad=True)
        out = tmv.kernel_matvec(kern, Xt, pt)
        loss = (out * out).sum() + tkuf.kuf(kern, Zt, Xt).square().sum()
        loss.backward()
        grads.append([t.grad.cpu() for t in (pt, Zt, kern.variance.raw,
                                             kern.lengthscales.raw)])
    for cpu, gpu in zip(*grads):
        assert _rel(gpu, cpu) < 1e-5


def test_sharded_loss_on_the_card_matches_cpu(dev, monkeypatch):
    """NCCL at world size 1: the sharded streaming CGLB loss and gradients
    on the card (kernels 1-3 on the rank's columns, CG capped at 4) against
    the one-process loss on the CPU (plain versions)."""
    from cglb_tpu_torch.models import cglb as tc
    from cglb_tpu_torch.models import sgpr as ts
    from cglb_tpu_torch.parallel import mesh as tpm
    from cglb_tpu_torch.parallel import sharded as tsh

    rng = np.random.default_rng(4)
    X = rng.normal(size=(500, 3))
    Y = np.sin(X[:, :1]) + 0.1 * rng.normal(size=(500, 1))
    cfg = tc.CGLBConfig(max_error=1e-30, max_cg_iters=4,
                        precond_dtype="float64")

    def run(device, mesh):
        kern = tk.make_kernel("Matern32", 3, variance=1.3, lengthscales=0.9,
                              dtype=torch.float64, device=device)
        params = ts.SGPRParams(kern, X[:20], noise_variance=0.3,
                               dtype=torch.float64, device=device)
        Xt, Yt = (torch.tensor(a, device=device) for a in (X, Y))
        v0 = tc.init_v0(500, device=device)
        if mesh is None:
            loss, _ = tc.loss(params, Xt, Yt, v0, cfg)
        else:
            loss, _ = tsh.sharded_cglb_loss(params, Xt, Yt, v0, cfg, mesh,
                                            matvec="streaming")
        loss.backward()
        return loss.detach().cpu(), [q.raw.grad.cpu()
                                     for _, q in params.named_params()]

    monkeypatch.setenv("CGLB_COORDINATOR", f"localhost:{tpm.free_port()}")
    monkeypatch.setenv("CGLB_NUM_PROCESSES", "1")
    monkeypatch.setenv("CGLB_PROCESS_ID", "0")
    try:
        mesh = tpm.data_mesh(1, "cuda")
        assert mesh.backend == "nccl"
        got = run(dev, mesh)
    finally:
        tpm.shutdown()
    want = run("cpu", None)
    assert _rel(got[0], want[0]) < 1e-6
    for gpu, cpu in zip(got[1], want[1]):
        assert _rel(gpu, cpu) < 1e-5


def test_cli_on_the_card_launches_all_kernels(dev, tmp_path, monkeypatch):
    from cglb_tpu_torch.experiments import cli
    from cglb_tpu_torch.utils.serialization import load_json

    monkeypatch.setenv("CGLB_DATA_DIR", str(tmp_path / "no_data_here"))
    counters = (tmv.launch_matvec, tmv.launch_ls_grad, tkuf.launch_kuf)
    for fn in counters:
        fn.launches = 0
    cli.main(["-l", str(tmp_path), "--device", "cuda", "--matvec",
              "streaming", "train", "-n", "2", "-d", "synth_600x3", "-o",
              "adam_0.01", "cglb", "-m", "cglb", "-k", "Matern32", "-i", "cv",
              "-M", "16"])
    assert all(fn.launches > 0 for fn in counters)
    res = load_json(tmp_path / "results.json")
    assert np.isfinite(res["cg_lower_bound"])
    assert res["elbo"] <= res["titsias_upper_bound"]


@pytest.mark.parametrize("family", ["Matern32", "SquaredExponential"])
@pytest.mark.parametrize("n,d,b", [(1500, 8, 1), (700, 3, 2)])
def test_matvec_gradient_wrt_vector_matches_plain(dev, family, n, d, b):
    """dp of the streaming Function (one more symmetric launch of kernel 1,
    accurate tier) against the plain version g @ K^T, 3e-6 of max abs."""
    rng = np.random.default_rng(5)
    kern = tk.make_kernel(family, d, variance=1.4,
                          lengthscales=rng.uniform(0.5, 2.0, size=d),
                          dtype=torch.float64, device=dev)
    X = torch.tensor(rng.normal(size=(n, d)), device=dev)
    p = torch.tensor(rng.normal(size=(b, n)), device=dev, requires_grad=True)
    g = torch.tensor(rng.normal(size=(b, n)), device=dev)
    before = tmv.launch_matvec.launches
    out = tmv.kernel_matvec(kern, X, p)
    (dp,) = torch.autograd.grad(out, p, g)
    assert tmv.launch_matvec.launches == before + 2
    with torch.no_grad():
        want = g @ kern.K(X).T
    assert _rel(dp, want) < 3e-6


def test_scipy_feval_on_the_card_matches_cpu(dev):
    """One evaluation of the scipy bridge's objective (loss and flattened
    gradient of the streaming CGLB loss, v0 trained jointly so that dp
    runs) on the card against the plain versions on the CPU: loss to 1e-7,
    gradient to 1e-5 of its largest entry."""
    from cglb_tpu_torch.backend import Model
    from cglb_tpu_torch.models import cglb as tc
    from cglb_tpu_torch.models import sgpr as ts
    from cglb_tpu_torch.utils import flatten as tfl

    rng = np.random.default_rng(6)
    X = rng.normal(size=(900, 4))
    Y = np.sin(X[:, :1]) + 0.1 * rng.normal(size=(900, 1))
    v0 = 0.05 * rng.normal(size=(1, 900))
    out = []
    for device in ("cpu", dev):
        kern = tk.make_kernel("Matern32", 4, variance=1.2, lengthscales=0.9,
                              dtype=torch.float64, device=device)
        params = ts.SGPRParams(kern, X[:24], noise_variance=0.2,
                               dtype=torch.float64, device=device)
        model = Model("cglb", params,
                      (torch.tensor(X, device=device),
                       torch.tensor(Y, device=device)),
                      tc.CGLBConfig(joint_optimization=True),
                      matvec="streaming")
        with torch.no_grad():
            params.v0.raw.copy_(torch.tensor(v0))
        loss, _ = model.loss_fn()(params, model.carry_in())
        loss.backward()
        out.append((float(loss.detach()), tfl.flatten_grads_like(params)))
    (cl, cg), (gl, gg) = out
    assert abs(gl - cl) <= 1e-7 * abs(cl)
    assert np.abs(gg - cg).max() <= 1e-5 * np.abs(cg).max()


@pytest.mark.parametrize("optimizer,flags", [("scipy4", []),
                                             ("scipy_tol", []),
                                             ("scipy", ["--vjoint"])])
def test_scipy_cli_on_the_card(dev, tmp_path, monkeypatch, optimizer, flags):
    from cglb_tpu_torch.experiments import cli
    from cglb_tpu_torch.utils.serialization import load_json

    monkeypatch.setenv("CGLB_DATA_DIR", str(tmp_path / "no_data_here"))
    counters = (tmv.launch_matvec, tmv.launch_ls_grad, tkuf.launch_kuf)
    for fn in counters:
        fn.launches = 0
    cli.main(["-l", str(tmp_path), "--device", "cuda", "--matvec",
              "streaming", "train", "-n", "6", "-d", "synth_600x3", "-o",
              optimizer, "cglb", "-m", "cglb", "-k", "Matern32", "-i", "cv",
              "-M", "16"] + flags)
    assert all(fn.launches > 0 for fn in counters)
    res = load_json(tmp_path / "results.json")
    assert res["opt/num_iters"] == 6 and np.isfinite(res["loss"])
    assert res["elbo"] <= res["titsias_upper_bound"]


@pytest.mark.parametrize("family", ["mat32", "rbf"])
@pytest.mark.parametrize("nr,nc,d,b", [(1000, 0, 8, 10), (700, 0, 3, 64),
                                       (900, 400, 8, 64), (300, 1100, 9, 19)])
def test_grouped_launches_match_plain_and_repeat(dev, family, nr, nc, d, b):
    """Batches above one launch's 8 rows go out in groups (10 = 8 + 2, 19 =
    8 + 8 + 3, 64 = 8 x 8): kernel 1 concatenated, kernel 2 added in fp64,
    both within the single-launch bounds of the plain versions, one count a
    group, and bitwise equal when repeated; nc = 0 takes the symmetric
    path."""
    rng = np.random.default_rng(7)
    ls = torch.tensor(rng.uniform(0.5, 2.0, size=d), device=dev)
    rows = tmv.Prepared(torch.tensor(rng.normal(size=(nr, d)), device=dev),
                        ls, family)
    cols = rows if nc == 0 else tmv.Prepared(
        torch.tensor(rng.normal(size=(nc, d)), device=dev), ls, family)
    p = torch.tensor(rng.normal(size=(b, nr)), device=dev)
    g = torch.tensor(rng.normal(size=(b, cols.n)), device=dev)
    groups = -(-b // tmv.MAX_BATCH)
    before = tmv.launch_matvec.launches, tmv.launch_ls_grad.launches
    acc = tmv.launch_matvec(rows, cols, p, True)
    cg = tmv.launch_matvec(rows, cols, p, False)
    ls_grad = tmv.launch_ls_grad(rows, cols, p, g)
    assert tmv.launch_matvec.launches == before[0] + 2 * groups
    assert tmv.launch_ls_grad.launches == before[1] + groups
    want = tmv.matvec_unit_plain(rows.xg, cols.xg, p, family)
    assert acc.shape == (b, cols.n) and acc.dtype == torch.float64
    assert _rel(acc, want) < 3e-6 and _rel(cg, want) < 2e-3
    assert _rel(ls_grad, tmv.ls_grad_unit_plain(rows.xg, cols.xg, p, g,
                                                family)) < 1e-5
    assert torch.equal(acc, tmv.launch_matvec(rows, cols, p, True))
    assert torch.equal(ls_grad, tmv.launch_ls_grad(rows, cols, p, g))
    # a group equals the single launch of its rows
    assert torch.equal(acc[8:16] if b >= 16 else acc[8:],
                       tmv.launch_matvec(rows, cols, p[8:16], True))


def test_iterative_lml_on_the_card_matches_cpu(dev):
    """The streaming branch (N > 4096) of the iterative exact GP with 10
    shared probes: value and gradients on the card (kernels 1 and 2 in
    groups of 8 + 2, no dp launch) against the plain versions on the CPU:
    the value to 1e-6, the gradients to 1e-3 of their scale (the kernels
    take the solves' vectors in fp32, and 8 CG steps carry that into alpha
    and W, which the surrogate gradients are quadratic in)."""
    from cglb_tpu_torch.models import gpr as tg
    from cglb_tpu_torch.models import gpr_iterative as tit

    rng = np.random.default_rng(8)
    X = rng.normal(size=(4300, 3))
    Y = np.sin(X[:, :1]) + 0.1 * rng.normal(size=(4300, 1))
    Z = rng.choice([-1.0, 1.0], size=(10, 4300))
    cfg = tit.IterGPConfig(lanczos_steps=6, max_cg_iters=8)
    out = []
    for device in ("cpu", dev):
        kern = tk.make_kernel("Matern32", 3, variance=1.2, lengthscales=0.9,
                              dtype=torch.float64, device=device)
        params = tg.GPRParams(kern, noise_variance=0.5, dtype=torch.float64,
                              device=device)
        k1, k2 = tmv.launch_matvec.launches, tmv.launch_ls_grad.launches
        lml, aux = tit.iterative_lml(
            params, torch.tensor(X, device=device),
            torch.tensor(Y, device=device), cfg=cfg,
            probes=torch.tensor(Z, device=device))
        lml.backward()
        out.append((float(lml.detach()), aux,
                    [p.raw.grad.cpu() for _, p in params.named_params()]))
    k1 = tmv.launch_matvec.launches - k1
    k2 = tmv.launch_ls_grad.launches - k2
    (cl, caux, cgrads), (gl, gaux, ggrads) = out
    assert (gaux.cg_steps, gaux.probe_cg_steps) == (8, 8)
    # CG on err: init + 8 steps; on Z: 2 groups x (init + 8); Lanczos 2 x 6;
    # surrogates 1 + 2; the backward launches kernel 2 only, 1 + 2 groups
    assert k1 == 9 + 2 * 9 + 2 * 6 + 3 and k2 == 3
    assert abs(gl - cl) <= 1e-6 * abs(cl)
    for cpu, gpu in zip(cgrads, ggrads):
        assert _rel(gpu, cpu) < 1e-3


@pytest.mark.parametrize("optimizer,leaf", [
    ("staged", ["gpr", "-m", "exactgp", "-k", "Matern32"]),
    ("adam_0.01", ["gpr", "-m", "gpr", "-k", "Matern32"]),
    ("lbfgs", ["cglb", "-m", "cglb", "-k", "Matern32", "-i", "cv", "-M",
               "16"]),
    ("lbfgs_native", ["cglb", "-m", "cglb", "-k", "Matern32", "-i", "cv",
                      "-M", "16"]),
])
def test_exact_gp_and_lbfgs_cli_on_the_card(dev, tmp_path, monkeypatch,
                                            optimizer, leaf):
    from cglb_tpu_torch.experiments import cli
    from cglb_tpu_torch.models import gpr_iterative as tit
    from cglb_tpu_torch.utils.serialization import load_json

    monkeypatch.setenv("CGLB_DATA_DIR", str(tmp_path / "no_data_here"))
    monkeypatch.setattr(tit, "DENSE_LIMIT", 256)  # stream at N = 402
    tmv.launch_matvec.launches = tmv.launch_ls_grad.launches = 0
    cli.main(["-l", str(tmp_path), "--device", "cuda", "--matvec",
              "streaming", "train", "-n", "3", "-d", "synth_600x3", "-o",
              optimizer] + leaf)
    res = load_json(tmp_path / "results.json")
    assert all(np.isfinite(v) for v in res.values() if isinstance(v, float))
    streamed = leaf[2] != "gpr"  # the dense GP launches no kernel
    assert (tmv.launch_matvec.launches > 0) == streamed
    assert (tmv.launch_ls_grad.launches > 0) == streamed
