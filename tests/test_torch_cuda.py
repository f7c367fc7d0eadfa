"""PyTorch port on the card: each CUDA kernel against its plain version at
small shapes, including the padded widths (D > 8, B not a power of two)
and rectangular matvecs, and a short CLI run that must launch all three.

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


@pytest.mark.parametrize("family", ["mat32", "rbf"])
@pytest.mark.parametrize("nr,nc,d,b", [(300, 300, 3, 1), (257, 131, 20, 3),
                                       (1000, 77, 8, 8)])
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
