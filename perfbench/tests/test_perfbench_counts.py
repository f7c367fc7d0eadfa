"""The frozen operation and byte counts against the values PERF.md records
for the kin40k shapes (N 26800, D 8, M 2048)."""

import pytest

from perfbench import counts


def test_kernel_3_bound_is_its_bytes():
    ms, by = counts.kuf_bound(2048, 26800, 8)
    assert by == "bytes"
    assert ms == pytest.approx(0.2627, abs=5e-5)
    assert counts.kuf_bound(13200, 13200, 8, with_e=False)[0] == \
        pytest.approx(0.4166, abs=5e-5)


def test_kernel_1_bounds():
    ms, by = counts.matvec_bound(26800, 26800, 8, 1, True, symmetric=True)
    assert by == "operations"
    assert ms == pytest.approx(0.1715, abs=5e-5)
    assert counts.matvec_bound(26800, 26800, 8, 1, True)[0] == \
        pytest.approx(0.3216, abs=5e-5)


def test_kernel_2_bound():
    assert counts.ls_grad_bound(26800, 26800, 8, 1, symmetric=True)[0] == \
        pytest.approx(0.2573, abs=5e-5)


def test_calls_dispatch_to_their_bounds():
    mv = counts.KernelCall("matvec", 26800, 26800, 8, 1, True, True)
    lg = counts.KernelCall("ls_grad", 26800, 26800, 8, 1, True, True)
    kf = counts.KernelCall("kuf", 2048, 26800, 8)
    assert counts.call_bound_ms(mv) == counts.matvec_bound(
        26800, 26800, 8, 1, True, True)[0]
    assert counts.call_bound_ms(lg) == counts.ls_grad_bound(
        26800, 26800, 8, 1, True)[0]
    assert counts.call_bound_ms(kf) == counts.kuf_bound(2048, 26800, 8)[0]
    assert counts.kernel_flops([mv, kf]) == (
        counts.matvec_flops(26800, 26800, 8, 1, True)
        + counts.kuf_flops(2048, 26800, 8))


def test_dense_counts_grow_with_their_work():
    base = counts.cglb_step_dense_flops(26800, 2048, 3)
    assert 0.9e12 < base < 1.3e12  # about ten M^2 N products
    assert counts.cglb_step_dense_flops(26800, 2048, 4) > base
    one = counts.cglb_predict_dense_flops(26800, 2048, 1, 12)
    assert counts.cglb_predict_dense_flops(26800, 2048, 1001, 12) == \
        pytest.approx(one + 1000 * (2 * 2048 ** 2 + 2 * 2048))
