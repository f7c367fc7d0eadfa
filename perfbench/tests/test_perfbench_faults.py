"""``correct`` comes out false with the timed path broken underneath (each
fault a cell can have), and with the program on its fp32 path (the
control), on the CPU at the tiny size; on the card at the cells' own size
(``-m cuda``)."""

import time

import pytest
import torch

from perfbench import faults, harness, spec
from perfbench.control import control_numbers

CPU = torch.device("cpu")
CELL_FAULTS = [("cglb-tiny.adam", "state_unchanged"),
               ("cglb-tiny.adam", "half_batch"),
               ("cglb-tiny.predict", "mean_altered"),
               ("cglb-tiny.predict", "answer_altered"),
               ("cglb-tiny.predict-rate", "mean_altered"),
               ("cglb-tiny.predict-rate", "answer_altered")]


def _run(cell, device, seed=11, seconds=0.3):
    return harness.run_cell(cell, seed, seconds, False, device,
                            time.perf_counter())


@pytest.mark.parametrize("name,fault", CELL_FAULTS)
def test_a_fault_is_not_correct(tiny_root, name, fault):
    cell = spec.find_cell(name, tiny_root)
    with faults.FAULTS[fault]():
        out = _run(cell, CPU)
    assert out["correct"] is False
    assert _run(cell, CPU)["correct"] is True


def test_a_fault_in_the_window_alone_is_not_correct(tiny_root, monkeypatch):
    """Set-up's steps sound, the window's steps leaving the state
    unchanged: the compared steps reach into the window."""
    cell = spec.find_cell("cglb-tiny.adam", tiny_root)
    warm = int(cell.traffic["warmup_steps"])
    step, calls = torch.optim.Adam.step, []

    def late(self, closure=None):
        calls.append(1)
        return step(self, closure) if len(calls) <= warm else None

    monkeypatch.setattr(torch.optim.Adam, "step", late)
    out = _run(cell, CPU)
    assert len(calls) > warm
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("name", ["cglb-tiny.adam", "cglb-tiny.predict",
                                  "cglb-tiny.predict-rate"])
def test_the_control_is_not_correct(tiny_root, name):
    cell = spec.find_cell(name, tiny_root)
    numbers = control_numbers(cell, 11, CPU, 0.3)
    assert any(numbers[k] > v for k, v in cell.limits.items()), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cglb-kin40k.adam", "cglb-kin40k.predict",
                                  "cglb-kin40k.predict-rate"])
def test_the_control_is_not_correct_on_the_card(cuda_device, name):
    cell = spec.find_cell(name)
    for seed in (3700000001, 3700000002, 3700000003):
        numbers = control_numbers(cell, seed, cuda_device, 3.0)
        assert any(numbers[k] > v for k, v in cell.limits.items()), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cglb-kin40k.adam", "cglb-kin40k.predict",
                                  "cglb-kin40k.predict-rate"])
def test_a_short_run_on_the_card_is_correct(cuda_device, name):
    out = _run(spec.find_cell(name), cuda_device, 3700000004, 2.0)
    assert out["correct"] is True, out["checks"]
