"""The program's ``cglb.*`` spans (``utils/profiling.py`` ``annotate``):
nothing without a profiler, and under one the span tree of an Adam step and
of a prediction request, with CG's host reads counted; numbers unchanged by
the profiler."""

import torch_threads  # noqa: F401  (the test processes' torch thread cap)
import json

import numpy as np
import pytest
import torch

from cglb_tpu_torch import configs as tcfgs
from cglb_tpu_torch.backend import Torch
from cglb_tpu_torch.experiments.datasets import get_dataset
from cglb_tpu_torch.utils import profiling as tprof
from cglb_tpu_torch.utils.training import adam_minimize


@pytest.fixture(scope="module")
def bundle():
    return get_dataset("synth_300x2", dtype=np.float64)


def _model(bundle):
    """CGLB at M 12 on the CPU (dense operator, fp32 preconditioner, CG to
    max_error 1: four steps from zero)."""
    cfg = tcfgs.CGLBConfig(tcfgs.Matern32Config(),
                           tcfgs.InducingVariableConfig(12))
    return Torch(device="cpu").create_model(cfg, bundle.train, seed=0)


def _tree(path):
    """The ``cglb.*`` spans of a Chrome trace as nested (name, children)."""
    events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events["traceEvents"]
    spans = sorted(((ev["ts"], ev["ts"] + ev["dur"], ev["name"])
                    for ev in events if ev.get("ph") == "X"
                    and ev.get("cat") == "user_annotation"
                    and ev["name"].startswith("cglb.")),
                   key=lambda s: (s[0], -s[1]))
    root = ("", [])
    stack = [(float("inf"), root)]
    for start, end, name in spans:
        while stack[-1][0] < end:
            stack.pop()
        node = (name, [])
        stack[-1][1][1].append(node)
        stack.append((end, node))
    return root[1]


def _reads(steps):
    return [("cglb.cg.read", [])] * (steps + 1)


def test_no_profiler_no_record_function(monkeypatch):
    def entered(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    assert not torch.autograd._profiler_enabled()
    off = tprof.annotate("cglb.step")
    assert off is tprof.annotate("cglb.cg.read")
    with off as value:
        assert value is None


def test_annotate_records_under_a_profiler(tmp_path):
    with tprof.trace(tmp_path, device="cpu") as prof:
        with tprof.annotate("cglb.x"):
            torch.ones(4) + 1
    assert _tree(prof.trace_path) == [("cglb.x", [])]


def test_adam_step_span_tree(bundle, tmp_path):
    model = _model(bundle)
    with tprof.trace(tmp_path, device="cpu") as prof:
        res = adam_minimize(model.loss_fn(), model.params, model.carry_in(),
                            1, 0.01)
    steps = res.state.cg_steps
    assert steps > 0
    assert _tree(prof.trace_path) == [("cglb.step", [
        ("cglb.common", [("cglb.chol.read", [])]),
        ("cglb.precond", []),
        ("cglb.cg", _reads(steps)),
        ("cglb.backward", []),
    ])]


@pytest.mark.parametrize("max_error", [1.0, 1e-3])
def test_cg_reads_are_steps_plus_one(bundle, tmp_path, max_error):
    """Each solve reads its stop test once in cg_init and once a step;
    cg_advance starts from the value cg_init read."""
    from cglb_tpu_torch.models import cglb as tc
    from cglb_tpu_torch.ops import cg as tcg

    model = _model(bundle)
    X, Y = model.data
    p = model.params
    with torch.no_grad():
        ct = tc._common_terms(p, X, model.run_cfg, None, None, False)
        P = tc._make_precond(ct, p.noise_variance.value, model.run_cfg)
        matvec = (lambda v: v @ p.kernel.K(X)
                  + p.noise_variance.value * v)
    with tprof.trace(tmp_path, device="cpu") as prof:
        _, stats = tcg.preconditioned_cg(matvec, Y.T, torch.zeros_like(Y.T),
                                         P, max_error, 100)
    assert stats.steps > 0
    assert _tree(prof.trace_path) == [("cglb.cg", _reads(stats.steps))]


def test_predict_span_tree(bundle, tmp_path):
    model = _model(bundle)
    model.default_predict_batch = lambda: 40
    rows = bundle.test[0].shape[0]
    with tprof.trace(tmp_path, device="cpu") as prof:
        model.predict_log_density(bundle.test)
    [(name, children)] = _tree(prof.trace_path)
    assert name == "cglb.predict"
    [(prep, inner)] = [c for c in children if c[0] == "cglb.predict.prepare"]
    assert [c for c in children if c[0] != prep] == (
        [("cglb.predict.project", [])] * -(-rows // 40))
    # the solve from v0 = 0 at 1e-6 with the fp32 preconditioner
    assert [c[0] for c in inner] == ["cglb.common", "cglb.precond",
                                     "cglb.cg"]
    reads = inner[2][1]
    assert len(reads) > 2 and reads == [("cglb.cg.read", [])] * len(reads)


def test_profiler_changes_no_number(bundle, tmp_path):
    """Loss, gradient and prediction with the profiler on equal those with
    it off, bit for bit."""
    model = _model(bundle)
    fn = model.loss_fn()

    def evaluate():
        model.params.zero_grad(set_to_none=True)
        loss, aux = fn(model.params, model.carry_in())
        loss.backward()
        grads = [q.grad.clone() for q in model.params.parameters()
                 if q.requires_grad]
        pred = model.predict_log_density(bundle.test)
        return [loss.detach(), aux.v, pred] + grads

    off = evaluate()
    with tprof.trace(tmp_path, device="cpu"):
        on = evaluate()
    assert len(on) == len(off) > 3
    for a, b in zip(on, off):
        assert torch.equal(a, b)
