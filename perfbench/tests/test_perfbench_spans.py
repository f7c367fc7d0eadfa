"""The span readers (``perfbench/spans.py``) on a small synthetic Chrome
trace: device time goes to the span open at its launch on any thread, idle
time to the span open at the gap's start; each reader's None cases."""

from types import SimpleNamespace

import pytest
import torch

from perfbench import spans, spec

NEW = {"adam": ["common_ms.train", "precond_ms.train", "backward_ms.train",
                "cg_ms.train", "read_wait_ms.train", "host_reads.train"],
       "predict": [f"{m}.{s}" for s in ("predict", "serve")
                   for m in ("cg_ms", "prepare_ms", "project_ms",
                             "read_wait_ms", "host_reads")]}


def _ev(cat, name, ts, dur, tid=1, corr=None):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": {} if corr is None else {"correlation": corr}}


def _launch(corr, ts, tid=1):
    return _ev("cuda_runtime", "cudaLaunchKernel", ts, 2, tid, corr)


def _kernel(corr, ts, dur):
    return _ev("kernel", f"k{corr}", ts, dur, 7, corr)


# one Adam step, microseconds: the main thread (tid 1) runs the spans;
# autograd's device thread (tid 2) launches the backward's kernels
STEP = [
    _ev("user_annotation", "cglb.common", 5, 15),
    _ev("user_annotation", "cglb.chol.read", 15, 4),
    _ev("user_annotation", "cglb.precond", 20, 5),
    _ev("user_annotation", "cglb.cg", 25, 25),
    _ev("user_annotation", "cglb.cg.read", 30, 10),
    _ev("user_annotation", "cglb.cg.read", 42, 6),
    _ev("user_annotation", "cglb.backward", 50, 40),
    _ev("cpu_op", "aten::mm", 6, 3, 1, 1),
    _launch(1, 6), _kernel(1, 10, 5),        # common: runs 10-15
    _launch(2, 21), _kernel(2, 21, 3),       # precond: runs 21-24
    _launch(3, 31), _ev("gpu_memcpy", "Memcpy DtoH", 31, 2, 7, 3),
    _launch(4, 60, tid=2), _kernel(4, 61, 20),   # backward, other thread
    _launch(5, 89, tid=2), _kernel(5, 95, 4),    # runs after the span
    _launch(6, 92), _kernel(6, 99, 1),           # opt.step: the step only
]


def _events(unit="cglb.step"):
    """Two units 100 us apart; the first without its unit span (the slice
    began inside it)."""
    out = []
    for k in range(2):
        for ev in STEP:
            ev = dict(ev, ts=ev["ts"] + 100 * k, args=dict(ev["args"]))
            if "correlation" in ev["args"]:
                ev["args"]["correlation"] += 100 * k
            out.append(ev)
    return out + [_ev("user_annotation", unit, 100, 100)]


@pytest.fixture
def ctx(monkeypatch):
    """A traced run's context over synthetic events (``trace._prof`` holds
    them; ``chrome_events`` hands them on)."""
    monkeypatch.setattr(spans, "chrome_events", lambda prof: prof)

    def make(kind="adam", events=None, units=2):
        if events is None:
            events = _events(spans.UNITS[kind])
        return SimpleNamespace(
            kind=kind, slice_units=units,
            trace=SimpleNamespace(device=[("k", 0.0, 1.0)], _prof=events))
    return make


def test_device_time_goes_to_the_span_open_at_its_launch():
    tl = spans.Timeline(_events())
    # a kernel launched from a second thread inside cglb.backward goes to
    # it, also where it ran after the span ended
    assert tl.device_us["cglb.backward"] == 2 * (20 + 4)
    assert tl.device_us["cglb.common"] == 2 * 5
    assert tl.device_us["cglb.precond"] == 2 * 3
    assert tl.device_us["cglb.cg"] == tl.device_us["cglb.cg.read"] == 2 * 2
    assert tl.device_us["cglb.step"] == 5 + 3 + 2 + 24 + 1
    assert tl.counts["cglb.cg.read"] == 4
    # from the first recorded cglb.step (100 us) on, all of it
    assert tl.coverage("cglb.step") == 1.0
    assert tl.coverage("cglb.predict") is None


def test_idle_gap_that_begins_in_a_read_is_read_wait():
    tl = spans.Timeline(_events())
    # step 0: the copy ends at 33 inside cglb.cg.read (30-40); the card
    # idles until the backward's kernel at 61
    assert tl.idle_us["cglb.cg.read"] == pytest.approx(2 * 28)
    # 15-21 begins inside cglb.chol.read (15-19), the innermost open span
    assert tl.idle_us["cglb.chol.read"] == pytest.approx(2 * 6)
    assert tl.idle_us["cglb.precond"] == pytest.approx(2 * 7)


def test_a_span_open_at_the_slice_end_ends_there():
    events = _events() + [_ev("user_annotation", "cglb.step", 200, -1),
                          _launch(900, 201), _kernel(900, 202, 3)]
    tl = spans.Timeline(events)
    assert tl.counts["cglb.step"] == 2
    assert tl.device_us["cglb.step"] == 5 + 3 + 2 + 24 + 1 + 3
    assert tl.coverage("cglb.step") == 1.0


def test_the_readers(ctx):
    c = ctx()
    read = {n: spec.metric_reader(n) for n in NEW["adam"]}
    assert read["backward_ms.train"](c) == pytest.approx(2 * 24 / 1e3 / 2)
    assert read["common_ms.train"](c) == pytest.approx(10 / 1e3 / 2)
    assert read["read_wait_ms.train"](c) == pytest.approx(
        (2 * 28 + 2 * 6) / 1e3 / 2)
    assert read["host_reads.train"](c) == (4 + 2) / 2
    p = ctx("predict")
    assert spec.metric_reader("host_reads.serve")(p) == 3.0
    assert spec.metric_reader("cg_ms.predict")(p) == pytest.approx(2e-3)


@pytest.mark.parametrize("kind", ["adam", "predict"])
def test_none_for_another_kind_an_empty_slice_or_no_spans(ctx, kind):
    other = "predict" if kind == "adam" else "adam"
    no_spans = [ev for ev in _events() if ev["cat"] != "user_annotation"]
    for name in NEW[kind]:
        read = spec.metric_reader(name)
        assert read(ctx(kind)) is not None
        assert read(ctx(other)) is None
        empty = ctx(kind)
        empty.trace.device = []
        assert read(empty) is None
        assert read(ctx(kind, units=0)) is None
        assert read(ctx(kind, no_spans)) is None


class _Fake:
    """A profiler result's event (``_KinetoEvent``'s methods)."""

    def __init__(self, name, dev, start, end, corr, linked=0, ua=False,
                 tid=1):
        self._v = dict(name=name, device_type=dev, start_ns=start,
                       end_ns=end, correlation_id=corr,
                       linked_correlation_id=linked, is_user_annotation=ua,
                       start_thread_id=tid)

    def __getattr__(self, key):
        return lambda: self._v[key]


def test_chrome_events_from_the_profilers_results():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    raw = [_Fake("cglb.cg", cpu, 1000, 9000, 1, ua=True),
           _Fake("aten::sum", cpu, 2000, 4000, 2),
           _Fake("cudaLaunchKernel", cpu, 2500, 3000, 2, linked=2),
           _Fake("reduce_kernel", cuda, 3500, 4500, 2, linked=2),
           _Fake("cglb.cg", cuda, 3500, 4500, 1, ua=True),
           _Fake("cglb.step", cpu, 500, 0, 3, ua=True)]
    result = SimpleNamespace(trace_start_ns=lambda: 0, events=lambda: raw)
    ev = spans.chrome_events(SimpleNamespace(
        profiler=SimpleNamespace(kineto_results=result)))
    assert [(e["cat"], e["name"]) for e in ev] == [
        ("user_annotation", "cglb.cg"), ("cpu_op", "aten::sum"),
        ("cuda_runtime", "cudaLaunchKernel"), ("kernel", "reduce_kernel"),
        ("user_annotation", "cglb.step")]
    assert ev[2]["ts"] == 2.5 and ev[3]["dur"] == 1.0
    assert ev[2]["args"]["correlation"] == ev[3]["args"]["correlation"]
    assert ev[4]["dur"] < 0
    tl = spans.Timeline(ev)
    assert tl.device_us["cglb.cg"] == 1.0 and tl.spans[1][1] == 9.0
