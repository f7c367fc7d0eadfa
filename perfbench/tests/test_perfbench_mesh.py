"""The houseelectric cell on the CPU: its configuration at a tiny size as a
two-rank gloo cell through the harness, held to the streamed reference with
the cell's own limits; and the readers of its per-layer metrics on a built
trace and built launch records."""

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import counts, harness, ranks, readers, spans, spec
from perfbench.counts import KernelCall

from conftest import make_tiny_root
from test_perfbench_ranks import _rank_cmd

CELL = "cglb-houseelectric.mesh4"
TINY = "cglb-tiny-house.mesh2"
MESH = ["comm_ms.mesh", "exchanges.mesh", "mfu.mesh"]
# the one-card training cell's metrics that read the mesh cell too
TRAIN = ["cg_matvecs.train", "linalg_ms.train", "kernel_roofline.train",
         "idle_share.train", "common_ms.train", "precond_ms.train",
         "backward_ms.train", "cg_ms.train", "read_wait_ms.train",
         "host_reads.train"]


def make_tiny_house(dest):
    """A tiny root holding ``cglb-tiny-house.mesh2``: the houseelectric
    configuration (D 11, CG cap 4, the streamed reference) on 600 rows of
    the stand-in generator at M 16, the ``adam3`` mix and the cell's own
    limits, on two ranks."""
    root = make_tiny_root(dest)
    base = root / "perfbench"
    cfg = json.loads((base / "configs" / "cglb-houseelectric.json")
                     .read_text())
    cfg.update(name="cglb-tiny-house", dataset="synth_600x11", n_train=402,
               n_test=198, num_inducing=16, matvec="streaming",
               start="perfbench/data/cglb-tiny-house.model.json")
    start = json.loads((base / "data" / "cglb-houseelectric.model.json")
                       .read_text())
    Z = np.random.default_rng(1).normal(size=(16, 11))
    start["params"][".inducing_Z"] = {
        "__ndarray__": Z.tolist(), "dtype": "float64", "shape": [16, 11]}
    (base / "configs" / "cglb-tiny-house.json").write_text(json.dumps(cfg))
    (base / "data" / "cglb-tiny-house.model.json").write_text(
        json.dumps(start))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "cglb-tiny-house", "source": "tiny",
                             "file": "perfbench/configs/cglb-tiny-house.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": TINY, "config": "cglb-tiny-house",
                               "traffic": "adam3", "chips": 2,
                               "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TINY)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (base / "limits" / f"{TINY}.json").write_text(
        (base / "limits" / f"{CELL}.json").read_text())
    mix = json.loads((base / "traffic" / "adam3.json").read_text())
    mix.update(trace_seconds=0.2)
    (base / "traffic" / "adam3.json").write_text(json.dumps(mix))
    return root


@pytest.fixture(scope="module")
def house_root(tmp_path_factory):
    return make_tiny_house(tmp_path_factory.mktemp("house"))


def test_the_cell_and_its_files_are_found():
    cell = spec.find_cell(CELL)
    assert cell.chips == 4 and cell.traffic["compared_steps"] == 3
    assert cell.config["reference"] == "cglb_streamed"
    assert (cell.config["input_dim"], cell.config["num_inducing"],
            cell.config["kernel"], cell.config["dtype"]) == (
                11, 1024, "Matern32", "float64")
    assert {m["name"] for m in cell.per_layer} == set(MESH) | set(TRAIN)
    assert {m["name"] for m in cell.end_to_end} == {
        "setup_s", "train_step_ms", "peak_gib"}
    # the start holds the configuration's shapes
    from perfbench import drive

    values = drive.start_values(cell.config)
    assert values[".inducing_Z"].shape == (1024, 11)
    assert values[".kernel.lengthscales"].shape == (11,)
    # the mesh's metrics are read in this cell alone
    for w in spec.load_benchmark()["workloads"]:
        if w["name"] != CELL:
            names = {m["name"] for m in spec.find_cell(w["name"]).per_layer}
            assert not names & set(MESH)


@pytest.mark.parametrize("fault,correct", [("", True),
                                           ("exchange_left_out", False)])
def test_two_ranks_at_a_tiny_size(house_root, capfd, fault, correct):
    cmd = _rank_cmd(house_root, cell=TINY, fault=fault)
    assert ranks.launch(cmd, 2, 0.3, time.perf_counter(),
                        harness.report) == 0
    out, err = capfd.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is correct, err[-3000:]
    assert line["device"]["count"] == 2 and line["attempted"] >= 1
    steps = json.loads(err.split("window steps or requests by rank: ")[1]
                       .splitlines()[0])
    assert steps == [line["attempted"]] * 2


def test_rankcontrol_reads_the_control_and_a_fault_on_ranks(house_root):
    """rankcontrol.py on the tiny cell's two ranks: the sound program
    within every limit, the fp32 control and the left-out exchange
    (planted in each rank) each over one at least."""
    cmd = [sys.executable, str(house_root / "perfbench" / "rankcontrol.py"),
           "--workload", TINY, "--seeds", str(2 ** 33 + 5), "--variants",
           "sound", "control", "exchange_left_out", "--device", "cpu",
           "--timeout", "240"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(spec.ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(s) for s in out.stdout.splitlines()
             if s.startswith("{")]
    assert [d["variant"] for d in lines] == ["sound", "control",
                                             "exchange_left_out"]
    # rank 0 printed each reading as it was taken
    assert sum(json.dumps(d) in out.stderr for d in lines) == 3
    for d in lines:
        within = all(d[d["variant"]][k] <= v for k, v in d["limits"].items())
        assert within is (d["variant"] == "sound"), d
        assert d["steps"] == [d["steps"][0]] * 2 and d["steps"][0] >= 1


# --------------------------------------------------------------------------
# the readers on a built trace: one step of rank 0, microseconds
# --------------------------------------------------------------------------


def _ev(cat, name, ts, dur, corr=None, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": {} if corr is None else {"correlation": corr}}


def _work(corr, launch_ts, name, ts, dur, tid=1):
    return [_ev("cuda_runtime", "cuLaunchKernelEx", launch_ts, 2, corr, tid),
            _ev("kernel", name, ts, dur, corr, 7)]


def _step(t0, corr0, exchange=True):
    """A step: kernel 1 then its all-gather (an exchange), an all-reduce
    inside the backward (from autograd's thread) and the read of
    check_same."""
    ex = [] if not exchange else [
        _ev("user_annotation", "cglb.mesh.exchange", t0 + 20, 10),
        _ev("user_annotation", "cglb.mesh.exchange", t0 + 60, 10, tid=2),
        _ev("user_annotation", "cglb.mesh.read", t0 + 35, 5)]
    return ([_ev("user_annotation", "cglb.step", t0, 100),
             _ev("user_annotation", "cglb.backward", t0 + 50, 40)] + ex
            + _work(corr0, t0 + 1, "matvec_kernel", t0 + 2, 15)
            + _work(corr0 + 1, t0 + 21, "ncclDevKernel_AllGather_RING_LL",
                    t0 + 22, 6)
            + _work(corr0 + 2, t0 + 61, "ncclDevKernel_AllGather_RING_LL",
                    t0 + 62, 4, tid=2)
            + _work(corr0 + 3, t0 + 80, "ls_grad_kernel", t0 + 80, 10))


def _ctx(monkeypatch, chips=4, exchange=True, units=2):
    monkeypatch.setattr(spans, "chrome_events", lambda prof: prof)
    events = [e for k in range(units)
              for e in _step(100 * k, 10 * k, exchange)]
    dev = [(e["name"], e["ts"], e["dur"]) for e in events
           if e["cat"] == "kernel"]
    trace = SimpleNamespace(device=dev, _prof=events)
    trace.busy_s = lambda: sum(d for _, _, d in dev) * 1e-6
    n, m, d = 4000, 64, 11
    calls = [KernelCall("matvec", n, n // chips, d),
             KernelCall("ls_grad", n, n // chips, d)]
    return SimpleNamespace(
        kind="adam", config={"model": "cglb", "n_train": n,
                             "num_inducing": m},
        chips=chips, slice_units=units, slice_s=units * 100e-6,
        slice_calls=calls * units, trace=trace, units=units,
        seconds=1.0, unit_calls=[(u, c) for u in range(units) for c in calls],
        calls=calls * units)


def test_the_mesh_readers_on_a_built_trace(monkeypatch):
    read = {name: spec.metric_reader(name) for name in MESH}
    c = _ctx(monkeypatch)
    # the NCCL kernels launched inside the exchanges, on either thread
    assert read["comm_ms.mesh"](c) == pytest.approx((6 + 4) / 1e3)
    assert read["exchanges.mesh"](c) == 2.0
    assert read["mfu.mesh"](c) > 0
    # the one-card readers of rank 0's kernels and card
    assert spec.metric_reader("kernel_roofline.train")(
        c) == readers.kernel_roofline(c, "adam")
    assert spec.metric_reader("idle_share.train")(c) == pytest.approx(
        100.0 * (1 - 35 / 100))


def test_the_mesh_readers_read_nothing_on_one_card_or_without_the_spans(
        monkeypatch):
    for name in MESH:
        read = spec.metric_reader(name)
        assert read(_ctx(monkeypatch, chips=1)) is None, name
        assert read(SimpleNamespace(
            **{**vars(_ctx(monkeypatch)), "kind": "predict"})) is None, name
    # a program without the spans (the parent of the spans' change)
    c = _ctx(monkeypatch, exchange=False)
    assert spec.metric_reader("comm_ms.mesh")(c) is None
    assert spec.metric_reader("exchanges.mesh")(c) is None
    assert spec.metric_reader("idle_share.train")(c) is not None


def _one_card_step(n, m, d, cg_matvecs):
    """One card's calls of a CGLB step (models/cglb.py, ops/cg.py): CG's
    matvecs on the fp32 tier (the start's residual and one an iteration),
    the bound's K v on the accurate tier, kernel 3 once, kernel 2 once in
    the backward (v is detached: no matvec there); all symmetric."""
    return ([KernelCall("kuf", m, n, d)]
            + [KernelCall("matvec", n, n, d, 1, False, True)] * cg_matvecs
            + [KernelCall("matvec", n, n, d, 1, True, True),
               KernelCall("ls_grad", n, n, d, 1, True, True)])


def _rank_step(n, m, d, cg_matvecs, world):
    """Rank 0's calls of the same step on ``world`` ranks: kernel 3 on its
    N / R columns, every matvec on the accurate tier over all N rows
    against its N / R columns (the general path), kernel 2 likewise."""
    c = -(-n // world)
    return ([KernelCall("kuf", m, c, d)]
            + [KernelCall("matvec", n, c, d)] * (cg_matvecs + 1)
            + [KernelCall("ls_grad", n, c, d)])


def test_mfu_mesh_counts_what_one_card_needs():
    """mfu.mesh over four ranks counts the operations mfu.train counts for
    the same steps of the configuration on one card: the same numerator,
    over four cards' peak."""
    n, m, d = 442200, 1024, 11
    cg = [5, 3, 5]  # CG's matvecs a step: capped at 4 iterations, or fewer
    one = [(u, c) for u, k in enumerate(cg)
           for c in _one_card_step(n, m, d, k)]
    four = [(u, c) for u, k in enumerate(cg)
            for c in _rank_step(n, m, d, k, 4)]
    cfg = {"model": "cglb", "n_train": n, "num_inducing": m}

    def ctx(unit_calls, chips):
        return SimpleNamespace(kind="adam", config=cfg, seconds=30.0,
                               calls=[c for _, c in unit_calls],
                               unit_calls=unit_calls, chips=chips)

    train = spec.metric_reader("mfu.train")(ctx(one, 1))
    mesh = spec.metric_reader("mfu.mesh")(ctx(four, 4))
    assert 4 * mesh == pytest.approx(train, rel=1e-12)
    # what the ranks launch does not enter: a rank's redundant kernel work
    # (each rank's general path takes N^2 / R pairs, not N^2 / 2R)
    launched = counts.kernel_flops(c for _, c in four)
    assert launched != pytest.approx(counts.kernel_flops(
        c for _, c in one) / 4)
