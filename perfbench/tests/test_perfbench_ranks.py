"""A cell on several cards, on the CPU: the launcher starts its ranks (gloo
here, the program's mesh among them), rank 0's line comes out once every
rank has ended well, and a failing or hung rank ends the run with no
result and no rank left running."""

import json
import subprocess
import sys
import time

import pytest

from perfbench import harness, ranks

# one rank of a cell, on the CPU: run.py's rank path with the device and
# the tile size of the streamed reference set for the tiny size, a fault
# planted (faults.py) or rank ``broken`` failing in set-up
RANK = """
import contextlib, sys, time
STARTED = time.perf_counter()
sys.path[:0] = [{tiny!r}, {root!r}]
import torch
from perfbench import drive, faults, harness, ranks, spec
from perfbench.reference import cglb_streamed
cglb_streamed.BLOCK = 64
torch.set_num_threads(1)
r = ranks.Ranks.from_env()
if r.rank == {broken}:
    def broken(*args, **kwargs):
        raise RuntimeError("rank {broken} fails in set-up")
    drive.build_model = broken
fault = faults.FAULTS[{fault!r}]() if {fault!r} else contextlib.nullcontext()
with fault:
    code = harness.run_rank(spec.find_cell({cell!r}), 2 ** 33 + 5, 0.3,
                            {trace}, torch.device("cpu"), STARTED, r)
sys.exit(code)
"""


@pytest.fixture
def made(monkeypatch):
    """The processes the launcher starts."""
    procs = []
    popen = subprocess.Popen

    def record(*args, **kwargs):
        procs.append(popen(*args, **kwargs))
        return procs[-1]

    monkeypatch.setattr(ranks.subprocess, "Popen", record)
    return procs


def _rank_cmd(tiny_root, trace=False, broken=-1,
              cell="cglb-tiny-streamed.adam", fault=""):
    from perfbench.spec import ROOT

    return [sys.executable, "-c", RANK.format(
        tiny=str(tiny_root), root=str(ROOT), broken=broken, trace=trace,
        cell=cell, fault=fault)]


@pytest.mark.parametrize("cell,trace", [
    ("cglb-tiny-streamed.adam", False), ("cglb-tiny-streamed.adam", True),
    ("cglb-tiny-streamed.predict", False)])
def test_two_ranks_give_one_result(tiny_root, made, capfd, cell, trace):
    started = time.perf_counter()
    assert ranks.launch(_rank_cmd(tiny_root, trace, cell=cell), 2, 0.3,
                        started, harness.report) == 0
    out, err = capfd.readouterr()
    assert len(made) == 2 and all(p.poll() is not None for p in made)
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["correct"] is True, err[-3000:]
    assert line["device"]["count"] == 2 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    # both ranks ran the window's steps, as many each
    steps = json.loads(err.split("window steps or requests by rank: ")[1]
                       .splitlines()[0])
    assert steps == [line["attempted"]] * 2 and steps[0] > 0
    if trace:
        assert "cg_matvecs.train" in line["metrics"]
        assert line["metrics"]["ranks_seen.train"]["value"] == 2.0
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert 0 < line["metrics"]["setup_s"]["value"] < (
            time.perf_counter() - started)
    last = err.strip().splitlines()[-len(line["checks"]):]
    assert [s.split()[1] for s in last] == list(line["checks"])


def test_the_exchange_left_out_is_not_correct(tiny_root, made, capfd):
    cmd = _rank_cmd(tiny_root, fault="exchange_left_out")
    assert ranks.launch(cmd, 2, 0.3, time.perf_counter(),
                        harness.report) == 0
    out, err = capfd.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is False, err[-3000:]
    assert all(p.poll() is not None for p in made)


def test_a_failing_rank_ends_the_run(tiny_root, made, capfd):
    t0 = time.perf_counter()
    code = ranks.launch(_rank_cmd(tiny_root, broken=1), 2, 0.3, t0,
                        harness.report)
    out, err = capfd.readouterr()
    assert code != 0 and out.strip() == ""
    assert "rank 1 fails in set-up" in err
    assert len(made) == 2 and all(p.poll() is not None for p in made)
    assert time.perf_counter() - t0 < 60


def test_a_hung_rank_ends_at_the_deadline(made, capfd):
    t0 = time.perf_counter()
    code = ranks.launch([sys.executable, "-c", "import time; time.sleep(600)"],
                        2, 0.3, t0, harness.report, setup_s=2.0)
    out, _ = capfd.readouterr()
    assert code == 124 and out.strip() == ""
    assert len(made) == 2 and all(p.poll() is not None for p in made)
    assert time.perf_counter() - t0 < 30
