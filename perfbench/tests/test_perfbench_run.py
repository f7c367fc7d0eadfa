"""A whole run on the CPU at the tiny size: the last line's keys and their
order, the end-to-end and per-layer metrics a cell reports, and
``correct`` on sound runs."""

import json
import time

import pytest
import torch

from perfbench import harness, spec

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", ["cglb-tiny.adam", "cglb-tiny.predict",
                                  "cglb-tiny.predict-rate"])
def test_sound_runs_are_correct(tiny_root, cell):
    c = spec.find_cell(cell, tiny_root)
    out = harness.run_cell(c, 2 ** 33 + 17, 0.3, False, CPU,
                           time.perf_counter())
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in c.end_to_end}
    for k, v in out["checks"].items():
        assert v["value"] <= v["limit"] == c.limits[k]


def test_the_last_line(tiny_root, monkeypatch, capsys):
    cell = spec.find_cell("cglb-tiny.adam", tiny_root)
    monkeypatch.setattr(harness, "find_cell", lambda name, root: cell)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "_card", lambda: "stub card, 700.00 W")
    run = harness.run_cell
    monkeypatch.setattr(harness, "run_cell",
                        lambda c, s, sec, tr, dev, st: run(c, s, sec, tr,
                                                           CPU, st))
    assert harness.main(["--workload", "cglb-tiny.adam", "--seed", "5",
                         "--seconds", "0.3", "--trace", "1"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes", "busy_s", "window_s"}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {m["name"] for m in cell.per_layer} >= set(line["metrics"])
    assert "cg_matvecs.train" in line["metrics"]
    assert line["metrics"]["ranks_seen.train"]["value"] == 1.0
    last = err.strip().splitlines()[-3:]
    assert [s.split()[1] for s in last] == list(line["checks"])
