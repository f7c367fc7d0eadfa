"""The harness finds a configuration, a mix, a cell and a metric by name,
from files added to a copy of the checkout; and the generator's mixes."""

import json
from types import SimpleNamespace

import numpy as np

from perfbench import spec, traffic


def test_added_files_are_found(tiny_root):
    base = tiny_root / "perfbench"
    mix = json.loads((base / "traffic" / "predict.json").read_text())
    mix["rows_max"] = 50
    (base / "traffic" / "short.json").write_text(json.dumps(mix))
    (base / "metrics" / "rows_seen.predict.py").write_text(
        "def read(ctx):\n    return None if ctx.rows is None else "
        "float(sum(len(r) for r in ctx.rows))\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "cglb-tiny.short",
                               "config": "cglb-tiny", "traffic": "short",
                               "chips": 1, "why": "added"})
    bench["per_layer"].append({
        "name": "rows_seen.predict", "unit": "rows", "better": "higher",
        "source": "program_counter", "layer": "device",
        "moves": "predict_rows_per_s", "workloads": ["cglb-tiny.short"]})
    for m in bench["end_to_end"]:
        if "cglb-tiny.predict" in m.get("workloads", ()):
            m["workloads"].append("cglb-tiny.short")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    (base / "limits" / "cglb-tiny.short.json").write_text(
        (base / "limits" / "cglb-tiny.predict.json").read_text())
    try:
        cell = spec.find_cell("cglb-tiny.short", tiny_root)
        assert cell.config["num_inducing"] == 20
        assert cell.traffic["rows_max"] == 50
        assert [m["name"] for m in cell.per_layer] == ["rows_seen.predict"]
        names = {m["name"] for m in cell.end_to_end}
        assert {"setup_s", "predict_rows_per_s", "peak_gib"} <= names
        assert "train_step_ms" not in names
        read = spec.metric_reader("rows_seen.predict", base)
        assert read(SimpleNamespace(rows=[[1, 2], [3]])) == 3.0
    finally:
        (tiny_root / "BENCHMARK.json").write_text(
            json.dumps(dict(bench, workloads=bench["workloads"][:-1])))


def test_every_metric_of_the_benchmark_has_its_reader():
    bench = spec.load_benchmark()
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"])
        assert cell.per_layer and cell.limits
        assert "setup_s" in {m["name"] for m in cell.end_to_end}


def test_every_seed_sends_the_same_sizes():
    mix = {"rows_min": 1, "rows_max": 13200, "cycle": 32}
    sizes = traffic.cycle_sizes(mix)
    assert sizes == sorted(sizes) and sizes[0] >= 1 and sizes[-1] <= 13200
    for seed in (0, 2 ** 40 + 3):
        gen = traffic.requests(mix, seed, 13200)
        first = [len(next(gen)) for _ in range(32)]
        assert sorted(first) == sizes
        rows = next(gen)
        assert len(np.unique(rows)) == len(rows)
    a, b = traffic.requests(mix, 1, 13200), traffic.requests(mix, 1, 13200)
    assert all(np.array_equal(next(a), next(b)) for _ in range(40))
    one, two = traffic.requests(mix, 1, 13200), traffic.requests(mix, 2,
                                                                 13200)
    first = [len(next(one)) for _ in range(64)]
    assert first == [len(next(two)) for _ in range(64)]
    assert first[:32] == first[32:]
    assert max(first[:16]) > sizes[24] and max(first[16:32]) > sizes[24]


def test_spread_is_the_quartile_distance_over_the_median():
    from perfbench.spread import spread

    values = [10.0, 10.0, 11.0, 12.0, 10.0, 10.0]
    q1, med, q3 = 10.0, 10.0, 11.25  # statistics.quantiles, 'exclusive'
    assert spread(values) == (q3 - q1) / med
