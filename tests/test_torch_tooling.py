"""PyTorch port: the experiment tooling (sweep runner, grids, tables and
plots, plot CLI, short names, profiling hooks) held to the JAX package's
(``cglb_tpu/experiments/{sweep,plotting,plotcli,names}.py``,
``cglb_tpu/utils/profiling.py``).  The sweep tests mirror
tests/test_tooling.py with a fake runner; the tables are compared with the
JAX package's pandas tables on the TPU runs in runs/, to the 4 printed
decimals, with pandas and matplotlib blocked from import."""

import torch_threads  # noqa: F401  (the test processes' torch thread cap)
import math
import os
import shlex
import sys
import threading
import time
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

from cglb_tpu.experiments import names as jnames
from cglb_tpu.experiments import plotting as jplot
from cglb_tpu.experiments import sweep as jsweep
from cglb_tpu_torch.experiments import names as tnames
from cglb_tpu_torch.experiments import plotcli as tplotcli
from cglb_tpu_torch.experiments import plotting as tplot
from cglb_tpu_torch.experiments import sweep as tsweep
from cglb_tpu_torch.utils import profiling as tprof
from cglb_tpu_torch.utils.serialization import dump_json

ROOT = Path(__file__).resolve().parent.parent
JAX_GRIDS = ROOT / "cglb_tpu" / "experiments" / "grids"
PORT_GRIDS = ROOT / "cglb_tpu_torch" / "experiments" / "grids"


def _load(path):
    with open(path, "rb") as f:
        return tomllib.load(f)


@pytest.mark.parametrize("port,jax,drop", [
    ("main.toml", "main.toml", {"cmd"}),
    ("ablations.toml", "ablations.toml", {"cmd"}),
    # the port's proof runs go to a logdir that git ignores
    ("proof.toml", "tpu-proof.toml", {"cmd", "logdir"}),
])
def test_port_grids_expand_to_the_jax_grids_points(port, jax, drop):
    points = tsweep.expand_grid(_load(PORT_GRIDS / port))
    want = [{k: v for k, v in p.items() if k not in drop}
            for p in jsweep.expand_grid(_load(JAX_GRIDS / jax))]
    assert [{k: v for k, v in p.items() if k not in drop}
            for p in points] == want
    assert len(want) in (5, 108, 189)
    for cmd in map(tsweep._render, points):
        assert cmd.startswith(f"{sys.executable} -m "
                              "cglb_tpu_torch.experiments.cli -b torch -t fp64")


def test_protocol_adam_grid_is_the_tpu_runs_command():
    (point,) = tsweep.expand_grid(_load(PORT_GRIDS / "protocol-adam.toml"))
    cmd = tsweep._render(point)
    assert ("-s 0 train -n 2000 -d Wilson_kin40k -o adam_0.01 cglb -m cglb "
            "-k Matern32 -i cv -M 2048") in cmd
    assert tsweep._logdir(cmd).startswith("./runs/")


@pytest.mark.parametrize("spec", [
    {"sweep": {"cmd": "echo {dataset} {M} {seed}",
               "grid": {"dataset": ["a", "b"], "M": [1, 2], "seed": [7]}}},
    {"sweep": [{"cmd": "run {M} {seed}", "grid": {"M": [1, 2],
                                                  "seed": [7, 8]}},
               {"cmd": "run2 {seed}", "uid": "fixed", "platform": "cpu",
                "grid": {"seed": [7, 8]}}]},
])
def test_expand_grid_equals_jax(spec):
    assert tsweep.expand_grid(spec) == jsweep.expand_grid(spec)


def test_render_resolves_the_interpreter():
    assert tsweep._render({"cmd": "python3 -c pass"}) == shlex.join(
        [sys.executable, "-c", "pass"])
    assert tsweep._render({"cmd": "python -m x -l {d}", "d": "a",
                           "python": "venv/bin/python"}) == (
        "venv/bin/python -m x -l a")
    assert tsweep._render({"cmd": "{python} -m x"}).startswith(
        sys.executable)
    assert tsweep._render({"cmd": "echo python3"}) == "echo python3"


def test_sweep_dry_run(tmp_path, capsys):
    grid = tmp_path / "grid.toml"
    grid.write_text('[sweep]\ncmd = "echo {x}"\n[sweep.grid]\nx = [1, 2, 3]\n')
    assert tsweep.run_sweep(grid, dry_run=True) == 0
    assert capsys.readouterr().out.count("echo") == 3


def test_sweep_runs_commands_and_exits_with_the_failures(tmp_path):
    """Real subprocesses: the points run, and ``main`` exits with the number
    of points that failed."""
    marker = tmp_path / "out"
    grid = tmp_path / "grid.toml"
    grid.write_text(f'[sweep]\ncmd = "touch {marker}-{{x}}"\n'
                    "[sweep.grid]\nx = [1, 2]\n")
    assert tsweep.run_sweep(grid, num_proc=2, accel=(0, "cpu")) == 0
    assert Path(f"{marker}-1").exists() and Path(f"{marker}-2").exists()
    grid.write_text('[sweep]\ncmd = "{x}"\n[sweep.grid]\n'
                    'x = ["false", "true", "false"]\n')
    with pytest.raises(SystemExit) as exit_:
        tsweep.main([str(grid), "-p", "1"])
    assert exit_.value.code == 2


def _grid(tmp_path, names, extra=""):
    grid = tmp_path / "grid.toml"
    grid.write_text(
        '[sweep]\ncmd = "cli -l {logdir}/{name} train -n 5 leaf"\n'
        f'logdir = "{tmp_path}/logs"\n{extra}'
        f"[sweep.grid]\nname = {names!r}\n".replace("'", '"'))
    return grid


def test_sweep_skips_completed_and_resumes_killed_points(tmp_path):
    """results.json: skipped (unless --restart); checkpoint.json without
    results: re-issued with --resume right after the `train` token."""
    for name, marker in (("done", "results.json"),
                         ("killed", "checkpoint.json")):
        (tmp_path / "logs" / name).mkdir(parents=True)
        (tmp_path / "logs" / name / marker).write_text("{}")
    grid = _grid(tmp_path, ["done", "killed", "fresh"])
    cmds = []

    def runner(cmd, env, lane):
        cmds.append(cmd)
        return 0

    assert tsweep.run_sweep(grid, runner=runner, accel=(1, "gpu")) == 0
    by_name = {c.split("/logs/")[1].split()[0]: c for c in cmds}
    assert set(by_name) == {"killed", "fresh"}
    assert "train --resume -n 5 leaf" in by_name["killed"]
    assert "--resume" not in by_name["fresh"]
    cmds.clear()
    assert tsweep.run_sweep(grid, restart=True, runner=runner,
                            accel=(1, "gpu")) == 0
    assert len(cmds) == 3 and not any("--resume" in c for c in cmds)


def test_resume_goes_after_the_group_token_only():
    cmd = "cli -l x train -d train -n 5 leaf"
    assert tsweep._with_resume(cmd) == "cli -l x train --resume -d train -n 5 leaf"
    assert tsweep._with_resume("cli -d train leaf") == "cli -d train leaf"


def test_sweep_warms_one_point_per_group_first(tmp_path):
    grid = tmp_path / "grid.toml"
    grid.write_text('[[sweep]]\ncmd = "run {M} {seed}"\n'
                    "[sweep.grid]\nM = [1, 2]\nseed = [7, 8]\n"
                    '[[sweep]]\ncmd = "run2 {seed}"\n'
                    "[sweep.grid]\nseed = [7, 8]\n")
    order, lock = [], threading.Lock()

    def runner(cmd, env, lane):
        with lock:
            order.append(cmd)
        return 0

    assert tsweep.run_sweep(grid, num_proc=4, runner=runner,
                            accel=(1, "gpu")) == 0
    assert len(order) == 6
    assert set(order[:3]) == {"run 1 7", "run 2 7", "run2 7"}


def _lane_grid(tmp_path):
    grid = tmp_path / "grid.toml"
    grid.write_text(
        '[[sweep]]\ncmd = "gpu {seed}"\n[sweep.grid]\nseed = [1, 2, 3, 4]\n'
        '[[sweep]]\ncmd = "cpu {seed}"\nplatform = "cpu"\n'
        "[sweep.grid]\nseed = [1, 2, 3, 4]\n"
        '[[sweep]]\ncmd = "cli --device cpu {seed}"\n'
        "[sweep.grid]\nseed = [1, 2]\n")
    return grid


@pytest.mark.parametrize("cards", [1, 2])
def test_card_lane_takes_one_run_per_card(tmp_path, cards):
    """At most one run per card at a time, pinned with CUDA_VISIBLE_DEVICES
    when there are several; CPU points (platform = "cpu" or --device cpu)
    see no card and share the pool."""
    state = {"gpu_now": 0, "gpu_max": 0, "cpu_now": 0, "cpu_max": 0}
    busy, lock = set(), threading.Lock()

    def runner(cmd, env, lane):
        assert lane == ("gpu" if cmd.startswith("gpu") else "cpu")
        slot = env.get("CUDA_VISIBLE_DEVICES")
        with lock:
            state[f"{lane}_now"] += 1
            state[f"{lane}_max"] = max(state[f"{lane}_max"],
                                       state[f"{lane}_now"])
            if lane == "cpu":
                assert slot == ""
            elif cards > 1:
                assert slot in {str(i) for i in range(cards)}
                assert slot not in busy
                busy.add(slot)
            else:
                assert slot == os.environ.get("CUDA_VISIBLE_DEVICES")
        time.sleep(0.05)
        with lock:
            state[f"{lane}_now"] -= 1
            busy.discard(slot)
        return 0

    assert tsweep.run_sweep(_lane_grid(tmp_path), num_proc=6, runner=runner,
                            accel=(cards, "gpu")) == 0
    assert state["gpu_max"] == cards, state
    assert state["cpu_max"] >= 2, state


def test_no_card_sends_no_point_to_the_cpu_on_its_own(tmp_path):
    """Without a card a card point still runs in the card lane (and fails
    there, as the CLI raises): no silent CPU lane."""
    lanes = []

    def runner(cmd, env, lane):
        lanes.append(lane)
        if lane == "gpu":  # pinned to nothing, hidden from nothing
            assert env.get("CUDA_VISIBLE_DEVICES") == os.environ.get(
                "CUDA_VISIBLE_DEVICES")
        return 1 if lane == "gpu" else 0

    failed = tsweep.run_sweep(_lane_grid(tmp_path), runner=runner,
                              accel=(0, "cpu"))
    assert failed == 4 and lanes.count("gpu") == 4


def test_detect_accelerators_counts_cuda_cards():
    n = torch.cuda.device_count()
    assert tsweep.detect_accelerators() == ((n, "gpu") if n else (0, "cpu"))


def test_short_names_equal_jax():
    paths = ["logs/Wilson_pol/cglb-Matern32-fp64-M2048/999",
             "logs/Wilson_pol/sgprn2m-Matern32-fp64-M1024/1",
             "runs/compare/Wilson_kin40k/gpr-Matern32-fp64/0",
             "x/cglbnm2-RBF-fp32-M64-vzero/3", "plain/dir"]
    got = tnames.short_names(paths)
    assert got == jnames.short_names(paths)
    assert got[paths[0]] == "CGLB M=2048"
    assert got[paths[1]] == "SGPR-N2M M=1024"


def test_trace_writes_a_file_on_the_cpu(tmp_path):
    with tprof.trace(tmp_path / "tr", device="cpu") as prof:
        with tprof.annotate("step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "tr").glob("trace.*.json"))
    assert files == [prof.trace_path] and files[0].stat().st_size > 0
    assert "step" in files[0].read_text()
    assert any(ev.key == "step" for ev in prof.key_averages())


def _block(monkeypatch, *names):
    for name in names:
        monkeypatch.setitem(sys.modules, name, None)


def _rounded(values):
    return [("nan" if math.isnan(v) else f"{v:.4f}") for v in values]


@pytest.mark.parametrize("root", ["runs/sweep-tpu-proof", "runs/compare"])
def test_tables_equal_the_jax_pandas_tables(monkeypatch, capsys, root):
    """The rows, columns and values of results_table and gpr_table equal the
    JAX package's pandas tables to the printed 4 decimals; the port's run
    with pandas and matplotlib unimportable."""
    jexps = jplot.load_experiments(ROOT / root)
    jdf = jplot.TablePrinter(jexps).dataframe()
    jgpr = jplot.TablePrinter(jexps).gpr_pivot()
    _block(monkeypatch, "pandas", "matplotlib", "matplotlib.pyplot")
    exps = tplot.load_experiments(ROOT / root)
    assert [(e.dataset, e.uid, e.seed, e.model, e.num_inducing) for e in exps] \
        == [(e.dataset, e.uid, e.seed, e.model, e.num_inducing) for e in jexps]
    table = tplot.TablePrinter(exps).table()
    assert [key for key, _ in table.rows] == list(jdf.index)
    assert table.columns == list(jdf.columns)
    for (key, values), (_, row) in zip(table.rows, jdf.iterrows()):
        assert _rounded(values) == _rounded(row.tolist()), key
    gpr = tplot.TablePrinter(exps).gpr_table()
    assert [key[0] for key, _ in gpr.rows] == list(jgpr.index)
    assert gpr.columns == [f"{m}: {k}" for m, k in jgpr.columns]
    for (_, values), (_, row) in zip(gpr.rows, jgpr.iterrows()):
        assert _rounded(values) == _rounded(row.tolist())
    # the CLI prints the same values in each format
    for fmt in ("markdown", "latex", "csv", "plain"):
        tplotcli.main(["-r", str(ROOT / root), "results_table", "-f", fmt])
        out = capsys.readouterr().out
        for _, values in table.rows:
            for v in values:
                assert f"{v:.{6 if fmt == 'csv' else 4}f}" in out
    tplotcli.main(["-r", str(ROOT / root), "gpr_table"])
    assert capsys.readouterr().out.count("\n") == 2 + len(gpr.rows)


def test_sweep_proof_table_matches_its_results_table_md(monkeypatch):
    _block(monkeypatch, "pandas")
    table = tplot.TablePrinter(tplot.load_experiments(
        ROOT / "runs/sweep-tpu-proof")).table()
    text = (ROOT / "runs/sweep-tpu-proof/results_table.md").read_text()
    for (dataset, uid), values in table.rows:
        line = next(ln for ln in text.splitlines() if f"'{uid}'" in ln)
        assert [c.strip() for c in line.split("|")[2:5]] == _rounded(values)


def _fake_run(root, uid, seed, n=30):
    d = Path(root) / "Wilson_pol" / uid / str(seed)
    d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    dump_json({"iteration": list(range(0, n * 20, 20)),
               "elapsed_time": np.cumsum(rng.uniform(0.5, 1.5, n)).tolist(),
               "test/rmse": (1.0 / (1 + 0.2 * np.arange(n))).tolist(),
               "cg/steps-per-feval": rng.integers(1, 40, n * 3).tolist()},
              d / "logs.json")
    dump_json({"loss": float(seed), "test/rmse": 0.5, "id": str(d)},
              d / "results.json")


def test_plotter_draws_variants_in_their_own_styles(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    for uid in ("cglbn2m-Matern32-fp64-M512", "cglbn2m-Matern32-fp64-M512-a",
                "cglbn2m-Matern32-fp64-M512-b"):
        for seed in (1, 2):
            _fake_run(tmp_path, uid, seed)
    exps = tplot.load_experiments(tmp_path)
    plotter = tplot.Plotter(exps)
    ax = plotter.plot_metric("Wilson_pol", "test/rmse")
    styles = [line.get_linestyle() for line in ax.lines]
    assert len(styles) == 3 and len(set(styles)) == 3
    ax2 = plotter.plot_cg_steps("Wilson_pol")
    assert len(ax2.lines) == 6
    plotter.save(ax, tmp_path / "p.png")
    assert (tmp_path / "p.png").stat().st_size > 0


def test_plots_without_matplotlib_raise_naming_it(tmp_path, monkeypatch):
    _fake_run(tmp_path, "cglb-Matern32-fp64-M64", 1)
    _block(monkeypatch, "matplotlib", "matplotlib.pyplot")
    exps = tplot.load_experiments(tmp_path)
    with pytest.raises(ImportError, match="matplotlib"):
        tplot.Plotter(exps).plot_metric("Wilson_pol")
    with pytest.raises(ImportError, match="matplotlib"):
        tplotcli.main(["-r", str(tmp_path), "cgstep", "-o",
                       str(tmp_path / "plots")])
