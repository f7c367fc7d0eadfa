"""Plot and table CLI of the port, on argparse.

The commands and options of ``cglb_tpu/experiments/plotcli.py`` (reference:
cglb_experiments/plotcli.py:29-152), over a tree of runs
``<root>/<dataset>/<uid>/<seed>/`` such as the sweep runner writes:

    python3 -m cglb_tpu_torch.experiments.plotcli -r ROOT results_table \\
        [-f markdown|latex|csv|plain] [-o FILE]
    ... gpr_table [-f ...] [-o FILE]     # one row per dataset
    ... metrics [-m test/rmse] [-x elapsed_time|iteration] [-o plots]
    ... cgstep [-o plots]

The two tables need numpy only; the two plots need matplotlib.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

from .plotting import Plotter, TablePrinter, load_experiments

__all__ = ["main", "build_parser"]

_FORMATS = ["markdown", "latex", "csv", "plain"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cglb_tpu_torch.experiments.plotcli")
    ap.add_argument("-r", "--root", required=True,
                    help="directory of runs <dataset>/<uid>/<seed>/")
    commands = ap.add_subparsers(dest="command", required=True)
    for name, help_ in (("results_table", "final-metric medians per "
                         "(dataset, uid)"),
                        ("gpr_table", "LML / RMSE / NLPD per dataset and "
                         "model (GPR baselines)")):
        table = commands.add_parser(name, help=help_)
        table.add_argument("-f", "--fmt", choices=_FORMATS, default="markdown")
        table.add_argument("-o", "--output", default=None)
    metrics = commands.add_parser("metrics", help="metric-vs-time/iteration "
                                  "band plots per dataset")
    metrics.add_argument("-m", "--metric", default="test/rmse")
    metrics.add_argument("-x", "--x-axis", choices=["elapsed_time",
                                                    "iteration"],
                         default="elapsed_time")
    metrics.add_argument("-o", "--output-dir", default="plots")
    cgstep = commands.add_parser("cgstep", help="CG steps per function "
                                 "evaluation")
    cgstep.add_argument("-o", "--output-dir", default="plots")
    return ap


def _save_plots(exps, output_dir: str, draw, suffix) -> None:
    """One figure per dataset: ``draw(plotter, dataset)`` -> axes, saved as
    ``<output_dir>/<dataset>-<suffix>.png``."""
    plotter = Plotter(exps)
    outdir = Path(output_dir)
    outdir.mkdir(parents=True, exist_ok=True)
    for dataset in sorted({e.dataset for e in exps}):
        fname = outdir / f"{dataset}-{suffix}.png"
        plotter.save(draw(plotter, dataset), fname)
        print(f"wrote {fname}")


def main(argv: Optional[List[str]] = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not Path(args.root).is_dir():
        parser.error(f"--root {args.root!r} is not a directory")
    exps = load_experiments(args.root)
    if args.command in ("results_table", "gpr_table"):
        printer = TablePrinter(exps)
        s = (printer.print(args.fmt) if args.command == "results_table"
             else printer.print_gpr_table(args.fmt))
        if args.output:
            Path(args.output).write_text(s)
    elif args.command == "metrics":
        _save_plots(exps, args.output_dir,
                    lambda p, ds: p.plot_metric(ds, args.metric, args.x_axis),
                    f"{args.metric.replace('/', '_')}-{args.x_axis}")
    else:
        _save_plots(exps, args.output_dir,
                    lambda p, ds: p.plot_cg_steps(ds), "cgsteps")


if __name__ == "__main__":
    main()
