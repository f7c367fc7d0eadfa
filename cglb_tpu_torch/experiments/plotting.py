"""Analysis: parse run logs, plot metric bands over seeds, print tables.

The counterpart of ``cglb_tpu/experiments/plotting.py`` (reference:
cglb_experiments/plotting.py:49-708), for a machine that has numpy and
scipy but neither pandas nor matplotlib:

- :func:`load_experiments` walks ``<root>/<dataset>/<uid>/<seed>/logs.json``
  with ``results.json`` beside it, into :class:`ExpData`, as the JAX
  package does;
- :class:`TablePrinter` gives the JAX package's tables, the medians over
  seeds per (dataset, uid) and the GPR-baseline pivot (one row per dataset,
  one column per (model, metric)), computed with numpy and rendered by this
  module as markdown, latex, csv or plain text: no pandas;
- :class:`Plotter` draws the same plots (median and inter-quartile band of a
  metric against time or iteration, CG steps per function evaluation);
  matplotlib is imported only when a plot is drawn, and its absence raises
  an error that names it.  Variant arms of one model (a uid's trailing tag)
  take line styles of their own, never the model's.
"""

from __future__ import annotations

import csv
import io
import json
import math
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..utils.serialization import load_json

__all__ = ["ExpData", "load_experiments", "Plotter", "Table", "TablePrinter",
           "MODEL_STYLE"]

_UID_RE = re.compile(
    r"(?P<model>[a-z0-9]+)-(?P<kernel>[A-Za-z0-9]+)-(?P<float>fp\d+)"
    r"(-M(?P<M>\d+))?(?P<extra>.*)"
)

# model -> (color, linestyle, label); reference maps at plotting.py:72-172
MODEL_STYLE = {
    "cglb": ("#1f77b4", "-", "CGLB"),
    "cglbn2m": ("#17becf", "--", r"CGLB $N^2M$"),
    "cglbnm2": ("#9467bd", "-.", r"CGLB $NM^2$"),
    "sgpr": ("#ff7f0e", "-", "SGPR"),
    "sgprn2m": ("#d62728", "--", r"SGPR $N^2M$"),
    "gpr": ("#2ca02c", ":", "Iterative GP"),
}
# line styles of variant arms, in order of appearance, skipping the model's
_VARIANT_STYLES = ("--", ":", "-.", (0, (5, 1)), (0, (3, 1, 1, 1, 1, 1)))


@dataclass
class ExpData:
    dataset: str
    model: str
    uid: str
    seed: int
    logs: Dict[str, list] = field(repr=False)
    results: Dict[str, float] = field(repr=False, default_factory=dict)
    num_inducing: Optional[int] = None

    def series(self, key: str) -> np.ndarray:
        return np.asarray(self.logs.get(key, []), dtype=float)


def load_experiments(root) -> List[ExpData]:
    """Walk <root>/<dataset>/<uid>/<seed>/logs.json; a run whose logs do not
    parse is left out, and one whose results.json does not parse has no
    results."""
    out = []
    for logs_path in sorted(Path(root).glob("*/*/*/logs.json")):
        seed_dir = logs_path.parent
        uid_dir = seed_dir.parent
        m = _UID_RE.match(uid_dir.name)
        try:
            logs = load_json(logs_path)
        except (json.JSONDecodeError, OSError):
            continue
        results = {}
        results_path = seed_dir / "results.json"
        if results_path.exists():
            try:
                results = load_json(results_path)
            except (json.JSONDecodeError, OSError):
                pass
        try:
            seed = int(seed_dir.name)
        except ValueError:
            seed = 0
        out.append(ExpData(
            dataset=uid_dir.parent.name,
            model=m.group("model") if m else uid_dir.name,
            uid=uid_dir.name, seed=seed, logs=logs, results=results,
            num_inducing=int(m.group("M")) if (m and m.group("M")) else None))
    return out


def _uid_variant(uid: str) -> str:
    """A uid's trailing variant tag, e.g. 'cglb-Matern32-fp64-M2048-adam'
    -> 'adam' ('' for none)."""
    m = _UID_RE.match(uid)
    return (m.group("extra") if m else "").strip("-")


def _resample(x, y, grid, kind: str = "spline"):
    """Resample (x, y) onto a common grid, NaN outside support: a
    shape-preserving cubic (PCHIP) for kind="spline", piecewise-linear for
    kind="linear" and for series too short for a cubic or with repeated
    abscissae."""
    x, y = np.asarray(x, float), np.asarray(y, float)
    if len(x) < 2:
        return np.full_like(grid, np.nan, dtype=float)
    order = np.argsort(x)
    x, y = x[order], y[order]
    if kind == "spline" and len(x) >= 4 and np.all(np.diff(x) > 0):
        from scipy.interpolate import PchipInterpolator

        out = PchipInterpolator(x, y)(grid)
    else:
        out = np.interp(grid, x, y)
    return np.where((grid < x[0]) | (grid > x[-1]), np.nan, out)


def _median_iqr(series: List[np.ndarray]):
    stacked = np.vstack(series)
    return (np.nanmedian(stacked, axis=0), np.nanpercentile(stacked, 25, axis=0),
            np.nanpercentile(stacked, 75, axis=0))


def _pyplot():
    """matplotlib.pyplot (which draws on its Agg backend, files only, where
    there is no display)."""
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError(
            "plots need matplotlib, which is not installed (the tables of "
            "TablePrinter and plotcli's results_table / gpr_table do not)"
        ) from e
    return plt


class Plotter:
    def __init__(self, experiments: List[ExpData]):
        self.experiments = experiments

    @staticmethod
    def save(ax, path) -> None:
        """Write ``ax``'s figure to ``path`` and close it."""
        ax.figure.savefig(path, dpi=150, bbox_inches="tight")
        _pyplot().close(ax.figure)

    def _grouped(self, dataset: str) -> Dict[str, List[ExpData]]:
        groups: Dict[str, List[ExpData]] = {}
        for e in self.experiments:
            if e.dataset == dataset:
                groups.setdefault(e.uid, []).append(e)
        return groups

    def _styles(self, dataset: str) -> Dict[str, tuple]:
        """uid -> (color, linestyle, label): the model's style, and for each
        variant arm the next variant style that is not the model's."""
        out, variants = {}, {}
        for uid, runs in sorted(self._grouped(dataset).items()):
            model = runs[0].model
            color, ls, label = MODEL_STYLE.get(model, ("k", "-", model))
            if runs[0].num_inducing:
                label += f" M={runs[0].num_inducing}"
            variant = _uid_variant(uid)
            if variant:
                styles = [s for s in _VARIANT_STYLES if s != ls]
                k = variants.setdefault(model, 0)
                variants[model] = k + 1
                ls = styles[k % len(styles)]
                label += f" ({variant})"
            out[uid] = (color, ls, label)
        return out

    def plot_metric(self, dataset: str, metric: str = "test/rmse",
                    x_axis: str = "elapsed_time", ax=None,
                    num_points: int = 200, resample: str = "spline"):
        """Median + IQR band of `metric` vs time or iteration per uid."""
        if ax is None:
            _, ax = _pyplot().subplots(figsize=(6, 4))
        styles = self._styles(dataset)
        for uid, runs in sorted(self._grouped(dataset).items()):
            pairs = [(r.series(x_axis), r.series(metric)) for r in runs]
            pairs = [(x, y) for x, y in pairs if len(x) > 1 and len(x) == len(y)]
            if not pairs:
                continue
            grid = np.linspace(min(x.min() for x, _ in pairs),
                               max(x.max() for x, _ in pairs), num_points)
            med, q1, q3 = _median_iqr([_resample(x, y, grid, kind=resample)
                                       for x, y in pairs])
            color, ls, label = styles[uid]
            ax.plot(grid, med, color=color, linestyle=ls, label=label)
            ax.fill_between(grid, q1, q3, color=color, alpha=0.2, linewidth=0)
        ax.set_xlabel("wall-clock time (s)" if x_axis == "elapsed_time"
                      else x_axis)
        ax.set_ylabel(metric)
        ax.set_title(dataset)
        ax.legend(fontsize=8)
        return ax

    def plot_cg_steps(self, dataset: str, ax=None, smooth_std: float = 5.0,
                      boxplot_inset: bool = True, max_fevals: int = 1500):
        """CG steps per function evaluation: a gaussian-smoothed mean curve
        per uid with the faint raw mean behind it, and a horizontal boxplot
        inset of all its steps (whiskers at the 5th/95th percentiles)."""
        from scipy.ndimage import gaussian_filter1d

        if ax is None:
            _, ax = _pyplot().subplots(figsize=(5.2, 3.2))
        styles = self._styles(dataset)
        dists, colors, labels = [], [], []
        for uid, runs in sorted(self._grouped(dataset).items()):
            series = [r.series("cg/steps-per-feval")[:max_fevals] for r in runs
                      if len(r.series("cg/steps-per-feval"))]
            if not series:
                continue
            ln = min(len(s) for s in series)
            stacked = np.vstack([s[:ln] for s in series])
            mean = np.mean(stacked, axis=0)
            color, ls, label = styles[uid]
            ax.plot(mean, alpha=0.15, color=color, linewidth=0.8)
            if smooth_std > 0 and len(mean) > 3 * smooth_std:
                mean = gaussian_filter1d(mean, smooth_std)
            ax.plot(mean, color=color, linestyle=ls, label=label)
            dists.append(stacked.reshape(-1))
            colors.append(color)
            labels.append(label)
        if boxplot_inset and dists:
            inset = ax.inset_axes([0.62, 0.58, 0.34, 0.36])
            try:
                bps = inset.boxplot(dists, vert=False, sym="", whis=(5, 95),
                                    tick_labels=labels)
            except TypeError:  # matplotlib < 3.9 named the keyword `labels`
                bps = inset.boxplot(dists, vert=False, sym="", whis=(5, 95),
                                    labels=labels)
            for i, color in enumerate(colors):
                bps["medians"][i].set(color=color, linewidth=2.0)
                bps["boxes"][i].set(color=color)
                for w in bps["whiskers"][2 * i: 2 * i + 2]:
                    w.set(color=color)
            inset.tick_params(labelsize=6)
        ax.set_xlabel("function evaluation")
        ax.set_ylabel("CG steps")
        ax.set_title(dataset)
        ax.legend(fontsize=8, loc="lower left")
        return ax


class Table(NamedTuple):
    """Rows of medians: ``keys`` names the key columns, ``columns`` the
    value columns; each row is (key values, column values)."""
    keys: Tuple[str, ...]
    columns: List[str]
    rows: List[Tuple[Tuple[str, ...], List[float]]]


def _median(values: List[float]) -> float:
    """The median of the values that are not NaN (NaN if none), as pandas
    takes it."""
    values = [v for v in values if not math.isnan(v)]
    return float(np.median(values)) if values else math.nan


def _latex_escape(text: str) -> str:
    for ch in "\\&%$#_{}":
        text = text.replace(ch, "\\" + ch)
    return text


class TablePrinter:
    """Final-metric tables: medians over seeds."""

    def __init__(self, experiments: List[ExpData]):
        self.experiments = experiments

    def table(self, metrics: Sequence[str] = ("loss", "test/rmse",
                                              "test/nlpd")) -> Table:
        """One row per (dataset, uid) with results, in sorted order; one
        column per metric that some run reports."""
        groups: Dict[Tuple[str, str], Dict[str, List[float]]] = {}
        for e in self.experiments:
            if not e.results:
                continue
            cell = groups.setdefault((e.dataset, e.uid), {})
            for m in metrics:
                if m in e.results:
                    cell.setdefault(m, []).append(
                        float(np.asarray(e.results[m])))
        columns = [m for m in metrics if any(m in g for g in groups.values())]
        rows = [(key, [_median(groups[key].get(m, [])) for m in columns])
                for key in sorted(groups)]
        return Table(("dataset", "uid"), columns, rows)

    def gpr_table(self, metrics: Sequence[str] = ("lml", "test/rmse",
                                                  "test/nlpd")) -> Table:
        """The paper's GPR-baseline layout: one row per dataset, one column
        per (model, metric) in sorted order, labelled ``model: metric``
        (reference: plotting.py:636-708 print_gpr_table)."""
        cells: Dict[str, Dict[Tuple[str, str], List[float]]] = {}
        for e in self.experiments:
            if not e.results:
                continue
            for m in metrics:
                if m in e.results:
                    cells.setdefault(e.dataset, {}).setdefault(
                        (e.model, m), []).append(
                            float(np.asarray(e.results[m])))
        pairs = sorted({pair for row in cells.values() for pair in row})
        rows = [((ds,), [_median(cells[ds].get(pair, [])) for pair in pairs])
                for ds in sorted(cells)]
        keep = [i for i in range(len(pairs))
                if any(not math.isnan(values[i]) for _, values in rows)]
        return Table(("dataset",), [f"{pairs[i][0]}: {pairs[i][1]}"
                                    for i in keep],
                     [(key, [values[i] for i in keep]) for key, values in rows])

    @staticmethod
    def render(table: Table, fmt: str) -> str:
        """markdown, latex or plain text with 4 decimals; csv with 6."""
        if fmt not in ("markdown", "latex", "csv", "plain"):
            raise ValueError(f"unknown table format {fmt!r}")
        digits = 6 if fmt == "csv" else 4
        header = list(table.keys) + list(table.columns)
        body = [list(key) + [f"{v:.{digits}f}" for v in values]
                for key, values in table.rows]
        nk = len(table.keys)
        if fmt == "csv":
            buf = io.StringIO()
            writer = csv.writer(buf, lineterminator="\n")
            writer.writerow(header)
            writer.writerows(body)
            return buf.getvalue()
        if fmt == "latex":
            lines = [r"\begin{tabular}{" + "l" * nk
                     + "r" * len(table.columns) + "}", r"\toprule",
                     " & ".join(map(_latex_escape, header)) + r" \\",
                     r"\midrule"]
            lines += [" & ".join(map(_latex_escape, row)) + r" \\"
                      for row in body]
            return "\n".join(lines + [r"\bottomrule", r"\end{tabular}"])
        widths = [max(len(str(row[i])) for row in [header] + body)
                  for i in range(len(header))]

        def line(row, sep):
            cells = [str(c).ljust(w) if i < nk else str(c).rjust(w)
                     for i, (c, w) in enumerate(zip(row, widths))]
            return sep.join(cells)

        if fmt == "plain":
            return "\n".join(line(row, "  ") for row in [header] + body)
        rule = "|" + "|".join(":" + "-" * (w + 1) if i < nk
                              else "-" * (w + 1) + ":"
                              for i, w in enumerate(widths)) + "|"
        return "\n".join(["| " + line(header, " | ") + " |", rule]
                         + ["| " + line(row, " | ") + " |" for row in body])

    def print(self, fmt: str = "markdown", metrics=("loss", "test/rmse",
                                                    "test/nlpd")) -> str:
        s = self.render(self.table(metrics), fmt)
        print(s)
        return s

    def print_gpr_table(self, fmt: str = "latex",
                        metrics=("lml", "test/rmse", "test/nlpd")) -> str:
        s = self.render(self.gpr_table(metrics), fmt)
        print(s)
        return s
