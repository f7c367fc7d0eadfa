"""Dataset loading and normalization.

A copy of ``cglb_tpu/experiments/datasets.py`` (numpy only): the same
names give the same bits, so both packages train on identical data.

Reference semantics (cglb_experiments/datasets.py:25-76): datasets are loaded by
name, split 67/33, and z-scored with *train* statistics applied to the test split.
The reference pulls UCI ("Wilson") datasets through robustgp_experiments /
bayesian_benchmarks, which download from the web.  This environment has zero
egress, so loaders resolve in order:

1. a local data directory (``CGLB_DATA_DIR``, default ``~/.datasets``) containing
   ``<name>.npz`` files with ``X``/``Y`` arrays (or the bayesian_benchmarks
   uci layout),
2. for ``snelson1d`` and any ``synth_*`` name: a deterministic synthetic
   generator (GP-flavored data with the right shapes), so every pipeline is
   runnable offline.  Benchmark configs (kin40k etc.) get shape-faithful
   synthetic stand-ins this way.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

import numpy as np

__all__ = ["DatasetBundle", "get_dataset", "norm", "DATASET_SHAPES"]

Dataset = Tuple[np.ndarray, np.ndarray]

# N (total), D for the reference's UCI suite (for synthetic stand-ins).
DATASET_SHAPES = {
    "Wilson_bike": (17379, 17),
    "Wilson_elevators": (16599, 18),
    "Wilson_kin40k": (40000, 8),
    "Wilson_pol": (15000, 26),
    "Wilson_protein": (45730, 9),
    "Wilson_keggundirected": (63608, 27),
    "Wilson_houseelectric": (2049280, 11),
}


@dataclass(frozen=True)
class DatasetBundle:
    name: str
    train: Dataset
    test: Dataset
    # "real" (loaded from disk) or "synthetic" (offline stand-in).  Surfaces
    # in results.json/logs.json ("data" field) and in display names, so a
    # stand-in run can never masquerade as a real-data result.
    source: str = "real"

    def to_tuple(self):
        return (self.train, self.test)

    @property
    def synthetic(self) -> bool:
        return self.source == "synthetic"

    @property
    def provenance(self) -> str:
        return self.source

    @property
    def display_name(self) -> str:
        return f"{self.name}:synth" if self.synthetic else self.name


def norm(x: np.ndarray):
    """Z-score with train statistics (reference: datasets.py:35-39)."""
    mu = np.mean(x, axis=0, keepdims=True)
    std = np.std(x, axis=0, keepdims=True) + 1e-6
    return (x - mu) / std, mu, std


def _data_dir() -> Path:
    return Path(os.environ.get("CGLB_DATA_DIR", "~/.datasets")).expanduser()


def _load_local(name: str):
    d = _data_dir()
    npz = d / f"{name}.npz"
    if npz.exists():
        data = np.load(npz)
        return np.asarray(data["X"]), np.asarray(data["Y"]).reshape(-1, 1)
    # bayesian_benchmarks uci layout: <dir>/uci/<name>/data.csv-ish
    for sub in (d / "uci" / name.replace("Wilson_", ""), d / name):
        csv = sub / "data.csv"
        if csv.exists():
            arr = np.loadtxt(csv, delimiter=",")
            return arr[:, :-1], arr[:, -1:].reshape(-1, 1)
    return None


def _synthetic(name: str, seed: int = 0):
    """Deterministic GP-flavored synthetic data with dataset-faithful shapes."""
    hard = False
    if name == "snelson1d":
        n, dim = 200, 1
    elif name in DATASET_SHAPES:
        n, dim = DATASET_SHAPES[name]
    else:
        m = re.fullmatch(r"synth_(\d+)x(\d+)(_hard)?", name)
        if not m:
            raise KeyError(name)
        n, dim = int(m.group(1)), int(m.group(2))
        hard = bool(m.group(3))
    rng = np.random.default_rng(seed + n + dim)
    X = rng.normal(size=(n, dim))
    if hard:
        # protocol-length stand-in: the plain generator below converges to
        # its noise floor in ~15 L-BFGS iterations at kin40k scale (scipy
        # stops with a legitimate CONVERGENCE status long before the
        # reference's 2000-step budget — PERF.md "Protocol-length run").
        # This variant keeps hyperparameter learning active much longer:
        # multi-scale random-feature banks (frequencies spanning ~30x) over
        # per-dimension relevance weights (so the ARD lengthscales must
        # separate), plus 5% observation noise.
        nf = 64
        rel = np.geomspace(0.3, 3.0, dim)
        signal = np.zeros((n, 1))
        for scale, amp in ((0.25, 1.0), (1.0, 0.6), (4.0, 0.35)):
            W = rng.normal(size=(dim, nf)) * (rel / np.sqrt(dim))[:, None] / scale
            b = rng.uniform(0, 2 * np.pi, size=(nf,))
            w2 = rng.normal(size=(nf, 1)) / np.sqrt(nf)
            signal = signal + amp * np.sqrt(2.0) * np.cos(X @ W + b) @ w2
        Y = signal + 0.05 * np.std(signal) * rng.normal(size=(n, 1))
        return X, Y
    # smooth nonlinear target: random-feature GP sample + noise.  The noise
    # level is deliberately UCI-like (~25% of signal variance after z-scoring)
    # — near-noiseless stand-ins let large-M models interpolate and drive the
    # likelihood variance to its floor, an unrealistically brutal conditioning
    # regime.
    nf = 64
    W = rng.normal(size=(dim, nf)) / np.sqrt(dim)
    b = rng.uniform(0, 2 * np.pi, size=(nf,))
    w2 = rng.normal(size=(nf, 1)) / np.sqrt(nf)
    signal = np.sqrt(2.0) * np.cos(X @ W + b) @ w2
    Y = signal + 0.5 * np.std(signal) * rng.normal(size=(n, 1))
    return X, Y


def get_dataset(
    name: str,
    dtype=np.float64,
    normalize: bool = True,
    prop: float = 0.67,
    split: int = 0,
) -> DatasetBundle:
    """Load by name; 67/33 split by a split-seeded permutation, z-scored with
    train stats (reference: datasets.py:47-76)."""
    loaded = _load_local(name)
    synthetic = False
    if loaded is None:
        loaded = _synthetic(name)
        synthetic = True
    X, Y = loaded
    n = X.shape[0]
    rng = np.random.default_rng(split)
    perm = rng.permutation(n)
    ntr = int(n * prop)
    tr_idx, te_idx = perm[:ntr], perm[ntr:]
    train = (X[tr_idx], Y[tr_idx])
    test = (X[te_idx], Y[te_idx])

    if normalize:
        (x_train, x_mu, x_std) = norm(train[0])
        (y_train, y_mu, y_std) = norm(train[1])
        x_test = (test[0] - x_mu) / x_std
        y_test = (test[1] - y_mu) / y_std
    else:
        (x_train, y_train), (x_test, y_test) = train, test

    def _cast(a, b):
        return np.asarray(a, dtype=dtype), np.asarray(b, dtype=dtype)

    return DatasetBundle(
        name,
        _cast(x_train, y_train),
        _cast(x_test, y_test),
        source="synthetic" if synthetic else "real",
    )
