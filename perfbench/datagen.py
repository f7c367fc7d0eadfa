"""The kin40k stand-in data, frozen.

Origin: ``cglb_tpu_torch/experiments/datasets.py`` at commit 010f438
(``DATASET_SHAPES``, ``_synthetic``, ``norm`` and the split and z-scoring of
``get_dataset``), copied so that a later change to the program cannot change
the benchmark's inputs.  The real ``Wilson_kin40k.npz`` is not in the
repository; the stand-in has its shape (40000 rows, D 8) and a smooth
random-feature target with noise at about a quarter of the signal variance.

The dataset itself is the generator's seed-0 draw, as in the program.  The
run's seed picks the 67/33 split, as the protocol's ``split`` does: every
seed gives the same 26800 / 13200 rows of the same data, in another
partition.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

__all__ = ["DATASET_SHAPES", "synthetic", "norm", "split_dataset"]

Dataset = Tuple[np.ndarray, np.ndarray]

DATASET_SHAPES = {
    "Wilson_bike": (17379, 17),
    "Wilson_elevators": (16599, 18),
    "Wilson_kin40k": (40000, 8),
    "Wilson_pol": (15000, 26),
    "Wilson_protein": (45730, 9),
    "Wilson_keggundirected": (63608, 27),
    "Wilson_houseelectric": (2049280, 11),
}


def norm(x: np.ndarray):
    """Z-score with train statistics."""
    mu = np.mean(x, axis=0, keepdims=True)
    std = np.std(x, axis=0, keepdims=True) + 1e-6
    return (x - mu) / std, mu, std


def synthetic(name: str, seed: int = 0) -> Dataset:
    """Deterministic GP-flavoured data with the dataset's shape (the
    program's ``_synthetic``)."""
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
    nf = 64
    W = rng.normal(size=(dim, nf)) / np.sqrt(dim)
    b = rng.uniform(0, 2 * np.pi, size=(nf,))
    w2 = rng.normal(size=(nf, 1)) / np.sqrt(nf)
    signal = np.sqrt(2.0) * np.cos(X @ W + b) @ w2
    Y = signal + 0.5 * np.std(signal) * rng.normal(size=(n, 1))
    return X, Y


def split_dataset(name: str, split: int, prop: float = 0.67
                  ) -> Tuple[Dataset, Dataset]:
    """(train, test) of the stand-in: a ``split``-seeded permutation cut at
    ``prop``, z-scored with the train split's statistics, fp64 (the
    program's ``get_dataset(name, split=split)``)."""
    X, Y = synthetic(name)
    n = X.shape[0]
    perm = np.random.default_rng(split).permutation(n)
    ntr = int(n * prop)
    tr, te = perm[:ntr], perm[ntr:]
    x_train, x_mu, x_std = norm(X[tr])
    y_train, y_mu, y_std = norm(Y[tr])
    x_test = (X[te] - x_mu) / x_std
    y_test = (Y[te] - y_mu) / y_std
    f64 = np.float64
    return ((np.asarray(x_train, f64), np.asarray(y_train, f64)),
            (np.asarray(x_test, f64), np.asarray(y_test, f64)))
