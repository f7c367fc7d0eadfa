"""Closed-form baselines: mean predictor and linear regression.

A copy of ``cglb_tpu/experiments/baselines.py`` (numpy only; that package
cannot be imported without jax): sanity floors for RMSE and NLPD.
Implemented with plain numpy least squares (no sklearn dependency).
"""

from __future__ import annotations

import math

import numpy as np

from .datasets import DatasetBundle

__all__ = ["meanpred_baseline", "linear_baseline"]


def _gaussian_logpdf(y, mu, var):
    return -0.5 * (math.log(2 * math.pi) + np.log(var) + (y - mu) ** 2 / var)


def meanpred_baseline(bundle: DatasetBundle) -> dict:
    _, ytr = bundle.train
    _, yte = bundle.test
    mu, var = float(np.mean(ytr)), float(np.var(ytr))
    lml = float(np.sum(_gaussian_logpdf(ytr, mu, var)))
    rmse = float(np.sqrt(np.mean((yte - mu) ** 2)))
    lpd = float(np.mean(_gaussian_logpdf(yte, mu, var)))
    return {"lml": lml, "test/rmse": rmse, "test/nlpd": -lpd}


def linear_baseline(bundle: DatasetBundle) -> dict:
    xtr, ytr = bundle.train
    xte, yte = bundle.test
    A = np.concatenate([xtr, np.ones((xtr.shape[0], 1))], axis=1)
    coef, *_ = np.linalg.lstsq(A, ytr, rcond=None)
    resid = ytr - A @ coef
    var = float(np.var(resid))
    lml = float(np.sum(_gaussian_logpdf(ytr, A @ coef, var)))
    Ate = np.concatenate([xte, np.ones((xte.shape[0], 1))], axis=1)
    pred = Ate @ coef
    rmse = float(np.sqrt(np.mean((yte - pred) ** 2)))
    lpd = float(np.mean(_gaussian_logpdf(yte, pred, var)))
    return {"lml": lml, "test/rmse": rmse, "test/nlpd": -lpd}
