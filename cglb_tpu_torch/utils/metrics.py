"""Metric assembly: RMSE and NLPD from prediction errors / log densities.

A copy of ``cglb_tpu/utils/metrics.py`` (numpy only).

Reference semantics: cglb/backend/metric.py:24-54 — metric callables return
dicts of floats; train/test RMSE and NLPD are computed from the concatenated
train+test prediction pass (tensorflow/interface.py:430-450).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

__all__ = ["call_metric_fns", "rmse_and_lpd_fn"]


def call_metric_fns(*fns: Callable[[], Dict]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for fn in fns:
        for k, v in fn().items():
            out[k] = float(np.asarray(v))
    return out


def rmse_and_lpd_fn(
    error_logdensity_cb: Callable[[], Tuple[tuple, tuple]],
) -> Callable[[], Dict[str, float]]:
    """Wrap a callback returning ((train_err, test_err), (train_ld, test_ld))."""

    def inner() -> Dict[str, float]:
        errs, logdens = error_logdensity_cb()
        train_err, test_err = (np.asarray(e) for e in errs)
        train_ld, test_ld = (np.asarray(l) for l in logdens)
        return {
            "train/rmse": float(np.sqrt(np.mean(train_err ** 2))),
            "test/rmse": float(np.sqrt(np.mean(test_err ** 2))),
            "train/nlpd": float(-np.mean(train_ld)),
            "test/nlpd": float(-np.mean(test_ld)),
        }

    return inner
