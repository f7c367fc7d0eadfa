"""The numbers that decide ``correct``, and the check against their limits.

Training: each compared step's loss, the first gradient as the optimizer
got it, and the change of the raw leaves over the compared steps.  The
gradient and the change are judged by the worst leaf: the gap between the
program's norm and the reference's, over the larger of the reference's norm
of that leaf and of the median leaf.  Leaves whose reference gradient lies
under a thousandth of the median leaf's move under Adam by round-off alone
and are left out of the change.

Prediction: every row of every request the run finished, against the
reference at that test row: the mean (absolute), the variance (relative)
and the log density (nats).
"""

from __future__ import annotations

import math
import statistics
import sys
from typing import Dict, List

import numpy as np
import torch

__all__ = ["training_numbers", "prediction_numbers", "judge"]

SILENT_LEAF = 1e-3


def _nan_to_inf(x: float) -> float:
    return x if math.isfinite(x) else float("inf")


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            leaves.items()}


def _worst_leaf(prog: Dict, ref: Dict, keys: List[str]) -> float:
    p, r = _norms({k: prog[k] for k in keys}), _norms({k: ref[k]
                                                       for k in keys})
    med = statistics.median(r.values())
    return max(_nan_to_inf(abs(p[k] - r[k]) / max(r[k], med, 1e-300))
               for k in keys)


def training_numbers(losses, grad0, theta0, theta_c,
                     ref_losses, ref_grad0, ref_theta0, ref_theta_c
                     ) -> Dict[str, float]:
    """The three training numbers; every argument is the program's or the
    reference's (``ref_*``) own."""
    keys = list(ref_grad0)
    loss_gap = max(_nan_to_inf(abs(a - b) / abs(b))
                   for a, b in zip(losses, ref_losses))
    if len(losses) != len(ref_losses):
        loss_gap = float("inf")
    gnorm = _norms(ref_grad0)
    med = statistics.median(gnorm.values())
    moved = [k for k in keys if gnorm[k] >= SILENT_LEAF * med]
    change = {k: theta_c[k] - theta0[k] for k in keys}
    ref_change = {k: ref_theta_c[k] - ref_theta0[k] for k in keys}
    print("losses " + " ".join(f"{a!r}/{b!r}" for a, b in
                               zip(losses, ref_losses)), file=sys.stderr)
    for name, a, b in (("grad", grad0, ref_grad0), ("change", change,
                                                   ref_change)):
        pa, pb = _norms(a), _norms(b)
        print(f"{name} norms " + " ".join(f"{k}:{pa[k]:.6g}/{pb[k]:.6g}"
                                          for k in keys), file=sys.stderr)
    return {"loss_gap": loss_gap,
            "grad_gap": _worst_leaf(grad0, ref_grad0, keys),
            "change_gap": _worst_leaf(change, ref_change, moved)}


def prediction_numbers(rows, mean, var, logdens, ref_mean, ref_var,
                       ref_logdens) -> Dict[str, float]:
    """Gaps over every request: ``rows`` the requests' test-row indices,
    the others per request (the program's) or per test row (``ref_*``,
    numpy)."""
    idx = np.concatenate(rows)
    m = np.concatenate([np.asarray(x, dtype=np.float64) for x in mean])
    v = np.concatenate([np.asarray(x, dtype=np.float64) for x in var])
    ld = np.concatenate([np.asarray(x, dtype=np.float64) for x in logdens])

    def worst(a):
        a = np.abs(a)
        return _nan_to_inf(float(np.max(a))) if np.all(np.isfinite(a)) \
            else float("inf")

    return {"mean_gap": worst(m - ref_mean[idx]),
            "var_gap": worst((v - ref_var[idx]) / ref_var[idx]),
            "logdens_gap": worst(ld - ref_logdens[idx])}


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): each number beside its limit, also printed as the
    last lines on standard error."""
    checks = {}
    ok = True
    for k, limit in limits.items():
        v = numbers.get(k, float("inf"))
        good = v <= limit
        ok = ok and good
        checks[k] = {"value": v, "limit": limit}
        print(f"check {k} {v!r} limit {limit!r} {'ok' if good else 'FAIL'}",
              file=sys.stderr)
    return ok, checks
