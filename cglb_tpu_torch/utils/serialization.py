"""Numpy-aware JSON save/load for model parameters and results.

A copy of ``cglb_tpu/utils/serialization.py`` (numpy only; that module
cannot be imported without jax), so a ``model.json`` or ``checkpoint.json``
written by either package loads into the other.

Replaces the reference's json_tricks dependency (tensorflow/interface.py:358-383,
cli.py:105-109) with a small first-party encoder: numpy arrays round-trip through
nested lists with dtype/shape metadata.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict

import numpy as np

__all__ = ["dump_json", "load_json", "save_model_params", "load_model_params",
           "save_checkpoint", "load_checkpoint"]


class _NumpyEncoder(json.JSONEncoder):
    def default(self, obj):
        if isinstance(obj, np.ndarray):
            return {
                "__ndarray__": obj.tolist(),
                "dtype": str(obj.dtype),
                "shape": list(obj.shape),
            }
        if isinstance(obj, (np.floating,)):
            return float(obj)
        if isinstance(obj, (np.integer,)):
            return int(obj)
        if isinstance(obj, (np.bool_,)):
            return bool(obj)
        if hasattr(obj, "tolist"):  # torch tensors and other array types
            return self.default(np.asarray(obj))
        return super().default(obj)


def _decode_hook(d):
    if "__ndarray__" in d:
        return np.asarray(d["__ndarray__"], dtype=d["dtype"]).reshape(d["shape"])
    return d


def dump_json(obj: Any, path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, cls=_NumpyEncoder)


def load_json(path) -> Any:
    with open(path) as f:
        return json.load(f, object_hook=_decode_hook)


def save_model_params(params_dict: Dict[str, np.ndarray], logdir) -> None:
    """Write model.json into logdir (reference: interface.py:358-363)."""
    dump_json(
        {k: np.asarray(v) for k, v in params_dict.items()},
        Path(logdir) / "model.json",
    )


def load_model_params(filepath) -> Dict[str, np.ndarray]:
    return load_json(filepath)


def save_checkpoint(logdir, params_dict: Dict[str, np.ndarray],
                    v0=None, extra: Dict = None) -> None:
    """Full-state checkpoint: the parameters and the CG warm start, so that
    a resumed run does not pay the cold-start CG cost."""
    state = {
        "params": {k: np.asarray(v) for k, v in params_dict.items()},
        "v0": None if v0 is None else np.asarray(v0),
        "extra": extra or {},
    }
    # atomic replace: a crash mid-write (what checkpoints exist for) must
    # not leave a truncated checkpoint.json behind
    path = Path(logdir) / "checkpoint.json"
    tmp = path.with_suffix(".json.tmp")
    dump_json(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(filepath) -> Dict:
    return load_json(filepath)
