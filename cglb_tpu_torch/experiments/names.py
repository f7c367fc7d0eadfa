"""Logdir-path -> short display names for tables.

A copy of ``cglb_tpu/experiments/names.py`` (reference:
cglb_experiments/utils.py:19-47).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["short_names"]

_M_RE = re.compile(r"-M(\d+)")
_MODEL_RE = re.compile(r"^([a-z0-9]+)-")

_PRETTY = {
    "cglb": "CGLB",
    "cglbn2m": "CGLB-N2M",
    "cglbnm2": "CGLB-NM2",
    "sgpr": "SGPR",
    "sgprn2m": "SGPR-N2M",
    "gpr": "GPR",
}


def short_names(paths: Iterable[str]) -> Dict[str, str]:
    """Map each logdir path to a compact display name like 'CGLB M=2048'."""
    out = {}
    for p in paths:
        leaf = Path(p).name
        for part in Path(p).parts[::-1]:
            if _MODEL_RE.match(part):
                leaf = part
                break
        model_m = _MODEL_RE.match(leaf)
        model = _PRETTY.get(model_m.group(1), leaf) if model_m else leaf
        m_match = _M_RE.search(leaf)
        name = f"{model} M={m_match.group(1)}" if m_match else model
        out[str(p)] = name
    return out
