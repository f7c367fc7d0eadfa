"""The one general generator: what a run sends, from a mix's data file and
the seed.

``"kind": "adam"``: a closed loop of back-to-back Adam steps on the whole
training split.  The file gives the steps of set-up (``warmup_steps``),
how many steps from the start are held to the reference
(``compared_steps``, more than set-up's, so that the window's first steps
are among them) and the traced slice's length (``trace_seconds``, at least
``trace_min_units`` steps).

``"kind": "predict"``: a closed loop of one client.  Request sizes are
log-uniform on [``rows_min``, ``rows_max``], stratified: each cycle holds
the ``cycle`` quantiles (j + 0.5) / cycle of that law once, in one fixed
order (by the fractional part of j times the golden ratio, so that large
and small requests alternate), the same for every seed; each request's
rows are drawn from the seed's test split without replacement.  The window ends with the first whole cycle at or after
``--seconds``, so every window holds the same sizes.  Set-up sends
``warmup_cycles`` cycles first; the traced slice is ``trace_min_units``
requests and at least ``trace_seconds``.

With ``rate_per_s`` the loop is open: request k is due k / rate after the
window opens, whatever came before it, and its latency runs from when it
was due (a wait behind earlier requests counts).  The window holds the
whole cycles that cover ``--seconds`` at that rate.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List

import numpy as np

__all__ = ["cycle_sizes", "requests"]


def cycle_sizes(mix: Dict) -> List[int]:
    """The sizes of one cycle, smallest first (set-up sends them so)."""
    lo, hi, n = int(mix["rows_min"]), int(mix["rows_max"]), int(mix["cycle"])
    a, b = math.log(lo), math.log(hi)
    return [min(hi, max(lo, int(round(math.exp(a + (j + 0.5) / n * (b - a))))))
            for j in range(n)]


def requests(mix: Dict, seed: int, n_rows: int) -> Iterator[np.ndarray]:
    """Endless row-index arrays, one a request."""
    rng = np.random.default_rng(seed)
    sizes = np.asarray(cycle_sizes(mix))
    order = sizes[np.argsort((np.arange(len(sizes)) * 0.6180339887498949)
                             % 1.0, kind="stable")]
    while True:
        for s in order:
            yield rng.choice(n_rows, size=min(int(s), n_rows),
                             replace=False)
