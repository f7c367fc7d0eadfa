"""Profiling hooks: torch.profiler traces, named regions and phase timers.

The counterpart of ``cglb_tpu/utils/profiling.py`` in PyTorch's idiom:

- :func:`trace` records a ``torch.profiler`` window, with the CUDA activity
  when the device is a card, and writes it as a Chrome trace (open it in
  ``chrome://tracing`` or Perfetto) into a directory;
- :func:`annotate` names a region inside such a window
  (``torch.profiler.record_function``);
- :class:`PhaseTimer` sums host wall time per phase, and synchronizes the
  card at the end of a phase so that its time is that of the device work,
  not of its enqueueing.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Dict, Optional, Union

import torch

__all__ = ["trace", "annotate", "PhaseTimer"]


@contextlib.contextmanager
def trace(logdir, device: Optional[Union[str, torch.device]] = None):
    """Profile the block and write ``trace.<pid>.<ns>.json`` into
    ``logdir``; yields the ``torch.profiler.profile`` (its
    ``key_averages()`` and the written file's path, ``.trace_path``, are
    read after the block).  ``device``: CUDA activity for a CUDA device
    (default: when CUDA is available)."""
    if device is None:
        cuda = torch.cuda.is_available()
    else:
        cuda = torch.device(device).type == "cuda"
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.trace_path = out / f"trace.{os.getpid()}.{time.time_ns()}.json"
    prof.export_chrome_trace(str(prof.trace_path))


def annotate(name: str):
    """A named region inside a trace."""
    return torch.profiler.record_function(name)


def _synchronize(sync) -> None:
    """Wait for the card that ``sync`` (a tensor or a device) lives on; a
    CPU tensor or device needs no wait."""
    device = sync.device if isinstance(sync, torch.Tensor) else torch.device(
        sync)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Cumulative wall-clock per phase; with ``sync`` the device is
    synchronized at the phase's end, so the time is that of its work."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = ["phase                     total_s   calls   mean_ms"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:24s} {t:8.3f}  {c:6d}  {t / c * 1e3:8.2f}")
        return "\n".join(lines)
