"""Profiling hooks: torch.profiler traces and named spans.

The counterpart of ``cglb_tpu/utils/profiling.py`` in PyTorch's idiom:

- :func:`trace` records a ``torch.profiler`` window, with the CUDA activity
  when the device is a card, and writes it as a Chrome trace (open it in
  ``chrome://tracing`` or Perfetto) into a directory;
- :func:`annotate` names a span inside such a window
  (``torch.profiler.record_function``), and costs nothing without one.

The program's spans are named ``cglb.*`` (README.md, "Tracing"); they
nest, so that each step's or request's spans sit inside its top span.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Optional, Union

import torch

__all__ = ["trace", "annotate"]

_OFF = contextlib.nullcontext()


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
    """A named span inside a trace (``torch.profiler.record_function``).
    With no profiler running it is one shared null context: entering a
    ``record_function`` costs several microseconds even then, and the spans
    sit in loops that read the card back every iteration."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
