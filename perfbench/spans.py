"""The program's spans in a traced slice, and the per-layer metrics that
read them.

The program names its layers with ``cglb.*`` spans (``cglb_tpu_torch/utils/
profiling.py`` ``annotate``): each Adam step is a ``cglb.step``, each
prediction request a ``cglb.predict`` (the unit spans), and a step's or
request's spans nest inside its unit span.  :class:`Timeline` puts the
slice's device work and idle time to them:

- device time: each kernel, copy and fill goes to the program spans whose
  host interval holds the host time of its launch (the runtime call with
  its correlation id), whatever thread launched it: the backward's kernels
  are launched from autograd's device thread, inside ``cglb.backward``'s
  interval on the main thread.  Where it ran on the device timeline does
  not decide.  A span's time is that of the work launched inside it, its
  child spans' included.
- idle time: each gap between the device's merged intervals goes to the
  innermost program span open at the gap's start (``DeviceTrace.
  idle_by_host_op``'s rule, restricted to the program's spans).
- slice edges: a slice may start and stop inside a unit (``drive.py``'s
  ``adam`` slice does both); a span cut by the slice's end ends there, and
  :meth:`Timeline.coverage` counts from the first unit span on.

The events are the profiler's (``ctx.trace._prof``), in the Chrome trace's
form.  A profiler writes its Chrome trace once, and ``DeviceTrace`` has
written it: :func:`chrome_events` rebuilds those events from the
profiler's results, on their one clock.  The parse is made once a context.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from .tracing import DEVICE_CATEGORIES

__all__ = ["PREFIX", "UNITS", "READS", "chrome_events", "Timeline",
           "timeline", "span_ms", "read_wait_ms", "host_reads"]

PREFIX = "cglb."
# the unit span of each kind of mix: one a step or request
UNITS = {"adam": "cglb.step", "predict": "cglb.predict"}
# the spans around a read of the card back to the host
READS = ("cglb.cg.read", "cglb.chol.read")


def chrome_events(prof) -> List[Dict]:
    """The events of a stopped ``torch.profiler.profile`` as its Chrome
    trace has them (``ph`` "X", ``name``, ``cat``, ``ts`` and ``dur`` in
    microseconds from the trace's start, ``tid``, ``args.correlation``):
    the host's ops and annotations, the runtime calls that launched device
    work, and the device's kernels, copies and fills.  The GPU-side spans of
    annotations are left out.  A runtime call shares its correlation id and
    its enclosing op with the work it launched, and is named ``cu*``."""
    result = prof.profiler.kineto_results
    t0 = result.trace_start_ns()
    cuda = torch.autograd.DeviceType.CUDA
    raw = list(result.events())
    on_device = {(e.correlation_id(), e.linked_correlation_id())
                 for e in raw if e.device_type() == cuda}
    out = []
    for e in raw:
        name = e.name()
        key = (e.correlation_id(), e.linked_correlation_id())
        if e.device_type() == cuda:
            if e.is_user_annotation() or name.startswith(PREFIX):
                continue
            cat = ("gpu_memcpy" if name.startswith("Memcpy") else
                   "gpu_memset" if name.startswith("Memset") else "kernel")
        elif e.is_user_annotation():
            cat = "user_annotation"
        elif key in on_device and name.startswith("cu"):
            cat = "cuda_runtime"
        else:
            cat = "cpu_op"
        dur = (e.end_ns() - e.start_ns() if e.end_ns() >= e.start_ns()
               else -1)
        out.append({"ph": "X", "name": name, "cat": cat,
                    "ts": (e.start_ns() - t0) / 1e3, "dur": dur / 1e3,
                    "tid": e.start_thread_id(),
                    "args": {"correlation": e.correlation_id()}})
    return out


Span = Tuple[float, float, str]  # (start, end, name), microseconds


def _open_at(spans: Sequence[Span], times: Iterable[float]
             ) -> List[Tuple[str, ...]]:
    """For each of ``times`` (ascending), the names of the spans open at it,
    outermost first: a sweep over the spans in start order with a stack of
    the open ones (the program's spans nest)."""
    order = sorted(spans, key=lambda s: (s[0], -s[1]))
    stack: List[Span] = []
    out = []
    k = 0
    for t in times:
        while k < len(order) and order[k][0] <= t:
            while stack and stack[-1][1] < order[k][0]:
                stack.pop()
            stack.append(order[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(tuple(s[2] for s in stack if s[1] >= t))
    return out


def _merged(intervals: Iterable[Tuple[float, float]]
            ) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


class Timeline:
    """A slice's device work and idle time put to the program's spans, in
    microseconds; ``events`` in the Chrome trace's form."""

    def __init__(self, events: Iterable[Dict]):
        raw_spans, launch, work = [], {}, []
        end = 0.0
        for ev in events:
            if ev.get("ph") != "X":
                continue
            ts, dur = float(ev["ts"]), float(ev.get("dur", -1))
            end = max(end, ts + dur)
            cat, name = ev.get("cat"), str(ev.get("name", ""))
            corr = ev.get("args", {}).get("correlation")
            if cat == "user_annotation" and name.startswith(PREFIX):
                raw_spans.append((ts, dur, name))
            elif cat in ("cuda_runtime", "cuda_driver"):
                launch[corr] = ts
            elif cat in DEVICE_CATEGORIES:
                work.append((ts, dur, corr))
        # a span left open at the slice's end ends there
        self.spans: List[Span] = [(s, s + d if d >= 0 else end, n)
                                  for s, d, n in raw_spans]
        self.counts = Counter(n for _, _, n in self.spans)
        # (launch time, device us, names of the spans open at the launch)
        launched = sorted((launch[c], d) for _, d, c in work if c in launch)
        self.work = [(t, d, names) for (t, d), names in zip(
            launched, _open_at(self.spans, (t for t, _ in launched)))]
        self.unmatched = [(s, d) for s, d, c in work if c not in launch]
        self.device_us: Dict[str, float] = defaultdict(float)
        for _, d, names in self.work:
            for n in set(names):
                self.device_us[n] += d
        self.idle_us: Dict[str, float] = defaultdict(float)
        iv = _merged((s, s + d) for s, d, _ in work)
        gaps = [(e0, s1 - e0) for (_, e0), (s1, _) in zip(iv, iv[1:])]
        for (_, gap), names in zip(gaps, _open_at(self.spans,
                                                  (t for t, _ in gaps))):
            self.idle_us[names[-1] if names else ""] += gap

    def coverage(self, unit: str) -> Optional[float]:
        """The share of the device time launched from the first ``unit``
        span's start on (work without a launch found: from its device
        start) that was launched inside a ``unit`` span."""
        starts = [s for s, _, n in self.spans if n == unit]
        if not starts:
            return None
        first = min(starts)
        total = sum(d for t, d, _ in self.work if t >= first)
        total += sum(d for s, d in self.unmatched if s >= first)
        inside = sum(d for t, d, names in self.work
                     if t >= first and unit in names)
        return inside / total if total > 0 else None


def timeline(ctx, kind: str) -> Optional[Timeline]:
    """The slice's Timeline (made once a context), or None: another kind
    of mix, no device events (the CPU), or no unit span (a program without
    the spans)."""
    if ctx.kind != kind or not ctx.slice_units or not ctx.trace.device:
        return None
    tl = getattr(ctx, "spans_timeline", None)
    if tl is None:
        tl = ctx.spans_timeline = Timeline(chrome_events(ctx.trace._prof))
    return tl if tl.counts[UNITS[kind]] else None


def span_ms(ctx, kind: str, name: str) -> Optional[float]:
    """Device ms launched inside the span ``name`` per step or request."""
    tl = timeline(ctx, kind)
    return None if tl is None else tl.device_us[name] / 1e3 / ctx.slice_units


def read_wait_ms(ctx, kind: str) -> Optional[float]:
    """Device idle ms per step or request in gaps that begin inside a read
    of the card back to the host."""
    tl = timeline(ctx, kind)
    if tl is None:
        return None
    return sum(tl.idle_us[n] for n in READS) / 1e3 / ctx.slice_units


def host_reads(ctx, kind: str) -> Optional[float]:
    """Reads of the card back to the host per step or request."""
    tl = timeline(ctx, kind)
    if tl is None:
        return None
    return sum(tl.counts[n] for n in READS) / ctx.slice_units
