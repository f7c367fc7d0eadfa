"""What a traced run reads from the program: its launchers' calls and
counters, and the card's timeline under ``torch.profiler``.

- :class:`KernelRecorder` logs every call of the launchers of kernels 1-3
  (``ops.matvec.launch_matvec``, ``launch_ls_grad``, ``ops.kuf.launch_kuf``)
  with its shapes, from the arguments, at the data's D.  The wrappers share
  the launchers' attribute dicts, so the program's launch counters count on.
- :class:`DeviceTrace` profiles a slice (kernels, copies and fills on the
  card, the host's ops) and reads it back from the profiler's Chrome trace:
  the device intervals, their union (busy time) and the host ops that were
  running while the card idled.  The method is ``chip_smoke.py``'s
  ``profiled_steps`` (commit 010f438): device work is kernels, copies and
  fills only; the GPU-side spans of annotations cover work already counted
  and are left out.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from .counts import KernelCall

__all__ = ["KernelRecorder", "DeviceTrace", "launch_counts",
           "DEVICE_CATEGORIES"]

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _modules():
    from cglb_tpu_torch.ops import kuf, matvec
    return matvec, kuf


def launch_counts() -> Dict[str, int]:
    """The program's launch counters of kernels 1-3."""
    mv, kf = _modules()
    return {"matvec": mv.launch_matvec.launches,
            "matvec_accurate": mv.launch_matvec.accurate_launches,
            "ls_grad": mv.launch_ls_grad.launches,
            "kuf": kf.launch_kuf.launches}


class KernelRecorder:
    """Within the block, ``calls`` gets (unit, KernelCall) for every call
    of a launcher of kernels 1-3; ``unit`` is whatever the driver set last
    (the step or request in progress)."""

    def __init__(self):
        self.calls: List[Tuple[int, KernelCall]] = []
        self.unit = -1
        self._saved = []

    def _wrap(self, module, name, shape_of):
        orig = getattr(module, name)

        def wrapper(*args, **kwargs):
            self.calls.append((self.unit, shape_of(*args, **kwargs)))
            return orig(*args, **kwargs)

        wrapper.__dict__ = orig.__dict__  # the counters stay one object
        setattr(module, name, wrapper)
        self._saved.append((module, name, orig))

    def __enter__(self):
        mv, kf = _modules()

        def matvec_shape(rows, cols, p, accurate):
            return KernelCall("matvec", rows.n, cols.n, rows.xg.shape[1],
                              p.shape[0], bool(accurate), rows is cols)

        def ls_grad_shape(rows, cols, p, g):
            return KernelCall("ls_grad", rows.n, cols.n, rows.xg.shape[1],
                              p.shape[0], True, rows is cols)

        def kuf_shape(zg, xg, var, family, with_e=True):
            return KernelCall("kuf", zg.shape[0], xg.shape[0], zg.shape[1],
                              1, True, False, bool(with_e))

        self._wrap(mv, "launch_matvec", matvec_shape)
        self._wrap(mv, "launch_ls_grad", ls_grad_shape)
        self._wrap(kf, "launch_kuf", kuf_shape)
        return self

    def __exit__(self, *exc):
        for module, name, orig in reversed(self._saved):
            setattr(module, name, orig)
        self._saved.clear()
        return False


class DeviceTrace:
    """A ``torch.profiler`` window over the block (the card's activity and
    the host's ops), read back when it closes: ``device`` holds (name,
    start_us, dur_us) of every kernel, copy and fill; ``host`` the host's
    ops (name, start_us, dur_us); ``window_s`` the host-clock length of the
    window, which starts and ends with the card idle."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.device: List[Tuple[str, float, float]] = []
        self.host: List[Tuple[str, float, float]] = []
        self.window_s = 0.0
        self._prof = None
        self._t0 = 0.0

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._sync()
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read()
        return False

    def _read(self):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            row = (str(ev.get("name", "")), float(ev["ts"]), float(ev["dur"]))
            cat = ev.get("cat", "")
            if cat in DEVICE_CATEGORIES:
                self.device.append(row)
            elif cat in ("cpu_op", "user_annotation"):
                self.host.append(row)

    # ------------------------------------------------------------------
    # readings

    def intervals(self) -> List[Tuple[float, float]]:
        """The union of the device intervals, merged, in microseconds."""
        spans = sorted((s, s + d) for _, s, d in self.device)
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) * 1e-6

    def device_seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, _, dur in self.device:
            out[name] += dur * 1e-6
        return dict(out)

    def idle_by_host_op(self) -> Dict[str, float]:
        """The card's idle gaps between its first and last interval, each
        put to the innermost host op running at the gap's start (a sweep
        over the host ops in start order with a stack of the open ones)."""
        iv = self.intervals()
        host = sorted(self.host, key=lambda h: h[1])
        out: Dict[str, float] = defaultdict(float)
        stack: List[Tuple[float, str]] = []  # (end, name) of open ops
        k = 0
        for (_, e0), (s1, _) in zip(iv, iv[1:]):
            while k < len(host) and host[k][1] <= e0:
                name, hs, hd = host[k]
                while stack and stack[-1][0] < hs:
                    stack.pop()
                stack.append((hs + hd, name))
                k += 1
            while stack and stack[-1][0] < e0:
                stack.pop()
            out[stack[-1][1] if stack else "(no host op)"] += (s1 - e0) * 1e-6
        return dict(out)


def top(table: Dict[str, float], n: int = 10) -> List[List]:
    """The ``n`` largest entries as [name, seconds]."""
    return [[k, v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])
            [:n]]
