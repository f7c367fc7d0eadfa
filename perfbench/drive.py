"""Drives the program (``cglb_tpu_torch``) through one run of a cell.

The timed entries are the program's own: ``utils.training.adam_minimize``
over ``backend.Model.loss_fn()`` for an ``adam`` mix (the calls of the CLI's
``Torch.optimize``), ``backend.Model.predict_log_density`` for a
``predict`` mix.  Nothing else of the program is called in the window.

An ``adam`` run is one call of ``adam_minimize``: one model and one
optimizer from set-up to the end.  Its first ``warmup_steps`` steps are
set-up (the first of them builds the kernels); the window opens after them
with the card idle and closes, with the card idle, at the first step that
starts ``seconds`` after it opened, and not before the first
``compared_steps`` steps from the start are done: those the reference
follows, so the window's own first steps are among them.
``adam_minimize`` has no stopping rule of its own, so the harness's loss
function raises :class:`_Closed` instead of starting that step: every step
of the window is a whole step.

On several ranks (``ranks``, a :class:`perfbench.ranks.Ranks`) the model
holds the program's mesh (``make_mesh``), the window opens once every rank
is ready, and every decision that reads the clock (closing the window,
ending the traced slice, a closed loop's next request) is rank 0's, shared
before the step or request starts; only rank 0 traces its card.
"""

from __future__ import annotations

import contextlib
import json
import math
import time
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from . import traffic as _traffic
from .spec import ROOT
from .tracing import DeviceTrace, KernelRecorder, launch_counts

__all__ = ["start_values", "make_mesh", "build_model", "run_adam",
           "run_predict", "p95"]


class _Closed(Exception):
    """The window (and a traced run's slice) is over."""


class _Logger:
    """The logger ``adam_minimize`` calls after each step; it records
    nothing (the step hook does)."""

    class timer:  # noqa: N801 - the attribute adam_minimize reads
        @staticmethod
        def reset():
            pass

        @staticmethod
        def start():
            pass

    def __call__(self, i):
        pass

    def log_for_feval(self, **kw):
        pass


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def start_values(cfg: Dict, root=ROOT) -> Dict[str, np.ndarray]:
    """The configuration's starting parameters (constrained values)."""
    saved = json.loads((root / cfg["start"]).read_text())["params"]
    out = {}
    for k, v in saved.items():
        out[k] = np.asarray(v["__ndarray__"], dtype=v["dtype"]).reshape(
            v["shape"])
    return out


def make_mesh(chips: int, device: torch.device):
    """This rank's mesh of ``chips`` ranks (the CLI's ``--mesh chips``),
    joining the ranks' group by the program's launch contract."""
    from cglb_tpu_torch.backend import make_mesh as program_mesh

    return program_mesh(chips, device)


def build_model(cfg: Dict, train, device: torch.device, values: Dict,
                mesh=None):
    """The program's Model for configuration ``cfg`` on the training split,
    at the parameters ``values``; with ``mesh``, column-sharded over its
    ranks (every rank holds all of X)."""
    from cglb_tpu_torch import config as pconf
    from cglb_tpu_torch.backend import Model
    from cglb_tpu_torch.ops.kernels import make_kernel
    from cglb_tpu_torch.utils.flatten import assign_parameters

    pconf.set_default_float(cfg["dtype"])
    pconf.set_default_jitter(cfg["jitter"])
    dtype = pconf.torch_dtype()
    X = torch.as_tensor(train[0], dtype=dtype, device=device)
    Y = torch.as_tensor(train[1], dtype=dtype, device=device)
    kernel = make_kernel(cfg["kernel"], X.shape[1], device=device)
    if cfg["model"] == "cglb":
        from cglb_tpu_torch.models.cglb import CGLBConfig
        from cglb_tpu_torch.models.sgpr import SGPRParams

        params = SGPRParams(kernel, values[".inducing_Z"], device=device)
        assign_parameters(params, values)
        run_cfg = CGLBConfig(max_error=cfg["max_error"],
                             max_cg_iters=cfg["max_cg_iters"],
                             restart_cg_iters=cfg["restart_cg_iters"],
                             precond_dtype=cfg["precond_dtype"])
        return Model("cglb", params, (X, Y), run_cfg, matvec=cfg["matvec"],
                     mesh=mesh)
    raise ValueError(f"unknown model {cfg['model']!r}")


def _raws(model) -> Dict[str, torch.Tensor]:
    return {name: p.raw for name, p in model.params.named_params()
            if p.trainable}


def run_adam(model, cfg: Dict, mix: Dict, seconds: float, trace: bool,
             device: torch.device, ranks=None) -> SimpleNamespace:
    """One run of an ``adam`` mix.  Returns the window (steps, seconds,
    non-finite losses), set-up's end on the host clock, what the reference
    checks (the first ``compared_steps`` losses, set-up's and the
    window's, the first gradient as Adam got it, the raw leaves before and
    after those steps) and, when traced, the recorder, the counters and
    the device trace."""
    from cglb_tpu_torch.utils.training import adam_minimize

    warm, compared = int(mix["warmup_steps"]), int(mix["compared_steps"])
    if compared <= warm:
        raise ValueError("compared_steps <= warmup_steps: the window's "
                         "steps would go unchecked")
    loss_fn = model.loss_fn()
    raws = _raws(model)
    out = SimpleNamespace(
        losses=[], grad0=None, theta0={k: v.detach().clone()
                                       for k, v in raws.items()},
        theta_c=None, steps=0, seconds=0.0, failed=0, setup_end=None,
        recorder=KernelRecorder() if trace else None, counters=None,
        slice_recorder=KernelRecorder() if trace else None,
        device_trace=None, trace_units=0)
    st = SimpleNamespace(i=0, phase="setup", t0=0.0, i0=0, tt0=0.0)
    bad = torch.zeros((), dtype=torch.int64, device=device)
    carry = model.carry_in()
    traces = trace and (ranks is None or ranks.rank == 0)

    def close_window():
        _sync(device)
        if ranks is not None:
            ranks.barrier()
        out.seconds = time.perf_counter() - st.t0
        out.steps = st.i - st.i0
        out.failed = int(bad)
        if not trace:
            raise _Closed
        out.recorder.__exit__(None, None, None)
        out.counters = {k: v - out.counters[k]
                        for k, v in launch_counts().items()}
        out.slice_recorder.__enter__()
        if traces:
            out.device_trace = DeviceTrace(device.type == "cuda").__enter__()
        st.phase, st.tt0, st.i0 = "trace", time.perf_counter(), st.i

    def action() -> int:
        """1: close the window before this step; 2: end the slice."""
        now = time.perf_counter()
        if (st.phase == "window" and now - st.t0 >= seconds
                and st.i >= compared):
            return 1
        if st.phase == "trace" and (
                now - st.tt0 >= mix["trace_seconds"]
                and st.i - st.i0 >= mix["trace_min_units"]):
            return 2
        return 0

    def feed(params, state, *args):
        act = action()
        if ranks is not None and st.phase != "setup":
            act = ranks.agree(act)
        if act == 1:
            close_window()
        elif act == 2:
            if traces:
                out.device_trace.__exit__(None, None, None)
            out.slice_recorder.__exit__(None, None, None)
            out.trace_units = st.i - st.i0
            raise _Closed
        if trace:
            out.recorder.unit = out.slice_recorder.unit = st.i
        loss, state = loss_fn(params, state, *args)
        if st.i < compared:
            out.losses.append(loss.detach().clone())
        if st.phase == "window":
            bad.add_(torch.logical_not(torch.isfinite(loss.detach())).long())
        return loss, state

    def hook(params, state):
        # after opt.step(): the gradients are still those Adam took
        if st.i == 0:
            out.grad0 = {k: v.grad.detach().clone() for k, v in raws.items()}
        if st.i == compared - 1:
            out.theta_c = {k: v.detach().clone() for k, v in raws.items()}
        if st.i == warm - 1:
            _sync(device)
            if ranks is not None:
                ranks.opened()
            if trace:
                out.counters = launch_counts()
                out.recorder.__enter__()
            st.phase, st.i0 = "window", st.i + 1
            st.t0 = out.setup_end = time.perf_counter()
        st.i += 1

    try:
        adam_minimize(feed, model.params, carry, warm + 10 ** 9,
                      float(cfg["learning_rate"]), logger=_Logger(),
                      sync_fn=hook)
    except _Closed:
        pass
    out.losses = [float(x) for x in out.losses]
    return out


def run_predict(model, test, cfg: Dict, mix: Dict, seconds: float,
                trace: bool, seed: int, device: torch.device, ranks=None
                ) -> SimpleNamespace:
    """One run of a ``predict`` mix: requests from one client, back to
    back or (``rate_per_s``) each at its due time, each
    ``Model.predict_log_density`` on host arrays of its rows, ended when
    the log densities are on the host.  Records each request's rows,
    latency, log densities and the mean and variance the model computed
    for them (read from its ``predict_f_batched``)."""
    Xs, Ys = test
    tol = float(mix["cg_tolerance"])
    captured = {}
    predict_f = model.predict_f_batched

    def capture(*args, **kwargs):
        captured["f"] = predict_f(*args, **kwargs)
        return captured["f"]

    model.predict_f_batched = capture
    out = SimpleNamespace(rows=[], latency=[], logdens=[], mean=[], var=[],
                          units=0, seconds=0.0, failed=0, setup_end=None,
                          recorder=KernelRecorder() if trace else None,
                          slice_recorder=KernelRecorder() if trace else None,
                          counters=None, device_trace=None, trace_units=0)

    def request(idx, keep: bool, due: Optional[float] = None):
        xs, ys = Xs[idx], Ys[idx]
        if due is not None and due > time.perf_counter():
            time.sleep(due - time.perf_counter())
        t0 = time.perf_counter() if due is None else due
        ld = model.predict_log_density((xs, ys), cg_tolerance=tol)
        ld = ld.cpu().numpy()
        lat = time.perf_counter() - t0
        if keep:
            mean, var = captured["f"]
            out.rows.append(idx)
            out.latency.append(lat)
            out.logdens.append(ld)
            out.mean.append(mean[:, 0])
            out.var.append(var[:, 0])
            out.failed += int(not np.all(np.isfinite(ld)))

    # set-up sends every size of the mix once: the allocator holds a block
    # of each before the window opens
    warm_rng = np.random.default_rng([seed, 1])
    for _ in range(int(mix["warmup_cycles"])):
        for s in _traffic.cycle_sizes(mix):
            request(warm_rng.choice(len(Xs), size=min(s, len(Xs)),
                                    replace=False), keep=False)
    sched = _traffic.requests(mix, seed, len(Xs))
    _sync(device)
    if ranks is not None:
        ranks.opened()
    if trace:
        out.counters = launch_counts()
        out.recorder.__enter__()
    cycle = int(mix["cycle"])
    rate = mix.get("rate_per_s")
    count = (None if rate is None
             else -(-int(math.ceil(seconds * rate)) // cycle) * cycle)

    def due(k):
        return None if rate is None else t0 + k / rate

    def more(going: bool) -> bool:
        return going if ranks is None else bool(ranks.agree(going))

    t0 = out.setup_end = time.perf_counter()
    while (len(out.rows) < count if rate is not None else
           more(time.perf_counter() - t0 < seconds or len(out.rows) % cycle)):
        if out.recorder is not None:
            out.recorder.unit = len(out.rows)
        request(next(sched), True, due(len(out.rows)))
    out.seconds = time.perf_counter() - t0
    out.units = len(out.rows)
    if trace:
        out.recorder.__exit__(None, None, None)
        out.counters = {k: v - out.counters[k]
                        for k, v in launch_counts().items()}
        tracer = (DeviceTrace(device.type == "cuda")
                  if ranks is None or ranks.rank == 0
                  else contextlib.nullcontext())
        with out.slice_recorder, tracer as dt:
            tt0 = time.perf_counter()
            while more(time.perf_counter() - tt0 < mix["trace_seconds"]
                       or out.trace_units < mix["trace_min_units"]):
                idx = next(sched)
                out.slice_recorder.unit = len(out.rows)
                request(idx, True, due(len(out.rows)))
                out.trace_units += 1
        out.device_trace = dt
    del model.predict_f_batched
    return out


def p95(values) -> Optional[float]:
    """The 95th percentile (linear between order statistics)."""
    if not values:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))

