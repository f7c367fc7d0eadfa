"""Run logging: pausable wall-clock StopWatch and the metrics Logger.

A copy of ``cglb_tpu/utils/logging.py``.  Elapsed time excludes metric
evaluation (the StopWatch is paused around it); metrics and parameters
(inducing points excluded) are recorded every ``holdout_interval`` optimizer
steps, and optionally CG stats on every function evaluation
(``<key>-per-feval``), into the in-memory logs that the CLI dumps to
``logs.json``.  With ``tensorboard=True`` (the default) and a logdir, every
recorded step also goes to TensorBoard scalars (``utils/tfevents.py``, an
``events.out.tfevents.*`` file in the logdir) under the JAX Logger's tags
and steps: ``elapsed_time``, the kernel and likelihood parameters one scalar
per dimension (``_tb_format_parameters``) and the metrics.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Dict

import numpy as np

from .tfevents import EventFileWriter

__all__ = ["StopWatch", "Logger"]


class StopWatch:
    """Pausable wall-clock timer."""

    def __init__(self):
        self._start_time = None
        self._pause_time = None
        self._total_paused = None

    def started(self) -> bool:
        return self._start_time is not None

    def start(self):
        self._start_time = time.time()
        self._total_paused = 0.0

    def pause(self):
        self._pause_time = time.time()

    def resume(self):
        self._total_paused += time.time() - self._pause_time
        self._pause_time = None

    def reset(self):
        self._start_time = None
        self._pause_time = None
        self._total_paused = None

    def get_elapsed_time(self) -> float:
        return (time.time() - self._start_time) - self._total_paused

    def stop(self) -> float:
        """The elapsed time; the watch is reset."""
        elapsed = self.get_elapsed_time()
        self.reset()
        return elapsed


def _make_tb_writer(logdir: str):
    """The event-file writer in ``logdir``, or None where the file cannot
    be created (a run is not refused for its TensorBoard sink, as in the
    JAX package)."""
    try:
        return EventFileWriter(str(logdir))
    except OSError:
        return None


class Logger:
    """Step callback recording metrics/params every holdout_interval steps."""

    def __init__(
        self,
        logdir: str,
        metrics_fn: Callable[[], Dict[str, float]],
        model_parameters_fn: Callable[[], Dict[str, np.ndarray]],
        holdout_interval: int = 10,
        include_feval_log: bool = False,
        tensorboard: bool = True,
    ):
        self.logdir = logdir
        self.holdout_interval = holdout_interval
        self.include_feval_log = include_feval_log
        self._metrics_fn = metrics_fn
        self._model_parameters_fn = model_parameters_fn
        self._logs: Dict[str, list] = {}
        self.counter = 0
        self.timer = StopWatch()
        self._tb = _make_tb_writer(logdir) if (tensorboard and logdir) else None

    @property
    def logs(self) -> Dict:
        return self._logs

    def model_parameters(self) -> Dict[str, np.ndarray]:
        params = self._model_parameters_fn()
        return {k: v for k, v in params.items() if "inducing" not in k}

    def metrics(self) -> Dict[str, float]:
        prefixes = ("train", "test", "cg/", "loss")
        metrics = self._metrics_fn()
        return {k: v for k, v in metrics.items() if k.startswith(prefixes)}

    def log(self, **kwargs):
        for k, v in kwargs.items():
            self._logs.setdefault(k, []).append(v)

    def log_for_feval(self, **kwargs):
        if self.include_feval_log:
            self.log(**{f"{k}-per-feval": v for k, v in kwargs.items()})

    @contextmanager
    def no_recording(self):
        holdout, feval = self.holdout_interval, self.include_feval_log
        self.holdout_interval = -1
        self.include_feval_log = False
        try:
            yield
        finally:
            self.holdout_interval, self.include_feval_log = holdout, feval

    def _tb_write(self, records: Dict[str, float], step: int):
        if self._tb is None:
            return
        for name, value in records.items():
            try:
                value = float(np.asarray(value))
            except (TypeError, ValueError):  # not a scalar: no TB tag
                continue
            self._tb.add_scalar(name, value, step)
        self._tb.flush()

    def close(self):
        """Close the TensorBoard file (the logs stay readable)."""
        if self._tb is not None:
            self._tb.close()

    def __call__(self, step, *args):
        iteration = self.counter
        self.counter += 1
        if self.holdout_interval < 0:
            return
        if iteration % self.holdout_interval != 0:
            return

        elapsed = self.timer.get_elapsed_time() if self.timer.started() else 0.0
        if self.timer.started():
            self.timer.pause()
        try:
            params = self.model_parameters()
            metrics = self.metrics()
            self._tb_write({"elapsed_time": elapsed,
                            **_tb_format_parameters(params), **metrics},
                           iteration)
            if "loss" in metrics:
                print(f"{iteration} - loss={metrics['loss']:.4f}", flush=True)
            self.log(iteration=iteration, elapsed_time=elapsed, params=params,
                     **metrics)
        finally:
            if self.timer.started():
                self.timer.resume()


def _tb_format_parameters(parameters: Dict) -> Dict[str, float]:
    """Kernel and likelihood parameters as one scalar tag per dimension
    (``.kernel.lengthscales`` -> ``kernel/lengthscales[0]``, ...)."""
    out = {}
    for key, parameter in parameters.items():
        name = key.lstrip(".")
        if name.split(".")[0] not in ("kernel", "likelihood", "noise_variance"):
            continue
        p = np.asarray(parameter).reshape(-1)
        tag = name.replace(".", "/", 1)
        if p.size == 1:
            out[tag] = float(p[0])
        else:
            for i in range(p.size):
                out[f"{tag}[{i}]"] = float(p[i])
    return out
