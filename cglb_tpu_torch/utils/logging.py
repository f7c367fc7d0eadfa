"""Run logging: pausable wall-clock StopWatch and the metrics Logger.

A copy of ``cglb_tpu/utils/logging.py`` without its TensorBoard sink
(``utils/tfevents.py`` is not ported yet; ROADMAP.md).  Elapsed time excludes
metric evaluation (the StopWatch is paused around it); metrics and
parameters (inducing points excluded) are recorded every
``holdout_interval`` optimizer steps, and optionally CG stats on every
function evaluation (``<key>-per-feval``), into the in-memory logs that the
CLI dumps to ``logs.json``.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Dict

import numpy as np

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


class Logger:
    """Step callback recording metrics/params every holdout_interval steps."""

    def __init__(
        self,
        logdir: str,
        metrics_fn: Callable[[], Dict[str, float]],
        model_parameters_fn: Callable[[], Dict[str, np.ndarray]],
        holdout_interval: int = 10,
        include_feval_log: bool = False,
    ):
        self.logdir = logdir
        self.holdout_interval = holdout_interval
        self.include_feval_log = include_feval_log
        self._metrics_fn = metrics_fn
        self._model_parameters_fn = model_parameters_fn
        self._logs: Dict[str, list] = {}
        self.counter = 0
        self.timer = StopWatch()

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
            if "loss" in metrics:
                print(f"{iteration} - loss={metrics['loss']:.4f}", flush=True)
            self.log(iteration=iteration, elapsed_time=elapsed, params=params,
                     **metrics)
        finally:
            if self.timer.started():
                self.timer.resume()
