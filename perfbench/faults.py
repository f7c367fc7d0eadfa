"""Faults planted under the timed path, to show that ``correct`` catches
them (``tests/test_perfbench_faults.py`` on the CPU; ``control.py
--fault`` reads them on the card).  Each is a context manager that breaks
the program's path while it is open.

- ``state_unchanged``: the optimizer's step leaves the parameters as they
  are;
- ``half_batch``: the model sees half of the training rows and its loss is
  doubled, the sum over the rest scaled to the whole;
- ``mean_altered``: the posterior mean of one row of the fortieth request
  (the window's eighth, after set-up's cycle of 32) is shifted by 1e-3
  where the model produces it;
- ``answer_altered``: one log density of the fortieth request is shifted
  by 1e-3 nats where the model produces it;
- ``exchange_left_out``: on several ranks, the all-reduce of the program's
  mesh sums every rank's part but the last one's (alike on every rank, so
  that the ranks stay in step); planted in each rank.
"""

from __future__ import annotations

import contextlib

import torch

from . import drive

__all__ = ["FAULTS", "state_unchanged", "half_batch", "mean_altered",
           "answer_altered", "exchange_left_out"]


@contextlib.contextmanager
def _patched(owner, name, value):
    orig = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def state_unchanged():
    return _patched(torch.optim.Adam, "step",
                    lambda self, closure=None: None)


def half_batch():
    build = drive.build_model

    def half(cfg, train, device, values, mesh=None):
        n = len(train[0]) // 2
        model = build(cfg, (train[0][:n], train[1][:n]), device, values,
                      mesh=mesh)
        make = model.loss_fn

        def loss_fn():
            fn = make()

            def doubled(params, state, *args):
                loss, state = fn(params, state, *args)
                return 2.0 * loss, state

            return doubled

        model.loss_fn = loss_fn
        return model

    return _patched(drive, "build_model", half)


def _fortieth(name, alter):
    """Model.<name> with ``alter`` applied to its fortieth call's
    result."""
    from cglb_tpu_torch.backend import Model

    orig = getattr(Model, name)
    calls = []

    def altered(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        calls.append(1)
        return alter(out) if len(calls) == 40 else out

    return _patched(Model, name, altered)


def mean_altered():
    def alter(out):
        mean, var = out
        mean = mean.clone()
        mean[0] += 1e-3
        return mean, var

    return _fortieth("predict_f_batched", alter)


def answer_altered():
    def alter(out):
        out = out.clone()
        out[0] += 1e-3
        return out

    return _fortieth("predict_log_density", alter)


def exchange_left_out():
    from cglb_tpu_torch.parallel.mesh import DataMesh

    def all_but_last(self, x):
        parts = self._gathered(x.reshape(-1))
        out = parts[0]
        for part in parts[1:-1]:
            out = out + part
        return out.reshape(x.shape).to(x.device)

    return _patched(DataMesh, "all_reduce", all_but_last)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "mean_altered": mean_altered, "answer_altered": answer_altered,
          "exchange_left_out": exchange_left_out}
