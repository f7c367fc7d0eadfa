"""Experiment CLI of the PyTorch port, on argparse.

Same grammar and options as ``cglb_tpu/experiments/cli.py:241-316``:

    python -m cglb_tpu_torch.experiments.cli -t fp64 -l LOGDIR -s SEED \\
        [--device cuda|cpu] train -n 5 -d Wilson_kin40k -o adam_0.01 \\
        cglb -m cglb -k Matern32 -i cv -M 2048 [-e 1.0]

and the same artifacts in LOGDIR (``results.json``, ``logs.json``,
``model.json``) with the same keys.  ``--device`` (default ``cuda``) is new;
``--common-dtype mixed`` is an alias of float64.  Options and leaves that
are not ported yet parse and then fail with an error naming their ROADMAP
queue: optimizers other than ``adam_*``, the n2m/nm2/gpr leaves, ``--vzero``,
``--vjoint``, ``--mesh``, ``--dispatch-bound`` and checkpoints.  The
``metric``, ``gpr_metric`` and ``baseline`` commands are not ported yet.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

from .. import config as _config
from ..backend import Torch
from ..configs import (GPR_CONFIGS, INDUCING_VARIABLE_CONFIGS,
                       KERNEL_CONFIGS, SGPR_CONFIGS)
from ..utils.logging import Logger
from ..utils.serialization import dump_json
from .datasets import DatasetBundle, get_dataset

__all__ = ["main", "build_parser"]

_HOLDOUT_INTERVAL = 20

_OPTIMIZERS = ["scipy", "scipy4", "scipy_tol", "lbfgs", "lbfgs_native",
               "staged", "adam_0.1", "adam_0.01", "adam_0.001"]

_SPARSE = ("sgpr", "sgprn2m")
_CGLB = ("cglb", "cglbn2m", "cglbnm2")


@dataclass(frozen=True)
class _Action:
    """The training run a leaf command's model config is handed to."""

    backend: Torch
    seed: int
    logdir: str
    dataset: DatasetBundle
    num_steps: int = 0
    optimizer: Optional[str] = None
    holdout_interval: int = _HOLDOUT_INTERVAL

    def execute(self, model_cfg, param_file: Optional[str] = None) -> None:
        model = self.backend.create_model(model_cfg, self.dataset.train,
                                          seed=self.seed)
        if param_file:
            model = self.backend.load(model, param_file)
        backend, logdir = self.backend, self.logdir
        datasets = self.dataset.to_tuple()
        metrics_fn = backend.metrics_fn(model, datasets)
        logger = Logger(logdir, metrics_fn,
                        lambda: backend.model_parameters(model),
                        self.holdout_interval)
        res = backend.optimize(model, datasets, self.num_steps, logger,
                               self.optimizer)
        backend.save(model, logdir)

        meta = {"id": logdir, "data": self.dataset.provenance}
        meta.update(res.info or {})
        # train-time CG summaries from the holdout-sampled series (Adam logs
        # no per-feval series), under the JAX CLI's keys
        train_stats = {}
        for key in ("cg/steps", "cg/error"):
            series = logger.logs.get(key) or []
            finite = np.asarray([v for v in series if np.isfinite(v)],
                                dtype=float)
            if finite.size:
                train_stats[f"{key}_train_mean"] = float(finite.mean())
                train_stats[f"{key}_train_max"] = float(finite.max())
                train_stats[f"{key}_train_median"] = float(np.median(finite))
        dump_json({**metrics_fn(), **train_stats, **meta},
                  Path(logdir, "results.json"))
        dump_json({**logger.logs, **meta}, Path(logdir, "logs.json"))


def _add_leaves(group: argparse.ArgumentParser) -> None:
    leaves = group.add_subparsers(dest="leaf", required=True)
    for name in _SPARSE + _CGLB + ("gpr",):
        leaf = leaves.add_parser(name)
        models = GPR_CONFIGS if name == "gpr" else SGPR_CONFIGS
        leaf.add_argument("-m", "--model-class", choices=list(models),
                          required=True)
        leaf.add_argument("-k", "--kernel", choices=list(KERNEL_CONFIGS),
                          required=True)
        if name != "gpr":
            leaf.add_argument("-i", "--inducing-variable", required=True,
                              choices=list(INDUCING_VARIABLE_CONFIGS))
            leaf.add_argument("-M", "--num-inducing-variables", type=int,
                              default=100)
        leaf.add_argument("-p", "--param_file", default=None)
        if name in _CGLB:
            leaf.add_argument("-e", "--max_error", type=float, default=1.0)
            leaf.add_argument("--vjoint", action=argparse.BooleanOptionalAction,
                              default=False)
            leaf.add_argument("--vzero", action=argparse.BooleanOptionalAction,
                              default=False)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cglb_tpu_torch.experiments.cli")
    ap.add_argument("-b", "--backend", choices=["torch"], default="torch")
    ap.add_argument("-t", "--float-type", choices=["fp32", "fp64"],
                    default="fp64")
    ap.add_argument("-l", "--logdir", default="./logdir")
    ap.add_argument("-s", "--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda raises when CUDA is absent)")
    ap.add_argument("--matvec", choices=["auto", "dense", "streaming"],
                    default="auto", help="kernel matvec for CG")
    ap.add_argument("--keops", action=argparse.BooleanOptionalAction,
                    default=None, help="alias: --keops == --matvec streaming")
    ap.add_argument("--common-dtype", choices=["float64", "mixed"],
                    default="mixed", help="mixed is an alias of float64")
    ap.add_argument("--mesh", type=int, default=0)
    ap.add_argument("--max-cg-iters", type=int, default=100)
    ap.add_argument("--dispatch-bound", type=int, default=0)
    commands = ap.add_subparsers(dest="command", required=True)

    train = commands.add_parser("train")
    train.add_argument("-n", "--num-steps", type=int, default=100)
    train.add_argument("-d", "--dataset", required=True)
    train.add_argument("-o", "--optimizer", choices=_OPTIMIZERS,
                       default="scipy")
    train.add_argument("--ckpt-every", type=int, default=0)
    train.add_argument("--resume", action="store_true")
    train.add_argument("--holdout-interval", type=int,
                       default=_HOLDOUT_INTERVAL)
    _add_leaves(train)
    return ap


def _model_config(args):
    kernel = KERNEL_CONFIGS[args.kernel]()
    if args.leaf == "gpr":
        return GPR_CONFIGS[args.model_class](kernel)
    iv = INDUCING_VARIABLE_CONFIGS[args.inducing_variable](
        args.num_inducing_variables)
    cls = SGPR_CONFIGS[args.model_class]
    if args.leaf in _CGLB:
        return cls(kernel, iv, args.max_error, args.vjoint, args.vzero)
    return cls(kernel, iv)


def _unported(args) -> Optional[str]:
    if args.mesh not in (0, 1):
        return "--mesh (multi-GPU, ROADMAP.md queue 1)"
    if args.dispatch_bound:
        return "--dispatch-bound (ROADMAP.md queue 1)"
    if args.ckpt_every or args.resume:
        return "--ckpt-every / --resume (ROADMAP.md queue 1)"
    return None


def main(argv: Optional[List[str]] = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    unported = _unported(args)
    if unported:
        parser.error(f"{unported} is not ported to cglb_tpu_torch yet")
    logdir = Path(args.logdir).expanduser().resolve()
    logdir.mkdir(exist_ok=True, parents=True)
    matvec = args.matvec
    if args.keops is not None:
        matvec = "streaming" if args.keops else "dense"
    # --common-dtype: both values run fp64 common terms (native on the card)
    backend = Torch(device=args.device, matvec=matvec,
                    max_cg_iters=args.max_cg_iters)
    backend.set_default_float(args.float_type)
    backend.set_default_jitter(args.float_type)
    backend.set_seed(args.seed)
    try:
        dataset = get_dataset(args.dataset, dtype=_config.default_float(),
                              split=args.seed)
    except KeyError:
        parser.error(f"Unknown dataset {args.dataset!r}")
    action = _Action(backend=backend, seed=args.seed, logdir=str(logdir),
                     dataset=dataset, num_steps=args.num_steps,
                     optimizer=args.optimizer,
                     holdout_interval=args.holdout_interval)
    action.execute(_model_config(args), args.param_file)


if __name__ == "__main__":
    main()
