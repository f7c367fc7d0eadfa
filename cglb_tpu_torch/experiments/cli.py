"""Experiment CLI of the PyTorch port, on argparse.

Same grammar and options as ``cglb_tpu/experiments/cli.py:241-316``:

    python -m cglb_tpu_torch.experiments.cli -t fp64 -l LOGDIR -s SEED \\
        [--device cuda|cpu] train -n 5 -d Wilson_kin40k -o adam_0.01 \\
        cglb -m cglb -k Matern32 -i cv -M 2048 [-e 1.0]

and the same artifacts in LOGDIR (``results.json``, ``logs.json``,
``model.json``, ``checkpoint.json`` with ``--ckpt-every``, and the
TensorBoard scalars ``events.out.tfevents.*``) with the same keys and tags.
Leaves: ``cglb``, ``cglbn2m``, ``cglbnm2``, ``sgpr``, ``sgprn2m`` and ``gpr -m
gpr|exactgp -k KERNEL [-p model.json]`` (the dense and the iterative exact GP);
optimizers: ``scipy``, ``scipy4``, ``scipy_tol``, ``lbfgs``, ``lbfgs_native``,
``staged`` and ``adam_<lr>`` (on ``gpr`` every ``adam_<lr>`` runs the staged
schedule with that learning rate).  ``metric ... <leaf> -p model.json`` writes
``metric.npy``, ``gpr_metric -d DS -k KERNEL -p model.json`` evaluates any
saved model as a dense GP and writes ``gpr_metric.npy`` beside that file,
and ``baseline mean|linear`` a ``results.json``, as the JAX CLI does.
``--device`` (default ``cuda``) is new; ``--common-dtype mixed`` is an alias of
float64.  ``--dispatch-bound K`` is accepted: the port's CG returns to the
host every iteration, so every ``adam_<lr>`` step is already bounded, and
K > 0 logs each step's CG stats as the JAX CLI's bounded loop does.

``--mesh N`` (N > 1, or -1 for one rank a card) trains data-parallel over N
ranks of ``torch.distributed`` (``parallel/``): a process that is a rank
already (under ``torchrun``, or with ``CGLB_COORDINATOR``,
``CGLB_NUM_PROCESSES`` and ``CGLB_PROCESS_ID``) joins the group; otherwise
the CLI starts N ranks of itself on a local TCP rendezvous and exits with
the first non-zero exit code of a rank.  NCCL on CUDA, one card a rank (N
above the visible cards fails); ``--dist-backend gloo`` lets ranks share
cards; ``--device cpu`` runs gloo ranks on the CPU.  Only rank 0 writes into
LOGDIR.
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

from .. import config as _config
from ..backend import Torch, make_mesh
from ..parallel import mesh as _pmesh
from ..configs import (GPR_CONFIGS, INDUCING_VARIABLE_CONFIGS,
                       KERNEL_CONFIGS, SGPR_CONFIGS)
from ..utils.logging import Logger
from ..utils.serialization import dump_json
from .baselines import linear_baseline, meanpred_baseline
from .datasets import DatasetBundle, get_dataset

__all__ = ["main", "build_parser"]

_HOLDOUT_INTERVAL = 20

_OPTIMIZERS = ["scipy", "scipy4", "scipy_tol", "lbfgs", "lbfgs_native",
               "staged", "adam_0.1", "adam_0.01", "adam_0.001"]

_SPARSE = ("sgpr", "sgprn2m")
_CGLB = ("cglb", "cglbn2m", "cglbnm2")


@dataclass(frozen=True)
class _Action:
    """What to do with the model a leaf command's config builds."""

    backend: Torch
    seed: int
    logdir: str
    dataset: DatasetBundle
    kind: str  # "train" | "metric"
    num_steps: int = 0
    optimizer: Optional[str] = None
    metric_dst: Optional[Path] = None
    ckpt_every: int = 0   # full-state checkpoint interval (iterations)
    resume: bool = False  # continue from logdir/checkpoint.json if present
    holdout_interval: int = _HOLDOUT_INTERVAL
    dispatch_bound: int = 0  # --dispatch-bound

    def execute(self, model_cfg, param_file: Optional[str] = None) -> None:
        model = self.backend.create_model(model_cfg, self.dataset.train,
                                          seed=self.seed)
        if param_file:
            model = self.backend.load(model, param_file)
        if self.kind == "train":
            self._train(model)
        else:
            self._metric(model)

    def _train(self, model) -> None:
        backend, logdir = self.backend, self.logdir
        datasets = self.dataset.to_tuple()
        num_steps = self.num_steps
        done = 0
        ckpt = Path(logdir, "checkpoint.json")
        if self.resume and ckpt.exists():
            model = backend.load_checkpoint(model, ckpt)
            done = int(model.last_checkpoint_extra.get("iters_done", 0))
            num_steps = max(num_steps - done, 0)
        metrics_fn = backend.metrics_fn(model, datasets)
        # every rank evaluates the metrics (they hold collectives); rank 0
        # alone keeps the event file
        logger = Logger(logdir if model.writes else None, metrics_fn,
                        lambda: backend.model_parameters(model),
                        self.holdout_interval, include_feval_log=True)
        try:
            res = backend.optimize(
                model, datasets, num_steps, logger, self.optimizer,
                checkpoint_every=self.ckpt_every,
                checkpoint_dir=logdir if self.ckpt_every else None,
                checkpoint_offset=done,
                resume_extra=model.last_checkpoint_extra,
                dispatch_bound=self.dispatch_bound)
        finally:
            logger.close()
        backend.save(model, logdir)

        meta = {"id": logdir, "data": self.dataset.provenance}
        meta.update(res.info or {})
        # Train-time CG cost: the final evaluation's cg/steps is taken at the
        # converged warm start (about 0 steps), so the per-feval series is
        # summarized beside it.  Adam logs no per-feval series: it falls
        # back to the holdout-sampled one.
        train_stats = {}
        for key in ("cg/steps", "cg/error"):
            series = (logger.logs.get(f"{key}-per-feval")
                      or logger.logs.get(key) or [])
            finite = np.asarray([v for v in series if np.isfinite(v)],
                                dtype=float)
            if finite.size:
                train_stats[f"{key}_train_mean"] = float(finite.mean())
                train_stats[f"{key}_train_max"] = float(finite.max())
                # the mean is dominated by line-search probes at extreme
                # hyperparameters; the median is the central tendency
                train_stats[f"{key}_train_median"] = float(np.median(finite))
        results = {**metrics_fn(), **train_stats, **meta}
        if model.writes:
            dump_json(results, Path(logdir, "results.json"))
            dump_json({**logger.logs, **meta}, Path(logdir, "logs.json"))

    def _metric(self, model) -> None:
        results = self.backend.metrics_fn(model, self.dataset.to_tuple())()
        results["id"] = str(self.metric_dst.parent)
        results["data"] = self.dataset.provenance
        if model.writes:
            np.save(self.metric_dst, results)


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
    ap.add_argument("--mesh", type=int, default=0,
                    help="data-parallel CGLB over N ranks (-1: one a card)")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                    help="default: nccl on cuda, gloo on cpu; gloo on cuda "
                         "lets ranks share a card")
    ap.add_argument("--max-cg-iters", type=int, default=100)
    ap.add_argument("--dispatch-bound", type=int, default=0,
                    help="adam_* on cglb: log each step's CG stats (CG "
                         "returns to the host every iteration already)")
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

    metric = commands.add_parser("metric")
    metric.add_argument("-d", "--dataset", required=True)
    _add_leaves(metric)

    gpr_metric = commands.add_parser("gpr_metric")
    gpr_metric.add_argument("-d", "--dataset", required=True)
    gpr_metric.add_argument("-k", "--kernel", choices=list(KERNEL_CONFIGS),
                            required=True)
    gpr_metric.add_argument("-p", "--param_file", required=True)

    baseline = commands.add_parser("baseline")
    baseline.add_argument("-d", "--dataset", required=True)
    baseline.add_argument("baseline", choices=["mean", "linear"])
    return ap


def _model_config(args):
    kernel = KERNEL_CONFIGS[args.kernel]()
    if args.command == "gpr_metric":
        return GPR_CONFIGS["gpr"](kernel)
    if args.leaf == "gpr":
        return GPR_CONFIGS[args.model_class](kernel)
    iv = INDUCING_VARIABLE_CONFIGS[args.inducing_variable](
        args.num_inducing_variables)
    cls = SGPR_CONFIGS[args.model_class]
    if args.leaf in _CGLB:
        return cls(kernel, iv, args.max_error, args.vjoint, args.vzero)
    return cls(kernel, iv)


def _start_ranks(parser, args, argv: Optional[List[str]]) -> None:
    """Run this command line as ``--mesh`` ranks of a local group; exit
    with the first non-zero exit code of a rank."""
    try:
        world = _pmesh.plan_ranks(args.mesh, args.device, args.dist_backend)
    except (ValueError, RuntimeError) as err:
        parser.error(str(err))
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    if args.device == "cpu":  # the ranks share the host's cores
        env.setdefault("OMP_NUM_THREADS",
                       str(max(1, (os.cpu_count() or 1) // world)))
    cmd = [sys.executable, "-m", "cglb_tpu_torch.experiments.cli"] + list(
        sys.argv[1:] if argv is None else argv)
    print(f"--mesh {args.mesh}: {world} ranks, "
          f"{_pmesh.resolve_backend(args.device, args.dist_backend)} on "
          f"{args.device}", file=sys.stderr, flush=True)
    try:
        _pmesh.run_ranks(cmd, world, env=env)
    except _pmesh.RankFailed as err:
        print(f"cglb_tpu_torch.experiments.cli: {err}", file=sys.stderr)
        raise SystemExit(err.returncode)


def main(argv: Optional[List[str]] = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    mesh = None
    if args.mesh not in (0, 1):
        if not _pmesh.in_launched_rank():
            _start_ranks(parser, args, argv)
            return
        mesh = make_mesh(args.mesh, args.device, args.dist_backend)
        print(f"--mesh: {mesh.describe()}", file=sys.stderr, flush=True)
    logdir = Path(args.logdir).expanduser().resolve()
    logdir.mkdir(exist_ok=True, parents=True)
    Torch.set_default_float(args.float_type)
    Torch.set_default_jitter(args.float_type)
    Torch.set_seed(args.seed)
    try:
        dataset = get_dataset(args.dataset, dtype=_config.default_float(),
                              split=args.seed)
    except KeyError:
        parser.error(f"Unknown dataset {args.dataset!r}")
    if args.command == "baseline":
        fns = {"linear": linear_baseline, "mean": meanpred_baseline}
        results = fns[args.baseline](dataset)
        results["id"] = args.baseline
        results["data"] = dataset.provenance
        if mesh is None or mesh.rank == 0:
            dump_json(results, Path(logdir, "results.json"))
        return
    matvec = args.matvec
    if args.keops is not None:
        matvec = "streaming" if args.keops else "dense"
    # --common-dtype: both values run fp64 common terms (native on the card)
    backend = Torch(device=args.device, matvec=matvec,
                    max_cg_iters=args.max_cg_iters, mesh=mesh)
    common = dict(backend=backend, seed=args.seed, logdir=str(logdir),
                  dataset=dataset)
    if args.command == "train":
        action = _Action(kind="train", num_steps=args.num_steps,
                         optimizer=args.optimizer,
                         ckpt_every=args.ckpt_every, resume=args.resume,
                         holdout_interval=args.holdout_interval,
                         dispatch_bound=args.dispatch_bound, **common)
    elif args.command == "metric":
        action = _Action(kind="metric",
                         metric_dst=Path(logdir, "metric.npy"), **common)
    else:  # gpr_metric
        action = _Action(kind="metric", metric_dst=Path(
            Path(args.param_file).parent, "gpr_metric.npy"), **common)
    action.execute(_model_config(args), args.param_file)


if __name__ == "__main__":
    main()
