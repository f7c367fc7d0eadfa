"""The backend facade: a stateful ``Model`` shell over the functional core and
a ``Torch`` object with the verbs of ``cglb_tpu/backend.py`` (create_model,
optimize, metrics_fn, save, load).

The device is explicit: ``Torch(device="cuda")`` raises when CUDA is absent
(``device="cpu"`` for tests).  At N >= 8192 the CGLB loss runs on the
streaming operator (kernels 1 and 2; ops/matvec.py), with the fp32 CG tier in
the CG loop when max_error >= 0.5; Kuf comes from kernel 3 (ops/kuf.py) on
every path that has inducing points.  Model kinds: ``cglb`` (Jensen
log-det), ``cglbn2m``, ``cglbnm2``, ``sgpr``, ``sgprn2m``, the dense exact GP
``gpr`` and the iterative one ``exactgp`` (CG, SLQ and Lanczos variances on
kernels 1 and 2 above 4096 rows, whatever the matvec mode); optimizers:
``scipy``, ``scipy4``, ``scipy_tol``, ``lbfgs``, ``lbfgs_native``, ``staged``
and ``adam_<lr>``, with periodic full-state checkpoints.  On ``gpr`` and
``exactgp`` every ``adam_<lr>`` runs the staged schedule with that learning
rate, as the JAX package's backend does.  ``optimize(dispatch_bound=k)``
is the JAX package's dispatch-bounded Adam (``cglb_tpu/parallel/dispatch.py``):
the port's CG already returns to the host every iteration, so that step is
the one-call loss, and k > 0 only logs each step's CG stats as the bounded
loop does.

``Torch(mesh=...)`` (a ``parallel.mesh.DataMesh``, from :func:`make_mesh`)
runs the CGLB and SGPR losses, metrics and the CGLB prediction's CG
column-sharded over the ranks (``parallel/sharded.py``), on the dense block
or kernels 1-2 as above, with the accurate tier throughout, as the JAX
package's ``--mesh`` does (``cglb_tpu/backend.py:131-146, 189-209``); the
exact GPs run whole on every rank.  Every rank runs the same optimizer on
the same replicated parameters; only rank 0 writes files.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import config as _config
from . import configs as _cfgs
from .models import cglb as _cglb
from .models import gpr as _gpr
from .models import gpr_iterative as _itgp
from .models import sgpr as _sgpr
from .models.cglb import CGLBConfig as _RunCfg
from .models.gaussian import predict_log_density as _pld
from .ops import kernels as _k
from .ops import matvec as _mv
from .parallel import mesh as _pmesh
from .parallel import sharded as _sharded
from .parallel import streaming as _pstream
from .transforms import Param as _Param
from .utils import flatten as _fl
from .utils import metrics as _metrics
from .utils import serialization as _ser
from .utils import training as _training
from .utils.logging import Logger

__all__ = ["Model", "Torch", "make_mesh", "resolve_device"]

_CGLB_KINDS = {"cglb": "jensen", "cglbn2m": "n2m", "cglbnm2": "nm2"}
_SGPR_KINDS = ("sgpr", "sgprn2m")
_GPR_KINDS = ("gpr", "exactgp")


def make_mesh(size: int, device, backend: str = None):
    """The DataMesh of ``--mesh size`` over this process's group (None for
    0 or 1: one process; -1: the whole group).  Raises where the group's
    size differs, or where NCCL would give this rank no card of its own."""
    if size in (0, 1):
        return None
    return _pmesh.data_mesh(size, device, backend)


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available "
            "(pass --device cpu to run the plain versions on the CPU)")
    return dev


class Model:
    """Parameters, training data on the device, for CGLB the CG warm start
    ``v0`` with the last CG stats, and for the iterative exact GP the state
    of the generator its probes come from."""

    # streaming matvec above this N when the matvec mode is "auto"
    STREAMING_THRESHOLD = 8192

    def __init__(self, kind: str, params,
                 data: Tuple[torch.Tensor, torch.Tensor],
                 run_cfg: Optional[_RunCfg] = None, matvec: str = "auto",
                 mesh=None):
        self.kind = kind
        self.params = params
        self.data = data
        self.run_cfg = run_cfg
        self.matvec_mode = matvec
        # the ranks' DataMesh: CGLB and SGPR work column-sharded over it,
        # and only rank 0 writes files
        self.mesh = mesh
        X, Y = data
        self.v0 = None
        if kind in _CGLB_KINDS:
            self.v0 = _cglb.init_v0(X.shape[0], Y.shape[1], X.dtype, X.device)
            if self.joint:
                # --vjoint: v0 becomes a trainable Param of the parameter
                # module, after the others
                self.params.v0 = _Param(self.v0, trainable=True)
        self.cg_steps = 0
        self.cg_residual_error = 0.0
        # exactgp: get_state() of the probes' generator, seeded at first use
        self.generator_state = None
        self.last_checkpoint_extra: Dict = {}

    @property
    def joint(self) -> bool:
        """v is optimized jointly with the parameters (--vjoint without
        --vzero)."""
        cfg = self.run_cfg
        return (cfg is not None and cfg.joint_optimization
                and not cfg.vzero)

    @property
    def writes(self) -> bool:
        """This process writes the run's files (rank 0, or no mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    @property
    def streaming(self) -> bool:
        n = self.data[0].shape[0]
        return self.matvec_mode == "streaming" or (
            self.matvec_mode == "auto" and n >= self.STREAMING_THRESHOLD)

    def loss_fn(self) -> Callable:
        """fn(params, carry) -> (loss, carry); carry is v0 or a CGLBAux, for
        ``exactgp`` the state of the probes' generator.  The ``gpr`` and
        ``exactgp`` functions also take a data slice, fn(params, carry, X,
        Y), for the staged schedule."""
        X, Y = self.data
        if self.kind == "gpr":
            def fn(params, state, *data):
                return -_gpr.log_marginal_likelihood(
                    params, *(data or self.data)), state

            return fn
        if self.kind == "exactgp":
            itcfg = _itgp.IterGPConfig()

            def fn(params, carry, *data):
                Xd, Yd = data or self.data
                # the state, not the generator, is carried: evaluations
                # from one carry draw the same probes
                gen = _itgp.make_generator(carry, Xd.device)
                loss, _ = _itgp.iterative_loss(params, Xd, Yd, gen, itcfg)
                return loss, gen.get_state()

            return fn
        if self.kind in _SGPR_KINDS:
            bound = _sgpr.elbo if self.kind == "sgpr" else _sgpr.elbo_n2m
            mesh = self.mesh

            def fn(params, state):
                return -bound(params, X, Y, mesh=mesh), state

            return fn
        # fp32 CG tier only in the loose training regime: its operator error
        # sits far below the stopping threshold there, and the accurate
        # assembly keeps the bound valid
        return self._cglb_loss_fn(fast_cg=self.run_cfg.max_error >= 0.5)

    def loss_fn_tol(self) -> Callable:
        """fn(params, carry, max_error) -> (loss, aux): the CGLB loss with
        the CG stopping tolerance as an argument, for the levels of the
        adaptive schedule (``-o scipy_tol``).  CG runs on the accurate
        streaming tier here: the CG tier's operator error is sound only
        while the stopping threshold dwarfs it, which no longer holds once
        the schedule tightens below about 0.5."""
        if self.kind not in _CGLB_KINDS:
            raise ValueError("adaptive CG tolerance requires a CGLB model")
        return self._cglb_loss_fn(fast_cg=False)

    def _cglb_loss_fn(self, fast_cg: bool) -> Callable:
        X, Y = self.data
        cfg = self.run_cfg
        streaming = self.streaming
        joint = self.joint
        mesh = self.mesh

        def fn(params, carry, max_error=None):
            v0 = carry.v if isinstance(carry, _cglb.CGLBAux) else carry
            if joint:
                # trainable v: read from the parameter module so that the
                # gradient flows into it through the bound assembly
                v0 = params.v0.value
            if mesh is not None:  # the accurate tier throughout
                return _sharded.sharded_cglb_loss(
                    params, X, Y, v0, cfg, mesh,
                    matvec=self._operator_mode(), max_error=max_error)
            matvec = matvec_cg = None
            if streaming:
                matvec, cg_tier = _mv.make_streaming_operator_pair(
                    params.kernel, X, params.noise_variance.value)
                matvec_cg = cg_tier if fast_cg else matvec
            return _cglb.loss(params, X, Y, v0, cfg, matvec=matvec,
                              matvec_cg=matvec_cg, max_error=max_error)

        return fn

    def _operator_mode(self) -> str:
        return "streaming" if self.streaming else "dense"

    def carry_in(self):
        if self.kind == "exactgp":
            if self.generator_state is None:
                self.generator_state = _itgp.make_generator(
                    _config.settings.seed, self.data[0].device).get_state()
            return self.generator_state
        return self.v0

    def carry_out(self, state) -> None:
        if self.kind == "exactgp" and state is not None:
            self.generator_state = state
        if self.kind in _CGLB_KINDS and isinstance(state, _cglb.CGLBAux):
            self.v0 = state.v
            self.cg_steps = int(state.cg_steps)
            self.cg_residual_error = float(state.cg_residual_error)

    def loss_value(self) -> float:
        with torch.no_grad():
            loss, state = self.loss_fn()(self.params, self.carry_in())
        self.carry_out(state)
        return float(loss)

    @torch.no_grad()
    def elbo(self) -> float:
        return float(_sgpr.elbo(self.params, *self.data, mesh=self.mesh))

    @torch.no_grad()
    def upper_bound(self) -> float:
        return float(_sgpr.upper_bound(self.params, *self.data,
                                       mesh=self.mesh))

    @torch.no_grad()
    def lml(self) -> float:
        """The dense log marginal likelihood (``gpr``)."""
        return float(_gpr.log_marginal_likelihood(self.params, *self.data))

    def predict_f(self, Xnew, cg_tolerance: Optional[float] = 1e-3):
        return self.predict_f_batched(Xnew, cg_tolerance=cg_tolerance)

    def default_predict_batch(self) -> int:
        """Rows per prediction batch: clamp(2^30 / (32 M), 4096, 1e5)
        (cglb_tpu/backend.py:389), which holds a batch's Kus temporaries to
        about 1 GiB.  The dense GP materializes K(batch, X) instead, 8 N
        bytes a row, and is held to the same; the iterative one streams its
        cross products (or has N <= 4096) and takes the upper clamp."""
        if self.kind == "exactgp":
            return 100_000
        row_bytes = (8 * self.data[0].shape[0] if self.kind == "gpr"
                     else 32 * self.params.num_inducing)
        return max(4096, min(100_000, (1 << 30) // row_bytes))

    @torch.no_grad()
    def predict_f_batched(self, Xnew, batch_size: Optional[int] = None,
                          cg_tolerance: Optional[float] = 1e-3):
        """Posterior mean and marginal variance at Xnew.  The common terms
        and the CG solve run once; only the O(S) projections repeat per
        batch of ``batch_size`` rows (default: default_predict_batch)."""
        p = self.params
        X, Y = self.data
        Xnew = torch.as_tensor(Xnew, dtype=X.dtype, device=X.device)
        batch_size = batch_size or self.default_predict_batch()
        if self.kind == "gpr":
            cache = _gpr.predict_prepare(p, X, Y)

            def batch(xs):
                return _gpr.predict_from_cache(p, cache, X, xs)
        elif self.kind == "exactgp":
            cache = _itgp.predict_prepare(p, X, Y)

            def batch(xs):
                return _itgp.predict_from_cache(p, cache, X, xs)
        elif self.kind in _SGPR_KINDS:
            cache = _sgpr.predict_prepare(p, X, Y)

            def batch(xs):
                return _sgpr.predict_from_cache(p, cache, xs)
        else:
            mesh = self.mesh
            matvec = None
            if mesh is not None:
                matvec = _sharded.sharded_operator(
                    mesh, p.kernel, X, p.noise_variance.value,
                    self._operator_mode())
            elif self.streaming:
                matvec = _mv.make_streaming_operator(p.kernel, X,
                                                     p.noise_variance.value)
            v0 = p.v0.value if self.joint else self.v0
            cache = _cglb.predict_prepare(p, X, Y, v0, self.run_cfg,
                                          cg_tolerance=cg_tolerance,
                                          matvec=matvec, mesh=mesh)

            def batch(xs):
                cross = None
                if self.streaming:
                    def cross(v):
                        if mesh is not None:
                            return _pstream.sharded_cross_matvec(
                                mesh, p.kernel, X, xs, v)
                        return _mv.kernel_cross_matvec(p.kernel, X, xs, v)
                return _cglb.predict_from_cache(p, cache, X, xs,
                                                cross_matvec=cross)
        means, vars_ = [], []
        for start in range(0, Xnew.shape[0], batch_size):
            m, v = batch(Xnew[start:start + batch_size])
            means.append(m)
            vars_.append(v)
        return torch.cat(means, 0), torch.cat(vars_, 0)

    def parameter_dict(self) -> Dict[str, np.ndarray]:
        return self.params.parameter_dict()


class Torch:
    """Backend facade with the verbs of cglb_tpu/backend.py's ``Jax``.
    ``mesh``: this rank's DataMesh (:func:`make_mesh`; its device is the
    rank's), the counterpart of the Jax facade's ``configure_backend(mesh=)``
    state."""

    name = "torch"

    def __init__(self, device="cuda", matvec: str = "auto",
                 max_cg_iters: int = 100, mesh=None):
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.matvec_mode = matvec
        self.max_cg_iters = int(max_cg_iters)

    @staticmethod
    def set_default_float(float_type: str):
        _config.set_default_float(float_type)

    @staticmethod
    def set_default_jitter(value):
        _config.set_default_jitter(value)

    @staticmethod
    def set_seed(seed: int):
        _config.set_default_seed(seed)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=_config.torch_dtype(),
                               device=self.device)

    def create_kernel(self, kernel_cfg: _cfgs.KernelConfig, data):
        p = kernel_cfg.params(data)
        name = ("Matern32" if isinstance(kernel_cfg, _cfgs.Matern32Config)
                else "SquaredExponential")
        return _k.make_kernel(name, data[0].shape[-1], variance=p["variance"],
                              lengthscales=p["lengthscales"],
                              device=self.device)

    def create_model(self, model_cfg: _cfgs.ModelConfig, data,
                     seed: int = None) -> Model:
        seed = seed if seed is not None else _config.settings.seed
        kind = {_cfgs.CGLBConfig: "cglb", _cfgs.CGLBN2MConfig: "cglbn2m",
                _cfgs.CGLBNM2Config: "cglbnm2", _cfgs.SGPRConfig: "sgpr",
                _cfgs.SGPRN2MConfig: "sgprn2m", _cfgs.GPRConfig: "gpr",
                _cfgs.ExactGPConfig: "exactgp"}[type(model_cfg)]
        X, Y = self._tensor(data[0]), self._tensor(data[1])
        kernel = self.create_kernel(model_cfg.kernel, (X, Y))
        p = model_cfg.params((X, Y))
        if kind in _GPR_KINDS:
            params = _gpr.GPRParams(kernel,
                                    noise_variance=p["noise_variance"],
                                    output_dim=Y.shape[1], device=self.device)
            # the exact GPs run whole on every rank (the mesh only says who
            # writes)
            return Model(kind, params, (X, Y), matvec=self.matvec_mode,
                         mesh=self.mesh)
        Z = p["inducing_variable"](kernel, seed=seed)
        params = _sgpr.SGPRParams(kernel, Z, noise_variance=p["noise_variance"],
                                  output_dim=Y.shape[1], device=self.device)
        run_cfg = None
        if kind in _CGLB_KINDS:
            run_cfg = _RunCfg(max_error=p["max_error"],
                              joint_optimization=p["joint_optimization"],
                              vzero=p["vzero"],
                              logdet_variant=_CGLB_KINDS[kind],
                              max_cg_iters=self.max_cg_iters)
        return Model(kind, params, (X, Y), run_cfg, matvec=self.matvec_mode,
                     mesh=self.mesh)

    @staticmethod
    def model_parameters(model: Model) -> Dict[str, np.ndarray]:
        return model.parameter_dict()

    @staticmethod
    def save(model: Model, logdir) -> None:
        if model.writes:
            _ser.save_model_params(model.parameter_dict(), logdir)

    @staticmethod
    def save_checkpoint(model: Model, logdir, extra: Dict = None) -> None:
        """Full-state checkpoint: parameters and the CG warm start (rank 0
        writes; every rank reads it on resume)."""
        if not model.writes:
            return
        v0 = None if model.v0 is None else model.v0.detach().cpu().numpy()
        _ser.save_checkpoint(logdir, model.parameter_dict(), v0=v0,
                             extra={"kind": model.kind, **(extra or {})})

    @staticmethod
    def load_checkpoint(model: Model, filepath) -> Model:
        state = _ser.load_checkpoint(filepath)
        _fl.assign_parameters(model.params, state["params"])
        if state.get("v0") is not None and model.v0 is not None:
            model.v0 = torch.as_tensor(state["v0"], dtype=model.v0.dtype,
                                       device=model.v0.device)
        # resume metadata (iters_done, the live tolerance level)
        model.last_checkpoint_extra = state.get("extra", {}) or {}
        return model

    @staticmethod
    def load(model: Model, filepath) -> Model:
        _fl.assign_parameters(model.params, _ser.load_model_params(filepath))
        return model

    @classmethod
    def optimize(cls, model: Model, datasets, num_steps: int,
                 logger: Optional[Logger] = None, optimizer: str = None,
                 checkpoint_every: int = 0, checkpoint_dir=None,
                 checkpoint_offset: int = 0, resume_extra: Dict = None,
                 dispatch_bound: int = 0):
        """checkpoint_every > 0 (with checkpoint_dir): write a full-state
        checkpoint every that-many accepted iterations, so that a killed run
        resumes (CLI --ckpt-every / --resume) instead of restarting.
        checkpoint_offset: iterations done before this call (recorded as
        extra["iters_done"]).
        resume_extra: the loaded checkpoint's extra dict (scipy_tol's live
        tolerance level).
        dispatch_bound: CLI ``--dispatch-bound``; > 0 logs each ``adam_*``
        step's CG stats on a CGLB model with its own CG solve (the step is
        already bounded: CG returns to the host every iteration)."""
        loss_fn = model.loss_fn()
        carry = model.carry_in()
        cglb_kind = model.kind in _CGLB_KINDS
        live_extra: Dict = {}
        iters = {"n": checkpoint_offset}

        def feval_stats(state):
            if isinstance(state, _cglb.CGLBAux):
                return {"cg/steps": int(state.cg_steps),
                        "cg/error": float(state.cg_residual_error)}
            return {}

        stats_fn = feval_stats if cglb_kind else None

        def sync_fn(params, state):
            # the parameters are live in the module already; publish the
            # carry for the Logger's metric closures
            model.carry_out(state)
            if checkpoint_every and checkpoint_dir is not None:
                iters["n"] += 1
                if iters["n"] % checkpoint_every == 0:
                    cls.save_checkpoint(
                        model, checkpoint_dir,
                        extra={"iters_done": iters["n"], **live_extra})

        scipy_args = dict(logger=logger, feval_stats_fn=stats_fn,
                          sync_fn=sync_fn)
        plain_tol = not cglb_kind or model.run_cfg.v_is_external
        if optimizer is None or optimizer == "scipy" or (
                optimizer == "scipy_tol" and plain_tol):
            # scipy_tol without CG in the loss (not CGLB, or v external):
            # the tolerance has no effect, so the plain bridge runs
            res = _training.scipy_minimize(loss_fn, model.params, carry,
                                           num_steps, **scipy_args)
        elif optimizer == "scipy4":
            # 4 restarts, the inducing points frozen after the 2nd
            res = _training.scipy_minimize(
                loss_fn, model.params, carry, num_steps, attempts=4,
                freeze_inducing_after=2, **scipy_args)
        elif optimizer == "scipy_tol":
            res = _training.scipy_tol_minimize(
                loss_fn, model.loss_fn_tol(), model.params, carry, num_steps,
                tol_start=model.run_cfg.max_error,
                # the live level rides in every checkpoint; a resumed run
                # re-enters the schedule where the killed one died
                on_level=lambda m: live_extra.update(max_error=m),
                tol_resume=(resume_extra or {}).get("max_error"),
                **scipy_args)
        elif optimizer == "lbfgs":
            res = _training.lbfgs_minimize(
                loss_fn, model.params, carry, num_steps, logger,
                feval_stats_fn=stats_fn, sync_fn=sync_fn)
        elif optimizer == "lbfgs_native":
            res = _training.native_lbfgs_minimize(
                loss_fn, model.params, carry, num_steps, logger,
                feval_stats_fn=stats_fn, sync_fn=sync_fn)
        elif optimizer == "staged" and model.kind in _GPR_KINDS:
            # the exact-GP baseline's schedule, at its default learning rate
            res = _training.staged_gpr_optimize(
                loss_fn, model.params, *model.data, num_steps, logger,
                sync_fn=sync_fn)
        elif optimizer.startswith("adam"):
            lr = float(optimizer.split("_", maxsplit=1)[1])
            if model.kind in _GPR_KINDS:
                # as the JAX package's backend: every adam_<lr> on an exact
                # GP runs the staged schedule with that learning rate
                res = _training.staged_gpr_optimize(
                    loss_fn, model.params, *model.data, num_steps, logger,
                    adam_lr=lr, sync_fn=sync_fn)
            else:
                # dispatch-bounded (CGLB with its own CG solve): the same
                # step, with each step's CG stats logged as the JAX
                # package's bounded loop logs them
                bounded = (dispatch_bound > 0 and cglb_kind
                           and not model.run_cfg.v_is_external)
                res = _training.adam_minimize(
                    loss_fn, model.params, carry, num_steps, lr, logger,
                    sync_fn=sync_fn,
                    feval_stats_fn=stats_fn if bounded else None)
        else:
            raise NotImplementedError(optimizer)
        model.carry_out(res.state)
        return res

    def metrics_fn(self, model: Model, datasets
                   ) -> Callable[[], Dict[str, float]]:
        train, test = datasets
        Xtr, Ytr = self._tensor(train[0]), self._tensor(train[1])
        Xte, Yte = self._tensor(test[0]), self._tensor(test[1])

        def err_and_logdensity():
            X = torch.cat([Xtr, Xte], dim=0)
            Y = torch.cat([Ytr, Yte], dim=0)
            mean, var = model.predict_f_batched(X)
            err = (Y - mean).cpu().numpy()
            logden = _pld(mean, var, model.params.noise_variance.value,
                          Y).detach().cpu().numpy()
            n = Xtr.shape[0]
            return (err[:n], err[n:]), (logden[:n], logden[n:])

        rmse_lpd = _metrics.rmse_and_lpd_fn(err_and_logdensity)

        if model.kind == "gpr":
            def core():
                lml = model.lml()
                return {"lml": lml, "loss": -lml}
        elif model.kind == "exactgp":
            def core():
                loss = model.loss_value()
                return {"lml": -loss, "loss": loss}
        elif model.kind in _SGPR_KINDS:
            def core():
                # sgprn2m reports its own bound as ``elbo``
                loss = model.loss_value()
                return {"elbo": -loss,
                        "titsias_upper_bound": model.upper_bound(),
                        "loss": loss}
        else:
            def core():
                cg_lb = -model.loss_value()
                return {
                    "elbo": model.elbo(),
                    "titsias_upper_bound": model.upper_bound(),
                    "cg_lower_bound": cg_lb,
                    "loss": -cg_lb,
                    "cg/steps": model.cg_steps,
                    "cg/error": model.cg_residual_error,
                }

        return lambda: _metrics.call_metric_fns(core, rmse_lpd)
