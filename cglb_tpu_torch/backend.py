"""The backend facade: a stateful ``Model`` shell over the functional core and
a ``Torch`` object with the verbs of ``cglb_tpu/backend.py`` (create_model,
optimize, metrics_fn, save, load).

The device is explicit: ``Torch(device="cuda")`` raises when CUDA is absent
(``device="cpu"`` for tests).  At N >= 8192 the CGLB loss runs on the
streaming operator (kernels 1 and 2; ops/matvec.py), with the fp32 CG tier in
the CG loop when max_error >= 0.5; Kuf comes from kernel 3 (ops/kuf.py) on
every path.  Ported model kinds: ``cglb`` (Jensen log-det) and ``sgpr``;
optimizer: ``adam_<lr>``.  The rest raises NotImplementedError naming its
ROADMAP queue.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import config as _config
from . import configs as _cfgs
from .models import cglb as _cglb
from .models import sgpr as _sgpr
from .models.cglb import CGLBConfig as _RunCfg
from .models.gaussian import predict_log_density as _pld
from .ops import kernels as _k
from .ops import matvec as _mv
from .utils import metrics as _metrics
from .utils import serialization as _ser
from .utils import training as _training
from .utils.logging import Logger

__all__ = ["Model", "Torch", "resolve_device"]


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available "
            "(pass --device cpu to run the plain versions on the CPU)")
    return dev


def _not_ported(what: str, queue: str):
    return NotImplementedError(
        f"{what} is not ported to cglb_tpu_torch yet (ROADMAP.md: {queue})")


class Model:
    """Parameters, training data on the device, and for CGLB the CG warm
    start ``v0`` with the last CG stats."""

    # streaming matvec above this N when the matvec mode is "auto"
    STREAMING_THRESHOLD = 8192

    def __init__(self, kind: str, params: _sgpr.SGPRParams,
                 data: Tuple[torch.Tensor, torch.Tensor],
                 run_cfg: Optional[_RunCfg] = None, matvec: str = "auto"):
        self.kind = kind
        self.params = params
        self.data = data
        self.run_cfg = run_cfg
        self.matvec_mode = matvec
        X, Y = data
        self.v0 = (_cglb.init_v0(X.shape[0], Y.shape[1], X.dtype, X.device)
                   if kind == "cglb" else None)
        self.cg_steps = 0
        self.cg_residual_error = 0.0

    @property
    def streaming(self) -> bool:
        n = self.data[0].shape[0]
        return self.matvec_mode == "streaming" or (
            self.matvec_mode == "auto" and n >= self.STREAMING_THRESHOLD)

    def loss_fn(self) -> Callable:
        """fn(params, carry) -> (loss, carry); carry is v0 or a CGLBAux."""
        X, Y = self.data
        if self.kind == "sgpr":
            def fn(params, state):
                return -_sgpr.elbo(params, X, Y), state

            return fn
        cfg = self.run_cfg
        streaming = self.streaming
        # fp32 CG tier only in the loose training regime: its operator error
        # sits far below the stopping threshold there, and the accurate
        # assembly keeps the bound valid
        fast_cg = cfg.max_error >= 0.5

        def fn(params, carry):
            v0 = carry.v if isinstance(carry, _cglb.CGLBAux) else carry
            matvec = matvec_cg = None
            if streaming:
                matvec, cg_tier = _mv.make_streaming_operator_pair(
                    params.kernel, X, params.noise_variance.value)
                matvec_cg = cg_tier if fast_cg else matvec
            return _cglb.loss(params, X, Y, v0, cfg, matvec=matvec,
                              matvec_cg=matvec_cg)

        return fn

    def carry_in(self):
        return self.v0

    def carry_out(self, state) -> None:
        if self.kind == "cglb" and isinstance(state, _cglb.CGLBAux):
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
        return float(_sgpr.elbo(self.params, *self.data))

    @torch.no_grad()
    def upper_bound(self) -> float:
        return float(_sgpr.upper_bound(self.params, *self.data))

    def predict_f(self, Xnew, cg_tolerance: Optional[float] = 1e-3):
        return self.predict_f_batched(Xnew, cg_tolerance=cg_tolerance)

    def default_predict_batch(self) -> int:
        """clamp(2^30 / (32 M), 4096, 1e5) rows (cglb_tpu/backend.py:389)."""
        m = self.params.num_inducing
        return max(4096, min(100_000, (1 << 30) // (32 * m)))

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
        if self.kind == "sgpr":
            cache = _sgpr.predict_prepare(p, X, Y)

            def batch(xs):
                return _sgpr.predict_from_cache(p, cache, xs)
        else:
            matvec = None
            if self.streaming:
                matvec = _mv.make_streaming_operator(p.kernel, X,
                                                     p.noise_variance.value)
            cache = _cglb.predict_prepare(p, X, Y, self.v0, self.run_cfg,
                                          cg_tolerance=cg_tolerance,
                                          matvec=matvec)

            def batch(xs):
                cross = None
                if self.streaming:
                    def cross(v):
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
    """Backend facade with the verbs of cglb_tpu/backend.py's ``Jax``."""

    name = "torch"

    def __init__(self, device="cuda", matvec: str = "auto",
                 max_cg_iters: int = 100):
        self.device = resolve_device(device)
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
        kind = {_cfgs.CGLBConfig: "cglb", _cfgs.SGPRConfig: "sgpr"}.get(
            type(model_cfg))
        if kind is None:
            raise _not_ported(f"model {type(model_cfg).__name__}",
                              "queue 1, slices 3-4")
        if kind == "cglb" and (model_cfg.vzero or
                               model_cfg.joint_optimization):
            raise _not_ported("--vzero / --vjoint", "queue 1, slice 3")
        X, Y = self._tensor(data[0]), self._tensor(data[1])
        kernel = self.create_kernel(model_cfg.kernel, (X, Y))
        p = model_cfg.params((X, Y))
        Z = p["inducing_variable"](kernel, seed=seed)
        params = _sgpr.SGPRParams(kernel, Z, noise_variance=p["noise_variance"],
                                  output_dim=Y.shape[1], device=self.device)
        run_cfg = None
        if kind == "cglb":
            run_cfg = _RunCfg(max_error=p["max_error"],
                              max_cg_iters=self.max_cg_iters)
        return Model(kind, params, (X, Y), run_cfg, matvec=self.matvec_mode)

    @staticmethod
    def model_parameters(model: Model) -> Dict[str, np.ndarray]:
        return model.parameter_dict()

    @staticmethod
    def save(model: Model, logdir) -> None:
        _ser.save_model_params(model.parameter_dict(), logdir)

    @staticmethod
    def load(model: Model, filepath) -> Model:
        _training.from_jax_parameter_dict(model.params,
                                          _ser.load_model_params(filepath))
        return model

    @staticmethod
    def optimize(model: Model, datasets, num_steps: int,
                 logger: Optional[Logger] = None, optimizer: str = None,
                 checkpoint_every: int = 0, **_unused):
        if checkpoint_every:
            raise _not_ported("--ckpt-every / --resume", "queue 1, slice 6")
        if optimizer is None or not optimizer.startswith("adam"):
            raise _not_ported(f"optimizer {optimizer!r}",
                              "queue 1, slices 1 and 5")
        lr = float(optimizer.split("_", maxsplit=1)[1])

        def sync_fn(params, state):
            # the Logger's metric closures read the live model
            model.carry_out(state)

        res = _training.adam_minimize(model.loss_fn(), model.params,
                                      model.carry_in(), num_steps, lr,
                                      logger, sync_fn=sync_fn)
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

        if model.kind == "sgpr":
            def core():
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
