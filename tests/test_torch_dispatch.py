"""PyTorch port: ``--dispatch-bound`` against the JAX package's
``parallel.dispatch.bounded_train_step``, fp64 on the CPU.  The port's CG
returns to the host every iteration, so its one-call Adam step
(``Model.loss_fn``) is the bounded step: the same CG iterate sequence and
the same gradients at the solved v.

The CG depth is capped at 7 steps (chunks of 2, 2, 2, 1): the two packages'
CG iterates drift apart once the Ritz values converge (ROADMAP.md section
3), so the losses are held to 1e-8 at a depth where the iterates still agree
to the last digits."""

import torch_threads  # noqa: F401  (the test processes' torch thread cap)
import json

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cglb_tpu.models import cglb as jc
from cglb_tpu.models import sgpr as js
from cglb_tpu.ops import kernels as jk
from cglb_tpu.parallel import dispatch as jdispatch
from cglb_tpu_torch.backend import Model, Torch
from cglb_tpu_torch.utils.logging import Logger
from cglb_tpu_torch.models import cglb as tc
from cglb_tpu_torch.models import sgpr as ts
from cglb_tpu_torch.ops import kernels as tk
from cglb_tpu_torch.utils import training as ttr

N, D, M, LR = 128, 3, 16, 0.01


def _data(rng):
    X = rng.normal(size=(N, D))
    Y = np.tanh(X @ rng.normal(size=(D, 1))) + 0.1 * rng.normal(size=(N, 1))
    return X, Y, X[rng.choice(N, M, replace=False)]


def _model(X, Y, Z, cfg):
    kern = tk.make_kernel("Matern32", D, variance=1.2, lengthscales=1.1,
                          dtype=torch.float64)
    params = ts.SGPRParams(kern, Z, noise_variance=0.5, dtype=torch.float64)
    return Model("cglb", params, (torch.tensor(X), torch.tensor(Y)), cfg,
                 matvec="dense")


def test_bounded_adam_steps_match_jax_bounded_train_step(rng):
    """Three Adam steps of the port's loss: each step's loss (at the
    parameters it started from), its CG steps and the trained parameters
    against bounded_train_step(iters_per_dispatch=2)."""
    X, Y, Z = _data(rng)
    jcfg = jc.CGLBConfig(max_error=1e-10, max_cg_iters=7,
                         common_dtype="float64", precond_dtype="float64")
    jkern = jk.make_kernel("Matern32", D, variance=1.2, lengthscales=1.1,
                           dtype=np.float64)
    jp = js.SGPRParams.create(jkern, Z, noise_variance=0.5, dtype=np.float64)
    opt = optax.adam(LR)
    step = jdispatch.bounded_train_step(jcfg, opt, matvec="dense",
                                        iters_per_dispatch=2)
    opt_state, v0 = opt.init(jp), jc.init_v0(N)
    jlosses, jsteps = [], []
    for _ in range(3):
        jp, opt_state, aux, loss = step(jp, opt_state, v0, jnp.asarray(X),
                                        jnp.asarray(Y))
        v0 = aux.v
        jlosses.append(float(loss))
        jsteps.append(int(aux.cg_steps))

    model = _model(X, Y, Z, tc.CGLBConfig(max_error=1e-10, max_cg_iters=7,
                                          precond_dtype="float64"))
    fn, losses, steps = model.loss_fn(), [], []

    def recorded(params, carry):
        loss, aux = fn(params, carry)
        losses.append(float(loss.detach()))
        steps.append(aux.cg_steps)
        return loss, aux

    ttr.adam_minimize(recorded, model.params, model.carry_in(), 3, LR)
    assert steps == jsteps == [7, 7, 7]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-8)
    for name, p in model.params.named_params():
        want = {".kernel.variance": jp.kernel.variance,
                ".kernel.lengthscales": jp.kernel.lengthscales,
                ".inducing_Z": jp.inducing_Z,
                ".noise_variance": jp.noise_variance,
                ".mean.c": jp.mean.c}[name]
        np.testing.assert_allclose(p.raw.detach().numpy(),
                                   np.asarray(want.raw), rtol=1e-7,
                                   atol=1e-10, err_msg=name)


@pytest.mark.parametrize("max_error,max_cg_iters", [(0.1, 40), (1e-10, 5)])
def test_backend_dispatch_bound_logs_the_cg_stats_of_each_step(
        rng, tmp_path, max_error, max_cg_iters):
    """-o adam_* with dispatch_bound 3 logs each step's CG steps and error,
    converged or capped, and lands where the run without it lands: the same
    step."""
    X, Y, Z = _data(rng)
    cfg = tc.CGLBConfig(max_error=max_error, max_cg_iters=max_cg_iters)
    runs = []
    for bound in (0, 3):
        model = _model(X, Y, Z, cfg)
        logger = Logger(tmp_path / str(bound), lambda: {}, lambda: {}, -1,
                        include_feval_log=True)
        res = Torch.optimize(model, None, 6, logger, "adam_0.05",
                             dispatch_bound=bound)
        runs.append((res, model, logger.logs))
    (r0, m0, logs0), (r3, m3, logs3) = runs
    assert "cg/steps-per-feval" not in logs0
    steps = logs3["cg/steps-per-feval"]
    assert len(steps) == len(logs3["cg/error-per-feval"]) == 6
    assert 0 < max(steps) <= max_cg_iters and steps[-1] == m3.cg_steps
    assert r3.final_loss == r0.final_loss
    torch.testing.assert_close(m3.v0, m0.v0, rtol=0, atol=0)


def test_cli_dispatch_bound_runs(tmp_path, monkeypatch):
    """--dispatch-bound runs -o adam_* on cglb from the CLI and logs the
    CG steps of every step (per-feval series)."""
    from cglb_tpu_torch.experiments import cli

    monkeypatch.setenv("CGLB_DATA_DIR", str(tmp_path / "no_data_here"))
    cli.main(["-l", str(tmp_path), "--device", "cpu", "--dispatch-bound",
              "2", "train", "-n", "3", "-d", "synth_60x2", "-o", "adam_0.01",
              "cglb", "-m", "cglb", "-k", "Matern32", "-i", "cv", "-M", "6"])
    res = json.loads((tmp_path / "results.json").read_text())
    logs = json.loads((tmp_path / "logs.json").read_text())
    assert np.isfinite(res["loss"]) and res["elbo"] <= res[
        "titsias_upper_bound"]
    assert len(logs["cg/steps-per-feval"]) == 3
    assert "cg/steps_train_median" in res
