"""PyTorch port: CGLB over torch.distributed (cglb_tpu_torch/parallel) at
world size 2, two gloo ranks on the CPU, against the JAX package's
``sharded_cglb_loss`` on its 8-device CPU mesh and its one-device
``cglb.loss``; fp64.

One spawn of two ranks for the module (:func:`ranks`, through the port's
own ``run_ranks`` and its ``CGLB_COORDINATOR`` bootstrap): each rank
computes every case from the inputs this process wrote (numpy seed, carried
into the port by ``assign_parameters``) and saves what it got; the tests
read those files, so that each check counts.  Tolerances: the loss 1e-9
relative; gradients 1e-7 of each parameter's largest with the fp64
preconditioner, 1e-6 with the fp32 one (as tests/test_torch_chunked.py);
CG either capped at 6 steps (the packages' iterates agree there) or at a
converged v where it takes no step.
"""

import torch_threads  # noqa: F401  (the test processes' torch thread cap)
import dataclasses
import functools
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cglb_tpu.models import cglb as jc
from cglb_tpu.models import sgpr as js
from cglb_tpu.parallel import mesh as jmesh
from cglb_tpu.parallel import sharded as jsh
from cglb_tpu_torch.models import cglb as tc
from cglb_tpu_torch.models import sgpr as ts
from cglb_tpu_torch.ops import kernels as tk
from cglb_tpu_torch.parallel import mesh as tpm
from cglb_tpu_torch.parallel import sharded as tsh
from cglb_tpu_torch.parallel import streaming as tst
from cglb_tpu_torch.utils.flatten import assign_parameters

ROOT = Path(__file__).resolve().parent.parent
CAP = 6
# n, family, preconditioner dtype of each case's data and model
CASES = {"even": (64, "Matern32"), "uneven": (61, "Matern32"),
         "chunked": (96, "Matern32"), "rbf": (64, "SquaredExponential")}
CHUNK = 24  # columns per chunk inside a rank's block of 48 (chunked case)
NAMES = [".kernel.variance", ".kernel.lengthscales", ".inducing_Z",
         ".noise_variance", ".mean.c"]


def _draw(rng, n, d=3, m=8):
    X = rng.normal(size=(n, d))
    Y = np.sin(X[:, :1]) + 0.05 * rng.normal(size=(n, 1))
    return X, Y, X[rng.choice(n, m, replace=False)].copy()


def _port_params(family, Z, values):
    kern = tk.make_kernel(family, Z.shape[1], dtype=torch.float64)
    params = ts.SGPRParams(kern, Z, dtype=torch.float64)
    return assign_parameters(params, values)


def _jax_params(family, Z, values):
    from cglb_tpu.ops import kernels as jk

    kern = jk.make_kernel(family, Z.shape[1],
                          variance=float(values[".kernel.variance"]),
                          lengthscales=values[".kernel.lengthscales"],
                          dtype=np.float64)
    return js.SGPRParams.create(kern, Z,
                                noise_variance=float(
                                    values[".noise_variance"]),
                                dtype=np.float64)


def _inputs(tmp: Path) -> dict:
    """Each case's data, parameter values and a converged v (the port's
    one-process CG at 1e-12, fp64 preconditioner), written for the ranks."""
    rng = np.random.default_rng(0)
    cases = {}
    for case, (n, family) in CASES.items():
        X, Y, Z = _draw(rng, n)
        values = {".kernel.variance": np.array(1.3),
                  ".kernel.lengthscales": np.array([0.9, 1.1, 0.8]),
                  ".inducing_Z": Z, ".noise_variance": np.array(0.4),
                  ".mean.c": np.array([0.0])}
        tp = _port_params(family, Z, values)
        tight = tc.CGLBConfig(max_error=1e-12, max_cg_iters=1000,
                              precond_dtype="float64")
        with torch.no_grad():
            _, aux = tc.loss(tp, torch.tensor(X), torch.tensor(Y),
                             tc.init_v0(n), tight)
        cases[case] = dict(X=X, Y=Y, Z=Z, family=family, values=values,
                           v=aux.v.numpy())
    flat = {}
    for case, c in cases.items():
        for key in ("X", "Y", "Z", "v"):
            flat[f"{case}__{key}"] = c[key]
        for name, val in c["values"].items():
            flat[f"{case}__p{name}"] = val
    np.savez(tmp / "inputs.npz", **flat)
    return cases


# --------------------------------------------------------------------------
# one rank (run as a process of the spawn)
# --------------------------------------------------------------------------


def _loss_and_grads(fn, params):
    params.zero_grad(set_to_none=True)
    loss, aux = fn(params)
    loss.backward()
    grads = {name: p.raw.grad.numpy().copy()
             for name, p in params.named_params()}
    return float(loss.detach()), aux, grads


def _rank_main(outdir: str) -> None:
    torch.set_num_threads(1)
    outdir = Path(outdir)
    mesh = tpm.data_mesh(2, "cpu")
    data = np.load(outdir / "inputs.npz")
    out = {"rank": np.array(mesh.rank), "world": np.array(mesh.world),
           "sum_of_ranks": mesh.all_reduce(
               torch.tensor([mesh.rank + 1.0])).numpy()}

    def case(name):
        family = CASES[name][1]
        values = {k: data[f"{name}__p{k}"] for k in NAMES}
        return (torch.tensor(data[f"{name}__X"]),
                torch.tensor(data[f"{name}__Y"]),
                torch.tensor(data[f"{name}__v"]),
                _port_params(family, data[f"{name}__Z"], values))

    def save(prefix, loss, aux, grads=None):
        out[f"{prefix}__loss"] = np.array(loss)
        out[f"{prefix}__cg_steps"] = np.array(aux.cg_steps)
        out[f"{prefix}__v"] = aux.v.numpy()
        for name, g in (grads or {}).items():
            out[f"{prefix}__grad{name}"] = g

    f64 = tc.CGLBConfig(max_error=1e-30, max_cg_iters=CAP,
                        precond_dtype="float64")
    fixed = {pd: tc.CGLBConfig(max_error=1e30, precond_dtype=pd)
             for pd in ("float64", "float32")}
    for name in ("even", "uneven", "rbf"):
        X, Y, v, params = case(name)
        n = X.shape[0]
        modes = ("dense", "streaming") if name != "uneven" else ("dense",)
        for mode in modes:
            def sharded(cfg, v0, variant="jensen"):
                cfg = dataclasses.replace(cfg, logdet_variant=variant)
                return lambda p: tsh.sharded_cglb_loss(
                    p, X, Y, v0, cfg, mesh, matvec=mode)

            with torch.no_grad():
                save(f"{name}_{mode}_capped",
                     *tsh.sharded_cglb_loss(params, X, Y, tc.init_v0(n),
                                            f64, mesh, matvec=mode))
            for pd, cfg in fixed.items():
                save(f"{name}_{mode}_{pd}",
                     *_loss_and_grads(sharded(cfg, v), params))
            if name == "even":
                for variant in ("n2m", "nm2"):
                    save(f"{name}_{mode}_{variant}", *_loss_and_grads(
                        sharded(fixed["float64"], v, variant), params))

    # the SGPR bounds with A A^T and A err summed over the ranks
    X, Y, _, params = case("even")
    for fn in (ts.elbo, ts.upper_bound, ts.elbo_n2m):
        params.zero_grad(set_to_none=True)
        value = fn(params, X, Y, mesh=mesh)
        value.backward()
        out[f"sgpr_{fn.__name__}__value"] = value.detach().numpy()
        for pname, prm in params.named_params():
            out[f"sgpr_{fn.__name__}__grad{pname}"] = prm.raw.grad.numpy()

    # the streaming operator against the dense one: values, and the
    # gradients of <op(p), w> in the kernel parameters and p
    X, _, _, params = case("rbf")
    g = torch.Generator().manual_seed(1)
    p0 = torch.randn(2, X.shape[0], generator=g, dtype=torch.float64)
    w = torch.randn(2, X.shape[0], generator=g, dtype=torch.float64)
    for mode in ("dense", "streaming"):
        params.zero_grad(set_to_none=True)
        p = p0.clone().requires_grad_(True)
        op = tsh.sharded_operator(mesh, params.kernel, X,
                                  params.noise_variance.value, mode)
        val = op(p)
        torch.sum(val * w).backward()
        out[f"op_{mode}__value"] = val.detach().numpy()
        out[f"op_{mode}__dp"] = p.grad.numpy()
        for pname, prm in params.named_params():
            if prm.raw.grad is not None:
                out[f"op_{mode}__grad{pname}"] = prm.raw.grad.numpy()
    out["op__cross"] = tst.sharded_cross_matvec(
        mesh, params.kernel, X, X[:7] + 0.1, p0).numpy()

    # chunked common terms inside each rank's block (48 columns, chunks of
    # CHUNK), each recomputed in the backward
    X, Y, v, params = case("chunked")
    ts.CHUNK_THRESHOLD_ELEMENTS = 16
    ts.CHUNK_ELEMENTS = CHUNK * params.num_inducing
    assert ts.chunk_width(48, params.num_inducing) == CHUNK
    for pd, cfg in fixed.items():
        save(f"chunked_dense_{pd}", *_loss_and_grads(
            lambda p: tsh.sharded_cglb_loss(p, X, Y, v, cfg, mesh), params))
    ts.CHUNK_THRESHOLD_ELEMENTS = 1 << 28
    ts.CHUNK_ELEMENTS = 1 << 26

    # sharded_train_step: two Adam steps, and the same two in one process
    X, Y, v, _ = case("even")
    X, Y = tsh.shard_data(mesh, X.numpy(), Y.numpy())
    cfg = tc.CGLBConfig(max_error=1e-30, max_cg_iters=CAP,
                        precond_dtype="float64")
    for tag in ("mesh", "one"):
        _, _, _, params = case("even")
        opt = torch.optim.Adam([r for r in params.parameters()
                                if r.requires_grad], lr=0.05)
        if tag == "mesh":
            step = tsh.sharded_train_step(mesh, cfg, opt)
        else:
            def step(p, v0, X, Y):
                opt.zero_grad(set_to_none=True)
                loss, aux = tc.loss(p, X, Y, v0, cfg)
                loss.backward()
                opt.step()
                return aux, loss.detach()
        v0 = tc.init_v0(X.shape[0])
        for _ in range(2):
            aux, _ = step(params, v0, X, Y)
            v0 = aux.v
        for name, prm in params.named_params():
            out[f"step_{tag}__raw{name}"] = prm.raw.detach().numpy()

    _exchange_cases(mesh, out, case)
    _backend_cases(mesh, out, outdir)
    np.savez(outdir / f"rank{mesh.rank}.npz", **out)
    tpm.shutdown()


def _exchange_cases(mesh, out: dict, case) -> None:
    """The exchange counters over three collectives of known sizes, and the
    spans of a sharded loss and its backward under a profiler beside the
    counters' change over the same calls."""
    ex = tpm.exchange
    n0, b0 = ex.exchanges, ex.exchange_bytes
    mesh.all_reduce(torch.ones(3, dtype=torch.float64))
    mesh.all_gather(torch.ones(2, 5, dtype=torch.float32), 10, 1)
    mesh.check_same(1.0, "a test value")
    out["exchange__counted"] = np.array([ex.exchanges - n0,
                                         ex.exchange_bytes - b0])
    X, Y, v, params = case("even")
    cfg = tc.CGLBConfig(max_error=1e30, precond_dtype="float64")
    n0 = ex.exchanges
    params.zero_grad(set_to_none=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        loss, _ = tsh.sharded_cglb_loss(params, X, Y, v, cfg, mesh,
                                        matvec="streaming")
        loss.backward()
    names = [e.name for e in prof.events()]
    out["exchange__traced"] = np.array([
        ex.exchanges - n0, names.count("cglb.mesh.exchange"),
        names.count("cglb.mesh.read")])


def _backend_cases(mesh, out: dict, outdir: Path) -> None:
    """The Torch facade at synth_300x2, M 12, with the mesh and without:
    the tolerance-level loss at 1.0 and 1e-2 from the fresh model's zero
    warm start and the test log density (CG at 1e-6; both with the fp64
    preconditioner), the loss, predictions, then one Adam
    step and 4 scipy iterations; each model's raw parameters.  Then every
    rank saves the meshed model and its checkpoint into a directory of its
    own (rank 0 alone writes), and reads rank 0's checkpoint back."""
    from cglb_tpu_torch.backend import Torch
    from cglb_tpu_torch.configs import (CGLBConfig, InducingVariableConfig,
                                        Matern32Config)
    from cglb_tpu_torch.experiments.datasets import get_dataset

    bundle = get_dataset("synth_300x2", dtype=np.float64)
    cfg = CGLBConfig(Matern32Config(), InducingVariableConfig(12))
    for tag, m in (("mesh", mesh), ("one", None)):
        model = Torch(device="cpu", mesh=m).create_model(
            cfg, bundle.train, seed=0)
        run_cfg = model.run_cfg
        model.run_cfg = dataclasses.replace(run_cfg, precond_dtype="float64")
        fn = model.loss_fn_tol()
        with torch.no_grad():
            out[f"backend_{tag}__tol"] = np.array([
                float(fn(model.params, model.v0, me)[0])
                for me in (1.0, 1e-2)])
        out[f"backend_{tag}__lpd"] = model.predict_log_density(
            bundle.test).numpy()
        model.run_cfg = run_cfg
        out[f"backend_{tag}__loss0"] = np.array(model.loss_value())
        mean, var = model.predict_f(bundle.test[0])
        out[f"backend_{tag}__mean"] = mean.numpy()
        out[f"backend_{tag}__var"] = var.numpy()
        out[f"backend_{tag}__elbo"] = np.array([model.elbo(),
                                                model.upper_bound()])
        datasets = (bundle.train, bundle.test)
        Torch.optimize(model, datasets, 1, optimizer="adam_0.01")
        out[f"backend_{tag}__adam"] = np.array(model.loss_value())
        Torch.optimize(model, datasets, 4, optimizer="scipy")
        out[f"backend_{tag}__scipy"] = np.array(model.loss_value())
        for name, prm in model.params.named_params():
            out[f"backend_{tag}__raw{name}"] = prm.raw.detach().numpy()
        if tag == "mesh":
            mine = outdir / f"saved{mesh.rank}"
            mine.mkdir()
            Torch.save(model, mine)
            Torch.save_checkpoint(model, mine, extra={"iters_done": 5})
            out["files_written"] = np.array(",".join(
                sorted(f.name for f in mine.iterdir())))
            mesh.barrier()
            v0 = model.v0.clone()
            model.v0 = torch.zeros_like(v0)
            Torch.load_checkpoint(model, outdir / "saved0" /
                                  "checkpoint.json")
            out["backend_mesh__resumed_v0_equal"] = np.array(
                torch.equal(model.v0, v0))
            out["backend_mesh__resumed_iters"] = np.array(
                model.last_checkpoint_extra["iters_done"])


# --------------------------------------------------------------------------
# the spawn and the JAX references
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(inputs, [rank 0's results, rank 1's]) of one two-rank spawn.  A
    hung collective fails here at the spawn's time limit."""
    tmp = tmp_path_factory.mktemp("mesh")
    cases = _inputs(tmp)
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, "
            f"{str(ROOT / 'tests')!r}]; import test_torch_parallel as t; "
            f"t._rank_main({str(tmp)!r})")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               CGLB_DATA_DIR=str(tmp / "no_data_here"))
    tpm.run_ranks([sys.executable, "-c", code], 2, env=env, timeout_s=240)
    return cases, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def _jax_config(pd, variant="jensen", **kw):
    return jc.CGLBConfig(common_dtype="float64", precond_dtype=pd,
                         logdet_variant=variant, **kw)


def _jax_grads(g):
    return {".kernel.variance": g.kernel.variance.raw,
            ".kernel.lengthscales": g.kernel.lengthscales.raw,
            ".inducing_Z": g.inducing_Z.raw,
            ".noise_variance": g.noise_variance.raw,
            ".mean.c": g.mean.c.raw}


@functools.lru_cache(maxsize=None)
def _jax_mesh():
    return jmesh.data_mesh(8)


def _jax_value_and_grad(c, cfg, v, sharded=False):
    params = _jax_params(c["family"], c["Z"], c["values"])
    X, Y = jnp.asarray(c["X"]), jnp.asarray(c["Y"])
    if sharded:
        def f(p):
            return jsh.sharded_cglb_loss(p, X, Y, jnp.asarray(v), cfg,
                                         _jax_mesh())
    else:
        def f(p):
            return jc.loss(p, X, Y, jnp.asarray(v), cfg)
    (loss, aux), g = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    return float(loss), aux, {k: np.asarray(v) for k, v in
                              _jax_grads(g).items()}


def _close_grads(got: dict, prefix: str, want: dict, rtol: float):
    for name, w in want.items():
        np.testing.assert_allclose(
            got[f"{prefix}__grad{name}"], w, rtol=0,
            atol=rtol * np.max(np.abs(w)), err_msg=f"{prefix} {name}")


# --------------------------------------------------------------------------
# the checks
# --------------------------------------------------------------------------


def test_coordinator_bootstrap_forms_the_group(ranks):
    """Both ranks joined one gloo group from CGLB_COORDINATOR /
    CGLB_NUM_PROCESSES / CGLB_PROCESS_ID, each with its own rank, and a
    collective sums over both."""
    _, (r0, r1) = ranks
    assert (int(r0["rank"]), int(r1["rank"])) == (0, 1)
    assert int(r0["world"]) == int(r1["world"]) == 2
    assert float(r0["sum_of_ranks"][0]) == float(r1["sum_of_ranks"][0]) == 3


@pytest.mark.parametrize("name,mode", [("even", "dense"),
                                       ("even", "streaming"),
                                       ("uneven", "dense"),
                                       ("rbf", "streaming")])
def test_sharded_loss_matches_jax_at_capped_cg(ranks, name, mode):
    """CG capped at 6 steps from zeros, fp64 preconditioner: the sharded
    loss equals JAX's one-device loss and (dense) its sharded loss to
    1e-9, with the same CG steps, on both ranks alike."""
    cases, (r0, r1) = ranks
    c = cases[name]
    prefix = f"{name}_{mode}_capped"
    cfg = _jax_config("float64", max_error=1e-30, max_cg_iters=CAP)
    params = _jax_params(c["family"], c["Z"], c["values"])
    X, Y = jnp.asarray(c["X"]), jnp.asarray(c["Y"])
    v0 = jc.init_v0(X.shape[0])
    want, aux = jax.jit(lambda p: jc.loss(p, X, Y, v0, cfg))(params)
    assert r0[f"{prefix}__loss"] == r1[f"{prefix}__loss"]
    assert int(r0[f"{prefix}__cg_steps"]) == int(aux.cg_steps) == CAP
    np.testing.assert_allclose(float(r0[f"{prefix}__loss"]), float(want),
                               rtol=1e-9)
    if name == "even" and mode == "dense":
        sh, _ = jax.jit(lambda p: jsh.sharded_cglb_loss(
            p, X, Y, v0, cfg, _jax_mesh()))(params)
        np.testing.assert_allclose(float(r0[f"{prefix}__loss"]), float(sh),
                                   rtol=1e-9)


@pytest.mark.parametrize("name,mode,pd,rtol", [
    ("even", "dense", "float64", 1e-7),
    ("even", "streaming", "float64", 1e-7),
    ("even", "dense", "float32", 1e-6),
    ("uneven", "dense", "float64", 1e-7),
    ("uneven", "dense", "float32", 1e-6),
    ("rbf", "streaming", "float64", 1e-7),
    ("chunked", "dense", "float64", 1e-7),
    ("chunked", "dense", "float32", 1e-6)])
def test_sharded_gradients_match_jax_at_converged_v(ranks, name, mode, pd,
                                                    rtol):
    """value_and_grad at a converged v (no CG step), against JAX's
    one-device loss: the loss to 1e-9, every gradient to ``rtol``; even N
    also against JAX's sharded loss on its 8-device mesh.  ``uneven`` holds
    61 rows (31 + 30 columns); ``chunked`` goes by chunks of 24 columns
    inside each rank's 48, recomputed in the backward."""
    cases, (r0, r1) = ranks
    c = cases[name]
    prefix = f"{name}_{mode}_{pd}"
    cfg = _jax_config(pd, max_error=1e30)
    want, aux, grads = _jax_value_and_grad(c, cfg, c["v"])
    assert int(r0[f"{prefix}__cg_steps"]) == int(aux.cg_steps) == 0
    np.testing.assert_allclose(float(r0[f"{prefix}__loss"]), want,
                               rtol=1e-9)
    _close_grads(r0, prefix, grads, rtol)
    _close_grads(r1, prefix, grads, rtol)
    if name == "even" and mode == "dense" and pd == "float64":
        sh, _, sgrads = _jax_value_and_grad(c, cfg, c["v"], sharded=True)
        np.testing.assert_allclose(float(r0[f"{prefix}__loss"]), sh,
                                   rtol=1e-9)
        _close_grads(r0, prefix, sgrads, rtol)


@pytest.mark.parametrize("variant", ["n2m", "nm2"])
@pytest.mark.parametrize("mode", ["dense", "streaming"])
def test_sharded_logdet_variants_match_jax(ranks, variant, mode):
    """The n2m (K's columns and C's per rank, traces summed) and nm2
    variants at a converged v: loss 1e-9, gradients 1e-7."""
    cases, (r0, _) = ranks
    prefix = f"even_{mode}_{variant}"
    cfg = _jax_config("float64", variant, max_error=1e30)
    want, _, grads = _jax_value_and_grad(cases["even"], cfg,
                                         cases["even"]["v"])
    np.testing.assert_allclose(float(r0[f"{prefix}__loss"]), want,
                               rtol=1e-9)
    _close_grads(r0, prefix, grads, 1e-7)


@pytest.mark.parametrize("fn", ["elbo", "upper_bound", "elbo_n2m"])
def test_sharded_sgpr_bounds_match_one_process(ranks, fn):
    """The SGPR bounds with the mesh (A A^T, A err and the n2m traces
    summed over the ranks) against the port's one process: values to
    1e-10, gradients to 1e-9 of each parameter's largest."""
    cases, (r0, _) = ranks
    c = cases["even"]
    tp = _port_params(c["family"], c["Z"], c["values"])
    want = getattr(ts, fn)(tp, torch.tensor(c["X"]), torch.tensor(c["Y"]))
    want.backward()
    np.testing.assert_allclose(r0[f"sgpr_{fn}__value"], float(want.detach()),
                               rtol=1e-10)
    for name, prm in tp.named_params():
        g = prm.raw.grad.numpy()
        np.testing.assert_allclose(r0[f"sgpr_{fn}__grad{name}"], g, rtol=0,
                                   atol=1e-9 * np.max(np.abs(g)),
                                   err_msg=name)


def test_streaming_operator_matches_dense(ranks):
    """The column-sharded streaming operator (kernels 1-2's plain versions
    on the CPU) against the dense block: p (K + s2 I), and the gradients of
    <p (K + s2 I), w> in p and the kernel parameters, to 1e-12; the
    row-sharded cross product v K(X, X') against the one-device one."""
    cases, (r0, r1) = ranks
    for key in r0:
        if key.startswith("op_dense__"):
            got = r0[key.replace("op_dense", "op_streaming")]
            np.testing.assert_allclose(
                got, r0[key], rtol=0,
                atol=1e-12 * np.max(np.abs(r0[key])), err_msg=key)
            np.testing.assert_array_equal(got, r1[key.replace(
                "op_dense", "op_streaming")])
    c = cases["rbf"]
    X = torch.tensor(c["X"])
    tp = _port_params(c["family"], c["Z"], c["values"])
    g = torch.Generator().manual_seed(1)
    p0 = torch.randn(2, X.shape[0], generator=g, dtype=torch.float64)
    with torch.no_grad():
        want = p0 @ tp.kernel.K(X, X[:7] + 0.1)
    np.testing.assert_allclose(r0["op__cross"], want.numpy(), rtol=1e-12)


def test_backend_mesh_matches_one_process(ranks):
    """The Torch facade with the mesh against the one-process facade at
    synth_300x2, M 12 (tests/test_parallel.py:160-197): the loss to 1e-9,
    the tolerance-level loss at 1.0 and 1e-2 to 1e-8, elbo and upper to
    1e-12, predictions to 1e-6 of their largest (the prediction's CG stops
    at 1e-3 with the model's fp32 preconditioner, whose products the ranks
    sum in two parts: 5e-8 measured), and after one Adam step and 4 scipy
    iterations the loss to 1e-5."""
    _, (r0, _) = ranks
    np.testing.assert_allclose(r0["backend_mesh__loss0"],
                               r0["backend_one__loss0"], rtol=1e-9)
    np.testing.assert_allclose(r0["backend_mesh__tol"],
                               r0["backend_one__tol"], rtol=1e-8)
    np.testing.assert_allclose(r0["backend_mesh__elbo"],
                               r0["backend_one__elbo"], rtol=1e-12)
    for key in ("mean", "var"):
        want = r0[f"backend_one__{key}"]
        np.testing.assert_allclose(r0[f"backend_mesh__{key}"], want, rtol=0,
                                   atol=1e-6 * np.max(np.abs(want)))
    assert r0["backend_mesh__scipy"] < r0["backend_mesh__loss0"]
    np.testing.assert_allclose(r0["backend_mesh__adam"],
                               r0["backend_one__adam"], rtol=1e-5)
    np.testing.assert_allclose(r0["backend_mesh__scipy"],
                               r0["backend_one__scipy"], rtol=1e-5)


def test_backend_predict_log_density_mesh_matches_one_process(ranks):
    """Model.predict_log_density (CG at 1e-6 under the mesh, fp64
    preconditioner) on both ranks equals the one-process value to 1e-9 of
    its scale, [S] test rows."""
    _, (r0, r1) = ranks
    want = r0["backend_one__lpd"]
    assert want.shape == (99,) and np.all(np.isfinite(want))
    for r in (r0, r1):
        np.testing.assert_allclose(r["backend_mesh__lpd"], want, rtol=0,
                                   atol=1e-9 * np.max(np.abs(want)))


def test_backend_tolerance_levels_match_jax(ranks):
    """Model.loss_fn_tol under the mesh at max_error 1.0 and 1e-2 against
    the JAX package's sharded loss with the tolerance as a traced argument
    (one compiled program for both levels), from zeros, both with the fp64
    preconditioner, to 1e-7."""
    from cglb_tpu.backend import Jax
    from cglb_tpu.configs import (CGLBConfig, InducingVariableConfig,
                                  Matern32Config)
    from cglb_tpu.experiments.datasets import get_dataset

    _, (r0, _) = ranks
    bundle = get_dataset("synth_300x2")
    Jax.configure_backend(mesh=8, common_dtype="float64")
    try:
        m8 = Jax.create_model(CGLBConfig(Matern32Config(),
                                         InducingVariableConfig(12)),
                              bundle.train, seed=0)
    finally:
        Jax.configure_backend(mesh=0, common_dtype="mixed")
    m8.run_cfg = dataclasses.replace(m8.run_cfg, precond_dtype="float64")
    fn = jax.jit(m8.loss_fn_tol())
    want = [float(fn(m8.params, m8.v0, *m8.data, jnp.asarray(me))[0])
            for me in (1.0, 1e-2)]
    np.testing.assert_allclose(r0["backend_mesh__tol"], want, rtol=1e-7)


def test_exchange_counters_count_each_collective_and_its_bytes(ranks):
    """An all-reduce of 3 fp64, an all-gather of a [2, 5] fp32 block and a
    check_same: three exchanges, each rank sending its part to the other
    rank (24, 40 and 8 bytes)."""
    _, (r0, r1) = ranks
    for r in (r0, r1):
        assert r["exchange__counted"].tolist() == [3, 24 + 40 + 8]


def test_exchange_spans_appear_under_a_profiler(ranks):
    """A sharded loss and its backward under torch.profiler: one
    cglb.mesh.exchange span for each exchange counted (the matvec's
    gathers, the all-reduces, the backward's), and one cglb.mesh.read for
    the CG solve's check of the ranks' step counts."""
    _, (r0, r1) = ranks
    for r in (r0, r1):
        counted, spans, reads = r["exchange__traced"].tolist()
        assert counted > 4 and spans == counted and reads == 1


def test_ranks_step_bitwise_equal_parameters(ranks):
    """After the Adam step and the scipy iterations both ranks hold the
    same bits in every parameter, and computed the same losses and warm
    starts throughout."""
    _, (r0, r1) = ranks
    keys = [k for k in r0 if k.startswith("backend_mesh__")
            or k.endswith(("__loss", "__v")) or "__grad" in k]
    assert any("__raw" in k for k in keys)
    for key in keys:
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)


def test_sharded_train_step_matches_one_process(ranks):
    """Two steps of sharded_train_step (Adam 0.05, CG capped at 6, fp64
    preconditioner) against the same two steps of cglb.loss in one process:
    every raw parameter to 1e-9 relative, and bitwise equal on the ranks."""
    _, (r0, r1) = ranks
    for key in r0:
        if key.startswith("step_mesh__"):
            want = r0[key.replace("step_mesh", "step_one")]
            np.testing.assert_allclose(r0[key], want, rtol=1e-9, atol=1e-12,
                                       err_msg=key)
            np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)


def test_rank0_alone_writes_and_every_rank_resumes(ranks):
    """Torch.save and Torch.save_checkpoint on both ranks, each into a
    directory of its own: only rank 0's holds model.json and
    checkpoint.json; both ranks then read rank 0's checkpoint back, warm
    start and resume metadata included."""
    _, (r0, r1) = ranks
    assert str(r0["files_written"]) == "checkpoint.json,model.json"
    assert str(r1["files_written"]) == ""
    for r in (r0, r1):
        assert bool(r["backend_mesh__resumed_v0_equal"])
        assert int(r["backend_mesh__resumed_iters"]) == 5


def test_world_size_one_group_is_the_identity():
    """A gloo group of one rank: enter, reduce, gather and shard return
    their input, with the gradients of the identity, and the sharded loss
    and gradients equal the one-process ones bit for bit (dense: the same
    block) or to 1e-12 (the column-block kernel)."""
    os.environ.update(CGLB_COORDINATOR=f"localhost:{tpm.free_port()}",
                      CGLB_NUM_PROCESSES="1", CGLB_PROCESS_ID="0")
    try:
        mesh = tpm.data_mesh(None, "cpu")
        assert (mesh.rank, mesh.world, mesh.backend) == (0, 1, "gloo")
        x = torch.randn(5, 4, dtype=torch.float64, requires_grad=True)
        for y in (mesh.enter(x), mesh.reduce(x), mesh.gather(x, 4, 1),
                  mesh.shard(x, 0)):
            x.grad = None
            torch.sum(y * y).backward()
            assert torch.equal(y, x)
            assert torch.equal(x.grad, 2 * x.detach())
        X, Y, Z = _draw(np.random.default_rng(3), 40)
        values = {".kernel.variance": np.array(1.1),
                  ".kernel.lengthscales": np.array([1.0, 0.7, 1.2]),
                  ".inducing_Z": Z, ".noise_variance": np.array(0.3),
                  ".mean.c": np.array([0.2])}
        Xt, Yt = torch.tensor(X), torch.tensor(Y)
        cfg = tc.CGLBConfig(max_error=1e-30, max_cg_iters=CAP,
                            precond_dtype="float64")
        one = _port_params("Matern32", Z, values)
        sh = _port_params("Matern32", Z, values)
        l1, a1, g1 = _loss_and_grads(
            lambda p: tc.loss(p, Xt, Yt, tc.init_v0(40), cfg), one)
        ls, as_, gs = _loss_and_grads(
            lambda p: tsh.sharded_cglb_loss(p, Xt, Yt, tc.init_v0(40), cfg,
                                            mesh), sh)
        assert a1.cg_steps == as_.cg_steps == CAP
        np.testing.assert_allclose(ls, l1, rtol=1e-12)
        for name, g in g1.items():
            np.testing.assert_allclose(gs[name], g, rtol=0,
                                       atol=1e-12 * np.max(np.abs(g)))
    finally:
        tpm.shutdown()
        for key in ("CGLB_COORDINATOR", "CGLB_NUM_PROCESSES",
                    "CGLB_PROCESS_ID"):
            os.environ.pop(key, None)


def test_layout_and_backend_rules():
    """Column blocks of ceil(N / R) (61 over 2: 31 + 30; 61 over 8: seven
    of 8 and one of 5), a rank left without columns raises; NCCL needs
    CUDA; --mesh above the visible cards raises unless gloo shares them,
    and -1 needs CUDA."""
    blocks = [tpm.DataMesh(r, 8, torch.device("cpu"), "gloo").cols(61)
              for r in range(8)]
    assert blocks[:2] == [(0, 8), (8, 16)] and blocks[-1] == (56, 61)
    assert tpm.DataMesh(1, 2, torch.device("cpu"), "gloo").cols(61) == (
        31, 61)
    with pytest.raises(ValueError, match="without columns"):
        tpm.DataMesh(0, 4, torch.device("cpu"), "gloo").cols(5)
    with pytest.raises(ValueError, match="NCCL"):
        tpm.resolve_backend("cpu", "nccl")
    assert tpm.resolve_backend("cpu") == "gloo"
    assert tpm.plan_ranks(3, "cpu") == 3
    with pytest.raises(ValueError, match="needs CUDA"):
        tpm.plan_ranks(-1, "cpu")


def test_plan_ranks_on_one_card(monkeypatch):
    """With one visible card: NCCL takes one rank, two raise naming gloo,
    gloo shares the card among two; -1 means one rank a card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tpm.plan_ranks(1, "cuda") == 1
    assert tpm.plan_ranks(-1, "cuda") == 1
    with pytest.raises(ValueError, match="gloo"):
        tpm.plan_ranks(2, "cuda")
    assert tpm.plan_ranks(2, "cuda", "gloo") == 2


def test_mesh_defaults_to_the_card(monkeypatch):
    """Like ``Torch``, ``data_mesh`` and ``maybe_initialize_distributed``
    take the card unless the caller asks for the CPU: in a launched rank
    with no card visible they raise instead of joining a CPU group."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setenv("CGLB_COORDINATOR", f"localhost:{tpm.free_port()}")
    monkeypatch.setenv("CGLB_NUM_PROCESSES", "1")
    monkeypatch.setenv("CGLB_PROCESS_ID", "0")
    for join in (tpm.maybe_initialize_distributed, tpm.data_mesh):
        with pytest.raises(RuntimeError, match="none is visible"):
            join()
    assert not torch.distributed.is_initialized()


def test_run_ranks_propagates_a_failing_rank(tmp_path):
    """A rank that exits non-zero ends the launch with its code, and the
    other rank (still waiting) is killed."""
    code = ("import os, sys, time\n"
            "if os.environ['CGLB_PROCESS_ID'] == '1': sys.exit(3)\n"
            "time.sleep(60)\n")
    with pytest.raises(tpm.RankFailed) as err:
        tpm.run_ranks([sys.executable, "-c", code], 2, timeout_s=30)
    assert (err.value.rank, err.value.returncode) == (1, 3)
