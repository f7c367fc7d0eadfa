"""PyTorch port: the streaming matvec's plain version (kernels 1 and 2 on the
CPU) and its autograd Function against the JAX package's Pallas kernels in
interpret mode and against dense fp64 autodiff.

Tolerances: 5e-5 * scale against interpret mode, whose bf16-split distance
matmul is the TPU kernel's own accuracy contract (tests/test_matvec_pallas);
1e-9 against dense fp64, since the plain version runs in fp64."""

import torch_threads  # noqa: F401  (the test processes' torch thread cap)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cglb_tpu.ops import kernels as jk
from cglb_tpu.ops import matvec_pallas as jmv
from cglb_tpu.transforms import Param as JParam
from cglb_tpu_torch.ops import kernels as tk
from cglb_tpu_torch.ops import matvec as tmv

FAMILIES = [("Matern32", "mat32"), ("SquaredExponential", "rbf")]


def _kernels(name, d, rng):
    ls = rng.uniform(0.5, 2.0, size=d)
    jkern = jk.make_kernel(name, d, dtype=np.float64)
    jkern = dataclasses.replace(
        jkern, variance=JParam.positive(1.7, lower=1e-6),
        lengthscales=JParam.positive(jnp.asarray(ls), lower=1e-6))
    tkern = tk.make_kernel(name, d, variance=1.7, lengthscales=ls,
                           dtype=torch.float64)
    return jkern, tkern


@pytest.mark.parametrize("name,family", FAMILIES)
def test_plain_matvec_matches_pallas_and_dense(rng, name, family):
    n, d = 200, 4
    X = rng.normal(size=(n, d))
    p = rng.normal(size=(2, n))
    jkern, tkern = _kernels(name, d, rng)
    got = tmv.kernel_matvec(tkern, torch.tensor(X), torch.tensor(p))
    got = got.detach().numpy()
    pallas = np.asarray(jmv.kernel_matvec(jkern, jnp.asarray(X),
                                          jnp.asarray(p), 128, 128,
                                          interpret=True))
    dense = np.asarray(jnp.asarray(p) @ jk.K(jkern, jnp.asarray(X)))
    scale = np.max(np.abs(dense))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=5e-5 * scale)
    np.testing.assert_allclose(got, dense, rtol=0, atol=1e-9 * scale)


@pytest.mark.parametrize("name,family", FAMILIES)
def test_plain_cross_matvec_matches_pallas_and_dense(rng, name, family):
    nr, nc, d = 150, 90, 3
    Xr, Xc = rng.normal(size=(nr, d)), rng.normal(size=(nc, d))
    p = rng.normal(size=(1, nr))
    jkern, tkern = _kernels(name, d, rng)
    got = tmv.kernel_cross_matvec(tkern, torch.tensor(Xr), torch.tensor(Xc),
                                  torch.tensor(p)).detach().numpy()
    pallas = np.asarray(jmv.kernel_cross_matvec(
        jkern, jnp.asarray(Xr), jnp.asarray(Xc), jnp.asarray(p), 64, 64,
        interpret=True))
    dense = np.asarray(jnp.asarray(p) @ jk.K(jkern, jnp.asarray(Xr),
                                             jnp.asarray(Xc)))
    scale = np.max(np.abs(dense))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=5e-5 * scale)
    np.testing.assert_allclose(got, dense, rtol=0, atol=1e-9 * scale)


@pytest.mark.parametrize("name,family", FAMILIES)
def test_function_backward_matches_pallas_and_dense(rng, name, family):
    """dp, dvar, dls of the Function (kernel 1 swapped for dp, kernel 2
    for dls) vs the Pallas custom_vjp and vs dense fp64 autodiff, on the
    raw parameters."""
    n, d = 160, 4
    X = rng.normal(size=(n, d))
    p = rng.normal(size=(1, n))
    w = rng.normal(size=(1, n))
    jkern, tkern = _kernels(name, d, rng)

    def f_pallas(kern, pv):
        out = jmv.kernel_matvec(kern, jnp.asarray(X), pv, 128, 128,
                                interpret=True)
        return jnp.sum(out * w)

    def f_dense(kern, pv):
        return jnp.sum((pv @ jk.K(kern, jnp.asarray(X))) * w)

    gp = jax.jit(jax.grad(f_pallas, argnums=(0, 1)))(jkern, jnp.asarray(p))
    gd = jax.jit(jax.grad(f_dense, argnums=(0, 1)))(jkern, jnp.asarray(p))

    pt = torch.tensor(p, requires_grad=True)
    out = tmv.kernel_matvec(tkern, torch.tensor(X), pt)
    torch.sum(out * torch.tensor(w)).backward()
    got = {"var": tkern.variance.raw.grad.numpy(),
           "ls": tkern.lengthscales.raw.grad.numpy(), "p": pt.grad.numpy()}
    for g, tol in ((gd, 1e-9), (gp, 5e-5)):
        want = {"var": np.asarray(g[0].variance.raw),
                "ls": np.asarray(g[0].lengthscales.raw),
                "p": np.asarray(g[1])}
        for key in want:
            scale = np.max(np.abs(want[key]))
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=tol * scale, err_msg=key)


def test_operator_pair_adds_noise_and_shares_prep(rng):
    n, d = 120, 3
    X = torch.tensor(rng.normal(size=(n, d)))
    p = torch.tensor(rng.normal(size=(1, n)))
    tkern = tk.make_kernel("Matern32", d, variance=1.3, dtype=torch.float64)
    acc, cg = tmv.make_streaming_operator_pair(tkern, X, 0.37)
    dense = p @ (tkern.K(X) + 0.37 * torch.eye(n, dtype=torch.float64))
    for op in (acc, cg):
        torch.testing.assert_close(op(p).detach(), dense.detach(), rtol=0,
                                   atol=1e-10)


def test_plain_ls_grad_matches_finite_difference(rng):
    """Kernel 2's plain version against a central difference of the plain
    matvec in the lengthscales (independent of any autodiff)."""
    n, d = 60, 3
    X = torch.tensor(rng.normal(size=(n, d)))
    p = torch.tensor(rng.normal(size=(1, n)))
    g = torch.tensor(rng.normal(size=(1, n)))
    ls = torch.tensor(rng.uniform(0.7, 1.5, size=d))
    rows = tmv.Prepared(X, ls, "mat32")
    acc = tmv.ls_grad_unit(rows, rows, p, g) * (-2.0 / (3.0 * ls))
    eps = 1e-6
    for k in range(d):
        dl = torch.zeros(d, dtype=torch.float64)
        dl[k] = eps
        f = [torch.sum(g * tmv.matvec_unit(tmv.Prepared(X, ls + s * dl,
                                                        "mat32"),
                                           tmv.Prepared(X, ls + s * dl,
                                                        "mat32"), p))
             for s in (1.0, -1.0)]
        fd = (f[0] - f[1]) / (2 * eps)
        np.testing.assert_allclose(float(acc[k]), float(fd), rtol=1e-6)


def test_kernel_shape_limits():
    with pytest.raises(ValueError):
        tmv.coord_plan(0)
    with pytest.raises(ValueError):
        tmv._bpad(9)
    assert [tmv._bpad(b) for b in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]


@pytest.mark.parametrize("d,width,wide", [
    (1, 8, False), (8, 8, False), (9, 12, False), (11, 12, False),
    (12, 12, False), (13, 32, False), (16, 32, False), (17, 32, False),
    (32, 32, False),
    (33, 40, True), (36, 40, True), (40, 40, True), (41, 48, True),
    (64, 64, True), (100, 104, True), (1000, 1000, True)])
def test_coordinate_plan_at_any_dimension(rng, d, width, wide):
    """Every D >= 1 has a launch plan: the first of the instantiated widths
    8, 12 and 32 that holds D (D 9-12 at 12, D 13-32 at 32), above 32 the
    wide kernels' multiple of WIDE_CHUNK (8: D 40 runs at 40, D 100 at
    104); the packed coordinates are x sqrt(gamma) / lengthscale in fp32,
    then zero columns up to the width (t over them is the same sum as over
    the D), packed once."""
    assert tmv.coord_plan(d) == (width, wide)
    assert width % tmv.WIDE_CHUNK == 0 or not wide
    X = torch.tensor(rng.normal(size=(5, d)))
    ls = torch.tensor(rng.uniform(0.5, 2.0, size=d))
    prep = tmv.Prepared(X, ls, "mat32")
    packed = prep.packed()
    assert prep.plan.wide == wide and packed.shape == (5, width)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    scaled = (X * (np.sqrt(tk.GAMMA["mat32"]) / ls)).float()
    assert torch.equal(packed[:, :d], scaled)
    assert not packed[:, d:].any()
    assert prep.packed() is packed


@pytest.mark.parametrize("n,block", [(1, 64), (64, 64), (130, 64),
                                     (300, 32)])
def test_block_shifted_columns_are_exact_fp32_differences(rng, n, block):
    """The wide kernel 2's moment pass stages its columns from
    ``block_shifted``: each run of ``block`` packed points less the run's
    first point, the same fp32 subtraction the kernel makes on the rows, so
    both sides of a pair are shifted by one point and distances are kept;
    far from the origin the shifted values are the size of the spread."""
    d = 40
    X = torch.tensor(rng.normal(size=(n, d)) + 100.0)
    prep = tmv.Prepared(X, torch.full((d,), 2.0, dtype=torch.float64),
                        "mat32")
    x, xs = prep.packed(), prep.block_shifted(block)
    assert xs.dtype == torch.float32 and xs.shape == x.shape
    assert xs.is_contiguous() and prep.block_shifted(block) is xs
    for b0 in range(0, n, block):
        assert torch.equal(xs[b0:b0 + block], x[b0:b0 + block] - x[b0])
    assert float(xs.abs().max()) < 20.0 < float(x.abs().max())


@pytest.mark.parametrize("d", [36, 40, 100])
@pytest.mark.parametrize("name,family", FAMILIES)
def test_cglb_loss_and_grads_match_jax_above_32_dimensions(rng, name,
                                                          family, d):
    """D = 36, 40 and 100, the wide plan (coordinates padded to 40, 40
    and 104; K(X, X) on the symmetric path): the port's CGLB loss on its
    streaming operator pair, with Kuf from kernel 3's wrapper (plain
    versions on the CPU), against the JAX package's at one converged v,
    fp64 common terms and preconditioner in both: 1e-9 on the loss, 1e-7
    on every gradient."""
    from cglb_tpu.models import cglb as jc
    from cglb_tpu.models import sgpr as js
    from cglb_tpu_torch.models import cglb as tc
    from cglb_tpu_torch.models import sgpr as ts

    n, m = 300, 12
    X = rng.normal(size=(n, d))
    Y = np.sin(X[:, :1]) + 0.1 * rng.normal(size=(n, 1))
    Z = X[:m].copy()
    ls = np.sqrt(d) * rng.uniform(0.5, 1.5, size=d)  # K off the diagonal
    jkern = dataclasses.replace(
        jk.make_kernel(name, d, dtype=np.float64),
        variance=JParam.positive(1.3, lower=1e-6),
        lengthscales=JParam.positive(jnp.asarray(ls), lower=1e-6))
    jp = js.SGPRParams.create(jkern, Z, noise_variance=0.3, dtype=np.float64)
    tp = ts.SGPRParams(tk.make_kernel(name, d, variance=1.3, lengthscales=ls,
                                      dtype=torch.float64),
                       Z, noise_variance=0.3, dtype=torch.float64)
    Xt, Yt = torch.tensor(X), torch.tensor(Y)
    assert tmv.Prepared(Xt, tp.kernel.lengthscales.value, family).plan.wide

    def operators():
        return tmv.make_streaming_operator_pair(tp.kernel, Xt,
                                                tp.noise_variance.value)

    with torch.no_grad():
        acc, cgt = operators()
        _, aux = tc.loss(tp, Xt, Yt, tc.init_v0(n), tc.CGLBConfig(
            max_error=1e-14, max_cg_iters=1000, precond_dtype="float64"),
            matvec=acc, matvec_cg=cgt)
    v = aux.v.numpy()
    jcfg = jc.CGLBConfig(max_error=1e30, common_dtype="float64",
                         precond_dtype="float64")
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jc.loss(p, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(v),
                          jcfg), has_aux=True))(jp)
    acc, cgt = operators()
    tl, taux = tc.loss(tp, Xt, Yt, torch.tensor(v), tc.CGLBConfig(
        max_error=1e30, precond_dtype="float64"), matvec=acc, matvec_cg=cgt)
    tl.backward()
    assert taux.cg_steps == 0
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-9)
    got = {name: prm.raw.grad.numpy() for name, prm in tp.named_params()}
    want = {".kernel.variance": jg.kernel.variance.raw,
            ".kernel.lengthscales": jg.kernel.lengthscales.raw,
            ".inducing_Z": jg.inducing_Z.raw,
            ".noise_variance": jg.noise_variance.raw}
    for key, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[key], w, rtol=0,
                                   atol=1e-7 * np.max(np.abs(w)),
                                   err_msg=key)


# launch geometry of the CUDA kernels (pure Python, checked on the CPU)

# the wide kernels above DP 32 (csrc/matvec_wide.cuh): 64 columns a block,
# 64 rows a staged tile, 2 blocks an SM
GEO_WIDE = tmv.Geometry(64, 64, 132 * 2)
GEOMETRIES = [tmv.Geometry(128, 128, 132 * 3), tmv.Geometry(64, 128, 132 * 2),
              tmv.Geometry(64, 64, 114), tmv.Geometry(128, 128, 16)]


def _segment_bounds(ni, segments, seg_rows):
    """[(begin, end)] of the rows each grid row of segments covers."""
    return [(s * seg_rows, min(ni, (s + 1) * seg_rows))
            for s in range(segments)]


@pytest.mark.parametrize("geo", GEOMETRIES)
@pytest.mark.parametrize("ni", [1, 3, 63, 64, 127, 128, 129, 1000, 13200,
                                26800])
def test_segment_plan_covers_each_row_once(geo, ni):
    for nj in (1, 77, 13200, 26800):
        segments, seg_rows = tmv.plan_segments(ni, nj, geo)
        assert seg_rows % geo.stage_rows == 0
        assert 1 <= segments <= tmv._MAX_SEGMENTS
        bounds = _segment_bounds(ni, segments, seg_rows)
        assert all(b < e for b, e in bounds)  # no empty segment
        covered = [i for b, e in bounds for i in range(b, e)]
        assert covered == list(range(ni))


@pytest.mark.parametrize("ni,nj", [(26800, 26800), (26800, 13200),
                                   (13200, 26800)])
@pytest.mark.parametrize("geo", GEOMETRIES[:3])
def test_segment_plan_fills_whole_waves_at_main_path_shapes(geo, ni, nj):
    """At the training and prediction shapes the blocks fill at least 90 %
    of the waves they take (a single segment would leave most SMs idle
    at the prediction shape 26800 x 13200)."""
    segments, _ = tmv.plan_segments(ni, nj, geo)
    blocks = -(-nj // geo.block_cols) * segments
    waves = -(-blocks // geo.slots)
    assert blocks / (waves * geo.slots) >= 0.9


def _block_rows(ni, nj, block_cols, col_block, begin, end, symmetric):
    """(rows feeding both sides, rows feeding the columns only) that the
    block of ``col_block`` and row segment [begin, end) takes, as
    csrc/matvec_kernels.cuh splits them.

    Not symmetric: every row of the segment feeds the block's columns.
    Symmetric (one point set, ni == nj): only rows below the end c1 of the
    block's columns [c0, c1); rows below c0 also feed their own output
    through the block's row sums, so each unordered pair is taken once."""
    if not symmetric:
        return range(0), range(begin, min(end, ni))
    c0 = col_block * block_cols
    c1 = min(c0 + block_cols, nj)
    end = min(end, ni)
    return range(begin, min(end, c0)), range(max(begin, c0), min(end, c1))


@pytest.mark.parametrize("geo", [tmv.Geometry(64, 64, 4),
                                 tmv.Geometry(32, 128, 7),
                                 tmv.Geometry(128, 128, 396), GEO_WIDE])
@pytest.mark.parametrize("n", [1, 50, 129, 300])
def test_symmetric_blocks_take_each_pair_once(geo, n):
    """Symmetric launches (one point set): over all blocks, the column side
    (p_i rho_ij into out_j, rows of either range) and the row side (p_j
    rho_ij into out_i, the first range only) count every ordered pair
    (i -> j) exactly once, the diagonal included."""
    segments, seg_rows = tmv.plan_segments(n, n, geo, True)
    assert seg_rows % geo.stage_rows == 0
    count = np.zeros((n, n), dtype=int)  # [i, j]: p_i rho_ij into out_j
    for cb in range(-(-n // geo.block_cols)):
        cols = np.arange(cb * geo.block_cols,
                         min(n, (cb + 1) * geo.block_cols))
        for begin, end in _segment_bounds(n, segments, seg_rows):
            both, col_only = _block_rows(n, n, geo.block_cols, cb, begin,
                                         end, True)
            for i in list(both) + list(col_only):
                count[i, cols] += 1
            for i in both:
                count[cols, i] += 1
    assert (count == 1).all()


def _segment_partials(xr, xc, p, family, geo, symmetric):
    """The kernels' decomposition with the plain version on row slices:
    (column partials [segments, B, nj], row partials [blocks, B, ni])."""
    ni, nj = xr.shape[0], xc.shape[0]
    segments, seg_rows = tmv.plan_segments(ni, nj, geo, symmetric)
    blocks = -(-nj // geo.block_cols)
    col_part = torch.zeros(segments, p.shape[0], nj, dtype=p.dtype)
    row_part = torch.zeros(blocks, p.shape[0], ni, dtype=p.dtype)
    for s, (begin, end) in enumerate(_segment_bounds(ni, segments,
                                                         seg_rows)):
        for cb in range(blocks):
            c = slice(cb * geo.block_cols, min(nj, (cb + 1) * geo.block_cols))
            both, col_only = _block_rows(ni, nj, geo.block_cols, cb,
                                         begin, end, symmetric)
            rows = list(both) + list(col_only)
            if rows:
                col_part[s, :, c] = tmv.matvec_unit_plain(
                    xr[rows], xc[c], p[:, rows], family)
            if len(both):
                row_part[cb][:, list(both)] = tmv.matvec_unit_plain(
                    xc[c], xr[list(both)], p[:, c], family)
    return col_part, row_part


@pytest.mark.parametrize("family", ["mat32", "rbf"])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("ni,geo", [(301, tmv.Geometry(64, 64, 4)),
                                    (1000, tmv.Geometry(32, 128, 7)),
                                    (50, tmv.Geometry(64, 64, 4))])
def test_segment_reduction_matches_whole_range(rng, family, symmetric, ni,
                                               geo):
    """Per-segment partials (the plain version on each block's rows), and
    in the symmetric case the per-column-block row sums, summed by
    reduce_segments equal the whole-range plain version."""
    nj = ni if symmetric else 90
    d = 5
    xr = torch.tensor(rng.normal(size=(ni, d)))
    xc = xr if symmetric else torch.tensor(rng.normal(size=(nj, d)))
    p = torch.tensor(rng.normal(size=(3, ni)))
    col_part, row_part = _segment_partials(xr, xc, p, family, geo, symmetric)
    want = tmv.matvec_unit_plain(xr, xc, p, family)
    got = tmv.reduce_segments(col_part)
    if symmetric:
        got = got + tmv.reduce_segments(row_part)
    else:
        assert float(row_part.abs().max()) == 0.0
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-12 * scale)


def test_reduce_segments_in_a_wider_dtype():
    parts = torch.tensor([[[1.0, 2.0]], [[3.0, 4.0]]], dtype=torch.float32)
    got = tmv.reduce_segments(parts, torch.float64)
    assert got.dtype == torch.float64
    assert got.tolist() == [[4.0, 6.0]]
    assert tmv.reduce_segments(parts[:1], torch.float64).dtype == \
        torch.float64


def test_padded_operands_are_zero_filled_and_aligned():
    a = torch.arange(6, dtype=torch.float64).reshape(2, 3)
    out = tmv._padded(a, 4, 8)
    assert out.dtype == torch.float32 and out.shape == (4, 8)
    assert out.data_ptr() % 16 == 0 and out.is_contiguous()
    torch.testing.assert_close(out[:2, :3], a.float())
    assert float(out[2:].abs().sum() + out[:, 3:].abs().sum()) == 0.0
    same = torch.zeros(2, 8, dtype=torch.float32)
    assert tmv._padded(same, 2, 8) is same
    view = torch.zeros(2, 9, dtype=torch.float32)[:, 1:]
    assert tmv._padded(view, 2, 8).is_contiguous()


# kernel 1's symmetric path in slabs of column blocks (pure Python)

# the DP 32 instantiation of kernel 1 (D 13-32 pad to 32): 2 columns a lane,
# 64 rows a staged tile (Tile in csrc/matvec_kernels.cuh)
GEO_DP32 = tmv.Geometry(64, 64, 132 * 2)
# the DP 12 instantiation (D 9-12; houseelectric's D 11): 4 columns a lane,
# 128 rows a staged tile
GEO_DP12 = tmv.Geometry(128, 128, 132 * 2)
HOUSEELECTRIC_TRAIN = 1_373_017  # int(2,049,280 * 0.67)


def _check_slab_plan(n, geo, bp, budget):
    slabs = tmv.plan_slabs(n, geo, bp, budget)
    blocks = -(-n // geo.block_cols)
    assert [s.cb0 for s in slabs] == [0] + [s.cb1 for s in slabs[:-1]]
    assert slabs[-1].cb1 == blocks
    for s in slabs:
        assert s.cb1 > s.cb0
        assert s.row_end == min(n, s.cb1 * geo.block_cols)
        assert s.seg_rows % geo.stage_rows == 0
        assert 1 <= s.segments <= tmv._MAX_SEGMENTS
        assert (s.segments - 1) * s.seg_rows < s.row_end \
            <= s.segments * s.seg_rows
    return slabs


@pytest.mark.parametrize("geo,blocks,gb", [(GEO_DP32, 21454, 117.8),
                                           (GEO_DP12, 10727, 58.9)])
@pytest.mark.parametrize("bp", [1, 8])
def test_slab_plan_bounds_row_partials_at_houseelectric(bp, geo, blocks, gb):
    """At houseelectric's training size the symmetric path's row sums, one
    float per (column block, row), would take 117.8 GB at B = 1 in a single
    launch at DP 32 (58.9 GB at DP 12, whose blocks are twice as wide); the
    slab plan holds every launch's to ROW_PARTIAL_BYTES (at most 1 GiB),
    whatever the batch width."""
    n = HOUSEELECTRIC_TRAIN
    assert -(-n // geo.block_cols) == blocks
    assert blocks * bp * n * 4 >= gb * 1e9 * bp
    slabs = _check_slab_plan(n, geo, bp, tmv.ROW_PARTIAL_BYTES)
    biggest = max((s.cb1 - s.cb0) * bp * s.row_end * 4 for s in slabs)
    assert biggest <= tmv.ROW_PARTIAL_BYTES <= 1 << 30
    assert len(slabs) > 1


@pytest.mark.parametrize("bp", [1, 2, 4, 8])
def test_one_slab_at_kin40k_shapes(bp):
    """Up to the kin40k shapes one slab covers every column block, with the
    row split the single launch had: the main path's launches are as they
    were."""
    for n, geo in ((26800, tmv.Geometry(128, 128, 132 * 3)),
                   (26800, GEO_DP32), (13200, tmv.Geometry(128, 128, 396))):
        slabs = _check_slab_plan(n, geo, bp, tmv.ROW_PARTIAL_BYTES)
        assert len(slabs) == 1
        assert (slabs[0].segments, slabs[0].seg_rows) == tmv.plan_segments(
            n, n, geo, True)


@pytest.mark.parametrize("geo", [tmv.Geometry(64, 64, 4),
                                 tmv.Geometry(32, 128, 7), GEO_WIDE])
@pytest.mark.parametrize("n", [129, 300])
def test_symmetric_slabs_take_each_pair_once(geo, n):
    """With a budget that forces several slabs, the launches' blocks (each
    slab's column blocks against its rows [0, row_end)) still count every
    ordered pair exactly once."""
    slabs = _check_slab_plan(n, geo, 1, 4 * n)  # n floats a slab
    assert len(slabs) >= 3
    count = np.zeros((n, n), dtype=int)
    for s in slabs:
        for cb in range(s.cb0, s.cb1):
            cols = np.arange(cb * geo.block_cols,
                             min(n, (cb + 1) * geo.block_cols))
            for begin, end in _segment_bounds(s.row_end, s.segments,
                                              s.seg_rows):
                both, col_only = _block_rows(n, n, geo.block_cols, cb, begin,
                                             end, True)
                for i in list(both) + list(col_only):
                    count[i, cols] += 1
                for i in both:
                    count[cols, i] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("n", [1, 63, 64, 65, 300, 26800])
def test_wide_symmetric_tiles_lie_below_or_on_the_diagonal(n):
    """The wide kernels decide per staged tile of 64 rows, not per row,
    which sides a symmetric pair feeds: each tile a column block takes must
    lie wholly below the block's first column c0 (both sides) or be the
    block's diagonal tile [c0, c0 + 64) (its columns only).  That holds for
    every launch the wrapper plans for them: segments of whole tiles,
    blocks of 64 columns, in one slab or in slabs forced by a small
    budget."""
    geo = GEO_WIDE
    assert geo.block_cols == geo.stage_rows
    for budget in (tmv.ROW_PARTIAL_BYTES, 4 * n):
        for s in _check_slab_plan(n, geo, 1, budget):
            for cb in range(s.cb0, s.cb1):
                c0 = cb * geo.block_cols
                c1 = min(n, c0 + geo.block_cols)
                for begin, end in _segment_bounds(s.row_end, s.segments,
                                                  s.seg_rows):
                    for i0 in range(begin, min(end, c1), geo.stage_rows):
                        assert i0 + geo.stage_rows <= c0 or i0 == c0


@pytest.mark.parametrize("family", ["mat32", "rbf"])
def test_slab_reduction_matches_whole_range(rng, family):
    """The wrapper's slab reduction (each slab's column partials reduced
    into its columns, then its row sums added to the rows it took, in slab
    order), with the plain version on each block's rows, equals the
    whole-range plain version."""
    n, d, geo = 301, 5, tmv.Geometry(64, 64, 4)
    x = torch.tensor(rng.normal(size=(n, d)))
    p = torch.tensor(rng.normal(size=(3, n)))
    slabs = _check_slab_plan(n, geo, 4, 4 * 4 * 128 * 2)
    assert len(slabs) >= 3
    out = torch.full((3, n), float("nan"), dtype=p.dtype)
    for s in slabs:
        col_part = torch.zeros(s.segments, 3, n, dtype=p.dtype)
        row_part = torch.zeros(s.cb1 - s.cb0, 3, s.row_end, dtype=p.dtype)
        for k, (begin, end) in enumerate(_segment_bounds(
                s.row_end, s.segments, s.seg_rows)):
            for cb in range(s.cb0, s.cb1):
                c = slice(cb * geo.block_cols,
                          min(n, (cb + 1) * geo.block_cols))
                both, col_only = _block_rows(n, n, geo.block_cols, cb,
                                             begin, end, True)
                rows = list(both) + list(col_only)
                if rows:
                    col_part[k, :, c] = tmv.matvec_unit_plain(
                        x[rows], x[c], p[:, rows], family)
                if len(both):
                    row_part[cb - s.cb0][:, list(both)] = \
                        tmv.matvec_unit_plain(x[c], x[list(both)], p[:, c],
                                              family)
        j = slice(s.cb0 * geo.block_cols, min(n, s.cb1 * geo.block_cols))
        out[:, j] = tmv.reduce_segments(col_part)[:, j]
        out[:, :s.row_end] += tmv.reduce_segments(row_part)
    want = tmv.matvec_unit_plain(x, x, p, family)
    np.testing.assert_allclose(out.numpy(), want.numpy(),
                               rtol=0, atol=1e-12 * float(want.abs().max()))


def test_ctypes_signatures_match_the_c_entry_points():
    """Each C entry point in csrc/*.cu takes as many parameters, of the same
    kinds (pointer, 64-bit or 32-bit integer), as the ctypes argtypes the
    wrappers call it with: a missing argtype passes a pointer as a 32-bit
    int, which the card reports only as an illegal address."""
    import ctypes
    import re

    from cglb_tpu_torch.ops import _build

    kinds = {ctypes.c_void_p: "ptr", ctypes.c_longlong: "i64",
             ctypes.c_int: "i32"}
    found = {}
    for src in _build.CSRC.glob("*.cu"):
        text = src.read_text()
        if 'extern "C"' not in text:
            continue
        body = text.split('extern "C"', 1)[1]
        for name, params in re.findall(r"\bint\s+(cglb_\w+)\(([^)]*)\)",
                                       body):
            out = []
            for param in params.split(","):
                param = " ".join(param.split())
                out.append("ptr" if "*" in param else
                           "i64" if "long long" in param else "i32")
            found[name] = out
    assert set(found) == set(_build._SIGNATURES)
    for name, argtypes in _build._SIGNATURES.items():
        want = [kinds.get(t, "ptr") for t in argtypes]  # POINTER(c_int)
        assert found[name] == want, name
