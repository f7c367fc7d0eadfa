// Streaming kernel matvec (kernel 1) and its lengthscale gradient (kernel 2):
// the kernels and their launches.  This header is compiled in four
// translation units, one per kernel family and path (matvec_<family>.cu,
// matvec_<family>_sym.cu), each instantiating run_family for every (DP, B);
// the C entry points are in matvec.cu.
//
// Kernel 1 replaces cglb_tpu/ops/matvec_pallas.py::_matvec_kernel (launched
// by _matvec_from_prep):
//
//     out[b, j] = sum_i p[b, i] * rho(t_ij),   t_ij = |xr_i - xc_j|^2,
//
// where xr/xc are the coordinates x * sqrt(gamma) / lengthscale prepared once
// per objective evaluation (so t = gamma * d2).  K is never stored.
//
// Kernel 2 replaces matvec_pallas.py::_ls_grad_kernel (launched by
// _ls_grad_from_prep): per block, the fp64 partial sums
//
//     partial[blk, d] = sum_ij m_ij (xr_i - xc_j)_d^2,
//     m_ij = (sum_b p[b, i] g[b, j]) * drho/d(d2)(t_ij),
//
// over the block's columns and rows.  The wrapper sums the partials with a
// deterministic torch.sum and applies -2 var / (gamma * lengthscale).
//
// What bounds them on an H100: instruction issue, not memory.  The inputs
// are N x DP floats (L2-resident), but every (i, j) pair costs DP
// subtractions and DP FMAs for t, two MUFU operations and two FP32 ones for
// the profile, and one FMA per batch row: about 22 instructions a pair at
// B = 1, D = 8 in kernel 1's compiled loop (cuobjdump -sass), about 38 in
// kernel 2, which adds DP products and DP FMAs for m * (xr_i - xc_j)^2;
// the symmetric loops take about 26 and 41 per unordered pair.  At the
// FP32 peak (67 TFLOP/s) the N = 26800 square takes 0.32 ms (kernel 1, 30
// flops a pair) and 0.49 ms (kernel 2, 46 flops a pair) for all N^2 pairs.
//
// Design:
// - Symmetric path.  When rows and columns are one point set (the training
//   operator, its gradient and the prediction CG: the wrapper passes the same
//   prepared set), each unordered pair is computed once.  Column block
//   [c0, c1) takes only rows i < c1: rows below c0 feed both its own columns
//   and, through a warp sum over the block's columns, the row's own output
//   (kernel 1: [column blocks, B, N] fp32 row sums, 128 terms each; kernel
//   2: m_ij + m_ji in one pass), and rows in [c0, c1) feed its columns only.
//   That halves the profile evaluations.  Kernel 1's row sums take one float
//   per (column block, row): 117.8 GB at N = 1,373,017 and DP 32, B = 1.  So
//   the wrapper launches the column blocks in slabs (col_block0, the grid's
//   x extent) whose row sums, over the rows [0, row_end) that the slab's
//   blocks take, fit a fixed budget, and reduces each slab's sums in a fixed
//   order before the next: row partials stay O(N) at any N, each pair is
//   still taken once, and a single slab covers every block up to the kin40k
//   shapes.
// - Register tiles.  A lane owns kCols columns (coordinates in registers)
//   and each warp step takes kRows rows (Tile, chosen from timings of tile
//   variants on an H100, PERF.md), so a step runs kCols * kRows
//   independent chains and one broadcast float4 read of a row's coordinates
//   from shared memory serves kCols * 32 pairs.
// - No fp64 per pair.  Each lane sums a staged tile's contributions in fp32
//   registers (at most 16 rows per column at the default tiles), then
//   promotes that run to fp64 once.  The CG tier adds the runs in fp32.
//   Kernel 2 keeps the squared direct differences of the t pass and
//   accumulates m * sq by fmaf; it never forms the TPU's moment expansion
//   rowsum(m) x_i^2 + colsum(m) x_j^2 - 2 x_i m x_j, which cancels in fp32.
// - Asynchronous staging.  Row tiles of kStageRows rows (coordinates, p and
//   in symmetric kernel 2 g) go through a ring of kStages buffers in shared
//   memory, filled by cp.async kStages - 1 tiles ahead of the warps that
//   consume them; the one barrier per tile finds its data already there.
// - A grid that fills the card.  The rows are split into segments of
//   seg_rows rows (a multiple of kStageRows), one grid row per segment; the
//   wrapper picks seg_rows from the SM count and the resident blocks per SM
//   (cglb_matvec_geometry) so that the blocks form whole waves.  Kernel 1
//   writes [segments, B, ldo] partials (its launch's columns) and kernel 2
//   [segments * blocks, DP]; the wrapper sums them in a fixed order.  No
//   atomics anywhere: two launches on the same inputs give bitwise-equal
//   results.
// - Fast transcendentals (common.cuh: ex2.approx, sqrt.approx) in every
//   tier.  On the card they cost no measurable accuracy and save about a
//   fifth of the accurate tier's time (PERF.md).
// - No tensor cores.  At B = 1 the contraction is a matrix-vector product,
//   which wgmma/mma.sync cannot speed up, and a TF32 mma could form the
//   K = 8 d2 only through the norm expansion, whose 10-bit mantissa loses
//   the small distances that matter most.
//
// Coordinates are zero-padded to DP in {8, 12, 32} columns (ops/matvec.py
// coord_plan: D 9-12 at 12, D 13-32 at 32; wider: the chunked kernels of
// matvec_wide.cuh) and p/g to B in
// {1, 2, 4, 8} rows by the wrapper; staged row vectors are zero-padded to a
// leading dimension that is a multiple of 4, so tiles load as 16-byte
// copies.  Rows past ni are zero-filled in shared memory and carry p = 0,
// so they add exactly zero.

#pragma once

#include "matvec.cuh"

namespace cglb {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;  // cp.async ring depth

// kernel 1 (LS = false) and kernel 2 (LS = true) tiles per coordinate width;
// at DP = 32 kernel 2 keeps one column a lane (two spill at 255 registers).
// DP = 12 (D 9-12) takes DP 8's tiles but for kernel 2's two columns a lane
// (four need 170 registers, one block an SM, and were no faster); a third
// resident block of kernel 1 (MinBlocks, 80 registers) gained 2 % with spills
template <int DP, bool LS>
struct Tile {
  static constexpr int kCols =
      DP == 8 ? 4 : DP == 12 ? (LS ? 2 : 4) : (LS ? 1 : 2);
  static constexpr int kRows = LS ? 1 : 2;
  static constexpr int kBlockCols = 32 * kCols;
  static constexpr int kStageRows = DP == 32 ? 64 : 128;
  static_assert(kStageRows % (kWarps * kRows) == 0, "rows per stage");
};

// __launch_bounds__ minimum of kernel 1's resident blocks per SM: three at
// DP 8, B 1 (80 registers); at B 2 the symmetric kernel would spill
template <int DP, int B>
struct MinBlocks {
  static constexpr int value = DP == 8 && B == 1 ? 3 : 1;
};

// Copies of the kT x DP coordinates of rows i0.., zero-filled past ni.
template <int DP, int kT>
__device__ __forceinline__ void load_coords(float* xs,
                                            const float* __restrict__ xr,
                                            int ni, int i0) {
  constexpr int kChunks = kT * DP / 4;
#pragma unroll
  for (int k0 = 0; k0 < kChunks; k0 += kThreads) {
    const int k = k0 + threadIdx.x;
    if (kChunks % kThreads == 0 || k < kChunks) {
      const bool ok = i0 + k * 4 / DP < ni;
      cp_async16(xs + k * 4, ok ? xr + (size_t)i0 * DP + k * 4 : xr, ok);
    }
  }
}

// Copies of B x kT values of the rows i0.. of v [B, ld], zero-filled past
// ld (v's padding up to ld is already zero).
template <int B, int kT>
__device__ __forceinline__ void load_vec(float* vs,
                                         const float* __restrict__ v, int ld,
                                         int i0) {
  constexpr int kChunks = B * kT / 4;
#pragma unroll
  for (int k0 = 0; k0 < kChunks; k0 += kThreads) {
    const int k = k0 + threadIdx.x;
    if (kChunks % kThreads == 0 || k < kChunks) {
      const int b = k / (kT / 4);
      const int i = i0 + (k - b * (kT / 4)) * 4;
      const bool ok = i < ld;
      cp_async16(vs + b * kT + (i - i0), ok ? v + (size_t)b * ld + i : v, ok);
    }
  }
}

// The columns of this lane: j = j0 + c * 32, zero past nj.
template <int DP, int kCols>
__device__ __forceinline__ void load_columns(float (&xj)[kCols][DP],
                                             const float* __restrict__ xc,
                                             int nj, int j0) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int j = j0 + c * 32;
#pragma unroll
    for (int d = 0; d < DP; d += 4) {
      const float4 v = j < nj ? __ldg(reinterpret_cast<const float4*>(
                                    xc + (size_t)j * DP + d))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      xj[c][d] = v.x;
      xj[c][d + 1] = v.y;
      xj[c][d + 2] = v.z;
      xj[c][d + 3] = v.w;
    }
  }
}

// v [B, ld] at the columns of this lane, zero past nj.
template <int B, int kCols>
__device__ __forceinline__ void load_column_values(
    float (&vj)[kCols][B], const float* __restrict__ v, int ld, int nj,
    int j0) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int j = j0 + c * 32;
#pragma unroll
    for (int b = 0; b < B; ++b) vj[c][b] = j < nj ? v[(size_t)b * ld + j] : 0.f;
  }
}

template <int DP>
__device__ __forceinline__ void load_row(float (&xi)[DP], const float* row) {
#pragma unroll
  for (int d = 0; d < DP; d += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + d);
    xi[d] = v.x;
    xi[d + 1] = v.y;
    xi[d + 2] = v.z;
    xi[d + 3] = v.w;
  }
}

// fixed-order butterfly: lane 0 always adds in the same order
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One staged tile (rows i0..) of kernel 1 against the lane's columns.
// SYM: the row side too, sum_j p[b, j] rho_ij over the block's columns,
// stored to rows_out[b * ld_rows + i] for rows below c0.  MASKED (symmetric
// tiles that reach c0): rows at or past c1 add nothing, and only rows below
// c0 store their row sums.
template <int FAM, int DP, int B, bool SYM, bool MASKED, int kC,
          int kR, int kT>
__device__ __forceinline__ void matvec_tile(
    const float* xt, const float* pt, const float (&xj)[kC][DP],
    const float (&pj)[kC][B], float (&run)[kC][B], int warp, int lane,
    int i0, int c0, int c1, float* __restrict__ rows_out, int ld_rows) {
#pragma unroll 2
  for (int r0 = warp * kR; r0 < kT; r0 += kWarps * kR) {
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      const int r = r0 + rr;
      const int i = i0 + r;
      float xi[DP];
      load_row<DP>(xi, xt + r * DP);
      float pi[B];
#pragma unroll
      for (int b = 0; b < B; ++b)
        pi[b] = (!MASKED || i < c1) ? pt[b * kT + r] : 0.0f;
      float v[B];
#pragma unroll
      for (int b = 0; b < B; ++b) v[b] = 0.0f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        float t = 0.0f;
#pragma unroll
        for (int d = 0; d < DP; ++d) {
          const float df = xi[d] - xj[c][d];
          t = fmaf(df, df, t);
        }
        const float rho = rho_f32<FAM>(t);
#pragma unroll
        for (int b = 0; b < B; ++b) {
          run[c][b] = fmaf(pi[b], rho, run[c][b]);
          if (SYM) v[b] = fmaf(pj[c][b], rho, v[b]);
        }
      }
      if (SYM && (!MASKED || i < c0)) {  // uniform across the warp
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const float s = warp_sum(v[b]);
          if (lane == 0) rows_out[(size_t)b * ld_rows + i] = s;
        }
      }
    }
  }
}

template <int FAM, int DP, int B, typename Acc, bool SYM>
__global__ void __launch_bounds__(kThreads, (MinBlocks<DP, B>::value))
matvec_kernel(const float* __restrict__ xr, int ni,
              const float* __restrict__ xc, int nj,
              const float* __restrict__ p, int ldp, int seg_rows,
              int row_end, int col_block0, Acc* __restrict__ out, int ldo,
              float* __restrict__ row_out) {
  using T = Tile<DP, false>;
  constexpr int kC = T::kCols, kR = T::kRows, kT = T::kStageRows;
  __shared__ __align__(16) float xs[kStages][kT * DP];
  __shared__ __align__(16) float ps[kStages][B * kT];
  __shared__ Acc red[kWarps * T::kBlockCols];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j_begin = col_block0 * T::kBlockCols;  // out's first column
  // the block's columns [c0, c1)
  const int c0 = j_begin + blockIdx.x * T::kBlockCols;
  const int c1 = min(c0 + T::kBlockCols, nj);
  const int i_begin = blockIdx.y * seg_rows;
  const int seg_end = min(i_begin + seg_rows, row_end);
  // symmetric: the rows at or past c1 are taken by their own column blocks
  const int i_end = SYM ? min(seg_end, c1) : seg_end;
  const int n_tiles = i_end > i_begin ? (i_end - i_begin + kT - 1) / kT : 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) {
      load_coords<DP, kT>(xs[s], xr, ni, i_begin + s * kT);
      load_vec<B, kT>(ps[s], p, ldp, i_begin + s * kT);
    }
    cp_async_commit();
  }

  float xj[kC][DP];
  load_columns<DP, kC>(xj, xc, nj, c0 + lane);
  float pj[kC][B];  // symmetric: p at the lane's columns, for the row side
  float* rows_out = nullptr;
  if (SYM) {
    load_column_values<B, kC>(pj, p, ldp, nj, c0 + lane);
    rows_out = row_out + (size_t)blockIdx.x * B * row_end;
    // this segment's rows from c0 on get no row sum from this block
    const int z0 = max(i_begin, c0);
    const int len = seg_end - z0;
    for (int k = threadIdx.x; k < B * len; k += kThreads) {
      const int b = k / len;
      rows_out[(size_t)b * row_end + z0 + (k - b * len)] = 0.0f;
    }
  }
  Acc acc[kC][B];
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int b = 0; b < B; ++b) acc[c][b] = Acc(0);

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this tile has landed; the previous buffer is free
    const int next = tile + kStages - 1;
    if (next < n_tiles) {
      load_coords<DP, kT>(xs[next % kStages], xr, ni, i_begin + next * kT);
      load_vec<B, kT>(ps[next % kStages], p, ldp, i_begin + next * kT);
    }
    cp_async_commit();

    const int i0 = i_begin + tile * kT;
    const float* xt = xs[tile % kStages];
    const float* pt = ps[tile % kStages];
    float run[kC][B];
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int b = 0; b < B; ++b) run[c][b] = 0.0f;
    if constexpr (SYM) {
      if (i0 + kT > c0)
        matvec_tile<FAM, DP, B, true, true, kC, kR, kT>(
            xt, pt, xj, pj, run, warp, lane, i0, c0, c1, rows_out, row_end);
      else
        matvec_tile<FAM, DP, B, true, false, kC, kR, kT>(
            xt, pt, xj, pj, run, warp, lane, i0, c0, c1, rows_out, row_end);
    } else {
      matvec_tile<FAM, DP, B, false, false, kC, kR, kT>(
          xt, pt, xj, pj, run, warp, lane, i0, c0, c1, rows_out, row_end);
    }
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int b = 0; b < B; ++b) acc[c][b] += static_cast<Acc>(run[c][b]);
  }

  // the block's 8 warps summed in a fixed order, one batch row at a time
#pragma unroll
  for (int b = 0; b < B; ++b) {
#pragma unroll
    for (int c = 0; c < kC; ++c)
      red[warp * T::kBlockCols + c * 32 + lane] = acc[c][b];
    __syncthreads();
    for (int k = threadIdx.x; k < T::kBlockCols; k += kThreads) {
      const int j = c0 + k;
      Acc s = red[k];
      for (int w = 1; w < kWarps; ++w) s += red[w * T::kBlockCols + k];
      if (j < nj)
        out[((size_t)blockIdx.y * B + b) * ldo + (j - j_begin)] = s;
    }
    __syncthreads();
  }
}

// One staged tile of kernel 2.  SYM: m_ij + m_ji for rows below c0, through
// g at the rows (gt) and p at the lane's columns (pj).  MASKED as in
// matvec_tile.
template <int FAM, int DP, int B, bool SYM, bool MASKED, int kC,
          int kR, int kT>
__device__ __forceinline__ void ls_grad_tile(
    const float* xt, const float* pt, const float* gt,
    const float (&xj)[kC][DP], const float (&gj)[kC][B],
    const float (&pj)[kC][B], float (&run)[DP], int warp, int i0, int c0,
    int c1) {
#pragma unroll 2
  for (int r0 = warp * kR; r0 < kT; r0 += kWarps * kR) {
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      const int r = r0 + rr;
      const int i = i0 + r;
      float xi[DP];
      load_row<DP>(xi, xt + r * DP);
      float pi[B], gi[B];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        pi[b] = (!MASKED || i < c1) ? pt[b * kT + r] : 0.0f;
        gi[b] = SYM && (!MASKED || i < c0) ? gt[b * kT + r] : 0.0f;
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        float sq[DP];  // (xi - xj)_d^2, shared by t and the sum
        float t = 0.0f;
#pragma unroll
        for (int d = 0; d < DP; ++d) {
          const float df = xi[d] - xj[c][d];
          sq[d] = df * df;
          t += sq[d];
        }
        float pg = 0.0f;
#pragma unroll
        for (int b = 0; b < B; ++b) {
          pg = fmaf(pi[b], gj[c][b], pg);
          if (SYM) pg = fmaf(gi[b], pj[c][b], pg);
        }
        const float m = pg * drho_unscaled_f32<FAM>(t);
#pragma unroll
        for (int d = 0; d < DP; ++d) run[d] = fmaf(m, sq[d], run[d]);
      }
    }
  }
}

template <int FAM, int DP, int B, bool SYM>
__global__ void __launch_bounds__(kThreads)
ls_grad_kernel(const float* __restrict__ xr, int ni,
               const float* __restrict__ xc, int nj,
               const float* __restrict__ p, int ldp,
               const float* __restrict__ g, int ldg, int seg_rows,
               double* __restrict__ partial) {
  using T = Tile<DP, true>;
  constexpr int kC = T::kCols, kR = T::kRows, kT = T::kStageRows;
  __shared__ __align__(16) float xs[kStages][kT * DP];
  __shared__ __align__(16) float ps[kStages][B * kT];
  __shared__ __align__(16) float gs[kStages][SYM ? B * kT : 4];
  __shared__ double red[kWarps * DP];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * T::kBlockCols;
  const int c1 = min(c0 + T::kBlockCols, nj);
  const int i_begin = blockIdx.y * seg_rows;
  const int seg_end = min(i_begin + seg_rows, ni);
  const int i_end = SYM ? min(seg_end, c1) : seg_end;
  const int n_tiles = i_end > i_begin ? (i_end - i_begin + kT - 1) / kT : 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) {
      load_coords<DP, kT>(xs[s], xr, ni, i_begin + s * kT);
      load_vec<B, kT>(ps[s], p, ldp, i_begin + s * kT);
      if (SYM) load_vec<B, kT>(gs[s], g, ldg, i_begin + s * kT);
    }
    cp_async_commit();
  }

  float xj[kC][DP];
  load_columns<DP, kC>(xj, xc, nj, c0 + lane);
  float gj[kC][B];  // zero for dead columns, so they add m = 0
  load_column_values<B, kC>(gj, g, ldg, nj, c0 + lane);
  float pj[kC][B];
  if (SYM) load_column_values<B, kC>(pj, p, ldp, nj, c0 + lane);
  double acc[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) acc[d] = 0.0;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = tile + kStages - 1;
    if (next < n_tiles) {
      load_coords<DP, kT>(xs[next % kStages], xr, ni, i_begin + next * kT);
      load_vec<B, kT>(ps[next % kStages], p, ldp, i_begin + next * kT);
      if (SYM)
        load_vec<B, kT>(gs[next % kStages], g, ldg, i_begin + next * kT);
    }
    cp_async_commit();

    const int i0 = i_begin + tile * kT;
    const float* xt = xs[tile % kStages];
    const float* pt = ps[tile % kStages];
    const float* gt = gs[tile % kStages];
    float run[DP];  // this tile's sum over the lane's rows and columns
#pragma unroll
    for (int d = 0; d < DP; ++d) run[d] = 0.0f;
    if constexpr (SYM) {
      if (i0 + kT > c0)
        ls_grad_tile<FAM, DP, B, true, true, kC, kR, kT>(
            xt, pt, gt, xj, gj, pj, run, warp, i0, c0, c1);
      else
        ls_grad_tile<FAM, DP, B, true, false, kC, kR, kT>(
            xt, pt, gt, xj, gj, pj, run, warp, i0, c0, c1);
    } else {
      ls_grad_tile<FAM, DP, B, false, false, kC, kR, kT>(
          xt, pt, gt, xj, gj, pj, run, warp, i0, c0, c1);
    }
#pragma unroll
    for (int d = 0; d < DP; ++d) acc[d] += static_cast<double>(run[d]);
  }

  // block sum per dimension in a fixed order: warp shuffles, then warps
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    double v = acc[d];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp * DP + d] = v;
  }
  __syncthreads();
  if (threadIdx.x < DP) {
    double s = red[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) s += red[w * DP + threadIdx.x];
    const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    partial[blk * DP + threadIdx.x] = drho_scale<FAM>() * s;
  }
}

template <typename T, typename Kernel>
int geometry(Kernel kernel, int* geo) {
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                    kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  geo[0] = T::kBlockCols;
  geo[1] = T::kStageRows;
  geo[2] = blocks;
  return 0;
}

// The row split must be the one the wrapper allocated partials for, and a
// symmetric launch needs one point set (and g staged like p).  Only kernel
// 1's symmetric path takes a part of the columns (a slab), and then the
// rows up to the end of its columns, which are all the rows its blocks
// take.
template <typename T>
bool bad_split(const Args& a) {
  const bool bad_sym =
      a.symmetric && (a.xr != a.xc || a.ni != a.nj ||
                      (a.ls_grad && a.ldg % 4 != 0));
  const bool whole = a.row_end == a.ni && a.col_block0 == 0 &&
                     (a.ls_grad || a.ldo == a.nj);
  const long long col_end = (long long)a.col_block0 * T::kBlockCols + a.ldo;
  const bool bad_slab = (!a.symmetric || a.ls_grad)
                            ? !whole
                            : (col_end > a.nj || a.row_end != col_end);
  return a.seg_rows <= 0 || a.seg_rows % T::kStageRows != 0 ||
         a.row_end <= 0 ||
         a.segments != (a.row_end + a.seg_rows - 1) / a.seg_rows ||
         a.ldp < a.ni || a.ldp % 4 != 0 || (a.ls_grad && a.ldg < a.nj) ||
         bad_sym || bad_slab;
}

template <int FAM, int DP, int B, bool SYM>
int run_sym(const Args& a, Op op) {
  using TM = Tile<DP, false>;
  using TL = Tile<DP, true>;
  if (op == kGeometry) {
    if (a.ls_grad)
      return geometry<TL>(ls_grad_kernel<FAM, DP, B, SYM>,
                          a.geometry);
    if (a.accurate)
      return geometry<TM>(
          matvec_kernel<FAM, DP, B, double, SYM>, a.geometry);
    return geometry<TM>(matvec_kernel<FAM, DP, B, float, SYM>,
                        a.geometry);
  }
  if (op == kLsGrad) {
    if (bad_split<TL>(a)) return kBadArgument;
    const dim3 grid((a.nj + TL::kBlockCols - 1) / TL::kBlockCols, a.segments);
    ls_grad_kernel<FAM, DP, B, SYM>
        <<<grid, kThreads, 0, a.stream>>>(a.xr, a.ni, a.xc, a.nj, a.p, a.ldp,
                                          a.g, a.ldg, a.seg_rows,
                                          static_cast<double*>(a.out));
  } else {
    if (bad_split<TM>(a)) return kBadArgument;
    const dim3 grid((a.ldo + TM::kBlockCols - 1) / TM::kBlockCols, a.segments);
    if (a.accurate)
      matvec_kernel<FAM, DP, B, double, SYM>
          <<<grid, kThreads, 0, a.stream>>>(
              a.xr, a.ni, a.xc, a.nj, a.p, a.ldp, a.seg_rows, a.row_end,
              a.col_block0, static_cast<double*>(a.out), a.ldo, a.row_out);
    else
      matvec_kernel<FAM, DP, B, float, SYM>
          <<<grid, kThreads, 0, a.stream>>>(
              a.xr, a.ni, a.xc, a.nj, a.p, a.ldp, a.seg_rows, a.row_end,
              a.col_block0, static_cast<float*>(a.out), a.ldo, a.row_out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int FAM, int DP, bool SYM>
int run_b(const Args& a, int b, Op op) {
  switch (b) {
    case 1: return run_sym<FAM, DP, 1, SYM>(a, op);
    case 2: return run_sym<FAM, DP, 2, SYM>(a, op);
    case 4: return run_sym<FAM, DP, 4, SYM>(a, op);
    case 8: return run_sym<FAM, DP, 8, SYM>(a, op);
    default: return kBadArgument;
  }
}

}  // namespace

template <int FAM, bool SYM>
int run_family(const Args& a, int dp, int b, Op op) {
  switch (dp) {
    case 8: return run_b<FAM, 8, SYM>(a, b, op);
    case 12: return run_b<FAM, 12, SYM>(a, b, op);
    case 32: return run_b<FAM, 32, SYM>(a, b, op);
    default: return kBadArgument;
  }
}

}  // namespace cglb
