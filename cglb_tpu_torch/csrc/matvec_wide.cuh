// Kernels 1 and 2 at any input dimension above 32: the "wide" kernels.
//
// They compute the functions of matvec_kernels.cuh (kernel 1 replaces
// cglb_tpu/ops/matvec_pallas.py::_matvec_kernel, kernel 2 ::_ls_grad_kernel;
// the JAX streaming matvec has no limit on D), on the symmetric path (one
// prepared point set: each unordered pair once) and on the general path (two
// sets), for coordinates zero-padded to a width DP that is a multiple of 8,
// given at run time.  The instantiations of matvec_kernels.cuh keep all of a
// lane's column coordinates in registers, which stops at DP 32; here the
// coordinates stream through shared memory in chunks instead.  This header
// is compiled once per kernel family (matvec_wide_<family>.cu).
//
// What bounds them on an H100: instruction issue, as for the narrow kernels.
// Per pair kernel 1 takes DP subtractions and DP FMAs for t by direct
// differences (no norm expansion: it would lose the small distances), two
// MUFU operations and two FP32 ones for the profile, and one FMA per batch
// row and side; kernel 2 adds one FMA per coordinate for the moment product
// below, so about 3 DP arithmetic instructions a pair where PR 6's design
// took 2 DP (DP / 32 + 1).  The inputs are N x DP floats, L2-resident.
//
// Design:
// - Register tiles.  A block owns kWBlock = 64 columns and walks its rows in
//   tiles of 64; each of its 256 threads holds 4 rows x 4 columns (16
//   pairs), so one staged 16-byte read of a point's coordinates serves 4
//   pairs and a coordinate costs two shared-memory reads per 16 pairs.
// - Chunks through a cp.async ring.  A tile's coordinates go through shared
//   memory in chunks of at most kWChunk = 32 (DP = 32 a + 8 r: chunks of 32,
//   then 16 and / or 8), rows and the block's columns point-major, filled by
//   cp.async ahead of the warps that consume them (one barrier per chunk;
//   each thread copies the same 16 bytes of two rows and two columns of
//   every chunk); p (and g) of a tile's rows come with its last chunk.  t
//   is whole after the tile's chunks, whatever DP is.  Kernel 1's ring has
//   kStages = 3 stages, kernel 2's kLsStages = 2: its m^T takes shared
//   memory too, and two stages leave room for 3 blocks an SM where three
//   allowed 2 (10 % faster in one call on the card; three stages were no
//   slower for kernel 1 at B 1 and faster at B 10, PERF.md).
// - Symmetric path as in matvec_kernels.cuh: column block [c0, c1) takes
//   rows i < c1 only.  Tiles and column blocks are both 64 wide and the
//   wrapper's row segments are whole tiles, so a tile lies either wholly
//   below c0 (both sides: kernel 1 adds the row sums sum_j p[b, j] rho_ij
//   over the block's columns, reduced over the 16 lanes that share the rows,
//   into [column blocks, B, rows] fp32 in slabs; kernel 2 takes m_ij + m_ji)
//   or on the diagonal block (the column side only).
// - Kernel 2 takes each pair's t and m once.  A tile makes two passes over
//   its chunks: the first sums t and forms m_ij = (sum_b p[b, i] g[b, j])
//   drho(t_ij), keeps m in shared memory with its row sums R and column sums
//   C; the second forms, per coordinate d, the TPU kernel's moment
//   expansion (matvec_pallas.py:201-211)
//       sum_ij m_ij (x_id - y_jd)^2
//         = sum_i x_id^2 R_i + sum_j y_jd^2 C_j - 2 sum_i x_id (m y)_id,
//   whose product m y ([64 x 64] @ [64 x chunk]) is register-tiled on the
//   CUDA cores, 2 rows x 4 coordinates a thread, in fp32.  The expansion
//   cancels where points lie far from the origin, so the second pass
//   shifts every coordinate by the block's first column (distances do not
//   change; the terms stay the size of the distances): its columns come
//   from a copy with each block's first point subtracted (xs, made by the
//   wrapper), its rows are shifted as they are read.  A +100 translation
//   of the data stays within the 1e-5 bound (tests/test_torch_cuda.py,
//   chip_smoke.py phase 15).  No tensor cores: 3xTF32 splits would cost
//   three products for the one fp32 product here, and a single TF32 pass
//   holds three decimal digits, not 1e-5.
// - No fp64 per pair.  Kernel 1 sums a thread's 4 rows in fp32 and promotes
//   that to the accumulator type once a tile; kernel 2 sums a chunk's
//   partials over the tile in fp32 (warp shuffles, then the 8 warps in
//   order) and adds them in fp64 per block.  Block sums go in a fixed order
//   and the wrapper adds the per-segment partials with a deterministic
//   torch.sum: no atomics, repeat launches are bitwise equal.
//
// Both write the layouts of matvec_kernels.cuh: kernel 1 [segments, B, ldo]
// (symmetric: row sums [launch's column blocks, B, row_end]), kernel 2
// [segments * column blocks, DP] fp64.  Dynamic shared memory: kernel 1 about
// 60 KB, kernel 2 about 60 KB + 12 DP bytes (DP up to about 13000).
// Registers a thread at B 1 / B 8 (ptxas -v, sm_90a, no spills): kernel 1
// symmetric 80 / 218 (accurate), 80 / 128 (CG tier), general 74 / 128 and
// 76 / 128; kernel 2 symmetric 70 / 166, general 66 / 122.  The SASS of
// the B 1 builds takes 278 instructions for 128 pair-coordinates in the t
// loop (2.17 a pair and coordinate) and 87 for 64 in kernel 2's moment
// loop (1.36): in these loops 2.17 DP instructions a pair for kernel 1 and
// 3.53 DP for kernel 2, beside each tile's profile and sums (chip_smoke.py
// phase 1, PERF.md).

#pragma once

#include "matvec_kernels.cuh"

namespace cglb {
namespace {

constexpr int kWBlock = 64;               // columns a block, rows a tile
constexpr int kWChunk = 32;               // coordinates a staged chunk, at most
constexpr int kWStride = kWChunk + 4;     // floats a staged point: 16-byte
                                          // reads of lanes 0-7 hit 8 banks
constexpr int kMStride = kWBlock + 4;     // floats a column of staged m^T
constexpr int kLsStages = 2;              // kernel 2's ring: 3 blocks an SM

struct WideTile {
  static constexpr int kBlockCols = kWBlock;
  static constexpr int kStageRows = kWBlock;
};

// Floats of one ring stage: a chunk of the tile's rows and of the block's
// columns, point-major, then p (and g) of the tile's rows.
template <int B, int NVEC>
__host__ __device__ constexpr int stage_floats() {
  return 2 * kWBlock * kWStride + NVEC * B * kWBlock;
}

// Kernel 2's shared memory after the ring: m^T, R, C per warp, the chunk's
// per-warp partials, the shift point (DP floats), then the block's fp64
// partials (DP doubles).
template <int B, bool SYM>
struct LsLayout {
  static constexpr int kStage = stage_floats<B, SYM ? 2 : 1>();
  static constexpr int kMs = kLsStages * kStage;
  static constexpr int kR = kMs + kWBlock * kMStride;
  static constexpr int kC = kR + kWBlock;
  static constexpr int kRed = kC + kWarps * kWBlock;
  static constexpr int kShift = kRed + kWarps * kWChunk;
  __host__ __device__ static int acc_offset(int dp) {  // floats, 8-aligned
    return kShift + ((dp + 1) & ~1);
  }
  __host__ __device__ static size_t bytes(int dp) {
    return sizeof(float) * acc_offset(dp) + sizeof(double) * dp;
  }
};

// The chunks of a DP-wide point: 32 coordinates each, then 16 and / or 8.
__host__ __device__ __forceinline__ int n_chunks(int dp) {
  const int rem = dp & (kWChunk - 1);
  return dp / kWChunk + (rem >= 16) + ((rem & 8) != 0);
}

__device__ __forceinline__ void chunk_of(int c, int dp, int& d0, int& w) {
  const int full = dp / kWChunk;
  if (c < full) {
    d0 = c * kWChunk;
    w = kWChunk;
    return;
  }
  d0 = full * kWChunk;
  if ((dp & (kWChunk - 1)) >= 16) {
    if (c == full) {
      w = 16;
      return;
    }
    d0 += 16;
  }
  w = 8;
}

// Position in the flat sequence of stages: tile, pass (kernel 2: 0 the t
// pass, 1 the moment pass), chunk.
struct Cursor {
  int tile = 0, pass = 0, chunk = 0;
  __device__ __forceinline__ void advance(int nc, int passes) {
    if (++chunk == nc) {
      chunk = 0;
      if (++pass == passes) {
        pass = 0;
        ++tile;
      }
    }
  }
};

// Copies of one stage: coordinates [d0, d0 + w) of the tile's rows i0.. and
// of the block's columns c0.., zero past ni / nj, and with the tile's last
// t-pass chunk p (and g) at the tile's rows, zero past their leading
// dimension.
template <int B, int NVEC>
__device__ __forceinline__ void stage_wide(
    float* st, const float* __restrict__ xr, int ni, int i0,
    const float* __restrict__ xc, int nj, int c0, int dp, int d0, int w,
    const float* __restrict__ p, int ldp, const float* __restrict__ g,
    int ldg, bool vectors) {
  // the thread's 16 bytes: points r and r + 32, coordinates c4 .. c4 + 3
  const int r = threadIdx.x >> 3, c4 = (threadIdx.x & 7) * 4;
  static_assert(kThreads == 8 * kWBlock / 2 && kWChunk == 32, "copy slots");
  if (c4 < w) {
    float* rs = st + r * kWStride + c4;
    float* cs = rs + kWBlock * kWStride;
    const float* xi = xr + (size_t)(i0 + r) * dp + d0 + c4;
    const float* xj = xc + (size_t)(c0 + r) * dp + d0 + c4;
    const size_t half = (size_t)(kWBlock / 2) * dp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + r + h * (kWBlock / 2), j = c0 + r + h * (kWBlock / 2);
      cp_async16(rs + h * (kWBlock / 2) * kWStride, i < ni ? xi + h * half : xr,
                 i < ni);
      cp_async16(cs + h * (kWBlock / 2) * kWStride, j < nj ? xj + h * half : xc,
                 j < nj);
    }
  }
  if (NVEC > 0 && vectors) {
    float* ps = st + 2 * kWBlock * kWStride;
    load_vec<B, kWBlock>(ps, p, ldp, i0);
    if (NVEC > 1) load_vec<B, kWBlock>(ps + B * kWBlock, g, ldg, i0);
  }
}

// t[k][c] += the staged chunk's sum_d (x_row - x_col)^2 for the thread's
// rows 4 ty + k and columns tx + 16 c.
__device__ __forceinline__ void add_t(const float* st, int w, int tx, int ty,
                                      float (&t)[4][4]) {
  const float* rp = st + 4 * ty * kWStride;
  const float* cp = st + kWBlock * kWStride + tx * kWStride;
  for (int d = 0; d < w; d += 8) {
#pragma unroll
    for (int h = 0; h < 8; h += 4) {
      float4 y[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        y[c] = *reinterpret_cast<const float4*>(cp + 16 * c * kWStride + d +
                                                h);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 x =
            *reinterpret_cast<const float4*>(rp + k * kWStride + d + h);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float df = x.x - y[c].x;
          t[k][c] = fmaf(df, df, t[k][c]);
          df = x.y - y[c].y;
          t[k][c] = fmaf(df, df, t[k][c]);
          df = x.z - y[c].z;
          t[k][c] = fmaf(df, df, t[k][c]);
          df = x.w - y[c].w;
          t[k][c] = fmaf(df, df, t[k][c]);
        }
      }
    }
  }
}

// sum over the 16 lanes that share a thread's rows (fixed-order butterfly)
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// v [B, ld] at the thread's columns j = c0 + tx + 16 c, zero past nj.
template <int B>
__device__ __forceinline__ void wide_column_values(
    float (&vj)[4][B], const float* __restrict__ v, int ld, int nj, int j0) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = j0 + 16 * c;
#pragma unroll
    for (int b = 0; b < B; ++b) vj[c][b] = j < nj ? v[(size_t)b * ld + j] : 0.f;
  }
}

// v [B, 64] staged at the thread's rows 4 ty .. 4 ty + 3.
template <int B>
__device__ __forceinline__ void wide_row_values(float (&vi)[B][4],
                                                const float* vs, int ty) {
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const float4 v = *reinterpret_cast<const float4*>(vs + b * kWBlock +
                                                      4 * ty);
    vi[b][0] = v.x;
    vi[b][1] = v.y;
    vi[b][2] = v.z;
    vi[b][3] = v.w;
  }
}

template <int FAM, int B, typename Acc, bool SYM>
__global__ void __launch_bounds__(kThreads)
matvec_wide_kernel(const float* __restrict__ xr, int ni,
                   const float* __restrict__ xc, int nj,
                   const float* __restrict__ p, int ldp, int dp,
                   int seg_rows, int row_end, int col_block0,
                   Acc* __restrict__ out, int ldo,
                   float* __restrict__ row_out) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStage = stage_floats<B, 1>();
  Acc* red = reinterpret_cast<Acc*>(smem + kStages * kStage);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tx = lane & 15;               // columns tx + 16 c
  const int ty = 2 * warp + (lane >> 4);  // rows 4 ty + k
  const int j_begin = col_block0 * kWBlock;
  const int c0 = j_begin + blockIdx.x * kWBlock;
  const int c1 = min(c0 + kWBlock, nj);
  const int i_begin = blockIdx.y * seg_rows;
  const int seg_end = min(i_begin + seg_rows, row_end);
  const int i_end = SYM ? min(seg_end, c1) : seg_end;
  const int n_tiles =
      i_end > i_begin ? (i_end - i_begin + kWBlock - 1) / kWBlock : 0;
  const int nc = n_chunks(dp);
  const int n_st = n_tiles * nc;

  Cursor issue;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_st) {
      int d0, w;
      chunk_of(issue.chunk, dp, d0, w);
      stage_wide<B, 1>(smem + s * kStage, xr, ni,
                       i_begin + issue.tile * kWBlock, xc, nj, c0, dp, d0, w,
                       p, ldp, nullptr, 0, issue.chunk == nc - 1);
    }
    cp_async_commit();
    issue.advance(nc, 1);
  }

  float pj[4][B];  // symmetric: p at the thread's columns, for the row side
  float* rows_out = nullptr;
  if (SYM) {
    wide_column_values<B>(pj, p, ldp, nj, c0 + tx);
    rows_out = row_out + (size_t)blockIdx.x * B * row_end;
    // this segment's rows from c0 on get no row sum from this block
    const int z0 = max(i_begin, c0);
    const int len = seg_end - z0;
    for (int k = threadIdx.x; k < B * len; k += kThreads) {
      const int b = k / len;
      rows_out[(size_t)b * row_end + z0 + (k - b * len)] = 0.0f;
    }
  }
  Acc acc[4][B];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int b = 0; b < B; ++b) acc[c][b] = Acc(0);
  float t[4][4];

  Cursor cur;
  for (int k = 0; k < n_st; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this stage has landed; the previous one is free
    if (k + kStages - 1 < n_st) {
      int d0, w;
      chunk_of(issue.chunk, dp, d0, w);
      stage_wide<B, 1>(smem + ((k + kStages - 1) % kStages) * kStage, xr, ni,
                       i_begin + issue.tile * kWBlock, xc, nj, c0, dp, d0, w,
                       p, ldp, nullptr, 0, issue.chunk == nc - 1);
    }
    cp_async_commit();
    issue.advance(nc, 1);

    const float* st = smem + (k % kStages) * kStage;
    int d0, w;
    chunk_of(cur.chunk, dp, d0, w);
    if (cur.chunk == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) t[r][c] = 0.0f;
    }
    add_t(st, w, tx, ty, t);
    if (cur.chunk == nc - 1) {  // t is whole: the tile's profile and sums
      const int i0 = i_begin + cur.tile * kWBlock;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) t[r][c] = rho_f32<FAM>(t[r][c]);
      float pi[B][4];
      wide_row_values<B>(pi, st + 2 * kWBlock * kWStride, ty);
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int b = 0; b < B; ++b) {
          float s = 0.0f;
#pragma unroll
          for (int r = 0; r < 4; ++r) s = fmaf(pi[b][r], t[r][c], s);
          acc[c][b] += static_cast<Acc>(s);
        }
      if (SYM && i0 < c0) {  // a tile below the diagonal: the row side
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int b = 0; b < B; ++b) {
            float v = 0.0f;
#pragma unroll
            for (int c = 0; c < 4; ++c) v = fmaf(pj[c][b], t[r][c], v);
            v = sum16(v);
            if (tx == 0) rows_out[(size_t)b * row_end + i0 + 4 * ty + r] = v;
          }
      }
    }
    cur.advance(nc, 1);
  }

  // the block's 16 row groups summed in a fixed order, one batch row at a
  // time: the warp's two, then the 8 warps
#pragma unroll
  for (int b = 0; b < B; ++b) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      Acc v = acc[c][b];
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 16) red[warp * kWBlock + tx + 16 * c] = v;
    }
    __syncthreads();
    if (threadIdx.x < kWBlock) {
      Acc s = red[threadIdx.x];
      for (int w = 1; w < kWarps; ++w) s += red[w * kWBlock + threadIdx.x];
      const int j = c0 + threadIdx.x;
      if (j < nj)
        out[((size_t)blockIdx.y * B + b) * ldo + (j - j_begin)] = s;
    }
    __syncthreads();
  }
}

// The moment pass of kernel 2 on one staged chunk of W coordinates (its
// columns staged shifted): per coordinate d of the chunk, this thread's
// share of sum_i x_id^2 R_i + sum_j y_jd^2 C_j - 2 sum_ij x_id m_ij y_jd,
// shifted, summed over the warp's threads of the same coordinates into
// red[warp][d].  Thread: 2 rows x 4 coordinates x 64 / JS columns.
template <int W>
__device__ __forceinline__ void moment_pass(const float* st, const float* ms,
                                            const float* Rs, const float* Cw,
                                            const float* shift, float* red,
                                            int lane, int warp) {
  constexpr int Q = W / 4;       // coordinate quads
  constexpr int JS = 8 / Q;      // column splits
  constexpr int NJ = kWBlock / JS;
  const int dq = threadIdx.x % Q;
  const int slot = threadIdx.x / Q;
  const int rp = slot & 31, js = slot >> 5;
  const float* rs = st;
  const float* cs = st + kWBlock * kWStride;

  float u[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) u[r][e] = 0.0f;
  const float* mcol = ms + js * NJ * kMStride + 2 * rp;
  const float* ycol = cs + js * NJ * kWStride + 4 * dq;
#pragma unroll 8
  for (int j = 0; j < NJ; ++j) {
    const float2 m = *reinterpret_cast<const float2*>(mcol + j * kMStride);
    const float4 y = *reinterpret_cast<const float4*>(ycol + j * kWStride);
    u[0][0] = fmaf(m.x, y.x, u[0][0]);
    u[0][1] = fmaf(m.x, y.y, u[0][1]);
    u[0][2] = fmaf(m.x, y.z, u[0][2]);
    u[0][3] = fmaf(m.x, y.w, u[0][3]);
    u[1][0] = fmaf(m.y, y.x, u[1][0]);
    u[1][1] = fmaf(m.y, y.y, u[1][1]);
    u[1][2] = fmaf(m.y, y.z, u[1][2]);
    u[1][3] = fmaf(m.y, y.w, u[1][3]);
  }
  const float4 s = *reinterpret_cast<const float4*>(shift + 4 * dq);
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = 2 * rp + r;
    const float4 x4 = *reinterpret_cast<const float4*>(rs + i * kWStride +
                                                       4 * dq);
    const float R = js == 0 ? Rs[i] : 0.0f;
    const float x[4] = {x4.x - s.x, x4.y - s.y, x4.z - s.z, x4.w - s.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = fmaf(x[e], fmaf(x[e], R, -2.0f * u[r][e]), v[e]);
  }
  if (js == 0) {  // the columns 2 rp, 2 rp + 1: sum_j y_jd^2 C_j
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = 2 * rp + r;
      float C = Cw[j];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) C += Cw[w * kWBlock + j];
      const float4 y = *reinterpret_cast<const float4*>(cs + j * kWStride +
                                                        4 * dq);
      v[0] = fmaf(y.x * y.x, C, v[0]);
      v[1] = fmaf(y.y * y.y, C, v[1]);
      v[2] = fmaf(y.z * y.z, C, v[2]);
      v[3] = fmaf(y.w * y.w, C, v[3]);
    }
  }
  // the warp's threads of this coordinate quad: lanes dq, dq + Q, ...
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int off = Q; off < 32; off <<= 1)
      v[e] += __shfl_xor_sync(0xffffffffu, v[e], off);
  }
  if (lane < Q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp * kWChunk + 4 * dq + e] = v[e];
  }
}

template <int FAM, int B, bool SYM>
__global__ void __launch_bounds__(kThreads)
ls_grad_wide_kernel(const float* __restrict__ xr, int ni,
                    const float* __restrict__ xc, int nj,
                    const float* __restrict__ xs,
                    const float* __restrict__ p, int ldp,
                    const float* __restrict__ g, int ldg, int dp,
                    int seg_rows, double* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  using L = LsLayout<B, SYM>;
  constexpr int kNvec = SYM ? 2 : 1;
  float* ms = smem + L::kMs;
  float* Rs = smem + L::kR;
  float* Cw = smem + L::kC;
  float* red = smem + L::kRed;
  float* shift = smem + L::kShift;
  double* acc = reinterpret_cast<double*>(smem + L::acc_offset(dp));

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tx = lane & 15;
  const int ty = 2 * warp + (lane >> 4);
  const int c0 = blockIdx.x * kWBlock;
  const int c1 = min(c0 + kWBlock, nj);
  const int i_begin = blockIdx.y * seg_rows;
  const int seg_end = min(i_begin + seg_rows, ni);
  const int i_end = SYM ? min(seg_end, c1) : seg_end;
  const int n_tiles =
      i_end > i_begin ? (i_end - i_begin + kWBlock - 1) / kWBlock : 0;
  const int nc = n_chunks(dp);
  const int n_st = n_tiles * 2 * nc;
  const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;

  Cursor issue;
#pragma unroll
  for (int s = 0; s < kLsStages - 1; ++s) {
    if (s < n_st) {
      int d0, w;
      chunk_of(issue.chunk, dp, d0, w);
      stage_wide<B, kNvec>(smem + s * L::kStage, xr, ni,
                           i_begin + issue.tile * kWBlock,
                           issue.pass == 0 ? xc : xs, nj, c0, dp, d0, w, p,
                           ldp, g, ldg,
                           issue.pass == 0 && issue.chunk == nc - 1);
    }
    cp_async_commit();
    issue.advance(nc, 2);
  }

  // the block's shift point (its first column) and its fp64 partials
  for (int d = threadIdx.x; d < dp; d += kThreads) {
    shift[d] = xc[(size_t)c0 * dp + d];
    acc[d] = 0.0;
  }
  float gj[4][B];  // zero for dead columns, so they add m = 0
  wide_column_values<B>(gj, g, ldg, nj, c0 + tx);
  float pj[4][B];
  if (SYM) wide_column_values<B>(pj, p, ldp, nj, c0 + tx);
  float t[4][4];
  int pend_d0 = 0, pend_w = 0;  // the chunk whose partials red holds

  Cursor cur;
  for (int k = 0; k < n_st; ++k) {
    cp_async_wait<kLsStages - 2>();
    __syncthreads();  // this stage has landed; the previous one is free
    if (pend_w > 0 && warp == 0 && lane < pend_w) {
      float s = red[lane];
      for (int w = 1; w < kWarps; ++w) s += red[w * kWChunk + lane];
      acc[pend_d0 + lane] += static_cast<double>(s);
    }
    pend_w = 0;
    if (k + kLsStages - 1 < n_st) {
      int d0, w;
      chunk_of(issue.chunk, dp, d0, w);
      stage_wide<B, kNvec>(smem + ((k + kLsStages - 1) % kLsStages) * L::kStage,
                           xr, ni, i_begin + issue.tile * kWBlock,
                           issue.pass == 0 ? xc : xs, nj, c0, dp, d0, w, p,
                           ldp, g, ldg,
                           issue.pass == 0 && issue.chunk == nc - 1);
    }
    cp_async_commit();
    issue.advance(nc, 2);

    const float* st = smem + (k % kLsStages) * L::kStage;
    int d0, w;
    chunk_of(cur.chunk, dp, d0, w);
    const int i0 = i_begin + cur.tile * kWBlock;
    if (cur.pass == 0) {
      if (cur.chunk == 0) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) t[r][c] = 0.0f;
      }
      add_t(st, w, tx, ty, t);
      if (cur.chunk == nc - 1) {  // t is whole: m, its sums, m^T staged
        const bool both = SYM && i0 < c0;  // a tile below the diagonal
        const float* vs = st + 2 * kWBlock * kWStride;
        float pi[B][4], gi[B][4];
        wide_row_values<B>(pi, vs, ty);
        if (SYM) wide_row_values<B>(gi, vs + B * kWBlock, ty);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float pg = 0.0f;
#pragma unroll
            for (int b = 0; b < B; ++b) {
              pg = fmaf(pi[b][r], gj[c][b], pg);
              if (SYM) pg = fmaf(both ? gi[b][r] : 0.0f, pj[c][b], pg);
            }
            t[r][c] = pg * drho_unscaled_f32<FAM>(t[r][c]);  // now m
          }
#pragma unroll
        for (int c = 0; c < 4; ++c)
          *reinterpret_cast<float4*>(ms + (tx + 16 * c) * kMStride +
                                     4 * ty) =
              make_float4(t[0][c], t[1][c], t[2][c], t[3][c]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float v = sum16(t[r][0] + t[r][1] + t[r][2] + t[r][3]);
          if (tx == 0) Rs[4 * ty + r] = v;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float v = t[0][c] + t[1][c] + t[2][c] + t[3][c];
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (lane < 16) Cw[warp * kWBlock + tx + 16 * c] = v;
        }
      }
    } else {  // the moment pass: the chunk's columns come shifted
      if (w == kWChunk)
        moment_pass<kWChunk>(st, ms, Rs, Cw, shift + d0, red, lane, warp);
      else if (w == 16)
        moment_pass<16>(st, ms, Rs, Cw, shift + d0, red, lane, warp);
      else
        moment_pass<8>(st, ms, Rs, Cw, shift + d0, red, lane, warp);
      pend_d0 = d0;
      pend_w = w;
    }
    cur.advance(nc, 2);
  }

  __syncthreads();
  if (pend_w > 0 && warp == 0 && lane < pend_w) {
    float s = red[lane];
    for (int w = 1; w < kWarps; ++w) s += red[w * kWChunk + lane];
    acc[pend_d0 + lane] += static_cast<double>(s);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < dp; d += kThreads)
    partial[blk * dp + d] = drho_scale<FAM>() * acc[d];
}

// Dynamic shared memory of kernel 1: the ring, then the block's sums.
template <int B, typename Acc>
constexpr size_t matvec_smem() {
  return sizeof(float) * kStages * stage_floats<B, 1>() +
         sizeof(Acc) * kWarps * kWBlock;
}

// Lets the kernel take smem bytes of dynamic shared memory (above 48 KB
// only when asked); with geo, its geometry for cglb_matvec_geometry.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem, int* geo = nullptr) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess || geo == nullptr) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  geo[0] = kWBlock;
  geo[1] = kWBlock;
  geo[2] = blocks;
  return 0;
}

template <int FAM, int B, typename Acc, bool SYM>
int launch_matvec_wide(const Args& a, int dp, Op op) {
  const auto kernel = matvec_wide_kernel<FAM, B, Acc, SYM>;
  constexpr size_t smem = matvec_smem<B, Acc>();
  if (op == kGeometry) return allow_smem(kernel, smem, a.geometry);
  if (const int err = allow_smem(kernel, smem)) return err;
  const dim3 grid((a.ldo + kWBlock - 1) / kWBlock, a.segments);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      a.xr, a.ni, a.xc, a.nj, a.p, a.ldp, dp, a.seg_rows, a.row_end,
      a.col_block0, static_cast<Acc*>(a.out), a.ldo, a.row_out);
  return static_cast<int>(cudaGetLastError());
}

template <int FAM, int B, bool SYM>
int launch_ls_grad_wide(const Args& a, int dp, Op op) {
  const auto kernel = ls_grad_wide_kernel<FAM, B, SYM>;
  const size_t smem = LsLayout<B, SYM>::bytes(dp);
  if (op == kGeometry) return allow_smem(kernel, smem, a.geometry);
  if (const int err = allow_smem(kernel, smem)) return err;
  const dim3 grid((a.nj + kWBlock - 1) / kWBlock, a.segments);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      a.xr, a.ni, a.xc, a.nj, a.xs, a.p, a.ldp, a.g, a.ldg, dp, a.seg_rows,
      static_cast<double*>(a.out));
  return static_cast<int>(cudaGetLastError());
}

template <int FAM, int B, bool SYM>
int run_wide_sym(const Args& a, int dp, Op op) {
  if (op != kGeometry && bad_split<WideTile>(a)) return kBadArgument;
  if (a.ls_grad) return launch_ls_grad_wide<FAM, B, SYM>(a, dp, op);
  if (a.accurate) return launch_matvec_wide<FAM, B, double, SYM>(a, dp, op);
  return launch_matvec_wide<FAM, B, float, SYM>(a, dp, op);
}

template <int FAM, int B>
int run_wide_b(const Args& a, int dp, Op op) {
  return a.symmetric ? run_wide_sym<FAM, B, true>(a, dp, op)
                     : run_wide_sym<FAM, B, false>(a, dp, op);
}

}  // namespace

template <int FAM>
int run_wide(const Args& a, int dp, int b, Op op) {
  if (dp <= 32 || dp % 8 != 0) return kBadArgument;
  switch (b) {
    case 1: return run_wide_b<FAM, 1>(a, dp, op);
    case 2: return run_wide_b<FAM, 2>(a, dp, op);
    case 4: return run_wide_b<FAM, 4>(a, dp, op);
    case 8: return run_wide_b<FAM, 8>(a, dp, op);
    default: return kBadArgument;
  }
}

}  // namespace cglb
