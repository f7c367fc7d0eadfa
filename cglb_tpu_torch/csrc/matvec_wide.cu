// Kernels 1 and 2 at any input dimension above 32: the "wide" kernels.
//
// They compute the functions of matvec_kernels.cuh (kernel 1 replaces
// cglb_tpu/ops/matvec_pallas.py::_matvec_kernel, kernel 2 ::_ls_grad_kernel;
// the JAX streaming matvec has no limit on D) on the general path, for
// coordinates zero-padded to a width DP that is a multiple of kChunk, given
// at run time.  The instantiations of matvec_kernels.cuh keep all of a
// lane's column coordinates in registers, which stops at DP 32; here a block
// loops over the coordinates in chunks of kChunk instead:
//
// - A block owns 32 columns (one a lane) and walks its row segment in tiles
//   of kRowsTile rows, each warp taking kRowsWarp of them.  For every chunk
//   the tile's rows and the block's columns are staged in shared memory
//   (plain loads, then one barrier) and each thread adds the chunk's squared
//   differences to the t of its kRowsWarp pairs, so t is whole before the
//   profile, whatever D is.
// - Kernel 1 then applies rho and sums p[b, i] rho in fp32 over the tile,
//   promoted to the accumulator type once a tile, as in matvec_kernels.cuh.
// - Kernel 2 needs a partial per coordinate, and D has no bound: it sums one
//   chunk of coordinates per pass over the rows, and each pass recomputes t
//   (over all chunks), the pair's weight m, and then m * (xr_i - xc_j)_d^2
//   for its own chunk, in fp32 a tile and fp64 across tiles.  So the
//   distance work grows as D^2 / kChunk: simple, not fast.
// - Block sums go in a fixed order (warps in order, fp64 butterflies), and
//   the wrapper adds the per-segment partials with a deterministic
//   torch.sum: no atomics, repeat launches are bitwise equal.
//
// Both write the layouts of matvec_kernels.cuh's general path: kernel 1
// [segments, B, nj], kernel 2 [segments * column blocks, DP] fp64.  The
// symmetric path (each unordered pair once) is not taken above DP 32: the
// wrapper sends K(X, X) to the general path, which takes every ordered pair.
//
// What bounds them on an H100: instruction issue, as for the narrow
// kernels: per pair and coordinate one subtraction and one FMA (kernel 1),
// plus a quarter of a shared-memory broadcast read; kernel 2 does that
// DP / kChunk + 1 times over.

#include "matvec_kernels.cuh"

namespace cglb {
namespace {

constexpr int kChunk = 32;                           // coordinates a pass
constexpr int kWideCols = 32;                        // columns per block
constexpr int kRowsTile = 64;                        // rows per staged tile
constexpr int kRowsWarp = kRowsTile / kWarps;        // rows per warp a tile

struct WideTile {
  static constexpr int kBlockCols = kWideCols;
  static constexpr int kStageRows = kRowsTile;
};

struct Staged {
  float rows[kRowsTile * kChunk];     // tile rows x chunk, 16-byte aligned
  float cols[kWideCols][kChunk + 1];  // padded: lane c reads row c
};

// Coordinates [d0, d0 + kChunk) of the rows i0.. and of the block's columns
// c0.., zero past ni / nj, into s; ends with a barrier.
__device__ __forceinline__ void stage_chunk(Staged& s,
                                            const float* __restrict__ xr,
                                            int ni, int i0,
                                            const float* __restrict__ xc,
                                            int nj, int c0, int dp, int d0) {
  constexpr int kQuads = kChunk / 4;
  for (int k = threadIdx.x; k < kRowsTile * kQuads; k += kThreads) {
    const int r = k / kQuads, q = k - r * kQuads;
    const int i = i0 + r;
    const float4 v = i < ni ? __ldg(reinterpret_cast<const float4*>(
                                  xr + (size_t)i * dp + d0) + q)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<float4*>(s.rows + r * kChunk)[q] = v;
  }
  for (int k = threadIdx.x; k < kWideCols * kQuads; k += kThreads) {
    const int c = k / kQuads, q = k - c * kQuads;
    const int j = c0 + c;
    const float4 v = j < nj ? __ldg(reinterpret_cast<const float4*>(
                                  xc + (size_t)j * dp + d0) + q)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    s.cols[c][4 * q] = v.x;
    s.cols[c][4 * q + 1] = v.y;
    s.cols[c][4 * q + 2] = v.z;
    s.cols[c][4 * q + 3] = v.w;
  }
  __syncthreads();
}

// The lane's column coordinates of the staged chunk.
__device__ __forceinline__ void column_chunk(float (&xj)[kChunk],
                                             const Staged& s, int lane) {
#pragma unroll
  for (int d = 0; d < kChunk; ++d) xj[d] = s.cols[lane][d];
}

// t[k] += the staged chunk's sum_d (x_row - x_col)^2 for the warp's rows k
// against the lane's column.
__device__ __forceinline__ void add_chunk_t(const Staged& s, int warp,
                                            int lane,
                                            float (&t)[kRowsWarp]) {
  float xj[kChunk];
  column_chunk(xj, s, lane);
#pragma unroll
  for (int k = 0; k < kRowsWarp; ++k) {
    const float* row = s.rows + (warp * kRowsWarp + k) * kChunk;
#pragma unroll
    for (int d = 0; d < kChunk; d += 4) {
      const float4 v = *reinterpret_cast<const float4*>(row + d);
      float df = v.x - xj[d];
      t[k] = fmaf(df, df, t[k]);
      df = v.y - xj[d + 1];
      t[k] = fmaf(df, df, t[k]);
      df = v.z - xj[d + 2];
      t[k] = fmaf(df, df, t[k]);
      df = v.w - xj[d + 3];
      t[k] = fmaf(df, df, t[k]);
    }
  }
}

// t of the warp's rows of the tile at i0 against the lane's column, over
// every chunk; the tile's last chunk (dp - kChunk) stays staged in s.
__device__ __forceinline__ void tile_t(Staged& s, const float* xr, int ni,
                                       int i0, const float* xc, int nj,
                                       int c0, int dp, int warp, int lane,
                                       float (&t)[kRowsWarp]) {
#pragma unroll
  for (int k = 0; k < kRowsWarp; ++k) t[k] = 0.0f;
  for (int d0 = 0; d0 < dp; d0 += kChunk) {
    __syncthreads();  // every warp is done with what s holds
    stage_chunk(s, xr, ni, i0, xc, nj, c0, dp, d0);
    add_chunk_t(s, warp, lane, t);
  }
}

template <int FAM, int B, typename Acc>
__global__ void __launch_bounds__(kThreads)
matvec_wide_kernel(const float* __restrict__ xr, int ni,
                   const float* __restrict__ xc, int nj,
                   const float* __restrict__ p, int ldp, int dp,
                   int seg_rows, Acc* __restrict__ out, int ldo) {
  __shared__ __align__(16) Staged s;
  __shared__ Acc red[kWarps * kWideCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kWideCols;
  const int i_begin = blockIdx.y * seg_rows;
  const int i_end = min(i_begin + seg_rows, ni);

  Acc acc[B];
#pragma unroll
  for (int b = 0; b < B; ++b) acc[b] = Acc(0);
  for (int i0 = i_begin; i0 < i_end; i0 += kRowsTile) {
    float t[kRowsWarp];
    tile_t(s, xr, ni, i0, xc, nj, c0, dp, warp, lane, t);
    float run[B];
#pragma unroll
    for (int b = 0; b < B; ++b) run[b] = 0.0f;
#pragma unroll
    for (int k = 0; k < kRowsWarp; ++k) {
      const int i = i0 + warp * kRowsWarp + k;
      const float rho = rho_f32<FAM>(t[k]);
#pragma unroll
      for (int b = 0; b < B; ++b)
        run[b] = fmaf(i < ni ? __ldg(p + (size_t)b * ldp + i) : 0.0f, rho,
                      run[b]);
    }
#pragma unroll
    for (int b = 0; b < B; ++b) acc[b] += static_cast<Acc>(run[b]);
  }

  // the block's 8 warps summed in a fixed order, one batch row at a time
#pragma unroll
  for (int b = 0; b < B; ++b) {
    red[warp * kWideCols + lane] = acc[b];
    __syncthreads();
    if (threadIdx.x < kWideCols) {
      Acc sum = red[threadIdx.x];
      for (int w = 1; w < kWarps; ++w) sum += red[w * kWideCols + threadIdx.x];
      const int j = c0 + threadIdx.x;
      if (j < nj) out[((size_t)blockIdx.y * B + b) * ldo + j] = sum;
    }
    __syncthreads();
  }
}

template <int FAM, int B>
__global__ void __launch_bounds__(kThreads)
ls_grad_wide_kernel(const float* __restrict__ xr, int ni,
                    const float* __restrict__ xc, int nj,
                    const float* __restrict__ p, int ldp,
                    const float* __restrict__ g, int ldg, int dp,
                    int seg_rows, double* __restrict__ partial) {
  __shared__ __align__(16) Staged s;
  __shared__ double red[kWarps * kChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kWideCols;
  const int j = c0 + lane;
  const int i_begin = blockIdx.y * seg_rows;
  const int i_end = min(i_begin + seg_rows, ni);
  const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  float gj[B];  // zero for dead columns, so they add m = 0
#pragma unroll
  for (int b = 0; b < B; ++b) gj[b] = j < nj ? g[(size_t)b * ldg + j] : 0.0f;

  for (int e0 = 0; e0 < dp; e0 += kChunk) {  // this pass's coordinates
    double acc[kChunk];
#pragma unroll
    for (int d = 0; d < kChunk; ++d) acc[d] = 0.0;
    for (int i0 = i_begin; i0 < i_end; i0 += kRowsTile) {
      float t[kRowsWarp];
      tile_t(s, xr, ni, i0, xc, nj, c0, dp, warp, lane, t);
      float m[kRowsWarp];
#pragma unroll
      for (int k = 0; k < kRowsWarp; ++k) {
        const int i = i0 + warp * kRowsWarp + k;
        float pg = 0.0f;
#pragma unroll
        for (int b = 0; b < B; ++b)
          pg = fmaf(i < ni ? __ldg(p + (size_t)b * ldp + i) : 0.0f, gj[b],
                    pg);
        m[k] = pg * drho_unscaled_f32<FAM>(t[k]);
      }
      if (e0 != dp - kChunk) {  // else tile_t left this chunk staged
        __syncthreads();
        stage_chunk(s, xr, ni, i0, xc, nj, c0, dp, e0);
      }
      float xj[kChunk];
      column_chunk(xj, s, lane);
      float run[kChunk];  // this tile's sum over the warp's rows
#pragma unroll
      for (int d = 0; d < kChunk; ++d) run[d] = 0.0f;
#pragma unroll
      for (int k = 0; k < kRowsWarp; ++k) {
        const float* row = s.rows + (warp * kRowsWarp + k) * kChunk;
#pragma unroll
        for (int d = 0; d < kChunk; ++d) {
          const float df = row[d] - xj[d];
          run[d] = fmaf(m[k], df * df, run[d]);
        }
      }
#pragma unroll
      for (int d = 0; d < kChunk; ++d) acc[d] += static_cast<double>(run[d]);
    }

    // block sum per coordinate in a fixed order: warp shuffles, then warps
#pragma unroll
    for (int d = 0; d < kChunk; ++d) {
      double v = acc[d];
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp * kChunk + d] = v;
    }
    __syncthreads();
    if (threadIdx.x < kChunk) {
      double sum = red[threadIdx.x];
      for (int w = 1; w < kWarps; ++w) sum += red[w * kChunk + threadIdx.x];
      partial[blk * dp + e0 + threadIdx.x] = drho_scale<FAM>() * sum;
    }
    __syncthreads();  // red is free for the next pass
  }
}

template <int FAM, int B>
int run_wide_b(const Args& a, int dp, Op op) {
  if (op == kGeometry) {
    if (a.symmetric) return kBadArgument;
    if (a.ls_grad)
      return geometry<WideTile>(ls_grad_wide_kernel<FAM, B>, a.geometry);
    if (a.accurate)
      return geometry<WideTile>(matvec_wide_kernel<FAM, B, double>,
                                a.geometry);
    return geometry<WideTile>(matvec_wide_kernel<FAM, B, float>, a.geometry);
  }
  if (a.symmetric || bad_split<WideTile>(a)) return kBadArgument;
  const dim3 grid((a.nj + kWideCols - 1) / kWideCols, a.segments);
  if (op == kLsGrad)
    ls_grad_wide_kernel<FAM, B><<<grid, kThreads, 0, a.stream>>>(
        a.xr, a.ni, a.xc, a.nj, a.p, a.ldp, a.g, a.ldg, dp, a.seg_rows,
        static_cast<double*>(a.out));
  else if (a.accurate)
    matvec_wide_kernel<FAM, B, double><<<grid, kThreads, 0, a.stream>>>(
        a.xr, a.ni, a.xc, a.nj, a.p, a.ldp, dp, a.seg_rows,
        static_cast<double*>(a.out), a.ldo);
  else
    matvec_wide_kernel<FAM, B, float><<<grid, kThreads, 0, a.stream>>>(
        a.xr, a.ni, a.xc, a.nj, a.p, a.ldp, dp, a.seg_rows,
        static_cast<float*>(a.out), a.ldo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

template <int FAM>
int run_wide(const Args& a, int dp, int b, Op op) {
  if (dp <= 32 || dp % kChunk != 0) return kBadArgument;
  switch (b) {
    case 1: return run_wide_b<FAM, 1>(a, dp, op);
    case 2: return run_wide_b<FAM, 2>(a, dp, op);
    case 4: return run_wide_b<FAM, 4>(a, dp, op);
    case 8: return run_wide_b<FAM, 8>(a, dp, op);
    default: return kBadArgument;
  }
}

template int run_wide<RBF>(const Args&, int, int, Op);
template int run_wide<MAT32>(const Args&, int, int, Op);

}  // namespace cglb
