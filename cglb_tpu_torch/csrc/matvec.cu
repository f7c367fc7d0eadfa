// Streaming kernel matvec (kernel 1) and its lengthscale gradient (kernel 2).
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
// over the block's columns and all rows.  The wrapper sums the partials with
// a deterministic torch.sum and applies -2 var / (gamma * lengthscale).
//
// What bounds them on an H100: arithmetic, not memory.  Inputs are N x DP
// floats (L2-resident); every (i, j) pair costs DP differences, an rsqrt and
// an expf (SFU) and B fused adds, about 30 instructions at B = 1, D = 8.  At
// B = 1 the contraction is a matrix-vector product, so tensor cores do not
// help (the TPU's bf16 4-split packing of the MXU is not ported).  Design:
// each lane owns one output column, its coordinates in registers; a block of
// 8 warps owns 32 columns and loops over ALL rows (the TPU's sequential
// i-grid), staging 128 rows at a time in shared memory, where every lane of a
// warp reads the same row (a broadcast); the 8 warps take interleaved rows
// and are summed in a fixed order at the end, so results are deterministic.
// At N = 26800 that is 838 blocks, about 50 resident warps per SM.
//
// Tiers (template Acc): the accurate tier accumulates in fp64, the CG tier
// plainly in fp32.  Coordinates are zero-padded to DP in {8, 32} columns and
// p/g to B in {1, 2, 4, 8} rows by the wrapper; padded columns add zero to t.

#include <climits>

#include "common.cuh"

namespace cglb {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 32;   // output columns per block, one per lane
constexpr int kTileRows = 128;  // rows staged in shared memory per step

template <int FAM, int DP, int B, typename Acc>
__global__ void __launch_bounds__(kThreads)
matvec_kernel(const float* __restrict__ xr, int ni,
              const float* __restrict__ xc, int nj,
              const float* __restrict__ p, Acc* __restrict__ out) {
  __shared__ float xs[kTileRows * DP];
  __shared__ float ps[B * kTileRows];
  __shared__ Acc red[kWarps * B * kTileCols];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * kTileCols + lane;
  const bool live = j < nj;

  float xj[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) xj[d] = live ? xc[(size_t)j * DP + d] : 0.0f;
  Acc acc[B];
#pragma unroll
  for (int b = 0; b < B; ++b) acc[b] = Acc(0);

  for (int i0 = 0; i0 < ni; i0 += kTileRows) {
    const int rows = min(kTileRows, ni - i0);
    __syncthreads();  // the previous tile is consumed
    for (int k = threadIdx.x; k < rows * DP; k += kThreads)
      xs[k] = xr[(size_t)i0 * DP + k];
    for (int k = threadIdx.x; k < B * kTileRows; k += kThreads) {
      const int b = k / kTileRows;
      const int ii = k - b * kTileRows;
      ps[k] = (ii < rows) ? p[(size_t)b * ni + i0 + ii] : 0.0f;
    }
    __syncthreads();
    for (int ii = warp; ii < rows; ii += kWarps) {
      float t = 0.0f;
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        const float df = xs[ii * DP + d] - xj[d];
        t = fmaf(df, df, t);
      }
      const float r = rho_f32<FAM>(t);
#pragma unroll
      for (int b = 0; b < B; ++b)
        acc[b] += static_cast<Acc>(ps[b * kTileRows + ii]) *
                  static_cast<Acc>(r);
    }
  }

#pragma unroll
  for (int b = 0; b < B; ++b) red[(warp * B + b) * kTileCols + lane] = acc[b];
  __syncthreads();
  if (warp == 0 && live) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      Acc s = red[b * kTileCols + lane];
      for (int w = 1; w < kWarps; ++w) s += red[(w * B + b) * kTileCols + lane];
      out[(size_t)b * nj + j] = s;
    }
  }
}

template <int FAM, int DP, int B>
__global__ void __launch_bounds__(kThreads)
ls_grad_kernel(const float* __restrict__ xr, int ni,
               const float* __restrict__ xc, int nj,
               const float* __restrict__ p, const float* __restrict__ g,
               double* __restrict__ partial) {
  __shared__ float xs[kTileRows * DP];
  __shared__ float ps[B * kTileRows];
  __shared__ double red[kWarps * DP];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * kTileCols + lane;
  const bool live = j < nj;

  float xj[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) xj[d] = live ? xc[(size_t)j * DP + d] : 0.0f;
  float gj[B];
#pragma unroll
  for (int b = 0; b < B; ++b) gj[b] = live ? g[(size_t)b * nj + j] : 0.0f;
  double acc[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) acc[d] = 0.0;

  for (int i0 = 0; i0 < ni; i0 += kTileRows) {
    const int rows = min(kTileRows, ni - i0);
    __syncthreads();
    for (int k = threadIdx.x; k < rows * DP; k += kThreads)
      xs[k] = xr[(size_t)i0 * DP + k];
    for (int k = threadIdx.x; k < B * kTileRows; k += kThreads) {
      const int b = k / kTileRows;
      const int ii = k - b * kTileRows;
      ps[k] = (ii < rows) ? p[(size_t)b * ni + i0 + ii] : 0.0f;
    }
    __syncthreads();
    for (int ii = warp; ii < rows; ii += kWarps) {
      float df[DP];
      float t = 0.0f;
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        df[d] = xs[ii * DP + d] - xj[d];
        t = fmaf(df[d], df[d], t);
      }
      float pg = 0.0f;
#pragma unroll
      for (int b = 0; b < B; ++b) pg = fmaf(ps[b * kTileRows + ii], gj[b], pg);
      const float m = pg * drho_dd2_f32<FAM>(t);
#pragma unroll
      for (int d = 0; d < DP; ++d)
        acc[d] += static_cast<double>(m * df[d] * df[d]);
    }
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
    partial[(size_t)blockIdx.x * DP + threadIdx.x] = s;
  }
}

struct MatvecArgs {
  const float* xr;
  int ni;
  const float* xc;
  int nj;
  const float* p;
  const float* g;
  void* out;
  bool accurate;
  cudaStream_t stream;
};

template <int FAM, int DP, int B>
int launch(const MatvecArgs& a, bool ls_grad) {
  const dim3 grid((a.nj + kTileCols - 1) / kTileCols);
  if (ls_grad) {
    ls_grad_kernel<FAM, DP, B><<<grid, kThreads, 0, a.stream>>>(
        a.xr, a.ni, a.xc, a.nj, a.p, a.g, static_cast<double*>(a.out));
  } else if (a.accurate) {
    matvec_kernel<FAM, DP, B, double><<<grid, kThreads, 0, a.stream>>>(
        a.xr, a.ni, a.xc, a.nj, a.p, static_cast<double*>(a.out));
  } else {
    matvec_kernel<FAM, DP, B, float><<<grid, kThreads, 0, a.stream>>>(
        a.xr, a.ni, a.xc, a.nj, a.p, static_cast<float*>(a.out));
  }
  return static_cast<int>(cudaGetLastError());
}

template <int FAM, int DP>
int dispatch_b(const MatvecArgs& a, int b, bool ls_grad) {
  switch (b) {
    case 1: return launch<FAM, DP, 1>(a, ls_grad);
    case 2: return launch<FAM, DP, 2>(a, ls_grad);
    case 4: return launch<FAM, DP, 4>(a, ls_grad);
    case 8: return launch<FAM, DP, 8>(a, ls_grad);
    default: return kBadArgument;
  }
}

template <int FAM>
int dispatch_dp(const MatvecArgs& a, int dp, int b, bool ls_grad) {
  switch (dp) {
    case 8: return dispatch_b<FAM, 8>(a, b, ls_grad);
    case 32: return dispatch_b<FAM, 32>(a, b, ls_grad);
    default: return kBadArgument;
  }
}

int dispatch(const MatvecArgs& a, int family, int dp, int b, long long ni,
             long long nj, bool ls_grad) {
  if (ni <= 0 || nj <= 0 || ni > INT_MAX || nj > INT_MAX) return kBadArgument;
  switch (family) {
    case RBF: return dispatch_dp<RBF>(a, dp, b, ls_grad);
    case MAT32: return dispatch_dp<MAT32>(a, dp, b, ls_grad);
    default: return kBadArgument;
  }
}

}  // namespace
}  // namespace cglb

extern "C" {

// out [b, nj] (double when accurate, else float) = p [b, ni] @ rho(xr, xc)
int cglb_matvec(const float* xr, long long ni, const float* xc, long long nj,
                const float* p, int b, int dp, int family, int accurate,
                void* out, void* stream) {
  const cglb::MatvecArgs a{xr, static_cast<int>(ni), xc, static_cast<int>(nj),
                           p, nullptr, out, accurate != 0,
                           static_cast<cudaStream_t>(stream)};
  return cglb::dispatch(a, family, dp, b, ni, nj, false);
}

// number of blocks (rows of `partial`) cglb_ls_grad launches for nj columns
long long cglb_ls_grad_blocks(long long nj) {
  return (nj + cglb::kTileCols - 1) / cglb::kTileCols;
}

// partial [cglb_ls_grad_blocks(nj), dp] fp64
int cglb_ls_grad(const float* xr, long long ni, const float* xc, long long nj,
                 const float* p, const float* g, int b, int dp, int family,
                 double* partial, void* stream) {
  const cglb::MatvecArgs a{xr, static_cast<int>(ni), xc, static_cast<int>(nj),
                           p, g, partial, true,
                           static_cast<cudaStream_t>(stream)};
  return cglb::dispatch(a, family, dp, b, ni, nj, true);
}

}  // extern "C"
