// Fused Kuf builder (kernel 3).
//
// Replaces cglb_tpu/ops/kuf_pallas.py::_d2_kernel (launched by _d2_call)
// together with the XLA profile that followed it (_profile): on the TPU the
// squared distance was assembled in df32 (two-float f32) by Pallas and the
// profile applied by XLA, split only because of Mosaic compile limits.
// Hopper has fp64 in hardware, so one fp64 kernel does both:
//
//     t_mn   = sum_d (zg_md - xg_nd)^2        (direct differences, no
//                                              norm-expansion cancellation)
//     kuf_mn = var * rho(t_mn)
//     e_mn   = exp(-sqrt(t_mn)) for Matern32, rho(t_mn) for RBF  (optional:
//              the backward's residual, written only when e != nullptr)
//
// with zg = Z sqrt(gamma) / lengthscale, xg = X sqrt(gamma) / lengthscale
// prepared by the wrapper and zero-padded to DP in {8, 32} columns.
//
// What bounds it on an H100: writing the [M, N] output (8 bytes an entry,
// 16 with e; 439 MB at M = 2048, N = 26800), next to one fp64 sqrt and exp
// per entry.  Design: a block of 32 x 8 threads owns 32 rows (m) x 32 columns
// (n); the 32 Z rows sit in shared memory and are read as warp broadcasts,
// each thread keeps its X row in registers and writes 4 rows, so each warp
// writes 32 consecutive entries of a row (coalesced).

#include <climits>

#include "common.cuh"

namespace cglb {
namespace {

constexpr int kCols = 32;           // n per block (threadIdx.x)
constexpr int kRowThreads = 8;      // threadIdx.y
constexpr int kRowsPerThread = 4;
constexpr int kRows = kRowThreads * kRowsPerThread;  // m per block

__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}

template <int FAM, int DP, typename T>
__global__ void __launch_bounds__(kCols * kRowThreads)
kuf_kernel(const T* __restrict__ zg, int m, const T* __restrict__ xg, int n,
           const T* __restrict__ var_ptr, T* __restrict__ kuf,
           T* __restrict__ e_out) {
  __shared__ T zs[kRows * DP];
  const int tid = threadIdx.y * kCols + threadIdx.x;
  const int m0 = blockIdx.y * kRows;
  const int col = blockIdx.x * kCols + threadIdx.x;

  for (int k = tid; k < kRows * DP; k += kCols * kRowThreads)
    zs[k] = (m0 + k / DP < m) ? zg[(size_t)m0 * DP + k] : T(0);
  T xj[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) xj[d] = col < n ? xg[(size_t)col * DP + d] : T(0);
  __syncthreads();
  if (col >= n) return;
  const T var = *var_ptr;

#pragma unroll
  for (int rr = 0; rr < kRowsPerThread; ++rr) {
    const int r = threadIdx.y + rr * kRowThreads;
    const int row = m0 + r;
    if (row >= m) break;
    T t = T(0);
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      const T df = zs[r * DP + d] - xj[d];
      t = fma_t(df, df, t);
    }
    T rho, e;
    if (FAM == RBF) {
      rho = exp_t(-t);  // t = d2 / 2
      e = rho;
    } else {
      const T s = sqrt_t(t);  // t = 3 d2 => s = sqrt(3) r
      e = exp_t(-s);
      rho = (T(1) + s) * e;
    }
    const size_t o = (size_t)row * n + col;
    kuf[o] = var * rho;
    if (e_out != nullptr) e_out[o] = e;
  }
}

template <typename T, int FAM, int DP>
int launch(const T* zg, int m, const T* xg, int n, const T* var, T* kuf, T* e,
           cudaStream_t stream) {
  const dim3 grid((n + kCols - 1) / kCols, (m + kRows - 1) / kRows);
  const dim3 block(kCols, kRowThreads);
  kuf_kernel<FAM, DP, T><<<grid, block, 0, stream>>>(zg, m, xg, n, var, kuf, e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* zg, long long m, const T* xg, long long n, int dp,
             int family, const T* var, T* kuf, T* e, void* stream) {
  if (m <= 0 || n <= 0 || m > INT_MAX || n > INT_MAX ||
      (m + kRows - 1) / kRows > 65535)
    return kBadArgument;
  const auto s = static_cast<cudaStream_t>(stream);
  const int mi = static_cast<int>(m), ni = static_cast<int>(n);
  if (family == MAT32 && dp == 8) return launch<T, MAT32, 8>(zg, mi, xg, ni, var, kuf, e, s);
  if (family == MAT32 && dp == 32) return launch<T, MAT32, 32>(zg, mi, xg, ni, var, kuf, e, s);
  if (family == RBF && dp == 8) return launch<T, RBF, 8>(zg, mi, xg, ni, var, kuf, e, s);
  if (family == RBF && dp == 32) return launch<T, RBF, 32>(zg, mi, xg, ni, var, kuf, e, s);
  return kBadArgument;
}

}  // namespace
}  // namespace cglb

extern "C" {

// kuf [m, n] = var[0] * rho(zg, xg), var on the device; e [m, n] optional
// (nullptr to skip)
int cglb_kuf_f64(const double* zg, long long m, const double* xg, long long n,
                 int dp, int family, const double* var, double* kuf, double* e,
                 void* stream) {
  return cglb::dispatch<double>(zg, m, xg, n, dp, family, var, kuf, e, stream);
}

int cglb_kuf_f32(const float* zg, long long m, const float* xg, long long n,
                 int dp, int family, const float* var, float* kuf, float* e,
                 void* stream) {
  return cglb::dispatch<float>(zg, m, xg, n, dp, family, var, kuf, e, stream);
}

}  // extern "C"
