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
// prepared by the wrapper and zero-padded to DP in {8, 32} columns, or, for
// D > 32, to a multiple of 8 (kuf_wide_kernel).
//
// What bounds it on an H100: writing the [M, N] output (8 bytes an entry,
// 16 with e; 439 MB at M = 2048, N = 26800), next to one fp64 sqrt and exp
// per entry.  Design: a block of 32 x 8 threads owns 32 rows (m) x 32 columns
// (n); the 32 Z rows sit in shared memory and are read as warp broadcasts,
// each thread keeps its X row in registers and writes 4 rows, so each warp
// writes 32 consecutive entries of a row (coalesced).  Above DP 32 the
// wide kernel keeps the same blocks and loops over the coordinates in
// chunks of kChunk, then of 8 for the rest (DP is a multiple of 8): the
// chunk of the 32 Z rows in shared memory, of the thread's X row in
// registers, t of its 4 entries summed across chunks in the same order as
// one pass would, then the same profile.

#include <climits>

#include "common.cuh"

namespace cglb {
namespace {

constexpr int kCols = 32;           // n per block (threadIdx.x)
constexpr int kRowThreads = 8;      // threadIdx.y
constexpr int kRowsPerThread = 4;
constexpr int kRows = kRowThreads * kRowsPerThread;  // m per block
constexpr int kChunk = 32;  // coordinates a pass of kuf_wide_kernel

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

// kuf[o] = var * rho(t) and, with e_out, e_out[o] = e
template <int FAM, typename T>
__device__ __forceinline__ void write_entry(T t, T var, T* __restrict__ kuf,
                                            T* __restrict__ e_out, size_t o) {
  T rho, e;
  if (FAM == RBF) {
    rho = exp_t(-t);  // t = d2 / 2
    e = rho;
  } else {
    const T s = sqrt_t(t);  // t = 3 d2 => s = sqrt(3) r
    e = exp_t(-s);
    rho = (T(1) + s) * e;
  }
  kuf[o] = var * rho;
  if (e_out != nullptr) e_out[o] = e;
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
    write_entry<FAM, T>(t, var, kuf, e_out, (size_t)row * n + col);
  }
}

// t[rr] += the coordinates [d0, d0 + W) of the kernel's wide chunk loop
template <int W, typename T>
__device__ __forceinline__ void kuf_chunk(T* zs, const T* __restrict__ zg,
                                          int m, int m0,
                                          const T* __restrict__ xg, int n,
                                          int col, int dp, int d0, int tid,
                                          T (&t)[kRowsPerThread]) {
  __syncthreads();  // every thread is done with the previous chunk
  for (int k = tid; k < kRows * W; k += kCols * kRowThreads) {
    const int r = k / W;
    zs[k] = m0 + r < m ? zg[(size_t)(m0 + r) * dp + d0 + (k - r * W)] : T(0);
  }
  T xj[W];
#pragma unroll
  for (int d = 0; d < W; ++d)
    xj[d] = col < n ? xg[(size_t)col * dp + d0 + d] : T(0);
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < kRowsPerThread; ++rr) {
    const int r = threadIdx.y + rr * kRowThreads;
#pragma unroll
    for (int d = 0; d < W; ++d) {
      const T df = zs[r * W + d] - xj[d];
      t[rr] = fma_t(df, df, t[rr]);
    }
  }
}

template <int FAM, typename T>
__global__ void __launch_bounds__(kCols * kRowThreads)
kuf_wide_kernel(const T* __restrict__ zg, int m, const T* __restrict__ xg,
                int n, int dp, const T* __restrict__ var_ptr,
                T* __restrict__ kuf, T* __restrict__ e_out) {
  __shared__ T zs[kRows * kChunk];
  const int tid = threadIdx.y * kCols + threadIdx.x;
  const int m0 = blockIdx.y * kRows;
  const int col = blockIdx.x * kCols + threadIdx.x;

  T t[kRowsPerThread];
#pragma unroll
  for (int rr = 0; rr < kRowsPerThread; ++rr) t[rr] = T(0);
  int d0 = 0;
  for (; d0 + kChunk <= dp; d0 += kChunk)
    kuf_chunk<kChunk>(zs, zg, m, m0, xg, n, col, dp, d0, tid, t);
  for (; d0 < dp; d0 += 8)  // the rest, a multiple of 8
    kuf_chunk<8>(zs, zg, m, m0, xg, n, col, dp, d0, tid, t);
  if (col >= n) return;
  const T var = *var_ptr;
#pragma unroll
  for (int rr = 0; rr < kRowsPerThread; ++rr) {
    const int row = m0 + threadIdx.y + rr * kRowThreads;
    if (row >= m) break;
    write_entry<FAM, T>(t[rr], var, kuf, e_out, (size_t)row * n + col);
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
  if (dp > 32 && dp % 8 == 0 && (family == RBF || family == MAT32)) {
    const dim3 grid((ni + kCols - 1) / kCols, (mi + kRows - 1) / kRows);
    const dim3 block(kCols, kRowThreads);
    if (family == MAT32)
      kuf_wide_kernel<MAT32, T><<<grid, block, 0, s>>>(zg, mi, xg, ni, dp, var,
                                                       kuf, e);
    else
      kuf_wide_kernel<RBF, T><<<grid, block, 0, s>>>(zg, mi, xg, ni, dp, var,
                                                     kuf, e);
    return static_cast<int>(cudaGetLastError());
  }
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
