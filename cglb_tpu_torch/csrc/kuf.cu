// Fused Kuf builder (kernel 3).
//
// Replaces cglb_tpu/ops/kuf_pallas.py::_d2_kernel (launched by _d2_call)
// together with the XLA profile that followed it (_profile): on the TPU the
// squared distance was assembled in df32 (two-float f32) by Pallas and the
// profile applied by XLA, split only because of Mosaic compile limits.
// Hopper has fp64 in hardware, so one fp64 kernel does both:
//
//     t_mn   = sum_d (zg_md - xg_nd)^2        (direct differences)
//     kuf_mn = var * rho(t_mn)
//     e_mn   = exp(-sqrt(t_mn)) for Matern32, rho(t_mn) for RBF  (optional:
//              the backward's residual, written only when e != nullptr)
//
// with zg = Z sqrt(gamma) / lengthscale, xg = X sqrt(gamma) / lengthscale,
// handed over coordinate-major by the wrapper (ops/kuf.py kuf_operands), as
// the TPU kernel reads its X blocks: zt [DP, MP] and xt [DP, NP], DP the
// input dimension rounded up to a multiple of kChunk = 8 (ops/kuf.py
// kuf_plan, the TPU kernel's _dsub), MP and NP the rows and columns rounded
// up to the block tile, all padding zero.  One instantiation per family and
// type takes every DP: the number of chunks is a run-time argument.
//
// What bounds it on an H100: the [M, N] output (8 bytes an entry, 16 with e)
// against the fp64 work, DP subtractions and DP FMAs an entry for t (one
// issue slot each: at most 75 % of an fp64 bound that counts 3 DP flops)
// and an fp64 sqrt and exp.  Up to DP 16 the stores bound it; from DP 40
// on the coordinate loop does.
//
// No norm expansion and no tensor cores.  t = |z|^2 + |x|^2 - 2 z.x with the
// cross term on the fp64 tensor cores (DMMA) cancels: near t = 0 its error
// is about eps (|z|^2 + |x|^2), and Matern32 takes sqrt(t), so s would be
// off by about sqrt(eps) |z|, 1e-8 against the 1e-12 contract, and
// coincident points would not give exactly var.  Direct differences give t
// = 0 there exactly (tests/test_torch_kuf.py
// test_x_cotangent_is_zero_and_coincident_points_exact).
//
// Design:
// - Register tiles.  A block of 256 threads owns kBM = 64 rows x kBN = 64
//   columns; a thread keeps t of kTM = 8 rows (its warp's, consecutive) x
//   kTN = 2 columns (lane and lane + 32) in registers.  Per coordinate it
//   reads its 8 Z values as warp broadcasts (16-byte reads) and its 2 X
//   values (conflict-free 8-byte reads) and does 16 subtractions and 16
//   FMAs: each staged value feeds 2 or 8 entries.  Under 85 registers, so
//   three blocks an SM: a thread tile of 8 x 4 (126 registers, two blocks
//   an SM) was slower up to DP 16 and no faster above (PERF.md).
// - Staging.  The coordinates go through shared memory in chunks of 8, Z
//   [8 x 64] and X [8 x 64], through a ring of kStages = 3 buffers filled
//   by cp.async with 16-byte copies of the coordinate-major rows (coalesced,
//   unmasked: the padding is zero).  One barrier a chunk: right after it the
//   copies of the chunk two ahead are issued, which overlap the arithmetic.
// - t sums the coordinates in order, with no atomics: repeat launches are
//   bitwise equal.
// - Epilogue.  The profile in the type's precision (fp64 sqrt and exp for
//   cglb_kuf_f64), then streaming stores (st.global.cs: the output is not
//   read again while this kernel runs; plain stores were slower up to DP
//   40, PERF.md) in which lanes take consecutive columns: each warp store
//   writes 32 consecutive entries of one row (256 bytes of fp64), of Kuf
//   and, when asked, of e.  The grid's x axis takes the column tiles, its
//   y axis the row tiles (at most 65535: M up to 4,194,240).

#include <climits>

#include "common.cuh"

namespace cglb {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTM = 8;                 // rows a thread (and a warp)
constexpr int kTN = 2;                 // columns a thread
constexpr int kBM = kWarps * kTM;      // 64 rows a block
constexpr int kBN = 32 * kTN;          // 64 columns a block
constexpr int kChunk = 8;              // coordinates a stage
constexpr int kStages = 3;             // cp.async ring depth
constexpr int kMinBlocks = 3;          // resident blocks an SM

template <typename T>
struct Stage {
  T z[kChunk][kBM];
  T x[kChunk][kBN];
};

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

// the kTM values at p (16-byte aligned) as 16-byte shared-memory reads
__device__ __forceinline__ void load_rows(const double* p, double (&r)[kTM]) {
#pragma unroll
  for (int i = 0; i < kTM; i += 2) {
    const double2 v = *reinterpret_cast<const double2*>(p + i);
    r[i] = v.x;
    r[i + 1] = v.y;
  }
}

__device__ __forceinline__ void load_rows(const float* p, float (&r)[kTM]) {
#pragma unroll
  for (int i = 0; i < kTM; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    r[i] = v.x;
    r[i + 1] = v.y;
    r[i + 2] = v.z;
    r[i + 3] = v.w;
  }
}

// Copies of the coordinates [d0, d0 + kChunk) of the block's rows and
// columns into s.  Rows of zt are mp apart, rows of xt np.
template <typename T>
__device__ __forceinline__ void stage_chunk(Stage<T>& s,
                                            const T* __restrict__ zt,
                                            int mp, int m0,
                                            const T* __restrict__ xt,
                                            int np, int n0, int d0) {
  constexpr int kVec = 16 / sizeof(T);      // values a copy
  constexpr int kZ = kChunk * kBM / kVec;   // copies of the Z chunk
  constexpr int kX = kChunk * kBN / kVec;   // copies of the X chunk
#pragma unroll
  for (int k0 = 0; k0 < kZ; k0 += kThreads) {
    const int k = k0 + threadIdx.x;
    if (kZ % kThreads == 0 || k < kZ) {
      const int d = k / (kBM / kVec), c = (k % (kBM / kVec)) * kVec;
      cp_async16(&s.z[d][c], zt + (size_t)(d0 + d) * mp + m0 + c, true);
    }
  }
#pragma unroll
  for (int k0 = 0; k0 < kX; k0 += kThreads) {
    const int k = k0 + threadIdx.x;
    if (kX % kThreads == 0 || k < kX) {
      const int d = k / (kBN / kVec), c = (k % (kBN / kVec)) * kVec;
      cp_async16(&s.x[d][c], xt + (size_t)(d0 + d) * np + n0 + c, true);
    }
  }
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
  __stcs(kuf + o, var * rho);
  if (e_out != nullptr) __stcs(e_out + o, e);
}

template <int FAM, typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
kuf_tile_kernel(const T* __restrict__ zt, int m, int mp,
                const T* __restrict__ xt, int n, int np, int chunks,
                const T* __restrict__ var_ptr, T* __restrict__ kuf,
                T* __restrict__ e_out) {
  __shared__ __align__(16) Stage<T> stage[kStages];
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * kTM;  // the warp's first row
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  T t[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) t[i][j] = T(0);

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) stage_chunk(stage[c], zt, mp, m0, xt, np, n0, c * kChunk);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();
    // chunk c is in place, and every thread is done with chunk c - 1,
    // whose buffer the next copies overwrite
    __syncthreads();
    const int next = c + kStages - 1;
    if (next < chunks)
      stage_chunk(stage[next % kStages], zt, mp, m0, xt, np, n0,
                  next * kChunk);
    cp_async_commit();
    const Stage<T>& s = stage[c % kStages];
#pragma unroll
    for (int d = 0; d < kChunk; ++d) {
      T zr[kTM], xr[kTN];
      load_rows(&s.z[d][r0], zr);
#pragma unroll
      for (int j = 0; j < kTN; ++j) xr[j] = s.x[d][lane + 32 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const T df = zr[i] - xr[j];
          t[i][j] = fma_t(df, df, t[i][j]);
        }
    }
  }

  const T var = *var_ptr;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = m0 + r0 + i;
    if (row >= m) break;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + lane + 32 * j;
      if (col < n)
        write_entry<FAM, T>(t[i][j], var, kuf, e_out, (size_t)row * n + col);
    }
  }
}

template <typename T>
int dispatch(const T* zt, long long m, long long mp, const T* xt,
             long long n, long long np, int dp, int family, const T* var,
             T* kuf, T* e, void* stream) {
  if (m <= 0 || n <= 0 || mp < m || np < n || mp % kBM != 0 ||
      np % kBN != 0 || mp / kBM > 65535 || np > INT_MAX || dp < kChunk ||
      dp % kChunk != 0 || (family != RBF && family != MAT32))
    return kBadArgument;
  const dim3 grid(static_cast<unsigned>(np / kBN),
                  static_cast<unsigned>(mp / kBM));
  const auto s = static_cast<cudaStream_t>(stream);
  const int mi = static_cast<int>(m), mpi = static_cast<int>(mp);
  const int ni = static_cast<int>(n), npi = static_cast<int>(np);
  if (family == MAT32)
    kuf_tile_kernel<MAT32, T><<<grid, kThreads, 0, s>>>(
        zt, mi, mpi, xt, ni, npi, dp / kChunk, var, kuf, e);
  else
    kuf_tile_kernel<RBF, T><<<grid, kThreads, 0, s>>>(
        zt, mi, mpi, xt, ni, npi, dp / kChunk, var, kuf, e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace cglb

extern "C" {

// kuf [m, n] = var[0] * rho(zt, xt), var on the device; e [m, n] optional
// (nullptr to skip).  zt [dp, mp] and xt [dp, np] coordinate-major, mp a
// multiple of 64, np of 64, dp of 8, zero-padded.
int cglb_kuf_f64(const double* zt, long long m, long long mp,
                 const double* xt, long long n, long long np, int dp,
                 int family, const double* var, double* kuf, double* e,
                 void* stream) {
  return cglb::dispatch<double>(zt, m, mp, xt, n, np, dp, family, var, kuf,
                                e, stream);
}

int cglb_kuf_f32(const float* zt, long long m, long long mp, const float* xt,
                 long long n, long long np, int dp, int family,
                 const float* var, float* kuf, float* e, void* stream) {
  return cglb::dispatch<float>(zt, m, mp, xt, n, np, dp, family, var, kuf, e,
                               stream);
}

}  // extern "C"
