// Shared device helpers of the port's kernels: the unit-variance kernel
// profiles from t = gamma * d2 (gamma = 3 for Matern32, 1/2 for RBF, folded
// into the scaled coordinates by the Python wrappers) and the C return code.
//
// The fp32 profiles of the streaming kernels take one MUFU instruction per
// transcendental: ex2.approx on the argument scaled by log2(e), and
// sqrt.approx, both flushing subnormals (t >= 0, and an exponential below
// 2^-126 adds nothing to a sum of values near 1).  On an H100 they stay
// inside every tier's error bound and are about a fifth faster than expf /
// t * rsqrtf(t) (PERF.md).  They are chosen here per function, not by a
// global --use_fast_math, which would also reach the fp64 Kuf kernel.
#pragma once

#include <cuda_runtime.h>

namespace cglb {

enum Family { RBF = 0, MAT32 = 1 };

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp(-x)
__device__ __forceinline__ float exp_neg(float x) {
  return ex2_approx(-kLog2e * x);
}

// rho(t): exp(-t) for RBF (t = d2/2); (1 + s) exp(-s), s = sqrt(t) for
// Matern32 (t = 3 d2)
template <int FAM>
__device__ __forceinline__ float rho_f32(float t) {
  if (FAM == RBF) return exp_neg(t);
  const float s = sqrt_approx(t);
  const float e = exp_neg(s);
  return fmaf(s, e, e);
}

// d rho / d(d2) = drho_scale<FAM>() * drho_unscaled_f32<FAM>(t), as
// _tile_drho_dd2 (matvec_pallas.py:157-161) with the constant factored out
template <int FAM>
__host__ __device__ constexpr double drho_scale() {
  return FAM == RBF ? -0.5 : -1.5;
}

template <int FAM>
__device__ __forceinline__ float drho_unscaled_f32(float t) {
  return FAM == RBF ? exp_neg(t) : exp_neg(sqrt_approx(t));
}

// 16-byte asynchronous copies into shared memory (zero-filled unless ok)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Every C entry point returns cudaGetLastError() after its launch, or this
// code when the wrapper passed a shape the kernels are not instantiated for.
constexpr int kBadArgument = static_cast<int>(cudaErrorInvalidValue);

}  // namespace cglb
