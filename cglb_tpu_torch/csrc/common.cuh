// Shared device helpers of the port's kernels: the unit-variance kernel
// profiles from t = gamma * d2 (gamma = 3 for Matern32, 1/2 for RBF, folded
// into the scaled coordinates by the Python wrappers) and the C return code.
#pragma once

#include <cuda_runtime.h>

namespace cglb {

enum Family { RBF = 0, MAT32 = 1 };

// sqrt(t) as t * rsqrt(t); the clamp keeps t = 0 from giving 0 * inf
// (cglb_tpu/ops/matvec_pallas.py _tile_sqrt)
__device__ __forceinline__ float sqrt_f32(float t) {
  return t * rsqrtf(fmaxf(t, 1e-30f));
}

// rho(t): exp(-t) for RBF (t = d2/2); (1 + s) exp(-s), s = sqrt(t) for
// Matern32 (t = 3 d2)
template <int FAM>
__device__ __forceinline__ float rho_f32(float t) {
  if (FAM == RBF) return expf(-t);
  const float s = sqrt_f32(t);
  return (1.0f + s) * expf(-s);
}

// d rho / d(d2) from t, exactly as _tile_drho_dd2 (matvec_pallas.py:157-161)
template <int FAM>
__device__ __forceinline__ float drho_dd2_f32(float t) {
  if (FAM == RBF) return -0.5f * expf(-t);
  return -1.5f * expf(-sqrt_f32(t));
}

// Every C entry point returns cudaGetLastError() after its launch, or this
// code when the wrapper passed a shape the kernels are not instantiated for.
constexpr int kBadArgument = static_cast<int>(cudaErrorInvalidValue);

}  // namespace cglb
