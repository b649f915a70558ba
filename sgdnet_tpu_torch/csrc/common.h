// Shared device helpers for the SAGA kernels (epoch_kernel.cu, head_step.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace sgd {

// family / penalty codes; the Python wrappers pass the same integers
enum Family { GAUSSIAN = 0, BINOMIAL = 1, POISSON = 2, MULTINOMIAL = 3, MGAUSSIAN = 4 };
enum Penalty { RIDGE = 0, ELASTIC_NET = 1, GROUP_LASSO = 2 };

constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

// loads in f32 from the head's storage type
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// rounding of an f32 operand to the head's storage type before the
// multiply (bf16 heads: w and gc are cast to bf16, products accumulate f32)
template <typename T>
__device__ __forceinline__ float round_as(float v) { return v; }
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// elementwise family gradient for the single-output-per-class families
// (everything but multinomial); log_smooth caps the poisson rate
__device__ __forceinline__ float elementwise_gradient(int family, float lp, float y, float log_smooth) {
  switch (family) {
    case BINOMIAL:
      return 1.0f / (1.0f + expf(-lp)) - y;
    case POISSON:
      return expf(fminf(lp, log_smooth)) - y;
    default:  // GAUSSIAN, MGAUSSIAN
      return lp - y;
  }
}

}  // namespace sgd
