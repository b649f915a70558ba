// Shared device helpers for the kernels of csrc/.
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

namespace {

constexpr int SP_X = 32, SP_Y = 8;  // columns and part groups of a sum_partials CTA

// out[i] = sum over t < n_parts of part[t * n + i]: the second stage of a
// split reduction whose first stage wrote one partial row per tile or
// cluster.  The TPU grid accumulates in one scratch buffer across
// sequential steps; Hopper CTAs run in no order, and this fixed-order sum
// is the deterministic equivalent (no atomics): thread (x, y) adds parts
// y, y + 8, ... of column x in order, and the 8 group sums are added in
// group order.  Eight loads a column are in flight at once, where one
// thread walking all parts would wait for each in turn.
__global__ void __launch_bounds__(SP_X* SP_Y) sum_partials(const float* __restrict__ part, int n_parts,
                                                           long long n, float* __restrict__ out) {
  __shared__ float red[SP_Y][SP_X];
  const long long i = blockIdx.x * (long long)SP_X + threadIdx.x;
  float s = 0.f;
  if (i < n)
    for (int t = threadIdx.y; t < n_parts; t += SP_Y) s += part[t * n + i];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < n) {
    float acc = red[0][threadIdx.x];
#pragma unroll
    for (int y = 1; y < SP_Y; ++y) acc += red[y][threadIdx.x];
    out[i] = acc;
  }
}

inline cudaError_t launch_sum_partials(const float* part, int n_parts, long long n, float* out,
                                       cudaStream_t s) {
  sum_partials<<<(unsigned)((n + SP_X - 1) / SP_X), dim3(SP_X, SP_Y), 0, s>>>(part, n_parts, n, out);
  return cudaGetLastError();
}

}  // namespace

}  // namespace sgd
