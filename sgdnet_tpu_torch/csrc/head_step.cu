// Fused head step for Hopper (sm_90a), K2 of the port.
//
// Replaces sgdnet_tpu/solver/pallas_kernels.py `fused_head_step_at` ->
// pallas_call (bodies `_kernel`, `_kernel_prefetch`; `_kernel_vpu1` is a
// TPU layout variant of the same function and is not ported).  Over rows
// [start, start + B) of the FULL (n_pad, D) head it computes
//
//     lp   = head_b w^T + lp_extra
//     g    = gradient(lp, y) * wb          (multinomial: softmax over k)
//     gc   = g - g_mem_b
//     corr = gc^T head_b                   (k, D)
//
// and returns g (B, k) and corr.  `start` is an integer argument: no
// (B, D) copy of the block is ever made.
//
// What bounds it: at the dense multinomial shape (B = 4096, D = 784,
// k = 10) each step must read the B x D block (12.8 MB in f32) and does
// ~4 B D k flops, far below Hopper's compute-to-bandwidth ratio, so the
// block read is the floor.  Design:
//   * the grid runs over the B / bt row tiles (bt = 32: 128 CTAs for the
//     shape above, about one per SM);
//   * phase 1: one warp per row computes lp (lanes stride over D,
//     coalesced), then the gradient with lanes over classes, and keeps gc
//     in shared memory;
//   * phase 2: one thread per column sums its tile's partial corr (the
//     tile is re-read from L1/L2, not HBM) into a (tiles, k, D) scratch;
//   * a second small kernel sums the partials over tiles in a fixed order.
//     The TPU grid accumulated corr sequentially in one scratch buffer;
//     Hopper CTAs run in no order, and this two-stage reduction is the
//     deterministic equivalent (no atomics).
// Templated on the head type: f32 runs plain FP32 FMAs (never TF32); bf16
// loads bf16, casts w and gc to bf16 exactly as the Pallas kernel does,
// and accumulates in f32.

#include "common.h"

namespace {

constexpr int HT = 256;        // threads of a tile CTA
constexpr int HW = HT / 32;    // warps of a tile CTA
constexpr int KC = 8;          // classes held in registers at a time

template <typename T>
__global__ void __launch_bounds__(HT) head_step_tile(
    const T* __restrict__ head, long long start, int D, int k, int bt,
    const float* __restrict__ w, const float* __restrict__ lpe,
    const float* __restrict__ yb, const float* __restrict__ gm,
    const float* __restrict__ wb, int family,
    float* __restrict__ g_out, float* __restrict__ part) {
  extern __shared__ float sm[];
  float* lp_s = sm;            // bt * k
  float* gc_s = sm + bt * k;   // bt * k
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x;
  const int r0 = tile * bt;

  // ---- phase 1: lp, gradient, gc for the tile's rows (one warp each) ----
  for (int r = warp; r < bt; r += HW) {
    const int rb = r0 + r;  // row within the batch
    const T* xr = head + (start + rb) * (long long)D;
    for (int c0 = 0; c0 < k; c0 += KC) {
      float acc[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) acc[c] = 0.f;
      for (int j = lane; j < D; j += 32) {
        const float xv = sgd::to_f32(xr[j]);
#pragma unroll
        for (int c = 0; c < KC; ++c)
          if (c0 + c < k) acc[c] = fmaf(xv, sgd::round_as<T>(w[(long long)(c0 + c) * D + j]), acc[c]);
      }
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const float s = sgd::warp_sum(acc[c]);
        if (lane == 0 && c0 + c < k) lp_s[r * k + c0 + c] = s + lpe[rb * k + c0 + c];
      }
    }
    __syncwarp();
    float m = 0.f, denom = 1.f;
    if (family == sgd::MULTINOMIAL) {
      m = -INFINITY;
      for (int c = lane; c < k; c += 32) m = fmaxf(m, lp_s[r * k + c]);
      m = sgd::warp_max(m);
      float s = 0.f;
      for (int c = lane; c < k; c += 32) s += expf(lp_s[r * k + c] - m);
      denom = sgd::warp_sum(s);
    }
    const float wr = wb[rb];
    for (int c = lane; c < k; c += 32) {
      const float lp = lp_s[r * k + c];
      const float y = yb[rb * k + c];
      float g = family == sgd::MULTINOMIAL ? expf(lp - m) / denom - y
                                           : sgd::elementwise_gradient(family, lp, y, 0.f);
      g *= wr;
      g_out[rb * k + c] = g;
      gc_s[r * k + c] = sgd::round_as<T>(g - gm[rb * k + c]);
    }
  }
  __syncthreads();

  // ---- phase 2: this tile's partial corr (one thread per column) ----
  const T* xt = head + (start + r0) * (long long)D;
  for (int j = tid; j < D; j += HT) {
    for (int c0 = 0; c0 < k; c0 += KC) {
      float acc[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) acc[c] = 0.f;
      for (int r = 0; r < bt; ++r) {
        const float xv = sgd::to_f32(xt[(long long)r * D + j]);
#pragma unroll
        for (int c = 0; c < KC; ++c)
          if (c0 + c < k) acc[c] = fmaf(gc_s[r * k + c0 + c], xv, acc[c]);
      }
#pragma unroll
      for (int c = 0; c < KC; ++c)
        if (c0 + c < k) part[((long long)tile * k + c0 + c) * D + j] = acc[c];
    }
  }
}

// corr[i] = sum over tiles of part[t, i], in tile order
__global__ void head_corr_reduce(const float* __restrict__ part, int n_tiles, long long kD,
                                 float* __restrict__ corr) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= kD) return;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += part[t * kD + i];
  corr[i] = s;
}

template <typename T>
cudaError_t launch(const void* head, long long start, int D, int k, int B, int bt,
                   const float* w, const float* lpe, const float* yb, const float* gm,
                   const float* wb, int family, float* g_out, float* part, float* corr,
                   cudaStream_t s) {
  const int n_tiles = B / bt;
  const size_t smem = 2 * sizeof(float) * (size_t)bt * k;
  cudaError_t e = cudaFuncSetAttribute(head_step_tile<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  head_step_tile<T><<<n_tiles, HT, smem, s>>>(static_cast<const T*>(head), start, D, k, bt, w, lpe,
                                              yb, gm, wb, family, g_out, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long kD = (long long)k * D;
  head_corr_reduce<<<(unsigned)((kD + 255) / 256), 256, 0, s>>>(part, n_tiles, kD, corr);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One fused head step.  head_dtype: 0 = float32, 1 = bfloat16.  part is a
// (B / bt, k, D) f32 scratch.  Returns a cudaError_t (0 = launched).
int sgd_head_step(const void* head, int head_dtype, long long start, int D, int k, int B, int bt,
                  const float* w, const float* lpe, const float* yb, const float* gm,
                  const float* wb, int family, float* g_out, float* part, float* corr,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dtype == 1)
    return launch<__nv_bfloat16>(head, start, D, k, B, bt, w, lpe, yb, gm, wb, family, g_out, part,
                                 corr, s);
  return launch<float>(head, start, D, k, B, bt, w, lpe, yb, gm, wb, family, g_out, part, corr, s);
}

}  // extern "C"
