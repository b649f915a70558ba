// The measurement probes for Hopper (sm_90a): P1, P2 and P3 of the port.
//
// P1 `epoch_probe` replaces tools/bench_epoch_kernel.py `run_pallas` ->
// pallas_call (body `_epoch_kernel`): the single-block, gaussian-only
// prototype of the whole-epoch kernel K1.  One launch runs one epoch of T
// batched SAGA steps over the block starts `starts`, with no intercept, the
// l1 / l2 prox and the state updated in place (the TPU aliases it in and
// out).  The probe's arrays keep their lane-padded TPU layout: y, wt and
// g_mem are (N, 8) with lane 0 used, w and g_sum are (8, P) with row 0
// used.  Each step:
//
//     lp   = x_b w                       g    = (lp - y_b) wt_b
//     gc   = g - g_mem_b, g_mem_b <- g   corr = gc^T x_b
//     w    <- soft(w (1 - gamma l2) - gamma (corr / B + g_sum), gamma l1)
//     g_sum += corr / N
//
// What bounds it: the steps are strictly sequential, each a few kFLOP on an
// L2-resident 2.3 MB dataset, so the epoch is latency-bound; its time
// measures the per-step floor of a one-CTA loop on this card.  Design, as
// K1: one CTA; w and g_sum (P floats each) in shared memory for the epoch;
// one warp per batch row for lp (lanes over columns), one thread per column
// for corr and the update; every sum in a fixed order, so two runs give
// identical bits.  The divisor is B, not the batch weight, as in P1.
//
// P2 `colsum_tile` + `sum_partials` replaces tools/bench_pallas_dma.py
// `mk_reduce` -> pallas_call (body `reduce_kernel`): the f32 column sums of
// the block head[start : start + B] of a bf16 head, read in bt-row tiles.
// The TPU streams the tiles through one core's automatic pipeline, carrying
// the sum across grid steps.  Hopper cannot stream from one block that way,
// so the grid is (column strips) x (B / bt row tiles): each CTA sums its bt x
// 512 tile (one thread per column pair, coalesced bf16x2 loads) into a
// partial row, and a second launch adds the partials in a fixed order (K2's
// no-atomics scheme; deterministic).  `dimension_semantics` is a TPU
// compiler hint and has no counterpart.
//
// P3 `colsum_pipelined` replaces tools/bench_dma_streams.py `mk` ->
// pallas_call (body `kernel`): the same column sums through an explicit ring
// of NBUF asynchronous copies, the counterpart of make_async_copy with one
// DMA semaphore per slot.  Each CTA owns a strip of W columns over the B
// rows; a stage is chunk_rows x W bf16 landed in shared memory by cp.async
// (16 bytes a copy) with one commit group per chunk.  A TPU chunk (up to
// 512 x 16384 bf16) cannot fit 227 KB of shared memory, so the wrapper picks
// W so that NBUF stages fit.  Threads own a column pair and a residue class
// of the chunk's rows; their sums meet in shared memory in a fixed order.
//
// What bounds P2 and P3: the B x D bf16 block must cross from device memory
// once (268 MB at the probes' shape), one add per element; bytes bound them.

#include "common.h"

namespace {

constexpr int PT = 256;       // threads of the P1 CTA
constexpr int PW = PT / 32;   // warps of the P1 CTA
constexpr int LANES = 8;      // lane padding of P1's (N, 8) and (8, P) arrays
constexpr int CT = 256;       // threads of a P2 / P3 CTA
// P1's step size and penalties, fixed in the probe's body as on the TPU
// (tools/bench_epoch_kernel.py:39-41)
constexpr float GAMMA = 3e-3f, L1 = 1e-3f, L2 = 1e-4f;

__global__ void __launch_bounds__(PT) epoch_probe(const int* __restrict__ starts, int T, int B,
                                                  const float* __restrict__ x, int P, int N,
                                                  const float* __restrict__ y,
                                                  const float* __restrict__ wt,
                                                  float* __restrict__ w, float* __restrict__ g_mem,
                                                  float* __restrict__ g_sum) {
  extern __shared__ float sm[];
  float* w_s = sm;           // P
  float* gs_s = sm + P;      // P
  float* gc_s = sm + 2 * P;  // B
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < P; j += PT) {
    w_s[j] = w[j];
    gs_s[j] = g_sum[j];
  }
  __syncthreads();
  const float shrink = 1.f - GAMMA * L2, thr = GAMMA * L1;
  const float fb = (float)B, fn = (float)N;

  for (int t = 0; t < T; ++t) {
    const long long start = starts[t];
    // rows: lp, gradient, gc (one warp each)
    for (int b = warp; b < B; b += PW) {
      const float* xr = x + (start + b) * P;
      float acc = 0.f;
      for (int j = lane; j < P; j += 32) acc = fmaf(xr[j], w_s[j], acc);
      acc = sgd::warp_sum(acc);
      if (lane == 0) {
        const long long r = (start + b) * LANES;
        const float g = (acc - y[r]) * wt[r];
        gc_s[b] = g - g_mem[r];
        g_mem[r] = g;
      }
    }
    __syncthreads();
    // columns: corr, the prox step, g_sum (one thread each)
    for (int j = tid; j < P; j += PT) {
      float corr = 0.f;
      for (int b = 0; b < B; ++b) corr = fmaf(gc_s[b], x[(start + b) * P + j], corr);
      const float wh = w_s[j] * shrink - GAMMA * (corr / fb + gs_s[j]);
      // sign(wh) * max(|wh| - thr, 0), letting a NaN through as jnp does
      const float a = fabsf(wh) - thr;
      w_s[j] = (a > 0.f || isnan(a)) ? copysignf(a, wh) : 0.f;
      gs_s[j] += corr / fn;
    }
    __syncthreads();
  }
  for (int j = tid; j < P; j += PT) {
    w[j] = w_s[j];
    g_sum[j] = gs_s[j];
  }
}

// P2 stage 1: part[tile, j] = sum over the tile's bt rows of head[start + tile*bt + r, j]
__global__ void __launch_bounds__(CT) colsum_tile(const __nv_bfloat16* __restrict__ head, long long start,
                                                  int D, int bt, float* __restrict__ part) {
  const int j2 = blockIdx.x * CT + threadIdx.x;  // column pair
  if (2 * j2 >= D) return;
  const long long row0 = start + (long long)blockIdx.y * bt;
  const __nv_bfloat162* src = reinterpret_cast<const __nv_bfloat162*>(head + row0 * D) + j2;
  const long long stride = D / 2;
  float sx = 0.f, sy = 0.f;
#pragma unroll 8
  for (int r = 0; r < bt; ++r) {
    const float2 v = __bfloat1622float2(src[r * stride]);
    sx += v.x;
    sy += v.y;
  }
  reinterpret_cast<float2*>(part + (long long)blockIdx.y * D)[j2] = make_float2(sx, sy);
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// start the copies of chunk `chunk` (chunk_rows x W bf16 of the CTA's strip)
// into ring slot `slot`; every thread issues its share of 16-byte copies
__device__ __forceinline__ void issue_chunk(__nv_bfloat16* stage, const __nv_bfloat16* head,
                                            long long start, int D, int col0, int chunk_rows, int W,
                                            int slot, int chunk) {
  const int vpr = W / 8;  // 16-byte copies per stage row
  __nv_bfloat16* dst = stage + (size_t)slot * chunk_rows * W;
  const __nv_bfloat16* src = head + (start + (long long)chunk * chunk_rows) * D + col0;
  for (int i = threadIdx.x; i < chunk_rows * vpr; i += CT) {
    const int r = i / vpr, q = i - r * vpr;
    cp_async16(dst + r * W + q * 8, src + (long long)r * D + q * 8);
  }
}

// P3: out[col0 + c] for the CTA's W-column strip over rows [start, start + B)
template <int NBUF>
__global__ void __launch_bounds__(CT) colsum_pipelined(const __nv_bfloat16* __restrict__ head,
                                                       long long start, int D, int B, int chunk_rows,
                                                       int W, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float2* red = reinterpret_cast<float2*>(smem_raw + (size_t)NBUF * chunk_rows * W * 2);  // CT
  const int col0 = blockIdx.x * W;
  const int n_chunks = B / chunk_rows;
  for (int s = 0; s < NBUF; ++s) {
    if (s < n_chunks) issue_chunk(stage, head, start, D, col0, chunk_rows, W, s, s);
    cp_async_commit();
  }
  const int pairs = W / 2;          // W is a power of two in [8, 512]: pairs divides CT
  const int groups = CT / pairs;
  const int pair = threadIdx.x % pairs, grp = threadIdx.x / pairs;
  float sx = 0.f, sy = 0.f;
  for (int i = 0; i < n_chunks; ++i) {
    const int slot = i % NBUF;
    cp_async_wait<NBUF - 1>();  // this thread's copies of chunk i have landed
    __syncthreads();            // ... and every other thread's
    const __nv_bfloat162* src =
        reinterpret_cast<const __nv_bfloat162*>(stage + (size_t)slot * chunk_rows * W) + pair;
    for (int r = grp; r < chunk_rows; r += groups) {
      const float2 v = __bfloat1622float2(src[r * pairs]);
      sx += v.x;
      sy += v.y;
    }
    __syncthreads();  // the slot is read: refill it
    if (i + NBUF < n_chunks) issue_chunk(stage, head, start, D, col0, chunk_rows, W, slot, i + NBUF);
    cp_async_commit();
  }
  red[threadIdx.x] = make_float2(sx, sy);
  __syncthreads();
  if (threadIdx.x < pairs) {
    float ax = 0.f, ay = 0.f;
    for (int g = 0; g < groups; ++g) {
      const float2 v = red[g * pairs + threadIdx.x];
      ax += v.x;
      ay += v.y;
    }
    reinterpret_cast<float2*>(out + col0)[threadIdx.x] = make_float2(ax, ay);
  }
}

template <int NBUF>
cudaError_t launch_pipelined(const __nv_bfloat16* head, long long start, int D, int B, int chunk_rows,
                             int W, float* out, cudaStream_t s) {
  const size_t smem = (size_t)NBUF * chunk_rows * W * 2 + CT * sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(colsum_pipelined<NBUF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  colsum_pipelined<NBUF><<<D / W, CT, smem, s>>>(head, start, D, B, chunk_rows, W, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// P1: one epoch over the T block starts; w, g_mem, g_sum updated in place.
// x (N, P), y / wt / g_mem (N, 8), w / g_sum (8, P), all f32.  Returns a
// cudaError_t (0 = launched).
int sgd_epoch_probe(const int* starts, int T, int B, const float* x, int P, int N, const float* y,
                    const float* wt, float* w, float* g_mem, float* g_sum, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (size_t)(2 * P + B);
  cudaError_t e = cudaFuncSetAttribute(epoch_probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  epoch_probe<<<1, PT, smem, s>>>(starts, T, B, x, P, N, y, wt, w, g_mem, g_sum);
  return cudaGetLastError();
}

// P2: out (D,) f32 = column sums of head[start : start + B] of a bf16 (n, D)
// head, D even; part is a (B / bt, D) f32 scratch.
int sgd_block_colsum(const void* head, long long start, int D, int B, int bt, float* part, float* out,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((D / 2 + CT - 1) / CT), (unsigned)(B / bt));
  colsum_tile<<<grid, CT, 0, s>>>(static_cast<const __nv_bfloat16*>(head), start, D, bt, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return sgd::launch_sum_partials(part, B / bt, D, out, s);
}

// P3: the same sums through a ring of n_buf (2, 4 or 8) cp.async stages of
// chunk_rows x W bf16; W a power of two in [8, 512] dividing D, head
// 16-byte aligned, D % 8 == 0, chunk_rows dividing B.
int sgd_block_colsum_pipelined(const void* head, long long start, int D, int B, int n_buf, int chunk_rows,
                               int W, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* h = static_cast<const __nv_bfloat16*>(head);
  switch (n_buf) {
    case 2: return launch_pipelined<2>(h, start, D, B, chunk_rows, W, out, s);
    case 4: return launch_pipelined<4>(h, start, D, B, chunk_rows, W, out, s);
    case 8: return launch_pipelined<8>(h, start, D, B, chunk_rows, W, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
