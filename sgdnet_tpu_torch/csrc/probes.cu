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
// L2-resident 2.3 MB dataset, so the epoch is latency-bound; its time is the
// per-step floor of a one-CTA step chain on this card.  The design is K1's
// (csrc/epoch_kernel.cu, solver/epoch_kernel.py `plan`), without K1's
// generality (families, intercept, weights in the divisor, penalty factors,
// offsets, box limits, the refresh and the convergence test), so that P1
// beside K1 at one shape measures what that generality costs a step:
//   * the operands of a step are in shared memory when it starts: block
//     t + 1's and t + 2's rows of x and lane 0 of y and wt land in a ring of
//     S (2 or 3) stages by cp.async while block t is computed, and the start
//     of step t + S rides in a ring of 8 starts the same way;
//   * g_mem's lane of block t + 1's row b is loaded into a register right
//     after block t's row b is stored, by the thread that owns row b (a block
//     that recurs at once reads its fresh value: same thread, program order);
//   * w and g_sum stay in shared memory for the epoch;
//   * the launch's threads, the lanes L of a row (a power of two) and the
//     row groups of the column phase come from K1's `plan`: one warp and
//     __syncwarp at P <= 32, B = 32; at P 128 eight warps, 8 lanes a row
//     and two row groups, with CTA barriers;
//   * one reciprocal each of B and N, multiplied in (no division on the chain).
// Every sum runs in a fixed order (the lane sums of a row meet in a fixed
// xor butterfly), so two runs give identical bits.
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

constexpr int PT_MAX = 512;   // threads of the P1 CTA at most (K1's NTC)
constexpr int P1_RMAX = 4;    // rows a row slot of P1 keeps g_mem of in registers (K1's RMAX)
constexpr int LANES = 8;      // lane padding of P1's (N, 8) and (8, P) arrays
constexpr int CT = 256;       // threads of a P2 / P3 CTA
constexpr int P1_SMEM_LIMIT = 232448;
// P1's step size and penalties, fixed in the probe's body as on the TPU
// (tools/bench_epoch_kernel.py:39-41)
constexpr float GAMMA = 3e-3f, L1 = 1e-3f, L2 = 1e-4f;

// P1's shared memory in floats: the ring's S slots of x, y and wt, w, g_sum,
// gc, the column groups' partials and the ring of 8 starts.
// tools/probe_kernels.py `epoch_probe_smem_floats` is the same expression
// (tests/test_torch_probes.py evaluates this one).
constexpr long p1_smem_floats(long B, long P, long stages, long groups) {
  return /* SMEM-FORMULA */ stages * (B * P + 2 * B) + 2 * P + B + (groups > 1) * groups * P + 8 /* END-FORMULA */;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(PT_MAX) epoch_probe(const int* __restrict__ starts, int T, int B,
                                                      const float* __restrict__ x, int P, int N,
                                                      const float* __restrict__ y, const float* __restrict__ wt,
                                                      float* __restrict__ w, float* __restrict__ g_mem,
                                                      float* __restrict__ g_sum, int L, int groups, int S) {
  extern __shared__ __align__(16) float sm[];
  const int slot_f = B * P + 2 * B;
  float* ring = sm;                // S slots: x (B, P), y (B), wt (B)
  float* w_s = ring + S * slot_f;  // P
  float* gs_s = w_s + P;           // P
  float* gc_s = gs_s + P;          // B
  float* part_s = gc_s + B;        // groups x P (groups > 1)
  int* st_s = reinterpret_cast<int*>(part_s + (groups > 1 ? groups * P : 0));  // 8
  const int nts = blockDim.x, tid = threadIdx.x;
  const int NS = nts / L, rs = tid / L, q = tid & (L - 1);
  const int R = (B + NS - 1) / NS;
  const float shrink = 1.f - GAMMA * L2, thr = GAMMA * L1;
  const float inv_b = 1.f / (float)B, inv_n = 1.f / (float)N;

  for (int j = tid; j < P; j += nts) {
    w_s[j] = w[j];
    gs_s[j] = g_sum[j];
  }
  if (tid < S && tid < T) st_s[tid] = starts[tid];
  __syncthreads();

  // group m copies block m into ring slot `slot` and the start of step m + S
  auto issue = [&](int m, int slot) {
    if (m < T) {
      const long long start = st_s[m & 7];
      float* sl = ring + slot * slot_f;
      const float* xs = x + start * P;
      for (int i = tid; i < B * P / 4; i += nts) cp_async16(sl + 4 * i, xs + 4 * i);
      for (int b = tid; b < B; b += nts) {
        cp_async4(sl + B * P + b, y + (start + b) * LANES);
        cp_async4(sl + B * P + B + b, wt + (start + b) * LANES);
      }
      if (tid == 0 && m + S < T) cp_async4(st_s + ((m + S) & 7), starts + m + S);
    }
    cp_async_commit();
  };
  auto wait_ring = [&]() {  // step t + 1's group has landed (at most S - 2 pending)
    if (S == 2)
      cp_async_wait<0>();
    else
      cp_async_wait<1>();
  };
  auto barrier = [&]() {
    if (nts == 32)
      __syncwarp();
    else
      __syncthreads();
  };

  for (int m = 0; m < S - 1; ++m) issue(m, m);
  wait_ring();
  __syncthreads();

  float gm[P1_RMAX];  // this thread's g_mem rows of the current step
  if (q == 0 && T > 0) {
#pragma unroll
    for (int i = 0; i < P1_RMAX; ++i) {
      const int b = rs + i * NS;
      if (i < R && b < B) gm[i] = g_mem[((long long)st_s[0] + b) * LANES];
    }
  }
  int cur = 0, prev = S - 1;  // the ring slots of this step and of the one before
  for (int t = 0; t < T; ++t) {
    const long long start = st_s[t & 7];
    const float* xb = ring + cur * slot_f;
    const float* yb = xb + B * P;
    const float* wb = yb + B;
    issue(t + S - 1, prev);

    // ---- row phase: lp (L lanes a row), the gradient, gc; g_mem updated ----
#pragma unroll
    for (int i = 0; i < P1_RMAX; ++i) {
      if (i < R) {
        const int b = rs + i * NS;
        const bool valid = b < B;
        const float* xr = xb + (valid ? b : 0) * P;
        float acc = 0.f;
#pragma unroll 4
        for (int j = 4 * q; j < P; j += 4 * L) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + j);
          const float4 wv = *reinterpret_cast<const float4*>(w_s + j);
          acc = fmaf(xv.x, wv.x, acc);
          acc = fmaf(xv.y, wv.y, acc);
          acc = fmaf(xv.z, wv.z, acc);
          acc = fmaf(xv.w, wv.w, acc);
        }
        for (int o = L >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(sgd::FULL_MASK, acc, o);
        if (q == 0 && valid) {
          const float g = (acc - yb[b]) * wb[b];
          float* gmr = g_mem + (start + b) * LANES;
          gc_s[b] = g - gm[i];
          *gmr = g;
          // the next step's row b, loaded after this store by the same thread
          if (t + 1 < T) gm[i] = g_mem[((long long)st_s[(t + 1) & 7] + b) * LANES];
        }
      }
    }
    barrier();

    // ---- column phase: corr = gc^T x_b, then decay, prox, g_sum ----
    if (groups == 1) {
      for (int j = tid; j < P; j += nts) {
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        int b = 0;
        for (; b + 4 <= B; b += 4) {
          a0 = fmaf(gc_s[b], xb[b * P + j], a0);
          a1 = fmaf(gc_s[b + 1], xb[(b + 1) * P + j], a1);
          a2 = fmaf(gc_s[b + 2], xb[(b + 2) * P + j], a2);
          a3 = fmaf(gc_s[b + 3], xb[(b + 3) * P + j], a3);
        }
        for (; b < B; ++b) a0 = fmaf(gc_s[b], xb[b * P + j], a0);
        const float corr = (a0 + a1) + (a2 + a3);
        const float wh = w_s[j] * shrink - GAMMA * (corr * inv_b + gs_s[j]);
        // sign(wh) * max(|wh| - thr, 0), letting a NaN through as jnp does
        const float a = fabsf(wh) - thr;
        w_s[j] = (a > 0.f || isnan(a)) ? copysignf(a, wh) : 0.f;
        gs_s[j] += corr * inv_n;
      }
    } else {
      for (int it = tid; it < groups * P; it += nts) {
        const int gi = it / P, j = it - gi * P;
        float acc = 0.f;
#pragma unroll 4
        for (int b = gi; b < B; b += groups) acc = fmaf(gc_s[b], xb[b * P + j], acc);
        part_s[gi * P + j] = acc;
      }
      barrier();
      for (int j = tid; j < P; j += nts) {
        float corr = 0.f;
        for (int gi = 0; gi < groups; ++gi) corr += part_s[gi * P + j];
        const float wh = w_s[j] * shrink - GAMMA * (corr * inv_b + gs_s[j]);
        const float a = fabsf(wh) - thr;
        w_s[j] = (a > 0.f || isnan(a)) ? copysignf(a, wh) : 0.f;
        gs_s[j] += corr * inv_n;
      }
    }
    wait_ring();  // step t + 1's block and start have landed
    barrier();
    prev = cur;
    cur = cur + 1 == S ? 0 : cur + 1;
  }
  for (int j = tid; j < P; j += nts) {
    w[j] = w_s[j];
    g_sum[j] = gs_s[j];
  }
  cp_async_wait<0>();
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
// x (N, P), y / wt / g_mem (N, 8), w / g_sum (8, P), all f32, x 16-byte
// aligned with P % 4 == 0 and B even (every ring slot starts on 16 bytes);
// `threads`, `lanes` and `groups` from K1's plan, `stages` 2 or 3.  Returns a cudaError_t (0 = launched).
int sgd_epoch_probe(const int* starts, int T, int B, const float* x, int P, int N, const float* y,
                    const float* wt, float* w, float* g_mem, float* g_sum, int threads, int lanes, int groups,
                    int stages, void* stream) {
  const int NS = lanes > 0 ? threads / lanes : 0;
  const bool ok = threads >= 32 && threads <= PT_MAX && threads % 32 == 0 && lanes >= 1 && lanes <= 32
                  && (lanes & (lanes - 1)) == 0 && groups >= 1 && (stages == 2 || stages == 3) && P % 4 == 0
                  && B >= 2 && B % 2 == 0 && (B + NS - 1) / NS <= P1_RMAX;
  if (!ok) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * p1_smem_floats(B, P, stages, groups);
  if (smem > (size_t)P1_SMEM_LIMIT) return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(epoch_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, P1_SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  epoch_probe<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(starts, T, B, x, P, N, y, wt, w, g_mem,
                                                                        g_sum, lanes, groups, stages);
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
