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
// of NBUF asynchronous copies of chunk_rows rows each, the counterpart of
// make_async_copy with one DMA semaphore a slot.  The TPU streams whole
// (chunk_rows, D) chunks through one core; an SM holds 227 KB of shared
// memory, so the block is cut into strips of W columns (W a multiple of 16:
// a 32-byte sector a row, the widest whose NBUF stages fit; the last strip
// may be partial) and a strip into C = B / chunk_rows stages of chunk_rows x
// W bf16.  The design:
//   * the grid covers the card evenly: as many CTAs as the SMs hold at once
//     (SM count and CTAs an SM read from the device at launch), each
//     streaming the same number of stages give or take one (p3_stage)
//     through one ring that is filled once and drained once, not at every
//     strip.  In rounds, every CTA streams a whole strip, chunk by chunk,
//     so at any time the card reads one band of rows across adjacent
//     strips; the strips left after the rounds are dealt in contiguous
//     runs;
//   * one producer thread feeds the ring with TMA (cp.async.bulk.tensor.2d
//     against a tensor map of the head; a box spans at most 256 rows, so a
//     512-row chunk is two boxes on one full barrier); 8 consumer warps
//     drain it; a full and an empty mbarrier a slot, and no CTA barrier in
//     the loop.  TMA rather than a 1D cp.async.bulk a row segment: one
//     instruction lands a whole box, where 1D copies are chunk_rows a stage
//     and are served one after another (a build with them, issued from the
//     producer warp's 32 lanes, ran several times slower on the H100); and
//     the map knows the head's shape, so the partial last strip lands
//     zero-filled with the box's full byte count (every stage expects the
//     same bytes) and no box reads past the head.  Each call encodes its map
//     through cudaGetDriverEntryPoint (the library links cudart alone): a
//     fraction of a microsecond of host time, so nothing caches it;
//   * a consumer thread owns 8 columns (a 16-byte load a row) and a residue
//     class of the stage's rows; at the end of a piece (a round's strip, a
//     CTA's run over a leftover strip) its row groups meet in shared memory
//     in a fixed order and the piece's f32 row lands in its row of the
//     partial; a second launch adds a strip's rows in CTA order.  No
//     atomics: two launches give the same bits.
// tools/probe_kernels.py `pipeline_plan` picks W, the grid and the pieces;
// the launcher recomputes and checks them.
//
// What bounds P2 and P3: the B x D bf16 block must cross from device memory
// once (268 MB at the probes' shape), one add per element; bytes bound them.
// What holds P3 below that bound on the H100: its rings of 1024 and 2048
// rows leave a stage row of 192 or 96 bytes within 227 KB, and the card's
// memory serves row segments that narrow, 32 KB apart, below its rate (the
// 96-byte rings are the slowest at the same bytes a stage; a build whose
// consumers skip the adds streams hardly faster).  P2 reads 1 KB of a row
// a CTA.

#include <cuda.h>  // CUtensorMap and its enums (types only: nothing links libcuda)

#include <chrono>
#include <cstdint>

#include "common.h"

namespace {

constexpr int PT_MAX = 512;   // threads of the P1 CTA at most (K1's NTC)
constexpr int P1_RMAX = 4;    // rows a row slot of P1 keeps g_mem of in registers (K1's RMAX)
constexpr int LANES = 8;      // lane padding of P1's (N, 8) and (8, P) arrays
constexpr int CT = 256;       // threads of a P2 CTA
constexpr int P3_CONSUMERS = 256;               // consumer threads of a P3 CTA (8 warps)
constexpr int P3_THREADS = P3_CONSUMERS + 32;   // and its producer warp
constexpr int P3_BOX_MAX = 256;                 // a TMA box spans at most 256 elements a dimension
constexpr long P3_SMEM_LIMIT = 232448;          // one CTA's shared memory (solver/epoch_kernel.py SMEM_LIMIT)
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

// P3's consumer row groups at strip width W: a thread loads 8 columns
constexpr int p3_groups(long W) { return static_cast<int>(P3_CONSUMERS / (W / 8)); }

// P3's shared memory in bytes: NBUF stages of rows x W bf16, the row groups'
// reduction rows (groups x W f32), a full and an empty mbarrier a slot.
// tools/probe_kernels.py `pipeline_smem_bytes` is the same expression
// (tests/test_torch_probes.py evaluates this one).
constexpr long p3_smem_bytes(long n_buf, long rows, long W, long groups) {
  return /* P3-SMEM */ n_buf * rows * W * 2 + groups * W * 4 + n_buf * 16 /* END-P3-SMEM */;
}

// P3's dealing of a block's strips x C stages over G CTAs (tools/probe_kernels.py
// `pipeline_deal`, the same order).  Rounds first: in round i < q = strips / G,
// CTA g streams strip i G + g whole, chunk 0 to C - 1, so the CTAs of the card
// read one row band of adjacent strips at a time.  Then the R = strips - q G
// strips left, strip-major (stage u: chunk u % C of strip q G + u / C), dealt in
// contiguous runs, CTA g taking [R C g / G, R C (g + 1) / G).  A round's strip is
// one piece, in partial row 0; a leftover strip is split over the CTAs whose
// runs meet it, CTA g's piece in row g - (the CTA of the strip's first stage).
struct P3Stage {
  int strip, chunk, row;
  bool ends;  // the piece ends here: its sums land in the partial
};

// the CTA whose run holds leftover stage u of RC, over G CTAs
// (tools/probe_kernels.py `pipeline_cta_of`, the same expression)
__host__ __device__ __forceinline__ int p3_cta_of(long long u, long long RC, int G) {
  return static_cast<int>(/* P3-CTA-OF */ ((u + 1) * G + RC - 1) / RC - 1 /* END-P3-CTA-OF */);
}

// CTA g's k-th stage
__device__ __forceinline__ P3Stage p3_stage(long long k, int g, int G, int q, int R, int C) {
  if (k < (long long)q * C) {
    const int c = static_cast<int>(k % C);
    return {static_cast<int>(k / C) * G + g, c, 0, c == C - 1};
  }
  const long long RC = (long long)R * C, u = RC * g / G + (k - (long long)q * C);
  const int s = static_cast<int>(u / C), c = static_cast<int>(u % C);
  const bool ends = c == C - 1 || u + 1 == RC * (g + 1) / G;
  return {q * G + s, c, g - p3_cta_of((long long)s * C, RC, G), ends};
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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(smem_u32(bar))
               : "memory");
}

// the producer's arrival on a full barrier, with the bytes its copies will land
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed; a wait
// of seconds means a lost phase, and traps (a launch error) instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1LL << 34)) __trap();
  } while (!done);
}

// one TMA box of the head, columns [x, x + W) x rows [y, y + box_rows), into dst
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int x, int y, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// a barrier of the consumer warps alone (the producer never waits on it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(P3_CONSUMERS) : "memory");
}

// P3: CTA g streams its q C + (its run of the R C leftover) stages of the
// block (p3_stage), each of rows x W bf16 from rows start + chunk rows ...,
// and writes each piece's sums to its row of part
template <int NBUF>
__global__ void __launch_bounds__(P3_THREADS, 1)
    colsum_pipelined(const __grid_constant__ CUtensorMap map, long long start, int D, int rows, int W,
                     int box_rows, int C, int q, int R, float* __restrict__ part) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int stage_elems = rows * W, vpr = W / 8, groups = P3_CONSUMERS / vpr;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw + (size_t)NBUF * stage_elems * 2);  // groups x W
  unsigned long long* full = reinterpret_cast<unsigned long long*>(red + groups * W);
  unsigned long long* empty = full + NBUF;
  const int G = gridDim.x, g = blockIdx.x, tid = threadIdx.x;
  const long long n_stages =
      (long long)q * C + (long long)R * C * (g + 1) / G - (long long)R * C * g / G;  // this CTA's
  if (tid == 0) {
    if (smem_u32(smem_raw) % 128 != 0) __trap();  // TMA lands on 128-byte boundaries
    for (int s = 0; s < NBUF; ++s) {
      mbar_init(full + s, 1);                     // the producer's arrival (+ the boxes' bytes)
      mbar_init(empty + s, P3_CONSUMERS / 32);    // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= P3_CONSUMERS) {  // the producer warp: one thread keeps the ring full
    if (tid == P3_CONSUMERS) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<unsigned long long>(&map)) : "memory");
      const unsigned bytes = static_cast<unsigned>(stage_elems) * 2;  // full boxes, zero fill included
      const int boxes = rows / box_rows;
      for (long long k = 0; k < n_stages; ++k) {
        const int slot = static_cast<int>(k % NBUF);
        mbar_wait(empty + slot, static_cast<unsigned>((k / NBUF) & 1) ^ 1u);  // round 0 passes at once
        mbar_arrive_expect_tx(full + slot, bytes);
        const P3Stage st = p3_stage(k, g, G, q, R, C);
        const int col = st.strip * W;
        const long long row = start + (long long)st.chunk * rows;
        __nv_bfloat16* dst = ring + (size_t)slot * stage_elems;
        for (int b = 0; b < boxes; ++b)
          tma_box(dst + (size_t)b * box_rows * W, &map, col, static_cast<int>(row + (long long)b * box_rows),
                  full + slot);
      }
    }
    return;
  }

  // consumers: thread (grp, v) adds columns 8v .. 8v + 7 of rows grp, grp + groups, ...
  const int v = tid % vpr, grp = tid / vpr;
  const bool active = grp < groups;
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  for (long long k = 0; k < n_stages; ++k) {
    const int slot = static_cast<int>(k % NBUF);
    mbar_wait(full + slot, static_cast<unsigned>((k / NBUF) & 1));
    if (active) {
      const uint4* src = reinterpret_cast<const uint4*>(ring + (size_t)slot * stage_elems) + v;
#pragma unroll 4
      for (int r = grp; r < rows; r += groups) {
        const uint4 q = src[r * vpr];
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(h2[i]);
          acc[2 * i] += f.x;
          acc[2 * i + 1] += f.y;
        }
      }
    }
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(empty + slot);  // the warp has read the slot
    const P3Stage st = p3_stage(k, g, G, q, R, C);
    if (st.ends) {  // the piece's row groups meet in order, into its row of the partial
      const int col0 = st.strip * W;
      if (active) {
        float4* dst = reinterpret_cast<float4*>(red + grp * W + v * 8);
        dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = 0.f;
      }
      consumers_sync();
      if (tid < W && col0 + tid < D) {
        float sum = red[tid];
        for (int q = 1; q < groups; ++q) sum += red[q * W + tid];  // the row groups in order
        part[(long long)st.row * D + col0 + tid] = sum;
      }
      consumers_sync();  // red is free for the next piece
    }
  }
}

// P3's second pass: out[j] = the pieces of j's strip added in a fixed
// order (a round's strip: row 0 alone; a leftover strip: its CTAs' rows in
// CTA order)
__global__ void __launch_bounds__(256) colsum_pipelined_pieces(const float* __restrict__ part, long long D, int W,
                                                               int q, int R, int C, int G, float* __restrict__ out) {
  const long long j = blockIdx.x * 256LL + threadIdx.x;
  if (j >= D) return;
  const long long s = j / W - (long long)q * G, RC = (long long)R * C;  // s >= 0: a leftover strip
  const int n = s < 0 ? 1 : p3_cta_of(s * C + C - 1, RC, G) - p3_cta_of(s * C, RC, G) + 1;
  float acc = part[j];
  for (int p = 1; p < n; ++p) acc += part[p * D + j];
  out[j] = acc;
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime
cudaError_t encode_fn(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// the tensor map of a contiguous bf16 (n, D) head read in W x box_rows boxes
// (no swizzle: a box lands row-major, W bf16 a row; columns past D read as 0)
cudaError_t encode_head_map(const void* head, long long n, int D, int W, int box_rows, CUtensorMap* map) {
  EncodeTiledFn fn;
  cudaError_t e = encode_fn(&fn);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {(cuuint32_t)W, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(head), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int NBUF>
cudaError_t launch_pipelined(const CUtensorMap& map, long long start, int D, int rows, int W, int box_rows, int C,
                             int q, int R, int grid, float* part, float* out, cudaStream_t s) {
  const size_t smem = (size_t)p3_smem_bytes(NBUF, rows, W, p3_groups(W));
  cudaError_t e = cudaFuncSetAttribute(colsum_pipelined<NBUF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  colsum_pipelined<NBUF><<<grid, P3_THREADS, smem, s>>>(map, start, D, rows, W, box_rows, C, q, R, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  colsum_pipelined_pieces<<<(unsigned)((D + 255) / 256), 256, 0, s>>>(part, D, W, q, R, C, grid, out);
  return cudaGetLastError();
}

template <int NBUF>
cudaError_t occupancy(int smem, int* ctas) {
  cudaError_t e =
      cudaFuncSetAttribute(colsum_pipelined<NBUF>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, colsum_pipelined<NBUF>, P3_THREADS, smem);
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

// P3: the same sums through a ring of n_buf (2, 4 or 8) TMA stages of
// chunk_rows x W bf16 over a contiguous, 16-byte aligned bf16 (n, D) head,
// D % 8 == 0; W, box_rows, grid and pieces from tools/probe_kernels.py
// `pipeline_plan` (checked here: W a multiple of 16 in [16, 256], boxes of
// box_rows dividing chunk_rows on 128-byte boundaries, the ring within one
// CTA's shared memory, 1 <= grid <= stages, pieces the most CTAs a leftover
// strip is dealt to, 1 without one); part is a (pieces, D) f32 scratch.
int sgd_block_colsum_pipelined(const void* head, long long n, long long start, int D, int B, int n_buf,
                               int chunk_rows, int W, int box_rows, int grid, int pieces, float* part, float* out,
                               void* stream) {
  const bool shape_ok = D >= 8 && D % 8 == 0 && reinterpret_cast<uintptr_t>(head) % 16 == 0 && W >= 16 &&
                        W <= P3_BOX_MAX && W % 16 == 0 && box_rows >= 1 && box_rows <= P3_BOX_MAX &&
                        chunk_rows % box_rows == 0 && (box_rows * W * 2) % 128 == 0 && B >= chunk_rows &&
                        B % chunk_rows == 0 && start >= 0 && start + B <= n && n < (1LL << 31);
  if (!shape_ok || (n_buf != 2 && n_buf != 4 && n_buf != 8)) return cudaErrorInvalidValue;
  if (p3_smem_bytes(n_buf, chunk_rows, W, p3_groups(W)) > P3_SMEM_LIMIT) return cudaErrorInvalidValue;
  const int C = B / chunk_rows, strips = (D + W - 1) / W;
  if (grid < 1 || (long long)grid > (long long)strips * C) return cudaErrorInvalidValue;
  const int q = strips / grid, R = strips - q * grid;
  int most = 1;  // the most CTAs a leftover strip is dealt to
  for (long long s = 0; s < R; ++s) {
    const int k = p3_cta_of(s * C + C - 1, (long long)R * C, grid) - p3_cta_of(s * C, (long long)R * C, grid) + 1;
    most = k > most ? k : most;
  }
  if (pieces != most) return cudaErrorInvalidValue;
  CUtensorMap map;
  cudaError_t e = encode_head_map(head, n, D, W, box_rows, &map);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_buf) {
    case 2: return launch_pipelined<2>(map, start, D, chunk_rows, W, box_rows, C, q, R, grid, part, out, s);
    case 4: return launch_pipelined<4>(map, start, D, chunk_rows, W, box_rows, C, q, R, grid, part, out, s);
    default: return launch_pipelined<8>(map, start, D, chunk_rows, W, box_rows, C, q, R, grid, part, out, s);
  }
}

// P3's CTAs an SM holds at `smem` bytes of shared memory, into *ctas.
int sgd_colsum_pipelined_occupancy(int n_buf, int smem, int* ctas) {
  switch (n_buf) {
    case 2: return occupancy<2>(smem, ctas);
    case 4: return occupancy<4>(smem, ctas);
    case 8: return occupancy<8>(smem, ctas);
    default: return cudaErrorInvalidValue;
  }
}

// Mean host nanoseconds of one tensor-map encode of a P3 head over `reps`,
// into *ns: the host time a call spends on its map.
int sgd_colsum_pipelined_encode_ns(const void* head, long long n, int D, int W, int box_rows, int reps, double* ns) {
  CUtensorMap map;
  cudaError_t e = encode_head_map(head, n, D, W, box_rows, &map);  // resolve the entry point first
  if (e != cudaSuccess || reps < 1) return e != cudaSuccess ? e : cudaErrorInvalidValue;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps && e == cudaSuccess; ++i) e = encode_head_map(head, n, D, W, box_rows, &map);
  *ns = std::chrono::duration<double, std::nano>(std::chrono::steady_clock::now() - t0).count() / reps;
  return e;
}

}  // extern "C"
