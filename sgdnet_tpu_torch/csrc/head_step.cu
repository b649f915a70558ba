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
// What bounds it: bytes.  At the resident shapes (f32 D 784 k 10 B 4096; bf16
// D 16384 k 1 B 8192) the 4 B D k operations are 2x and 10x under the time
// the B x D block takes at 3.35 TB/s, so the block read is the floor and
// CUDA-core FMAs are enough; tensor cores would not move it.  Both products
// need every row, and corr needs gc, which needs the row's whole lp: the
// design keeps a row tile in shared memory between the two products, so each
// byte of the block comes from device memory once.
//
// `head_step_resident` (the design; solver/head_kernel.py `plan` picks its
// parameters):
//   * D is split into C column strips of W columns, one CTA of a thread
//     block cluster each (C = 1 when a row tile fits one CTA: the f32 shape;
//     C = 8 strips of 2048 bf16 columns at D 16384);
//   * a cluster walks `tpc` consecutive tiles of bt rows: a persistent
//     grid of as many clusters as the card holds at once.  Tiles are copied
//     into a ring of S stages with cp.async, 16 bytes a thread (4 or 2
//     bytes where a row of the head is not 16-byte aligned).  A tile's
//     steps depend on each other (lp before gc before corr, with a cluster
//     barrier between), so what hides their latency is other CTAs on the
//     same SM: `plan` prefers the shape that puts most CTAs on an SM (at
//     slice C's shape three of 70 KB, S = 1, 43 clusters x 12 tiles) over a
//     deeper ring in one;
//   * w's strip is staged once per CTA, rounded once to the head's type;
//   * phase 1: the CTA's 8 warps are row pairs (x two column segments on an
//     8-row tile); a warp sums its part of lp for its two rows, 16 bytes a
//     lane, in independent FMA chains; the parts of all C strips meet
//     through distributed shared memory after a cluster barrier and every
//     CTA adds them in rank and segment order, so each holds the tile's lp;
//   * the gradient and gc (rank 0 writes g); gc stays in shared memory.  An
//     elementwise family's gradient is taken by the thread that added lp; a
//     multinomial row's softmax by a warp;
//   * phase 2: a thread owns 16 bytes of columns and adds gc^T tile into its
//     accumulators from the SAME staged tile: registers across all of the
//     cluster's tiles where k fits one class chunk, else a (k, W) f32 array
//     in shared memory updated per class chunk;
//   * each cluster writes one (k, D) partial; `sum_partials` adds the
//     partials in a fixed order.  No atomics anywhere: rows in order within
//     a tile, tiles in order within a cluster, clusters in order.
//
// The streamed design (solver/head_kernel.py `stream_plan`), for the shapes
// whose w strip and corr accumulators no cluster holds (k x D large: 53
// classes of a bf16 head 16384 wide, slice M; CIFAR-100's f32 3072 x 100).
// Its products are 4 B D k operations, 20x the resident shapes': the bf16
// ones run on tensor cores (mma.sync m16n8k16, operands through ldmatrix),
// the f32 ones as register-tiled CUDA-core FMAs in true f32 (never TF32).
// Three launches, no (k, D) partial anywhere and no float atomics:
//   * `head_round_w`: w rounded once to the head's type, into a (kp, Dw)
//     scratch whose pad classes and columns are zero (kp = k rounded up to
//     16, the mma's tile);
//   * `head_step_streamed`: lp = head_b w^T, the gradient and gc.  A
//     cluster of C CTAs owns a 128-row tile; CTA r streams its run of
//     BK-column chunks of the tile and of w through a 4-stage cp.async
//     ring (zero-filled past B and D) and keeps the tile's lp part in
//     registers (mma fragments: a warp 16 rows x kp classes; f32: a thread
//     4 rows x kp / 8 classes); the C parts meet over distributed shared
//     memory, added in rank order; CTA r then owns 128 / C rows: a warp a
//     row takes the softmax (pad classes never enter it) and writes g and
//     gc, rounded to the head's type, into a (Bp, kp) scratch (zero past k
//     and B);
//   * `head_corr_streamed`: corr = gc^T head_b.  A cluster of R CTAs owns
//     a 128-column strip of D; CTA r streams its run of BR-row chunks of
//     the strip and of gc through the same kind of ring and keeps the (kp, 128)
//     strip of corr in registers across all its rows; the R parts meet
//     over distributed shared memory in rank order and corr is written
//     once.
// The block is read twice, once a kernel: the single read needs every
// column strip's part of a row's lp before that row's gc (a grid-wide
// exchange and barrier a panel of rows), the cost the two-read design
// trades for two independent launches; PERF.md has the numbers.
//
// Templated on the head type: f32 runs plain FP32 FMAs (never TF32); bf16
// loads bf16, casts w and gc to bf16 exactly as the Pallas kernel does,
// and accumulates in f32.

#include <cooperative_groups.h>

#include <algorithm>

#include "common.h"

namespace cg = cooperative_groups;

namespace {

constexpr int HT = 256;        // threads of a CTA
constexpr int HW = HT / 32;    // its warps
constexpr int MAX_C = 8;       // CTAs of a cluster, at most
constexpr int KC1 = 4;         // classes per chunk in phase 1 (k > 1)

struct HeadArgs {
  const void* head;
  long long start;
  int D, k, bt, C, W, S, tpc, n_tiles, copy_bytes, single, family;
  const float *w, *lpe, *yb, *gm, *wb;
  float *g_out, *part;
};

// ---- 16-byte vectors of the head's type, as floats ----

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ void load_vec(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x, o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_head_type(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_head_type(float v, __nv_bfloat16) { return __float2bfloat16(v); }

// ---- cp.async ----

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most `n` of this thread's commit groups are pending (n <= 3)
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// start the copy of the bt x ws strip of one tile into a ring stage whose
// rows are Wp elements apart.  copy_bytes: 16 (rows 16-byte aligned), 4
// (4-byte aligned) or 2 (a bf16 head with odd D: plain loads and stores,
// made visible by the barrier that follows the wait).
template <typename T>
__device__ __forceinline__ void issue_tile(T* stage, const T* src, int D, int bt, int ws, int Wp,
                                           int copy_bytes) {
  if (copy_bytes == 16) {
    constexpr int VE = Vec<T>::N;
    const int vpr = ws / VE;
    for (int i = threadIdx.x; i < bt * vpr; i += blockDim.x) {
      const int r = i / vpr, q = i - r * vpr;
      cp_async<16>(stage + r * Wp + q * VE, src + (long long)r * D + q * VE);
    }
  } else if (copy_bytes == 4) {
    constexpr int PE = 4 / (int)sizeof(T);  // elements per 4-byte copy
    const int vpr = ws / PE;
    for (int i = threadIdx.x; i < bt * vpr; i += blockDim.x) {
      const int r = i / vpr, q = i - r * vpr;
      cp_async<4>(stage + r * Wp + q * PE, src + (long long)r * D + q * PE);
    }
  } else {
    for (int i = threadIdx.x; i < bt * ws; i += blockDim.x) {
      const int r = i / ws, q = i - r * ws;
      stage[r * Wp + q] = src[(long long)r * D + q];
    }
  }
}

// gc^T tile for one 16-byte column vector and one class chunk: rows in order
template <typename T, int KC>
__device__ __forceinline__ void add_rows(float (&acc)[Vec<T>::N][KC], const T* xcol, int Wp, int bt,
                                         const float* gc_s, int k, int c0) {
  constexpr int VE = Vec<T>::N;
  const int kc = min(KC, k - c0);
#pragma unroll 4
  for (int r = 0; r < bt; ++r) {
    float xv[VE];
    load_vec(xcol + r * Wp, xv);
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (c < kc) {
        const float gv = gc_s[r * k + c0 + c];
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[e][c] = fmaf(gv, xv[e], acc[e][c]);
      }
    }
  }
}

// the gradient of one tile row from its lp (a whole warp per row: lanes
// over classes); writes g (write_g) and gc rounded to the head's type T,
// stored as G (f32 in shared memory, or T in the streamed kernels' scratch)
template <typename T, typename A, typename G>
__device__ __forceinline__ void row_gradient(const A& a, int rb, const float* lp_r, G* gc_r, bool write_g,
                                             int lane) {
  const int k = a.k;
  float m = 0.f, denom = 1.f;
  if (a.family == sgd::MULTINOMIAL) {
    m = -INFINITY;
    for (int c = lane; c < k; c += 32) m = fmaxf(m, lp_r[c]);
    m = sgd::warp_max(m);
    float s = 0.f;
    for (int c = lane; c < k; c += 32) s += expf(lp_r[c] - m);
    denom = sgd::warp_sum(s);
  }
  const float wr = a.wb[rb];
  for (int c = lane; c < k; c += 32) {
    const float lp = lp_r[c];
    const float y = a.yb[(long long)rb * k + c];
    float g = a.family == sgd::MULTINOMIAL ? expf(lp - m) / denom - y
                                           : sgd::elementwise_gradient(a.family, lp, y, 0.f);
    g *= wr;
    if (write_g) a.g_out[(long long)rb * k + c] = g;
    gc_r[c] = to_head_type(sgd::round_as<T>(g - a.gm[(long long)rb * k + c]), G());
  }
}

// KC: classes a thread's accumulators hold at a time (1 when k == 1)
template <typename T, int KC>
__global__ void __launch_bounds__(HT, KC == 1 ? 3 : 2) head_step_resident(const HeadArgs a) {
  constexpr int VE = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = a.D, k = a.k, bt = a.bt, C = a.C, Wp = a.W, S = a.S;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = C > 1 ? (int)cluster.block_rank() : 0;
  const int q = blockIdx.x / C;              // this cluster
  const int col0 = rank * Wp;                // the strip [col0, col0 + ws)
  const int ws = min(Wp, D - col0);
  const int nvec = (ws + VE - 1) / VE;       // 16-byte vectors of a strip row
  // phase 1: the 8 warps are min(bt / 2, 8) row pairs x nseg column segments
  const int pairs = bt / 2, nseg = max(HW / pairs, 1);
  const int seg = warp / pairs;
  const int vps = (nvec + nseg - 1) / nseg;
  const int v_lo = seg * vps, v_hi = min(v_lo + vps, nvec);

  T* ring = reinterpret_cast<T*>(smem_raw);                         // S x bt x Wp
  T* w_s = ring + (size_t)S * bt * Wp;                              // k x Wp
  float* corr_s = reinterpret_cast<float*>(w_s + (size_t)k * Wp);   // k x Wp unless single
  float* part_s = corr_s + (a.single ? 0 : (size_t)k * Wp);         // 2 x (nseg x bt) x k: this strip's lp
  float* lp_s = part_s + 2 * nseg * bt * k;                            // bt x k
  float* gc_s = lp_s + bt * k;                                      // bt x k

  const int t0 = q * a.tpc, nt = min(a.tpc, a.n_tiles - t0);
  const T* head = static_cast<const T*>(a.head) + a.start * (long long)D + col0;

  // the pad columns [ws, Wp) of every stage row stay zero; no copy writes them
  for (int i = tid; i < S * bt * (Wp - ws); i += HT) {
    const int r = i / (Wp - ws), j = i - r * (Wp - ws);
    ring[r * Wp + ws + j] = to_head_type(0.f, T());
  }
  for (int s = 0; s < S; ++s) {
    if (s < nt) issue_tile(ring + (size_t)s * bt * Wp, head + (long long)(t0 + s) * bt * D, D, bt, ws, Wp, a.copy_bytes);
    cp_async_commit();
  }
  // w's strip, rounded once to the head's type
  for (int i = tid; i < k * Wp; i += HT) {
    const int c = i / Wp, j = i - c * Wp;
    w_s[i] = to_head_type(j < ws ? a.w[(long long)c * D + col0 + j] : 0.f, T());
  }
  if (!a.single)
    for (int i = tid; i < k * Wp; i += HT) corr_s[i] = 0.f;
  float acc[VE][KC];
#pragma unroll
  for (int e = 0; e < VE; ++e)
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[e][c] = 0.f;

  for (int i = 0; i < nt; ++i) {
    const int slot = i % S;
    const T* tile = ring + (size_t)slot * bt * Wp;
    const int r0 = (t0 + i) * bt;            // first batch row of the tile
    float* part = part_s + (i & 1) * nseg * bt * k;
    cp_async_wait_pending(S - 1);            // this thread's copies of tile i have landed
    __syncthreads();                         // ... and every thread's (and w_s, on the first tile)

    // ---- phase 1: this strip's part of lp; a warp sums one segment of two rows ----
    for (int pr = warp % pairs; pr < pairs; pr += HW) {
      constexpr int KP = KC == 1 ? 1 : KC1;  // classes at a time
      constexpr int NCH = KC == 1 ? VE : 2;  // independent FMA chains per (row, class)
      const T* x0 = tile + (2 * pr) * Wp;
      const T* x1 = x0 + Wp;
      for (int c0 = 0; c0 < k; c0 += KP) {
        const int kc = min(KP, k - c0);
        float s0[KP][NCH], s1[KP][NCH];
#pragma unroll
        for (int c = 0; c < KP; ++c)
#pragma unroll
          for (int n = 0; n < NCH; ++n) s0[c][n] = s1[c][n] = 0.f;
        for (int v = v_lo + lane; v < v_hi; v += 32) {
          float a0[VE], a1[VE];
          load_vec(x0 + v * VE, a0);
          load_vec(x1 + v * VE, a1);
#pragma unroll
          for (int c = 0; c < KP; ++c) {
            if (c < kc) {
              float wv[VE];
              load_vec(w_s + (size_t)(c0 + c) * Wp + v * VE, wv);
#pragma unroll
              for (int e = 0; e < VE; ++e) {
                s0[c][e % NCH] = fmaf(a0[e], wv[e], s0[c][e % NCH]);
                s1[c][e % NCH] = fmaf(a1[e], wv[e], s1[c][e % NCH]);
              }
            }
          }
        }
#pragma unroll
        for (int c = 0; c < KP; ++c) {
          if (c < kc) {
            float u0 = s0[c][0], u1 = s1[c][0];
#pragma unroll
            for (int n = 1; n < NCH; ++n) u0 += s0[c][n], u1 += s1[c][n];
            u0 = sgd::warp_sum(u0), u1 = sgd::warp_sum(u1);
            if (lane == 0) {
              part[(seg * bt + 2 * pr) * k + c0 + c] = u0;
              part[(seg * bt + 2 * pr + 1) * k + c0 + c] = u1;
            }
          }
        }
      }
    }
    // ---- the parts meet: every CTA adds them in rank order, segments in order ----
    if (C > 1) cluster.sync(); else __syncthreads();
    for (int j = tid; j < bt * k; j += HT) {
      // all the loads first (remote shared memory is a long way off), then the sum
      float v[MAX_C][2];
      const float extra = a.lpe[(long long)r0 * k + j];
#pragma unroll
      for (int rk = 0; rk < MAX_C; ++rk) {
        if (rk < C) {
          const float* remote = C > 1 ? cluster.map_shared_rank(part, rk) : part;
          v[rk][0] = remote[j];
          v[rk][1] = nseg > 1 ? remote[bt * k + j] : 0.f;
        }
      }
      // an elementwise family's gradient right here: its loads fly with the remote ones
      const long long jb = (long long)r0 * k + j;
      float y = 0.f, gm = 0.f, wr = 0.f;
      if (a.family != sgd::MULTINOMIAL) y = a.yb[jb], gm = a.gm[jb], wr = a.wb[r0 + j / k];
      float lp = 0.f;
#pragma unroll
      for (int rk = 0; rk < MAX_C; ++rk)
        if (rk < C) lp += v[rk][0] + v[rk][1];
      lp += extra;
      if (a.family != sgd::MULTINOMIAL) {
        const float g = sgd::elementwise_gradient(a.family, lp, y, 0.f) * wr;
        if (rank == 0) a.g_out[jb] = g;
        gc_s[j] = sgd::round_as<T>(g - gm);
      } else {
        lp_s[j] = lp;
      }
    }
    __syncthreads();
    if (a.family == sgd::MULTINOMIAL) {  // the softmax needs a row's whole lp: a warp per row
      for (int r = warp; r < bt; r += HW)
        row_gradient<T>(a, r0 + r, lp_s + r * k, gc_s + r * k, rank == 0, lane);
      __syncthreads();
    }

    // ---- phase 2: gc^T tile from the same staged rows ----
    if (a.single) {
      if (tid < nvec) add_rows<T, KC>(acc, tile + tid * VE, Wp, bt, gc_s, k, 0);
    } else {
      for (int v = tid; v < nvec; v += HT) {
        for (int c0 = 0; c0 < k; c0 += KC) {
#pragma unroll
          for (int c = 0; c < KC; ++c)
#pragma unroll
            for (int e = 0; e < VE; ++e) acc[e][c] = c0 + c < k ? corr_s[(c0 + c) * Wp + v * VE + e] : 0.f;
          add_rows<T, KC>(acc, tile + v * VE, Wp, bt, gc_s, k, c0);
#pragma unroll
          for (int c = 0; c < KC; ++c)
            if (c0 + c < k)
#pragma unroll
              for (int e = 0; e < VE; ++e) corr_s[(c0 + c) * Wp + v * VE + e] = acc[e][c];
        }
      }
    }
    __syncthreads();                         // the slot is read: refill it
    if (i + S < nt)
      issue_tile(ring + (size_t)slot * bt * Wp, head + (long long)(t0 + i + S) * bt * D, D, bt, ws, Wp, a.copy_bytes);
    cp_async_commit();
  }

  // ---- this cluster's partial corr, strip by strip ----
  float* out = a.part + (long long)q * k * D + col0;
  if (a.single) {
    if (tid < nvec) {
#pragma unroll
      for (int c = 0; c < KC; ++c)
        if (c < k)
#pragma unroll
          for (int e = 0; e < VE; ++e)
            if (tid * VE + e < ws) out[(long long)c * D + tid * VE + e] = acc[e][c];
    }
  } else {
    for (int i = tid; i < k * ws; i += HT) {
      const int c = i / ws, j = i - c * ws;
      out[(long long)c * D + j] = corr_s[c * Wp + j];
    }
  }
  // no CTA leaves while another may still read its part of lp
  if (C > 1) cluster.sync();
}

// ---- the streamed design ----

constexpr int SBM = 128;      // rows of a head_step_streamed tile: 8 warps x 16
constexpr int SWN = 128;      // columns of a head_corr_streamed strip: 8 warps x 16
constexpr int STAGES = 4;     // ring stages of both (deeper rings measured no faster)
constexpr int MAX_KP = 128;   // classes, padded to 16

// by the head's type: BK columns of an lp stage row (128 bytes), BR rows of
// a corr stage; shared memory rows are padded by 16 bytes, which puts
// ldmatrix's eight row addresses in eight distinct bank groups
template <typename T>
struct Tiles;
template <>
struct Tiles<__nv_bfloat16> {
  static constexpr int BK = 64, BR = 64, PAD = 8;
};
template <>
struct Tiles<float> {
  static constexpr int BK = 32, BR = 32, PAD = 4;
};

struct StreamArgs {
  const void* head;
  long long start;
  int D, k, kp, B, Bp;  // Bp: rows of the gc scratch, 128 x the tiles of B
  int C, n_kc;          // head_step_streamed: CTAs of a cluster, BK-column chunks of D
  int R;                // head_corr_streamed: CTAs of a cluster (the rows cut into R runs)
  int copy_bytes, family;
  const float *w, *lpe, *yb, *gm, *wb;
  float *g_out, *corr;
  void *w_r, *gc;       // (kp, n_kc BK) and (Bp, kp + PAD) of the head's type
};

template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* smem_dst, const void* gmem_src, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int n = valid ? BYTES : 0;  // 0: nothing is read, the destination is zero-filled
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem_src), "r"(n) : "memory");
}

// copy rows [row0, row0 + ROWS) x columns [c0, c0 + COLS) of the block
// into dst (rows ld elements apart), BYTES a copy; zero past the block's B
// rows and past D (a multiple of BYTES / sizeof(T)).  The shape is a
// template so that a thread's rows and columns are shifts of its index
template <int BYTES, int ROWS, int COLS, typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* blk, int row0, int B, int D, int c0) {
  constexpr int PE = BYTES / (int)sizeof(T), VPR = COLS / PE;
  static_assert(ROWS * VPR % HT == 0, "a stage is whole copies of every thread");
#pragma unroll
  for (int j = 0; j < ROWS * VPR / HT; ++j) {
    const int i = threadIdx.x + j * HT, r = i / VPR, q = (i % VPR) * PE;
    const bool ok = row0 + r < B && c0 + q < D;
    const T* src = ok ? blk + (long long)(row0 + r) * D + c0 + q : blk;
    cp_async_zfill<BYTES>(dst + r * ld + q, src, ok);
  }
}

// stage_rows by the widest copy every row start of the head is aligned to
// (`issue_tile`'s copy_bytes: 16, 4, or 2: plain loads and stores, made
// visible by the barrier that follows the wait)
template <int ROWS, int COLS, typename T>
__device__ __forceinline__ void stage_block(T* dst, int ld, const T* blk, int row0, int B, int D, int c0,
                                            int copy_bytes) {
  if (copy_bytes == 16) {
    stage_rows<16, ROWS, COLS>(dst, ld, blk, row0, B, D, c0);
  } else if (copy_bytes == 4) {
    stage_rows<4, ROWS, COLS>(dst, ld, blk, row0, B, D, c0);
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * COLS; i += HT) {
      const int r = i / COLS, q = i % COLS;
      const bool ok = row0 + r < B && c0 + q < D;
      dst[r * ld + q] = ok ? blk[(long long)(row0 + r) * D + c0 + q] : to_head_type(0.f, T());
    }
  }
}

// copy n elements (a multiple of 16 bytes) of a 16-byte aligned scratch
template <typename T>
__device__ __forceinline__ void stage_contiguous(T* dst, const T* src, int n) {
  constexpr int VE = 16 / sizeof(T);
  for (int i = threadIdx.x * VE; i < n; i += HT * VE) cp_async<16>(dst + i, src + i);
}

// copy a rows x COLS tile of a 16-byte aligned scratch (rows lds elements apart)
template <int COLS, typename T>
__device__ __forceinline__ void stage_scratch(T* dst, int ld, const T* src, int lds, int rows) {
  constexpr int VE = 16 / sizeof(T), VPR = COLS / VE;
  for (int i = threadIdx.x; i < rows * VPR; i += HT) {
    const int r = i / VPR, q = (i % VPR) * VE;
    cp_async<16>(dst + r * ld + q, src + (long long)r * lds + q);
  }
}

// ---- tensor cores: ldmatrix and mma.sync m16n8k16, bf16 in, f32 accumulators ----

template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- head_step_streamed's products: lp of a 128-row tile over one BK-column chunk ----
// acc[16][4]: bf16, the warp's 16 rows x kp classes as 16 n8 fragments (row
// g or g + 8, class 8 n + 2 t (+1); g = lane / 4, t = lane % 4); f32, the
// thread's rows ty + 32 i (i < 4) x classes tx + 8 n (ty = tid / 8, tx = tid % 8)

// the fragments of one 16-column step of an lp chunk: A (the warp's 16
// rows, stored [row][column]) and B = w^T (w stored [class][column]), two
// n8 fragments a 16 classes
__device__ __forceinline__ void lp_frags(unsigned (&af)[4], unsigned (&bf)[MAX_KP / 16][4], const __nv_bfloat16* xs,
                                         const __nv_bfloat16* ws, int kk, int kp, int warp, int lane) {
  constexpr int LD = Tiles<__nv_bfloat16>::BK + Tiles<__nv_bfloat16>::PAD;
  ldmatrix_x4<false>(af, xs + (warp * 16 + (lane & 15)) * LD + kk + (lane >> 4) * 8);
#pragma unroll
  for (int np = 0; np < MAX_KP / 16; ++np)
    if (np * 16 < kp)
      ldmatrix_x4<false>(bf[np], ws + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk + ((lane >> 3) & 1) * 8);
}

// the loads of step kk + 16 are issued before the products of step kk:
// each ldmatrix's latency hides behind the previous step's mma
__device__ __forceinline__ void lp_chunk(float (&acc)[16][4], const __nv_bfloat16* xs, const __nv_bfloat16* ws,
                                         int kp, int warp, int lane) {
  constexpr int BK = Tiles<__nv_bfloat16>::BK;
  unsigned af[2][4], bf[2][MAX_KP / 16][4];
  lp_frags(af[0], bf[0], xs, ws, 0, kp, warp, lane);
#pragma unroll
  for (int s = 0; s < BK / 16; ++s) {
    const int cur = s & 1;
    if (s + 1 < BK / 16) lp_frags(af[cur ^ 1], bf[cur ^ 1], xs, ws, (s + 1) * 16, kp, warp, lane);
#pragma unroll
    for (int np = 0; np < MAX_KP / 16; ++np) {
      if (np * 16 < kp) {
        mma_bf16(acc[2 * np], af[cur], bf[cur][np][0], bf[cur][np][1]);
        mma_bf16(acc[2 * np + 1], af[cur], bf[cur][np][2], bf[cur][np][3]);
      }
    }
  }
}

__device__ __forceinline__ void lp_chunk(float (&acc)[16][4], const float* xs, const float* ws, int kp, int warp,
                                         int lane) {
  constexpr int BK = Tiles<float>::BK, LD = BK + Tiles<float>::PAD;
  const int tid = warp * 32 + lane, ty = tid >> 3, tx = tid & 7;
#pragma unroll 4
  for (int kk = 0; kk < BK; ++kk) {
    float xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = xs[(ty + 32 * i) * LD + kk];
#pragma unroll
    for (int n = 0; n < MAX_KP / 8; ++n) {
      if (n * 8 < kp) {
        const float wv = ws[(tx + 8 * n) * LD + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] = fmaf(xv[i], wv, acc[n][i]);
      }
    }
  }
}

// the tile's lp part into part (128 x kp f32)
__device__ __forceinline__ void store_lp(const float (&acc)[16][4], float* part, int kp, int warp, int lane,
                                         __nv_bfloat16) {
  const int r = warp * 16 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < MAX_KP / 8; ++n) {
    if (n * 8 < kp) {
      part[r * kp + 8 * n + c] = acc[n][0];
      part[r * kp + 8 * n + c + 1] = acc[n][1];
      part[(r + 8) * kp + 8 * n + c] = acc[n][2];
      part[(r + 8) * kp + 8 * n + c + 1] = acc[n][3];
    }
  }
}

__device__ __forceinline__ void store_lp(const float (&acc)[16][4], float* part, int kp, int warp, int lane, float) {
  const int tid = warp * 32 + lane, ty = tid >> 3, tx = tid & 7;
#pragma unroll
  for (int n = 0; n < MAX_KP / 8; ++n)
    if (n * 8 < kp)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[(ty + 32 * i) * kp + tx + 8 * n] = acc[n][i];
}

// ---- head_corr_streamed's products: corr's (kp, 128) strip over one BR-row chunk ----
// acc[8][2][4]: bf16, m16 tile m (classes 16 m + g, + 8) x the warp's two n8
// fragments (columns 16 warp + 8 n + 2 t (+1)); f32, the thread's classes
// ty + 16 m x columns 4 tx + 64 n + e (ty = tid / 16, tx = tid % 16)

// the fragments of one 16-row step of a corr chunk: B (the strip's rows,
// stored [row][column]: transposed loads, the warp's 16 columns) and A =
// gc^T (gc stored [row][class]: transposed loads), a 16 classes
__device__ __forceinline__ void corr_frags(unsigned (&bf)[4], unsigned (&af)[MAX_KP / 16][4], const __nv_bfloat16* xs,
                                           const __nv_bfloat16* gs, int kk, int kp, int warp, int lane) {
  constexpr int LDX = SWN + Tiles<__nv_bfloat16>::PAD;
  const int LDG = kp + Tiles<__nv_bfloat16>::PAD;
  ldmatrix_x4<true>(bf, xs + (kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDX + warp * 16 + (lane >> 4) * 8);
#pragma unroll
  for (int m = 0; m < MAX_KP / 16; ++m)
    if (m * 16 < kp)
      ldmatrix_x4<true>(af[m], gs + (kk + (lane >> 4) * 8 + (lane & 7)) * LDG + m * 16 + ((lane >> 3) & 1) * 8);
}

// as lp_chunk: the loads of step kk + 16 before the products of step kk
__device__ __forceinline__ void corr_chunk(float (&acc)[8][2][4], const __nv_bfloat16* xs, const __nv_bfloat16* gs,
                                           int kp, int warp, int lane) {
  constexpr int BR = Tiles<__nv_bfloat16>::BR;
  unsigned bf[2][4], af[2][MAX_KP / 16][4];
  corr_frags(bf[0], af[0], xs, gs, 0, kp, warp, lane);
#pragma unroll
  for (int s = 0; s < BR / 16; ++s) {
    const int cur = s & 1;
    if (s + 1 < BR / 16) corr_frags(bf[cur ^ 1], af[cur ^ 1], xs, gs, (s + 1) * 16, kp, warp, lane);
#pragma unroll
    for (int m = 0; m < MAX_KP / 16; ++m) {
      if (m * 16 < kp) {
        mma_bf16(acc[m][0], af[cur][m], bf[cur][0], bf[cur][1]);
        mma_bf16(acc[m][1], af[cur][m], bf[cur][2], bf[cur][3]);
      }
    }
  }
}

__device__ __forceinline__ void corr_chunk(float (&acc)[8][2][4], const float* xs, const float* gs, int kp, int warp,
                                           int lane) {
  constexpr int BR = Tiles<float>::BR, LDX = SWN + Tiles<float>::PAD;
  const int LDG = kp + Tiles<float>::PAD;
  const int tid = warp * 32 + lane, ty = tid >> 4, tx = tid & 15;
#pragma unroll 2
  for (int r = 0; r < BR; ++r) {
    // 16-byte loads: the thread's columns 4 tx + 64 h + e
    const float4 x0 = *reinterpret_cast<const float4*>(xs + r * LDX + 4 * tx);
    const float4 x1 = *reinterpret_cast<const float4*>(xs + r * LDX + 64 + 4 * tx);
    const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int m = 0; m < MAX_KP / 16; ++m) {
      if (m * 16 < kp) {
        const float gv = gs[r * LDG + ty + 16 * m];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[m][j >> 2][j & 3] = fmaf(gv, xv[j], acc[m][j >> 2][j & 3]);
      }
    }
  }
}

// f(class, column within the strip, value) for each accumulator of corr's strip
template <typename F>
__device__ __forceinline__ void corr_each(const float (&acc)[8][2][4], int kp, int warp, int lane, __nv_bfloat16,
                                          F&& f) {
  const int c = lane >> 2, j = warp * 16 + 2 * (lane & 3);
#pragma unroll
  for (int m = 0; m < MAX_KP / 16; ++m)
    if (m * 16 < kp)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) f(16 * m + c + (e >> 1) * 8, j + 8 * n + (e & 1), acc[m][n][e]);
}

template <typename F>
__device__ __forceinline__ void corr_each(const float (&acc)[8][2][4], int kp, int warp, int lane, float, F&& f) {
  const int tid = warp * 32 + lane, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int m = 0; m < MAX_KP / 16; ++m)
    if (m * 16 < kp)
#pragma unroll
      for (int j = 0; j < 8; ++j) f(ty + 16 * m, 4 * tx + 64 * (j >> 2) + (j & 3), acc[m][j >> 2][j & 3]);
}

// w rounded once to the head's type into the (kp, Dw) scratch, zero past k and D
template <typename T>
__global__ void __launch_bounds__(HT) head_round_w(const float* __restrict__ w, int k, int D, int kp, int Dw,
                                                   T* __restrict__ out) {
  const long long n = (long long)kp * Dw;
  for (long long i = blockIdx.x * (long long)HT + threadIdx.x; i < n; i += (long long)gridDim.x * HT) {
    const int c = (int)(i / Dw), j = (int)(i - (long long)c * Dw);
    out[i] = to_head_type(c < k && j < D ? w[(long long)c * D + j] : 0.f, T());
  }
}

// lp, the gradient and gc of one 128-row tile: a cluster of C CTAs, each a
// run of BK-column chunks; grid = tiles x C
template <typename T>
__global__ void __launch_bounds__(HT, 1) head_step_streamed(const StreamArgs a) {
  constexpr int BK = Tiles<T>::BK, LD = BK + Tiles<T>::PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, kp = a.kp;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = C > 1 ? (int)cluster.block_rank() : 0;
  const int row0 = (blockIdx.x / C) * SBM;                     // the tile's first batch row
  const int kc0 = rank * a.n_kc / C, nk = (rank + 1) * a.n_kc / C - kc0;
  const int Dw = a.n_kc * BK;
  const int stage = (SBM + kp) * LD;                           // a stage: 128 x BK of the head, kp x BK of w
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* lp_s = reinterpret_cast<float*>(ring + (size_t)STAGES * stage);  // (128 / C) x kp: the owned rows' lp
  const T* blk = static_cast<const T*>(a.head) + a.start * (long long)a.D;
  const T* w_r = static_cast<const T*>(a.w_r);

  auto issue = [&](int i) {
    T* st = ring + (size_t)(i % STAGES) * stage;
    const int c0 = (kc0 + i) * BK;
    stage_block<SBM, BK>(st, LD, blk, row0, a.B, a.D, c0, a.copy_bytes);
    stage_scratch<BK>(st + SBM * LD, LD, w_r + c0, Dw, kp);
  };

  float acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) issue(s);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait_pending(STAGES - 2);  // chunk i has landed (this thread's copies) ...
    __syncthreads();                    // ... every thread's, and chunk i - 1's slot is read
    if (i + STAGES - 1 < nk) issue(i + STAGES - 1);
    cp_async_commit();
    const T* xs = ring + (size_t)(i % STAGES) * stage;
    lp_chunk(acc, xs, xs + SBM * LD, kp, warp, lane);
  }
  cp_async_wait_pending(0);
  __syncthreads();

  // ---- the C parts meet: CTA r owns rows [r 128 / C, (r + 1) 128 / C) and adds them in rank order ----
  float* part = reinterpret_cast<float*>(ring);  // 128 x kp: this CTA's part, over the drained ring
  store_lp(acc, part, kp, warp, lane, T());
  if (C > 1) cluster.sync(); else __syncthreads();
  const int own = SBM / C, r_lo = rank * own;
  for (int j = tid; j < own * kp; j += HT) {
    const int r = j / kp, c = j - r * kp, rb = row0 + r_lo + r;
    float v[MAX_C];
#pragma unroll
    for (int rk = 0; rk < MAX_C; ++rk)
      if (rk < C) v[rk] = (C > 1 ? cluster.map_shared_rank(part, rk) : part)[(r_lo + r) * kp + c];
    float lp = 0.f;
#pragma unroll
    for (int rk = 0; rk < MAX_C; ++rk)
      if (rk < C) lp += v[rk];
    if (rb < a.B && c < a.k) lp += a.lpe[(long long)rb * a.k + c];
    lp_s[j] = lp;
  }
  if (C > 1) cluster.sync(); else __syncthreads();  // every part is read: no CTA leaves before

  // ---- the gradient, a warp a row; gc (zero past k and B) into the scratch ----
  T* gc = static_cast<T*>(a.gc);
  for (int r = warp; r < own; r += HW) {
    const int rb = row0 + r_lo + r;
    T* gc_r = gc + (long long)rb * (kp + Tiles<T>::PAD);  // the corr kernel's stage rows, padding and all
    const bool in = rb < a.B;
    if (in) row_gradient<T>(a, rb, lp_s + r * kp, gc_r, true, lane);
    for (int c = (in ? a.k : 0) + lane; c < kp; c += 32) gc_r[c] = to_head_type(0.f, T());
  }
}

// corr's 128-column strip: a cluster of R CTAs, each a run of BR-row
// chunks; grid = strips x R
template <typename T>
__global__ void __launch_bounds__(HT, 1) head_corr_streamed(const StreamArgs a) {
  constexpr int BR = Tiles<T>::BR, LDX = SWN + Tiles<T>::PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = a.R, kp = a.kp, LDG = kp + Tiles<T>::PAD;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = R > 1 ? (int)cluster.block_rank() : 0;
  const int col0 = (blockIdx.x / R) * SWN;
  const int n_ch = a.Bp / BR;
  const int ch0 = rank * n_ch / R, nr = (rank + 1) * n_ch / R - ch0;
  const int stage = BR * (LDX + LDG);          // a stage: BR x 128 of the head, BR x kp of gc
  T* ring = reinterpret_cast<T*>(smem_raw);
  const T* blk = static_cast<const T*>(a.head) + a.start * (long long)a.D;
  const T* gc = static_cast<const T*>(a.gc);

  auto issue = [&](int i) {
    T* st = ring + (size_t)(i % STAGES) * stage;
    const int r0 = (ch0 + i) * BR;
    stage_block<BR, SWN>(st, LDX, blk, r0, a.B, a.D, col0, a.copy_bytes);
    stage_contiguous(st + BR * LDX, gc + (long long)r0 * LDG, BR * LDG);
  };

  float acc[8][2][4];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nr) issue(s);
    cp_async_commit();
  }
  for (int i = 0; i < nr; ++i) {
    cp_async_wait_pending(STAGES - 2);
    __syncthreads();
    if (i + STAGES - 1 < nr) issue(i + STAGES - 1);
    cp_async_commit();
    const T* xs = ring + (size_t)(i % STAGES) * stage;
    corr_chunk(acc, xs, xs + BR * LDX, kp, warp, lane);
  }
  cp_async_wait_pending(0);
  __syncthreads();

  const int D = a.D, k = a.k;
  if (R == 1) {
    corr_each(acc, kp, warp, lane, T(), [&](int c, int j, float v) {
      if (c < k && col0 + j < D) a.corr[(long long)c * D + col0 + j] = v;
    });
    return;
  }
  // ---- the R parts meet in rank order: CTA r adds and writes its share of the strip ----
  float* part = reinterpret_cast<float*>(ring);  // kp x 128, over the drained ring
  corr_each(acc, kp, warp, lane, T(), [&](int c, int j, float v) { part[c * SWN + j] = v; });
  cluster.sync();
  const int n = kp * SWN, lo = rank * n / R, hi = (rank + 1) * n / R;
  for (int e = lo + tid; e < hi; e += HT) {
    const int c = e / SWN, j = e - c * SWN;
    if (c >= k || col0 + j >= D) continue;
    float v[MAX_C];
#pragma unroll
    for (int rk = 0; rk < MAX_C; ++rk)
      if (rk < R) v[rk] = cluster.map_shared_rank(part, rk)[e];
    float s = 0.f;
#pragma unroll
    for (int rk = 0; rk < MAX_C; ++rk)
      if (rk < R) s += v[rk];
    a.corr[(long long)c * D + col0 + j] = s;
  }
  cluster.sync();  // every part is read: no CTA leaves before
}

// a launch of `KERNEL` as a grid of `ctas` CTAs in clusters of `cluster`;
// with max_clusters not null nothing is launched: it receives the number
// of such clusters the card holds at once
template <auto KERNEL, typename Args>
cudaError_t launch_clustered(const Args& a, int ctas, int cluster, size_t smem, cudaStream_t s, int* max_clusters) {
  // the attribute is sticky on a device: set it again only for more
  constexpr int MAX_DEVICES = 64;
  static size_t allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES || smem > allowed[dev]) {
    e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    if (dev < MAX_DEVICES) allowed[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3(HT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters) return cudaOccupancyMaxActiveClusters(max_clusters, KERNEL, &cfg);
  return cudaLaunchKernelEx(&cfg, KERNEL, a);
}

template <typename T>
constexpr int wide_kc() { return 64 / Vec<T>::N; }  // 64 accumulators a thread over 16 bytes of columns

template <typename T>
cudaError_t launch_resident(const HeadArgs& a, int n_parts, size_t smem, float* corr, cudaStream_t s,
                            int* max_clusters) {
  cudaError_t e = a.k == 1
      ? launch_clustered<head_step_resident<T, 1>>(a, n_parts * a.C, a.C, smem, s, max_clusters)
      : launch_clustered<head_step_resident<T, wide_kc<T>()>>(a, n_parts * a.C, a.C, smem, s, max_clusters);
  if (max_clusters || e != cudaSuccess || a.part == corr) return e;
  return sgd::launch_sum_partials(a.part, n_parts, (long long)a.k * a.D, corr, s);
}

template <typename T>
cudaError_t launch_streamed(const StreamArgs& a, size_t smem, size_t smem2, cudaStream_t s, int* max_clusters) {
  const int tiles = a.Bp / SBM, strips = (a.D + SWN - 1) / SWN;
  if (max_clusters) {
    cudaError_t e = launch_clustered<head_step_streamed<T>>(a, tiles * a.C, a.C, smem, s, max_clusters);
    if (e != cudaSuccess) return e;
    return launch_clustered<head_corr_streamed<T>>(a, strips * a.R, a.R, smem2, s, max_clusters + 1);
  }
  const long long n = (long long)a.kp * a.n_kc * Tiles<T>::BK;
  const int grid = (int)std::min<long long>((n + HT - 1) / HT, 1024);
  head_round_w<T><<<grid, HT, 0, s>>>(a.w, a.k, a.D, a.kp, a.n_kc * Tiles<T>::BK, static_cast<T*>(a.w_r));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = launch_clustered<head_step_streamed<T>>(a, tiles * a.C, a.C, smem, s, nullptr);
  if (e != cudaSuccess) return e;
  return launch_clustered<head_corr_streamed<T>>(a, strips * a.R, a.R, smem2, s, nullptr);
}

}  // namespace

extern "C" {

// One fused head step of the resident design with the parameters
// solver/head_kernel.py `plan` chose.  head_dtype: 0 = float32, 1 =
// bfloat16.  C strips of W columns, tiles of bt rows, S ring stages, tpc
// tiles a cluster, n_parts clusters, copy_bytes 16 / 4 / 2, single =
// accumulators in registers.  part is an (n_parts, k, D) f32 scratch, or
// corr itself when n_parts == 1.  Returns a cudaError_t (0 = launched).
// With max_clusters not null nothing is launched: it receives the number
// of clusters of this shape the card holds at once.
int sgd_head_step(const void* head, int head_dtype, long long start, int D, int k, int B, int bt, int C, int W,
                  int S, int tpc, int n_parts, int copy_bytes, int single, int smem_bytes, const float* w,
                  const float* lpe, const float* yb, const float* gm, const float* wb, float* g_out, float* part,
                  float* corr, int family, void* stream, int* max_clusters) {
  const HeadArgs a{head, start, D, k, bt, C, W, S, tpc, B / bt, copy_bytes, single, family,
                   w, lpe, yb, gm, wb, g_out, part};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dtype == 1) return launch_resident<__nv_bfloat16>(a, n_parts, (size_t)smem_bytes, corr, s, max_clusters);
  return launch_resident<float>(a, n_parts, (size_t)smem_bytes, corr, s, max_clusters);
}

// One fused head step of the streamed design (`stream_plan`): kp classes
// padded to 16, lp tiles in clusters of C CTAs over n_kc BK-column chunks,
// corr strips in clusters of R CTAs; smem / smem2 the two kernels' shared memory.  w_r is a (kp, n_kc BK)
// scratch of the head's type, gc a (128 ceil(B / 128), kp + PAD) one
// (PAD: 8 bf16, 4 f32; its pad columns are never read).  With
// max_clusters not null nothing is launched: max_clusters[0] and [1]
// receive the clusters of the lp and the corr kernel the card holds at
// once.
int sgd_head_step_streamed(const void* head, int head_dtype, long long start, int D, int k, int B, int kp, int C,
                           int n_kc, int R, int smem, int smem2, int copy_bytes, const float* w,
                           const float* lpe, const float* yb, const float* gm, const float* wb, float* g_out,
                           float* corr, void* w_r, void* gc, int family, void* stream, int* max_clusters) {
  const StreamArgs a{head, start, D, k, kp, B, (B + SBM - 1) / SBM * SBM, C, n_kc, R, copy_bytes, family,
                     w, lpe, yb, gm, wb, g_out, corr, w_r, gc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dtype == 1) return launch_streamed<__nv_bfloat16>(a, (size_t)smem, (size_t)smem2, s, max_clusters);
  return launch_streamed<float>(a, (size_t)smem, (size_t)smem2, s, max_clusters);
}

}  // extern "C"
