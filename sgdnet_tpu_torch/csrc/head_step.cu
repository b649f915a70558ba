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
// What bounds it: bytes.  At the paths' shapes (f32 D 784 k 10 B 4096; bf16
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
// `head_step_streamed` is the tile kernel for the shapes whose w strip and
// accumulators exceed eight CTAs' shared memory (k x D large): one CTA per
// 32-row tile, w and the tile read through the caches, a partial per tile.
//
// Templated on the head type: f32 runs plain FP32 FMAs (never TF32); bf16
// loads bf16, casts w and gc to bf16 exactly as the Pallas kernel does,
// and accumulates in f32.

#include <cooperative_groups.h>

#include "common.h"

namespace cg = cooperative_groups;

namespace {

constexpr int HT = 256;        // threads of a CTA
constexpr int HW = HT / 32;    // its warps
constexpr int MAX_C = 8;       // CTAs of a cluster, at most
constexpr int KC1 = 4;         // classes per chunk in phase 1 (k > 1)
constexpr int KCS = 8;         // classes per chunk of the streamed kernel

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
// over classes); writes g (rank 0) and gc rounded to the head's type
template <typename T>
__device__ __forceinline__ void row_gradient(const HeadArgs& a, int rb, const float* lp_r, float* gc_r,
                                             bool write_g, int lane) {
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
    gc_r[c] = sgd::round_as<T>(g - a.gm[(long long)rb * k + c]);
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

// One CTA per bt-row tile; w and the tile come through the caches, the tile
// twice.  For the shapes `head_step_resident` cannot hold in shared memory.
template <typename T>
__global__ void __launch_bounds__(HT) head_step_streamed(const HeadArgs a) {
  extern __shared__ float sm[];
  const int D = a.D, k = a.k, bt = a.bt;
  float* lp_s = sm;            // bt * k
  float* gc_s = sm + bt * k;   // bt * k
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x;
  const int r0 = tile * bt;
  const T* head = static_cast<const T*>(a.head);

  for (int r = warp; r < bt; r += HW) {
    const int rb = r0 + r;  // row within the batch
    const T* xr = head + (a.start + rb) * (long long)D;
    for (int c0 = 0; c0 < k; c0 += KCS) {
      float acc[KCS];
#pragma unroll
      for (int c = 0; c < KCS; ++c) acc[c] = 0.f;
      for (int j = lane; j < D; j += 32) {
        const float xv = sgd::to_f32(xr[j]);
#pragma unroll
        for (int c = 0; c < KCS; ++c)
          if (c0 + c < k) acc[c] = fmaf(xv, sgd::round_as<T>(a.w[(long long)(c0 + c) * D + j]), acc[c]);
      }
#pragma unroll
      for (int c = 0; c < KCS; ++c) {
        const float s = sgd::warp_sum(acc[c]);
        if (lane == 0 && c0 + c < k) lp_s[r * k + c0 + c] = s + a.lpe[(long long)rb * k + c0 + c];
      }
    }
    __syncwarp();
    row_gradient<T>(a, rb, lp_s + r * k, gc_s + r * k, true, lane);
  }
  __syncthreads();

  const T* xt = head + (a.start + r0) * (long long)D;
  for (int j = tid; j < D; j += HT) {
    for (int c0 = 0; c0 < k; c0 += KCS) {
      float acc[KCS];
#pragma unroll
      for (int c = 0; c < KCS; ++c) acc[c] = 0.f;
      for (int r = 0; r < bt; ++r) {
        const float xv = sgd::to_f32(xt[(long long)r * D + j]);
#pragma unroll
        for (int c = 0; c < KCS; ++c)
          if (c0 + c < k) acc[c] = fmaf(gc_s[r * k + c0 + c], xv, acc[c]);
      }
#pragma unroll
      for (int c = 0; c < KCS; ++c)
        if (c0 + c < k) a.part[((long long)tile * k + c0 + c) * D + j] = acc[c];
    }
  }
}

template <typename T>
constexpr int wide_kc() { return 64 / Vec<T>::N; }  // 64 accumulators a thread over 16 bytes of columns

template <typename T, int KC>
cudaError_t launch_resident(const HeadArgs& a, int n_clusters, size_t smem, cudaStream_t s,
                            int* max_clusters) {
  auto kernel = head_step_resident<T, KC>;
  // the attribute is sticky on a device: set it again only for more
  constexpr int MAX_DEVICES = 64;
  static size_t allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES || smem > allowed[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    if (dev < MAX_DEVICES) allowed[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_clusters * a.C));
  cfg.blockDim = dim3(HT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters) return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <typename T>
cudaError_t launch(const HeadArgs& a, int resident, int n_parts, size_t smem, float* corr, cudaStream_t s,
                   int* max_clusters) {
  cudaError_t e;
  if (resident) {
    e = a.k == 1 ? launch_resident<T, 1>(a, n_parts, smem, s, max_clusters)
                 : launch_resident<T, wide_kc<T>()>(a, n_parts, smem, s, max_clusters);
    if (max_clusters) return e;
  } else {
    head_step_streamed<T><<<n_parts, HT, smem, s>>>(a);  // 8 bt k <= 32 KB: under the static limit
    e = cudaGetLastError();
  }
  if (e != cudaSuccess || a.part == corr) return e;
  return sgd::launch_sum_partials(a.part, n_parts, (long long)a.k * a.D, corr, s);
}

}  // namespace

extern "C" {

// One fused head step with the parameters solver/head_kernel.py `plan`
// chose.  head_dtype: 0 = float32, 1 = bfloat16.  resident = 1: C strips of
// W columns, tiles of bt rows, S ring stages, tpc tiles a cluster, n_parts
// clusters, copy_bytes 16 / 4 / 2, single = accumulators in registers;
// resident = 0: n_parts tiles of bt rows.  part is an (n_parts, k, D) f32
// scratch, or corr itself when n_parts == 1.  Returns a cudaError_t
// (0 = launched).  With max_clusters not null nothing is launched: it
// receives the number of clusters of this shape the card holds at once.
int sgd_head_step(const void* head, int head_dtype, long long start, int D, int k, int B, int resident,
                  int bt, int C, int W, int S, int tpc, int n_parts, int copy_bytes, int single,
                  int smem_bytes, const float* w, const float* lpe, const float* yb, const float* gm,
                  const float* wb, float* g_out, float* part, float* corr, int family, void* stream,
                  int* max_clusters) {
  const HeadArgs a{head, start, D, k, bt, C, W, S, tpc, B / bt, copy_bytes, single, family,
                   w, lpe, yb, gm, wb, g_out, part};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dtype == 1) return launch<__nv_bfloat16>(a, resident, n_parts, (size_t)smem_bytes, corr, s, max_clusters);
  return launch<float>(a, resident, n_parts, (size_t)smem_bytes, corr, s, max_clusters);
}

}  // extern "C"
