// Whole-SAGA-epoch kernel for Hopper (sm_90a), K1 of the port.
//
// Replaces sgdnet_tpu/solver/epoch_kernel.py `build` -> pallas_call (body
// `_make_kernel`, `_gradient`, `_prox`).  One launch runs up to E epochs of
// one lambda attempt: every batched SAGA step of each epoch over its T
// block starts, the exact g_sum refresh at the epochs the cadence names,
// and after each epoch the convergence statistics of solver/saga.py
// `fit_one` (max |w - w_epoch_start|, max |w|, whether w and the intercept
// are finite).  It stops after the first epoch at which the host's rule
// would stop, and returns the epochs it ran and that epoch's statistics.
//
// What bounds it: latency.  Step t + 1 reads the w that step t wrote, so
// the epoch is a chain of T steps of a few hundred FMAs each (abalone: 32
// rows x 9 columns); bytes and FLOPs are thousands of times under the
// chain's time.  The design shortens the chain:
//   * the operands of a step are already in shared memory when it starts:
//     rows of x (an x of the kernel's own, rows p rounded up to 4 floats),
//     y, weights and offsets of block t + 1 (and t + 2) are copied with
//     16-byte cp.async into a ring of S stages while block t is computed,
//     and the g_mem rows of block t + 1 are loaded into registers right
//     after block t's g_mem store by the thread that owns the same row of
//     the block (so a block that ends epoch e and starts epoch e + 1 reads
//     its fresh g_mem: same thread, program order);
//   * the step runs on as few threads as its shape needs: at B = 32, p <= 32
//     one warp, lane = row for lp, the gradient and gc, a shuffle for the
//     per-class gc sums and the batch weight, lane = column for corr, the
//     decay, the prox and g_sum, and __syncwarp instead of CTA barriers.
//     Wider shapes use more warps (one barrier between the row phase and
//     the column phase, named so the idle warps are not waited for); a row
//     takes L lanes (a power of two) only where p is wide enough to pay
//     for the shuffle reduction, and the column phase splits rows into G
//     groups where there are threads to spare;
//   * nothing on the chain that need not be: ring slots rotate (no integer
//     division), one reciprocal a step (__frcp_rn) instead of divisions,
//     the group-lasso norm only under that penalty;
//   * the kernel is templated on k rounded up to {1, 2, 4, 8}: no work on
//     class lanes that do not exist; the intercept lives in registers of
//     every step thread (each computes the same update);
//   * the refresh and the statistics use all 512 threads of the CTA; the
//     warps that take no part in the steps wait at a barrier meanwhile.
// Variant `l2` takes the shapes whose ring does not fit beside the state
// (large B): the same step with x, y, weights, offsets and g_mem read from
// global memory (L2-resident at the sizes the gate admits), as the earlier
// design did.  Only the k real classes and p real columns of the padded
// state are written, so its pad lanes stay exactly zero.  Every sum runs in
// a fixed order: two launches give the same bits.

#include "common.h"

namespace {

constexpr int KP = 8;          // class lanes of the padded state (PadState)
constexpr int NTC = 512;       // threads of the CTA
constexpr int NWC = NTC / 32;  // its warps
constexpr int RMAX = 4;        // rows a row slot keeps in registers (ring variant)
constexpr int SMEM_LIMIT = 232448;

// The shared-memory plan in floats: the ring, w, g_sum, gc, the column
// groups' partials, the refresh's partials, the per-warp sums, the
// intercept, flags and the ring of 8 block starts.  solver/epoch_kernel.py
// `smem_floats` is the same expression, and a CPU test evaluates the text
// between the markers against it.
constexpr long smem_floats(long KC, long B, long px, long has_offs, long stages, long groups, long rgroups,
                           long nq) {
  return /* SMEM-FORMULA */ stages * (B * px + B * KC + B + has_offs * B * KC) + 2 * KC * px + B * KC
         + (groups > 1) * groups * KC * px + (rgroups > 1) * rgroups * nq * KC * 4 + 16 * (KC + 2) + 2 * KC + 4
         + 8 /* END-FORMULA */;
}

struct Args {
  const int* starts;  // (E, T) block starts (row offsets)
  int E, T, B, n_pad;
  const float* x;  // (n_pad, px) kernel layout, pad columns zero
  int px, p;
  const float *y, *wt, *offs, *pf;  // y, offs: (n_pad, KC); pf: (>= p,)
  float *w, *ivec, *g_mem, *g_sum;  // padded state: (KP, P), (2, KP), (n_pad, KP), (KP, P)
  int P;
  float* wprev;  // (KC * px) scratch: w at the epoch's start
  float* stats;  // out: epochs run, max change, max size, finite
  int k, family, penalty;
  float log_smooth, gamma, l1, l2, w_total, decay;
  int fit_intercept, it0, every;
  float t_conv;
  int nts, lanes, groups, stages;
};

// ---- small vectors of KC floats (rows of g_mem, y, offsets, gc) ----

template <int KC>
__device__ __forceinline__ void load_k(const float* p, float (&v)[KC]) {
  if constexpr (KC == 1) {
    v[0] = p[0];
  } else if constexpr (KC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < KC; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x, v[i + 1] = t.y, v[i + 2] = t.z, v[i + 3] = t.w;
    }
  }
}

template <int KC>
__device__ __forceinline__ void store_k(float* p, const float (&v)[KC]) {
  if constexpr (KC == 1) {
    p[0] = v[0];
  } else if constexpr (KC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < KC; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// ---- cp.async ----

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most `n` (0 or 1) of this thread's commit groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n == 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void copy16(float* dst, const float* src, int n16, int tid, int nts) {
  for (int i = tid; i < n16; i += nts) cp_async16(dst + 4 * i, src + 4 * i);
}

// family gradient on the KC lanes of a row; lanes >= k are zero
template <int KC>
__device__ __forceinline__ void gradient(const Args& a, const float (&lp)[KC], const float (&yv)[KC],
                                         float (&g)[KC]) {
  if (a.family == sgd::MULTINOMIAL) {
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < KC; ++c)
      if (c < a.k) m = fmaxf(m, lp[c]);
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      g[c] = c < a.k ? expf(lp[c] - m) : 0.f;
      s += g[c];
    }
#pragma unroll
    for (int c = 0; c < KC; ++c) g[c] = c < a.k ? g[c] / s - yv[c] : 0.f;
  } else {
#pragma unroll
    for (int c = 0; c < KC; ++c)
      g[c] = c < a.k ? sgd::elementwise_gradient(a.family, lp[c], yv[c], a.log_smooth) : 0.f;
  }
}

// lp of row `xr` for every class: L lanes share the row, each summing every
// L-th 16-byte chunk; a butterfly over the L lanes leaves the sum in all
// of them.  Every lane of the warp must call it (the shuffles).
template <int KC>
__device__ __forceinline__ void row_dot(const float* xr, const float* w_s, int px, int q, int L,
                                        float (&acc)[KC]) {
#pragma unroll
  for (int c = 0; c < KC; ++c) acc[c] = 0.f;
#pragma unroll 4
  for (int j = 4 * q; j < px; j += 4 * L) {
    const float4 xv = *reinterpret_cast<const float4*>(xr + j);
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const float4 wv = *reinterpret_cast<const float4*>(w_s + c * px + j);
      acc[c] = fmaf(xv.x, wv.x, acc[c]);
      acc[c] = fmaf(xv.y, wv.y, acc[c]);
      acc[c] = fmaf(xv.z, wv.z, acc[c]);
      acc[c] = fmaf(xv.w, wv.w, acc[c]);
    }
  }
  for (int o = L >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[c] += __shfl_xor_sync(sgd::FULL_MASK, acc[c], o);
  }
}

// the L2 decay, the prox and the g_sum update of column j, given corr
template <int KC>
__device__ __forceinline__ void update_column(const Args& a, int j, const float (&corr)[KC], float inv_bw,
                                              float inv_w, float* w_s, float* gs_s) {
  const int px = a.px;
  const float pfj = a.pf != nullptr ? a.pf[j] : 1.f;
  const float shrink = 1.f - a.gamma * a.l2 * pfj;
  const float thr = a.gamma * a.l1 * pfj;
  float wh[KC];
  float nrm2 = 0.f;
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    const float ge = corr[c] * inv_bw + gs_s[c * px + j];
    wh[c] = w_s[c * px + j] * shrink - a.gamma * ge;
    nrm2 += wh[c] * wh[c];
  }
  float factor = 1.f;
  if (a.penalty == sgd::GROUP_LASSO) factor = fmaxf(1.f - thr / fmaxf(sqrtf(nrm2), 1e-30f), 0.f);
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    float v = wh[c];
    if (a.penalty == sgd::ELASTIC_NET) {
      // sign(v) * max(|v| - thr, 0), letting a NaN through as the JAX prox
      // does (the divergence guard must see it)
      const float m = fabsf(v) - thr;
      v = (m > 0.f || isnan(m)) ? copysignf(m, v) : 0.f;
    } else if (a.penalty == sgd::GROUP_LASSO) {
      v *= factor;
    }
    w_s[c * px + j] = v;
    gs_s[c * px + j] += corr[c] * inv_w;
  }
}

template <int KC, bool RING>
__global__ void __launch_bounds__(NTC) saga_epochs_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, px = a.px, p = a.p, k = a.k;
  const int S = RING ? a.stages : 0;
  const int slot_f = B * px + B * KC + B + (a.offs != nullptr ? B * KC : 0);
  const int nq = px / 4 + 1, rg = max(1, NWC / nq);
  float* ring = smem;
  float* w_s = ring + S * slot_f;
  float* gs_s = w_s + KC * px;
  float* gc_s = gs_s + KC * px;
  float* part_s = gc_s + B * KC;
  float* rpart = part_s + (a.groups > 1 ? a.groups * KC * px : 0);
  float* red_s = rpart + (rg > 1 ? rg * nq * KC * 4 : 0);
  float* iv_s = red_s + 16 * (KC + 2);
  float* flag_s = iv_s + 2 * KC;
  int* st_s = reinterpret_cast<int*>(flag_s + 4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nts = a.nts, L = a.lanes, NS = nts / L, NWS = nts / 32;
  const int rs = tid / L, q = tid % L;
  const int R = (B + NS - 1) / NS;
  const int n_steps = a.E * a.T;
  // depth of the copy pipeline: the ring's stages, else 3 for the block
  // starts alone; group m copies block m (ring) and the start of step m + D
  const int D = RING ? S : 3;
  const float inv_w = __frcp_rn(a.w_total);

  for (int i = tid; i < KC * px; i += NTC) {
    const int c = i / px, j = i - c * px;
    w_s[i] = a.w[c * a.P + j];
    gs_s[i] = a.g_sum[c * a.P + j];
  }
  if (tid < KC) {
    iv_s[tid] = a.ivec[tid];
    iv_s[KC + tid] = a.ivec[KP + tid];
  }
  if (tid < D && tid < n_steps) st_s[tid] = a.starts[tid];
  __syncthreads();

  // ring slots rotate: step s reads slot s % S, and issues block s + D - 1
  // into the slot step s - 1 read (no integer division on the chain)
  auto issue = [&](int m, int slot_m) {
    if (m < n_steps) {
      if constexpr (RING) {
        const long start = st_s[m & 7];
        float* slot = ring + slot_m * slot_f;
        copy16(slot, a.x + start * px, B * px / 4, tid, nts);
        copy16(slot + B * px, a.y + start * KC, B * KC / 4, tid, nts);
        copy16(slot + B * px + B * KC, a.wt + start, B / 4, tid, nts);
        if (a.offs != nullptr) copy16(slot + B * px + B * KC + B, a.offs + start * KC, B * KC / 4, tid, nts);
      }
      if (tid == 0 && m + D < n_steps) cp_async4(st_s + ((m + D) & 7), a.starts + m + D);
    }
    cp_async_commit();
  };
  auto step_barrier = [&]() {
    if (NWS == 1)
      __syncwarp();
    else
      asm volatile("bar.sync 1, %0;\n" ::"r"(nts) : "memory");
  };

  if (tid < nts) {
    for (int m = 0; m < D - 1; ++m) issue(m, m);
    cp_async_wait(D - 2);
  }
  int cur = 0, prev = D - 1;  // the ring slots of the current step and of the one before
  __syncthreads();

  float gm_pre[RMAX][KC];  // ring: this thread's g_mem rows of the next step
  if (RING && tid < nts && q == 0 && n_steps > 0) {
#pragma unroll
    for (int i = 0; i < RMAX; ++i) {
      const int b = rs + i * NS;
      if (i < R && b < B) load_k<KC>(a.g_mem + ((long)st_s[0] + b) * KP, gm_pre[i]);
    }
  }

  int n_run = 0, fin = 1;
  float mc = 0.f, ms = 0.f;
  for (int e = 0; e < a.E; ++e) {
    for (int i = tid; i < k * p; i += NTC) {
      const int c = i / p, j = i - c * p;
      a.wprev[c * px + j] = w_s[c * px + j];
    }
    __syncthreads();

    if (tid < nts) {
      float iv0[KC], iv1[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) iv0[c] = iv_s[c], iv1[c] = iv_s[KC + c];

      for (int t = 0; t < a.T; ++t) {
        const int s = e * a.T + t;
        const long start = st_s[s & 7];
        const float* slot = RING ? ring + cur * slot_f : nullptr;
        const float* xb = RING ? slot : a.x + start * px;
        const float* yb = RING ? slot + B * px : a.y + start * KC;
        const float* wb = RING ? slot + B * px + B * KC : a.wt + start;
        const float* ob = a.offs == nullptr ? nullptr : RING ? slot + B * px + B * KC + B : a.offs + start * KC;
        issue(s + D - 1, prev);  // the slot that held step s - 1's block

        // ---- row phase: lp, gradient, gc; g_mem updated ----
        float part[KC], partw = 0.f;
#pragma unroll
        for (int c = 0; c < KC; ++c) part[c] = 0.f;
        auto row = [&](int b, float (&gm)[KC], bool prefetch) {
          const bool valid = b < B;
          const int bb = valid ? b : 0;
          float lp[KC], yv[KC], g[KC];
          row_dot<KC>(xb + bb * px, w_s, px, q, L, lp);
          load_k<KC>(yb + bb * KC, yv);
          float ov[KC];
          if (ob != nullptr)
            load_k<KC>(ob + bb * KC, ov);
#pragma unroll
          for (int c = 0; c < KC; ++c) lp[c] += iv0[c] + (ob != nullptr ? ov[c] : 0.f);
          gradient<KC>(a, lp, yv, g);
          if (q == 0 && valid) {
            const float wv = wb[b];
            float* gmr = a.g_mem + (start + b) * KP;
            if (!prefetch) load_k<KC>(gmr, gm);
            float gv[KC], gc[KC];
#pragma unroll
            for (int c = 0; c < KC; ++c) {
              gv[c] = g[c] * wv;
              gc[c] = gv[c] - gm[c];
              part[c] += gc[c];
            }
            partw += wv;
            store_k<KC>(gmr, gv);
            store_k<KC>(gc_s + b * KC, gc);
            // next step's g_mem row, loaded after this store by the same
            // thread: a block that recurs at once reads its fresh values
            if (prefetch && s + 1 < n_steps) load_k<KC>(a.g_mem + ((long)st_s[(s + 1) & 7] + b) * KP, gm);
          }
        };
        if constexpr (RING) {
#pragma unroll
          for (int i = 0; i < RMAX; ++i)
            if (i < R) row(rs + i * NS, gm_pre[i], true);
        } else {
          for (int i = 0; i < R; ++i) {
            float gm[KC];
            row(rs + i * NS, gm, false);
          }
        }

        // ---- per-class gc sums and the batch weight ----
#pragma unroll
        for (int c = 0; c < KC; ++c) part[c] = sgd::warp_sum(part[c]);
        partw = sgd::warp_sum(partw);
        float sums[KC], bw;
        if (NWS == 1) {
#pragma unroll
          for (int c = 0; c < KC; ++c) sums[c] = part[c];
          bw = partw;
          __syncwarp();
        } else {
          if (lane == 0) {
#pragma unroll
            for (int c = 0; c < KC; ++c) red_s[warp * (KC + 1) + c] = part[c];
            red_s[warp * (KC + 1) + KC] = partw;
          }
          step_barrier();
#pragma unroll
          for (int c = 0; c < KC; ++c) sums[c] = 0.f;
          bw = 0.f;
          for (int wi = 0; wi < NWS; ++wi) {
#pragma unroll
            for (int c = 0; c < KC; ++c) sums[c] += red_s[wi * (KC + 1) + c];
            bw += red_s[wi * (KC + 1) + KC];
          }
        }
        // one division a step, taken while the column sums run
        const float inv_bw = __frcp_rn(fmaxf(bw, 1e-12f));

        // ---- column phase: corr = gc^T x_b, then decay, prox, g_sum ----
        if (a.groups == 1) {
          for (int j = tid; j < p; j += nts) {
            // 8 rows an iteration (B % 8 = 0), their loads issued together,
            // into 4 independent sums added in a fixed order
            float acc[4][KC];
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int c = 0; c < KC; ++c) acc[u][c] = 0.f;
            for (int b = 0; b < B; b += 8) {
              float xv[8];
#pragma unroll
              for (int u = 0; u < 8; ++u) xv[u] = xb[(b + u) * px + j];
#pragma unroll
              for (int u = 0; u < 8; ++u)
#pragma unroll
                for (int c = 0; c < KC; ++c) acc[u & 3][c] = fmaf(gc_s[(b + u) * KC + c], xv[u], acc[u & 3][c]);
            }
            float corr[KC];
#pragma unroll
            for (int c = 0; c < KC; ++c) corr[c] = (acc[0][c] + acc[1][c]) + (acc[2][c] + acc[3][c]);
            update_column<KC>(a, j, corr, inv_bw, inv_w, w_s, gs_s);
          }
        } else {
          for (int it = tid; it < a.groups * p; it += nts) {
            const int gi = it / p, j = it - gi * p;
            float acc[KC];
#pragma unroll
            for (int c = 0; c < KC; ++c) acc[c] = 0.f;
#pragma unroll 4
            for (int b = gi; b < B; b += a.groups) {
              const float xv = xb[b * px + j];
#pragma unroll
              for (int c = 0; c < KC; ++c) acc[c] = fmaf(gc_s[b * KC + c], xv, acc[c]);
            }
#pragma unroll
            for (int c = 0; c < KC; ++c) part_s[(gi * KC + c) * px + j] = acc[c];
          }
          step_barrier();
          for (int j = tid; j < p; j += nts) {
            float corr[KC];
#pragma unroll
            for (int c = 0; c < KC; ++c) corr[c] = 0.f;
            for (int gi = 0; gi < a.groups; ++gi) {
#pragma unroll
              for (int c = 0; c < KC; ++c) corr[c] += part_s[(gi * KC + c) * px + j];
            }
            update_column<KC>(a, j, corr, inv_bw, inv_w, w_s, gs_s);
          }
        }
        if (a.fit_intercept) {
#pragma unroll
          for (int c = 0; c < KC; ++c) {
            iv0[c] -= a.gamma * a.decay * (sums[c] * inv_bw + iv1[c]);
            iv1[c] += sums[c] * inv_w;
          }
        }
        cp_async_wait(D - 2);  // step s + 1's block and start have landed
        step_barrier();
        prev = cur;
        cur = cur + 1 == D ? 0 : cur + 1;
      }
      if (tid == 0) {
#pragma unroll
        for (int c = 0; c < KC; ++c) iv_s[c] = iv0[c], iv_s[KC + c] = iv1[c];
      }
    }
    __syncthreads();

    // ---- exact refresh: g_sum = g_mem^T x / W, g_sum_intercept = sum g_mem / W ----
    if (a.every > 0 && (a.it0 + e + 1) % a.every == 0) {
      // a warp owns a 16-byte chunk q of columns (q = nq - 1: the all-ones
      // column of the intercept) over every rg-th 32-row stripe; its lanes
      // walk the rows, and a butterfly sums them
      for (int it = warp; it < nq * rg; it += NWC) {
        const int qc = it % nq, h = it / nq;
        float acc[KC][4];
#pragma unroll
        for (int c = 0; c < KC; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
        const bool ones = qc == nq - 1;
#pragma unroll 4
        for (int r = h * 32 + lane; r < a.n_pad; r += 32 * rg) {
          float gm[KC];
          load_k<KC>(a.g_mem + (long)r * KP, gm);
          if (ones) {
#pragma unroll
            for (int c = 0; c < KC; ++c) acc[c][0] += gm[c];
          } else {
            const float4 xv = *reinterpret_cast<const float4*>(a.x + (long)r * px + 4 * qc);
#pragma unroll
            for (int c = 0; c < KC; ++c) {
              acc[c][0] = fmaf(gm[c], xv.x, acc[c][0]);
              acc[c][1] = fmaf(gm[c], xv.y, acc[c][1]);
              acc[c][2] = fmaf(gm[c], xv.z, acc[c][2]);
              acc[c][3] = fmaf(gm[c], xv.w, acc[c][3]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < KC; ++c)
#pragma unroll
          for (int m = 0; m < 4; ++m) acc[c][m] = sgd::warp_sum(acc[c][m]);
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < KC; ++c)
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              if (rg > 1) {
                rpart[((h * nq + qc) * KC + c) * 4 + m] = acc[c][m];
              } else if (c < k) {
                if (ones && m == 0)
                  iv_s[KC + c] = acc[c][0] * inv_w;
                else if (!ones && 4 * qc + m < p)
                  gs_s[c * px + 4 * qc + m] = acc[c][m] * inv_w;
              }
            }
        }
      }
      __syncthreads();
      if (rg > 1) {
        for (int it = tid; it < nq * KC * 4; it += NTC) {
          const int qc = it / (KC * 4), c = (it / 4) % KC, m = it % 4;
          float s = 0.f;
          for (int h = 0; h < rg; ++h) s += rpart[((h * nq + qc) * KC + c) * 4 + m];
          if (c < k) {
            if (qc == nq - 1 && m == 0)
              iv_s[KC + c] = s * inv_w;
            else if (qc < nq - 1 && 4 * qc + m < p)
              gs_s[c * px + 4 * qc + m] = s * inv_w;
          }
        }
        __syncthreads();
      }
    }

    // ---- convergence statistics (solver/saga.py fit_one) ----
    float dmax = 0.f, amax = 0.f;
    int ok = 1;
    for (int i = tid; i < k * p; i += NTC) {
      const int c = i / p, j = i - c * p;
      const float wv = w_s[c * px + j];
      const float d = fabsf(wv - a.wprev[c * px + j]), m = fabsf(wv);
      // fmaxf drops a NaN where torch.max keeps it: the flag carries it
      ok &= isfinite(d) && isfinite(m);
      dmax = fmaxf(dmax, d);
      amax = fmaxf(amax, m);
    }
    if (tid < k) ok &= isfinite(iv_s[tid]);
    dmax = sgd::warp_max(dmax);
    amax = sgd::warp_max(amax);
    ok = __all_sync(sgd::FULL_MASK, ok);
    if (lane == 0) {
      red_s[warp] = dmax;
      red_s[NWC + warp] = amax;
      red_s[2 * NWC + warp] = ok ? 1.f : 0.f;
    }
    __syncthreads();
    mc = 0.f, ms = 0.f, fin = 1;
    for (int wi = 0; wi < NWC; ++wi) {
      mc = fmaxf(mc, red_s[wi]);
      ms = fmaxf(ms, red_s[NWC + wi]);
      fin &= red_s[2 * NWC + wi] != 0.f;
    }
    n_run = e + 1;
    __syncthreads();  // red_s is the next step's again
    // the host's rule, in f32: all zero, or a relative change within
    // t_conv, or not finite
    const bool done = !fin || (ms == 0.f && mc == 0.f) || (ms != 0.f && mc <= a.t_conv * ms);
    if (done) break;
  }

  for (int i = tid; i < KC * px; i += NTC) {
    const int c = i / px, j = i - c * px;
    if (j < p) {
      a.w[c * a.P + j] = w_s[i];
      a.g_sum[c * a.P + j] = gs_s[i];
    }
  }
  if (tid < KC) {
    a.ivec[tid] = iv_s[tid];
    a.ivec[KP + tid] = iv_s[KC + tid];
  }
  if (tid == 0) {
    a.stats[0] = (float)n_run;
    a.stats[1] = mc;
    a.stats[2] = ms;
    a.stats[3] = fin ? 1.f : 0.f;
  }
  cp_async_wait(0);  // blocks prefetched past the stop
}

template <int KC, bool RING>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t s) {
  // the attribute once per instantiation, at the CTA's limit
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(saga_epochs_kernel<KC, RING>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  saga_epochs_kernel<KC, RING><<<1, NTC, smem, s>>>(a);
  return cudaGetLastError();
}

template <bool RING>
cudaError_t launch_kc(int kc, const Args& a, size_t smem, cudaStream_t s) {
  switch (kc) {
    case 1: return launch<1, RING>(a, smem, s);
    case 2: return launch<2, RING>(a, smem, s);
    case 4: return launch<4, RING>(a, smem, s);
    default: return launch<8, RING>(a, smem, s);
  }
}

}  // namespace

extern "C" {

// Up to E SAGA epochs of one lambda attempt on the padded state (w, ivec,
// g_mem, g_sum updated in place); stats receives the epochs run and the
// last epoch's max |dw|, max |w| and finite flag.  stages 0 is the `l2`
// variant, 2 or 3 the ring's depth.  Returns a cudaError_t (0 = launched).
int sgd_epochs(const int* starts, int E, int T, int B, int n_pad, const float* x, int px, int p,
               const float* y, const float* wt, const float* offs, const float* pf,
               float* w, float* ivec, float* g_mem, float* g_sum, int P, float* wprev, float* stats,
               int k, int kc, int family, int penalty, float log_smooth,
               float gamma, float l1, float l2, float w_total, float decay, int fit_intercept,
               int it0, int every, float t_conv, int nts, int lanes, int groups, int stages, void* stream) {
  const int NS = lanes > 0 ? nts / lanes : 0;
  const bool shape_ok = (kc == 1 || kc == 2 || kc == 4 || kc == 8) && k >= 1 && k <= kc && nts >= 32
                        && nts <= NTC && nts % 32 == 0 && lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0
                        && px % 4 == 0 && px >= p && B % 8 == 0 && groups >= 1
                        && (stages == 0 || ((stages == 2 || stages == 3) && (B + NS - 1) / NS <= RMAX));
  if (!shape_ok) return cudaErrorInvalidValue;
  const int nq = px / 4 + 1, rg = NWC / nq > 1 ? NWC / nq : 1;
  const size_t smem = sizeof(float) * smem_floats(kc, B, px, offs != nullptr, stages, groups, rg, nq);
  if (smem > (size_t)SMEM_LIMIT) return cudaErrorInvalidValue;
  const Args a{starts, E, T, B, n_pad, x, px, p, y, wt, offs, pf, w, ivec, g_mem, g_sum, P, wprev, stats,
               k, family, penalty, log_smooth, gamma, l1, l2, w_total, decay, fit_intercept, it0, every, t_conv,
               nts, lanes, groups, stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return stages == 0 ? launch_kc<false>(kc, a, smem, s) : launch_kc<true>(kc, a, smem, s);
}

const char* sgd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
