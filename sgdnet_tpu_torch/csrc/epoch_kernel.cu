// Whole-SAGA-epoch kernel for Hopper (sm_90a), K1 of the port.
//
// Replaces sgdnet_tpu/solver/epoch_kernel.py `build` -> pallas_call (body
// `_make_kernel`, `_gradient`, `_prox`): one launch runs every batched
// SAGA step of an epoch over T permuted block starts, then a second
// launch recomputes g_sum = g_mem^T x / W exactly.
//
// What bounds it: the steps are strictly sequential (step t+1 reads the w
// that step t wrote), so the epoch is latency-bound, not bandwidth- or
// FLOP-bound: per step it touches B rows of x (B*p floats) and the
// (k, p) state.  The design keeps everything a step needs close to the SM:
//   * one persistent CTA loops over the T steps;
//   * w, g_sum and the intercept vector (KP x P state) live in shared
//     memory for the whole epoch and are written back once at the end;
//   * x, y, weights, offsets and g_mem are read from global memory, which
//     stays L2-resident at the sizes the Python gate admits;
//   * phase A: one warp per batch row computes lp = x_b w^T + b (+offs),
//     the family gradient, gc = g - g_mem[b], and writes g_mem[b] = g;
//   * phase C: one thread per column j sums corr[:, j] = gc^T x_b[:, j]
//     and applies the L2 decay, the prox and the g_sum update in place.
// Only the k real classes and p real columns are touched, so the zero pad
// lanes of the padded state stay exactly zero (the convergence check over
// padded tiles stays valid).  Sums run in a fixed order: deterministic.

#include "common.h"

namespace {

constexpr int KP = 8;           // class lanes of the padded state
constexpr int NT = 512;         // threads of the epoch CTA
constexpr int NW = NT / 32;     // warps of the epoch CTA
constexpr int RT = 256;         // threads of a refresh CTA
constexpr int RW = RT / 32;

__global__ void __launch_bounds__(NT) saga_epoch(
    const int* __restrict__ starts, int T, int B,
    const float* __restrict__ x, int P, int p,
    const float* __restrict__ y, const float* __restrict__ wt,
    const float* __restrict__ offs, const float* __restrict__ pf,
    float* __restrict__ w, float* __restrict__ ivec,
    float* __restrict__ g_mem, float* __restrict__ g_sum,
    int k, int family, int penalty, float log_smooth,
    float gamma, float l1, float l2, float w_total, float decay, int fit_intercept) {
  extern __shared__ float smem[];
  float* w_s = smem;                     // KP * P
  float* gs_s = w_s + KP * P;            // KP * P
  float* gc_s = gs_s + KP * P;           // B * KP
  float* red_s = gc_s + B * KP;          // NW * (KP + 1)
  float* iv_s = red_s + NW * (KP + 1);   // 2 * KP: intercept, g_sum_intercept
  float* sums = iv_s + 2 * KP;           // KP + 1: sum_gc per class, batch weight

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < KP * P; i += NT) {
    w_s[i] = w[i];
    gs_s[i] = g_sum[i];
  }
  if (tid < 2 * KP) iv_s[tid] = ivec[tid];
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const long start = starts[t];

    // ---- phase A: rows (one warp each) ----
    float part[KP + 1];
#pragma unroll
    for (int c = 0; c <= KP; ++c) part[c] = 0.f;
    for (int b = warp; b < B; b += NW) {
      const long row = start + b;
      const float* xr = x + row * P;
      float acc[KP];
#pragma unroll
      for (int c = 0; c < KP; ++c) acc[c] = 0.f;
      for (int j = lane; j < p; j += 32) {
        const float xv = xr[j];
#pragma unroll
        for (int c = 0; c < KP; ++c)
          if (c < k) acc[c] = fmaf(xv, w_s[c * P + j], acc[c]);
      }
      float lp[KP];
#pragma unroll
      for (int c = 0; c < KP; ++c) {
        lp[c] = sgd::warp_sum(acc[c]) + iv_s[c];
        if (offs != nullptr && c < k) lp[c] += offs[row * KP + c];
      }
      float g[KP];
      if (family == sgd::MULTINOMIAL) {
        float m = -INFINITY;
#pragma unroll
        for (int c = 0; c < KP; ++c)
          if (c < k) m = fmaxf(m, lp[c]);
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < KP; ++c) {
          g[c] = c < k ? expf(lp[c] - m) : 0.f;
          s += g[c];
        }
#pragma unroll
        for (int c = 0; c < KP; ++c)
          if (c < k) g[c] = g[c] / s - y[row * KP + c];
      } else {
#pragma unroll
        for (int c = 0; c < KP; ++c)
          if (c < k) g[c] = sgd::elementwise_gradient(family, lp[c], y[row * KP + c], log_smooth);
      }
      if (lane == 0) {
        const float wtb = wt[row];
#pragma unroll
        for (int c = 0; c < KP; ++c) {
          if (c < k) {
            const float gv = g[c] * wtb;
            const float gc = gv - g_mem[row * KP + c];
            g_mem[row * KP + c] = gv;
            gc_s[b * KP + c] = gc;
            part[c] += gc;
          } else {
            gc_s[b * KP + c] = 0.f;
          }
        }
        part[KP] += wtb;
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c <= KP; ++c) red_s[warp * (KP + 1) + c] = part[c];
    }
    __syncthreads();
    if (tid <= KP) {
      float s = 0.f;
      for (int wi = 0; wi < NW; ++wi) s += red_s[wi * (KP + 1) + tid];
      sums[tid] = s;
    }
    __syncthreads();
    const float bw = fmaxf(sums[KP], 1e-12f);

    // ---- phase C: columns (one thread each) ----
    for (int j = tid; j < p; j += NT) {
      float corr[KP];
#pragma unroll
      for (int c = 0; c < KP; ++c) corr[c] = 0.f;
      for (int b = 0; b < B; ++b) {
        const float xv = x[(start + b) * P + j];
#pragma unroll
        for (int c = 0; c < KP; ++c)
          if (c < k) corr[c] = fmaf(gc_s[b * KP + c], xv, corr[c]);
      }
      const float pfj = pf != nullptr ? pf[j] : 1.f;
      const float shrink = 1.f - gamma * l2 * pfj;
      const float thr = gamma * l1 * pfj;
      float wh[KP];
      float nrm2 = 0.f;
#pragma unroll
      for (int c = 0; c < KP; ++c) {
        if (c < k) {
          const float ge = corr[c] / bw + gs_s[c * P + j];
          wh[c] = w_s[c * P + j] * shrink - gamma * ge;
          nrm2 += wh[c] * wh[c];
        }
      }
      const float factor = penalty == sgd::GROUP_LASSO
                               ? fmaxf(1.f - thr / fmaxf(sqrtf(nrm2), 1e-30f), 0.f)
                               : 1.f;
#pragma unroll
      for (int c = 0; c < KP; ++c) {
        if (c < k) {
          float v = wh[c];
          if (penalty == sgd::ELASTIC_NET) {
            // sign(v) * max(|v| - thr, 0), letting a NaN through as the
            // JAX prox does (the divergence guard must see it)
            const float a = fabsf(v) - thr;
            v = (a > 0.f || isnan(a)) ? copysignf(a, v) : 0.f;
          } else if (penalty == sgd::GROUP_LASSO)
            v *= factor;
          w_s[c * P + j] = v;
          gs_s[c * P + j] += corr[c] / w_total;
        }
      }
    }
    if (tid == 0 && fit_intercept) {
      for (int c = 0; c < k; ++c) {
        iv_s[c] -= gamma * decay * (sums[c] / bw + iv_s[KP + c]);
        iv_s[KP + c] += sums[c] / w_total;
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < KP * P; i += NT) {
    w[i] = w_s[i];
    g_sum[i] = gs_s[i];
  }
  if (tid < 2 * KP) ivec[tid] = iv_s[tid];
}

// Epoch-end exact refresh: g_sum[c, j] = sum_r g_mem[r, c] x[r, j] / W and
// ivec[1, c] = sum_r g_mem[r, c] / W.  Each CTA owns 32 columns (one per
// lane, coalesced row reads); column index p is a virtual all-ones column
// that yields the intercept average.  Its 8 warps split the rows and are
// summed in a fixed order.
__global__ void __launch_bounds__(RT) gsum_refresh(
    const float* __restrict__ x, int P, int p, int n_pad,
    const float* __restrict__ g_mem, int k, float w_total,
    float* __restrict__ g_sum, float* __restrict__ ivec) {
  __shared__ float red[RW][KP][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  float acc[KP];
#pragma unroll
  for (int c = 0; c < KP; ++c) acc[c] = 0.f;
  if (j <= p) {
    for (int r = warp; r < n_pad; r += RW) {
      const float xv = j < p ? x[(long)r * P + j] : 1.f;
#pragma unroll
      for (int c = 0; c < KP; ++c)
        if (c < k) acc[c] = fmaf(g_mem[(long)r * KP + c], xv, acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < KP; ++c) red[warp][c][lane] = acc[c];
  __syncthreads();
  if (warp == 0 && j <= p) {
    for (int c = 0; c < k; ++c) {
      float s = 0.f;
      for (int wi = 0; wi < RW; ++wi) s += red[wi][c][lane];
      if (j < p)
        g_sum[c * P + j] = s / w_total;
      else
        ivec[KP + c] = s / w_total;
    }
  }
}

// dynamic shared memory of the epoch CTA; the Python gate
// (solver/epoch_kernel.py smem_bytes) uses the same sum
size_t epoch_smem_bytes(int P, int B) {
  return sizeof(float) * (size_t)(2 * KP * P + B * KP + NW * (KP + 1) + 2 * KP + KP + 1);
}

}  // namespace

extern "C" {

// One SAGA epoch on the padded state (w, ivec, g_mem, g_sum updated in
// place), then the exact g_sum refresh when `refresh` is set.  Returns a
// cudaError_t (0 = launched).
int sgd_epoch(const int* starts, int T, int B, const float* x, int P, int p, int n_pad,
              const float* y, const float* wt, const float* offs, const float* pf,
              float* w, float* ivec, float* g_mem, float* g_sum,
              int k, int family, int penalty, float log_smooth,
              float gamma, float l1, float l2, float w_total, float decay,
              int fit_intercept, int refresh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = epoch_smem_bytes(P, B);
  cudaError_t e = cudaFuncSetAttribute(saga_epoch, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  saga_epoch<<<1, NT, smem, s>>>(starts, T, B, x, P, p, y, wt, offs, pf, w, ivec, g_mem, g_sum,
                                 k, family, penalty, log_smooth, gamma, l1, l2, w_total, decay,
                                 fit_intercept);
  e = cudaGetLastError();
  if (e != cudaSuccess || !refresh) return e;
  gsum_refresh<<<p / 32 + 1, RT, 0, s>>>(x, P, p, n_pad, g_mem, k, w_total, g_sum, ivec);
  return cudaGetLastError();
}

const char* sgd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
