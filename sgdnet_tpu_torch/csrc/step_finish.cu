// The SAGA step's finish for Hopper (sm_90a): K6 of the port.
//
// Replaces no TPU kernel: the JAX package leaves the step's finish
// (sgdnet_tpu/solver/saga.py, the tail of `_step`) to XLA, which fuses it;
// the port's plain version is a chain of ~21 torch ops
// (solver/finish_kernel.py `finish_step_reference`).  For a step's row
// weights wb (B,), gradient change gc (B, k), tail corr (k, p), optional
// head corr (k, D) and the state w, g_sum (k, p), intercept,
// g_sum_intercept (k,):
//
//   bw        = max(sum_b wb[b], 1e-12)             sum_gc[c] = sum_b gc[b, c]
//   corr_jc   = corr[c, j] (+ head[c, j] where j < D)
//   w_half    = w * shrink - gamma * (corr_jc / bw + g_sum)    (pf: w * (1 - gl2 pf_j) - ...)
//   w_new     = prox(w_half)  (Ridge: itself; elastic net: sign(w_half) * max(|w_half| - gl1 (pf_j), 0)),
//               then clamped to [lo, hi] where a box is given
//   g_sum_new = g_sum + corr_jc * (1 / w_total)
//   intercept_new = intercept - gdecay * (sum_gc / bw + g_sum_intercept)
//   g_sum_intercept_new = g_sum_intercept + sum_gc * (1 / w_total)
//
// Every operation rounds once, in the order the chain's torch ops run on
// the card (`__fadd_rn` and friends: nvcc contracts nothing into an FMA), so
// for the same bw the new w and g_sum are the chain's bits.  A division by
// a Python scalar (w_total) is, in PyTorch's CUDA kernel, a product with
// the scalar's reciprocal rounded to the fit's type; a division by bw, a
// device tensor, divides.  The maximum and minimum of the box are
// torch.maximum / minimum's: a NaN operand wins, else fmax / fmin.
//
// What bounds it: bytes.  At k 53, p 47236, D 16384 (the multiclass cell)
// it reads corr, w and g_sum once, the head corr once and gc once, and
// writes w and g_sum once: ~54 MB, ~16 us at 3.35 TB/s.  At k 1 its ~1 MB
// take ~0.3 us and the two launches set its time.  Two launches from one
// C call, no atomics, every sum in a fixed order:
//   * `finish_bw`: one CTA of RT threads; thread t sums wb[t], wb[t + RT],
//     ... in order, and the RT partials meet in a fixed tree in shared
//     memory (`tree_sum`).  bw lands in the caller's output buffer, after
//     the state's parts.
//   * `finish_columns`: its first CTAs (one a class, where the intercept is
//     fitted) sum their class of gc the same way over CT threads and update
//     the intercept; the rest own VEC consecutive columns a thread (16-byte
//     loads where p, D and every operand allow, else one column) and walk
//     CPT classes of them, every load of a warp one contiguous run.  The
//     grid is ceil(p / (VEC CT)) x ceil(k / CPT) column CTAs: ~1300 at
//     k 53, ~90 at k 1, on 132 SMs.

#include <stdint.h>

#include "common.h"

namespace {

constexpr int RT = 1024;  // threads of the bw CTA (solver/finish_kernel.py BW_THREADS)
constexpr int CT = 128;   // threads of an intercept or column CTA (ICPT_THREADS)
constexpr int CPT = 4;    // classes a column thread walks

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float max_of(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_of(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float min_of(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_of(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_of(double a) { return fabs(a); }

// torch.maximum / torch.minimum on the card
template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  return a != a ? a : (b != b ? b : max_of(a, b));
}
template <typename T>
__device__ __forceinline__ T minimum(T a, T b) {
  return a != a ? a : (b != b ? b : min_of(a, b));
}

// 16-byte loads and stores of V consecutive elements (V = 1: one element)
template <typename T>
__device__ __forceinline__ void load(const T* p, T (&v)[1]) { v[0] = *p; }
__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void load(const double* p, double (&v)[2]) {
  const double2 t = *reinterpret_cast<const double2*>(p);
  v[0] = t.x, v[1] = t.y;
}
template <typename T>
__device__ __forceinline__ void store(T* p, const T (&v)[1]) { *p = v[0]; }
__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// red[0] after the CTA's n partials in red[0, n) (n a power of two, at
// most the CTA's threads) are added pairwise in a fixed tree; every
// thread of the CTA calls it, after writing its partial
template <typename T>
__device__ __forceinline__ T tree_sum(T* red, int n) {
  __syncthreads();
  for (int h = n >> 1; h > 0; h >>= 1) {
    if ((int)threadIdx.x < h) red[threadIdx.x] = add_rn(red[threadIdx.x], red[threadIdx.x + h]);
    __syncthreads();
  }
  return red[0];
}

template <typename T>
__global__ void __launch_bounds__(RT) finish_bw(const T* __restrict__ wb, int B, T* __restrict__ bw) {
  __shared__ T red[RT];
  T s = 0;
  for (int r = threadIdx.x; r < B; r += RT) s = add_rn(s, wb[r]);
  red[threadIdx.x] = s;
  s = tree_sum(red, RT);
  // torch.clamp(min=1e-12): a NaN stays NaN
  if (threadIdx.x == 0) bw[0] = s < T(1e-12) ? T(1e-12) : s;
}

template <typename T>
struct Args {
  const T *gc, *corr, *head, *w, *g, *icpt, *gsi, *pf, *lo, *hi, *bw;
  T *w_out, *g_out, *icpt_out, *gsi_out;
  T gamma, shrink, gl1, gl2, gdecay, inv_wt;
  long long p;
  int B, k, D, prox, n_icpt, ncx;
};

// one element of the column part, with corr_jc already merged
template <typename T>
__device__ __forceinline__ void finish_elem(const Args<T>& a, T bw, T cj, T w, T g, T decay, T thr, bool box, T lo,
                                            T hi, T& w_new, T& g_new) {
  const T w_half = sub_rn(mul_rn(w, decay), mul_rn(a.gamma, add_rn(div_rn(cj, bw), g)));
  T v = w_half;
  if (a.prox == sgd::ELASTIC_NET) {
    T m = sub_rn(abs_of(w_half), thr);
    m = m < T(0) ? T(0) : m;  // torch.clamp(min=0): a NaN stays NaN
    v = mul_rn(T((T(0) < w_half) - (w_half < T(0))), m);  // torch.sign(w_half) * m
  }
  if (box) v = minimum(maximum(v, lo), hi);
  w_new = v;
  g_new = add_rn(g, mul_rn(cj, a.inv_wt));
}

template <typename T, int V>
__global__ void __launch_bounds__(CT) finish_columns(const Args<T> a) {
  const T bw = *a.bw;
  int b = blockIdx.x;
  if (b < a.n_icpt) {
    // the intercept of class b: its sum over the batch's rows, in order
    // within a thread, then the fixed tree
    __shared__ T red[CT];
    T s = 0;
    for (int r = threadIdx.x; r < a.B; r += CT) s = add_rn(s, a.gc[(long long)r * a.k + b]);
    red[threadIdx.x] = s;
    s = tree_sum(red, CT);
    if (threadIdx.x == 0) {
      const T ge = add_rn(div_rn(s, bw), a.gsi[b]);
      a.icpt_out[b] = sub_rn(a.icpt[b], mul_rn(a.gdecay, ge));
      a.gsi_out[b] = add_rn(a.gsi[b], mul_rn(s, a.inv_wt));
    }
    return;
  }
  b -= a.n_icpt;
  const long long j0 = ((long long)(b % a.ncx) * CT + threadIdx.x) * V;
  const int c0 = (b / a.ncx) * CPT;
  if (j0 >= a.p) return;
  T decay[V], thr[V];
  if (a.pf != nullptr) {
    T f[V];
    load(a.pf + j0, f);
#pragma unroll
    for (int i = 0; i < V; ++i) decay[i] = sub_rn(T(1), mul_rn(a.gl2, f[i])), thr[i] = mul_rn(a.gl1, f[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) decay[i] = a.shrink, thr[i] = a.gl1;
  }
  const bool in_head = j0 < a.D;  // V divides D: the V columns lie on one side
#pragma unroll
  for (int u = 0; u < CPT; ++u) {
    const int c = c0 + u;
    if (c < a.k) {
      const long long o = (long long)c * a.p + j0;
      T cv[V], wv[V], gv[V], wn[V], gn[V];
      load(a.corr + o, cv);
      load(a.w + o, wv);
      load(a.g + o, gv);
      if (in_head) {
        T hv[V];
        load(a.head + (long long)c * a.D + j0, hv);
#pragma unroll
        for (int i = 0; i < V; ++i) cv[i] = add_rn(cv[i], hv[i]);
      }
      const bool box = a.lo != nullptr;
      T lo[V] = {}, hi[V] = {};
      if (box) load(a.lo + o, lo), load(a.hi + o, hi);
#pragma unroll
      for (int i = 0; i < V; ++i)
        finish_elem(a, bw, cv[i], wv[i], gv[i], decay[i], thr[i], box, lo[i], hi[i], wn[i], gn[i]);
      store(a.w_out + o, wn);
      store(a.g_out + o, gn);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
cudaError_t launch_finish(const T* wb, const T* gc, const T* corr, const T* head, const T* w, const T* g,
                          const T* icpt, const T* gsi, double gamma, double shrink, double gl1, double gl2,
                          double gdecay, T* out, int B, int k, long long p, int D, int prox, int fit_intercept,
                          double w_total, const T* pf, const T* lo, const T* hi, cudaStream_t s) {
  const long long kp = (long long)k * p;
  Args<T> a;
  a.gc = gc, a.corr = corr, a.head = head, a.w = w, a.g = g, a.icpt = icpt, a.gsi = gsi, a.pf = pf, a.lo = lo,
  a.hi = hi;
  a.w_out = out, a.g_out = out + kp, a.icpt_out = out + 2 * kp, a.gsi_out = out + 2 * kp + k;
  T* bw = out + 2 * kp + 2 * k;
  a.bw = bw;
  // the chain's scalars are Python floats that the fit's type holds exactly;
  // 1 / w_total is rounded in that type on the host, as PyTorch rounds it
  a.gamma = T(gamma), a.shrink = T(shrink), a.gl1 = T(gl1), a.gl2 = T(gl2), a.gdecay = T(gdecay);
  a.inv_wt = T(1) / T(w_total);
  a.p = p, a.B = B, a.k = k, a.D = D, a.prox = prox, a.n_icpt = fit_intercept ? k : 0;
  finish_bw<T><<<1, RT, 0, s>>>(wb, B, bw);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr int VW = 16 / sizeof(T);
  const bool vec = p % VW == 0 && D % VW == 0 && aligned16(corr) && aligned16(head) && aligned16(w) &&
                   aligned16(g) && aligned16(out) && aligned16(pf) && aligned16(lo) && aligned16(hi);
  const long long groups = vec ? p / VW : p;
  a.ncx = (int)((groups + CT - 1) / CT);
  const long long grid = a.n_icpt + (long long)a.ncx * ((k + CPT - 1) / CPT);
  if (vec)
    finish_columns<T, VW><<<(unsigned)grid, CT, 0, s>>>(a);
  else
    finish_columns<T, 1><<<(unsigned)grid, CT, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K6 on one step: wb (B,), gc (B, k), corr (k, p), head (k, D) or null with
// D 0, w and g_sum (k, p), intercept and g_sum_intercept (k,), all
// contiguous; out holds 2 k p + 2 k + 1 elements: the new w, g_sum,
// intercept and g_sum_intercept in that order, then bw.  prox: 0 Ridge, 1
// elastic net; pf (p,) and the box's lo, hi (k, p) may be null (lo and hi
// together).  dtype: 0 = float32, 1 = float64.  Two launches on `stream`;
// returns a cudaError_t (0 = launched).
int sgd_step_finish(const void* wb, const void* gc, const void* corr, const void* head, const void* w,
                    const void* g_sum, const void* intercept, const void* g_sum_intercept, double gamma,
                    double shrink, double gl1, double gl2, double gdecay, void* out, int dtype, int B, int k,
                    long long p, int D, int prox, int fit_intercept, double w_total, const void* pf, const void* lo,
                    const void* hi, void* stream) {
  if (B < 1 || k < 1 || p < 1 || D < 0 || D > p || (D > 0) != (head != nullptr) || (lo == nullptr) != (hi == nullptr)
      || (prox != sgd::RIDGE && prox != sgd::ELASTIC_NET) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_finish<double>(
        static_cast<const double*>(wb), static_cast<const double*>(gc), static_cast<const double*>(corr),
        static_cast<const double*>(head), static_cast<const double*>(w), static_cast<const double*>(g_sum),
        static_cast<const double*>(intercept), static_cast<const double*>(g_sum_intercept), gamma, shrink, gl1,
        gl2, gdecay, static_cast<double*>(out), B, k, p, D, prox, fit_intercept, w_total,
        static_cast<const double*>(pf), static_cast<const double*>(lo), static_cast<const double*>(hi), s);
  return launch_finish<float>(
      static_cast<const float*>(wb), static_cast<const float*>(gc), static_cast<const float*>(corr),
      static_cast<const float*>(head), static_cast<const float*>(w), static_cast<const float*>(g_sum),
      static_cast<const float*>(intercept), static_cast<const float*>(g_sum_intercept), gamma, shrink, gl1, gl2,
      gdecay, static_cast<float*>(out), B, k, p, D, prox, fit_intercept, w_total, static_cast<const float*>(pf),
      static_cast<const float*>(lo), static_cast<const float*>(hi), s);
}

}  // extern "C"
