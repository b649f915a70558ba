// The BlockCOO tail's two index-driven sums for Hopper (sm_90a): K3 and K4
// of the port.
//
// Replace the Pallas probes of tools/bench_pallas_gather.py (`pallas_gather`
// :80 and `pallas_gather2` :100, out[e] = v[e] * w[c[e]]; `pallas_cumsum`
// :116, the segment-sum form; `pallas_scatter` :140, a scatter into (p,)),
// which probe the tail ops of sgdnet_tpu/solver/saga.py
// `_coo_batch_predict` / `_coo_batch_outer`.  For block `blk` of a BlockCOO
// tail (core/sparse.py):
//
//   K3 forward   out[r, c]   = sum over entries e of row r   vals[e] * w[c, cols[e]]     (B, k)
//   K4 outer     corr[c, j]  = sum over entries e of column j vals[e] * gc[rows[e], c]  (k, p)
//
// K4 is a sum, not the probe's set: a column recurs within a block.
//
// What bounds them: at the north-star shapes a block holds ~13k-41k true
// entries of 12 bytes (row, column, value) plus one 4-byte gather each,
// under a megabyte, i.e. well under a microsecond at 3.35 TB/s; on the card
// they are bound by the longest chain of dependent loads one thread walks,
// and per call by the host (a launch costs more than the kernel runs).
// Design: both are segment sums over views built once on the host, so
// neither needs atomics and two runs give identical bits:
//   * K3: rows ascend over a block's true entries, so `row_ptr` gives each
//     batch row a contiguous segment; one thread owns one (row, class) and
//     sums its segment in entry order.  The pad entries after the true
//     prefix are never read.
//   * K4: the block's rows and values are stored a second time in column
//     order (`rows_by_col`, `vals_by_col`: the walk reads them contiguously
//     and only gc[row] is a gather), and `col_seg` maps every one of the p
//     columns to its segment, empty for most.  One thread owns one (column,
//     class) with at most `heavy_len` entries (the caller's threshold, the
//     one `heavy_cols` was built with), sums them in order and writes
//     the column, zero where the block has no entry: the kernel writes all
//     of corr, so the caller allocates it uninitialised.  Columns are Zipf:
//     a column with more than `heavy_len` entries (listed in `heavy_cols`)
//     would set the whole launch's time if one thread walked it, so a warp
//     owns it instead: lane l sums entries l, l + 32, ... in order and the
//     32 lane sums meet in a fixed butterfly (`warp_sum_t`).  The heavy warps
//     are extra CTAs of the same launch.

#include "common.h"

namespace {

constexpr int TT = 256;  // threads per CTA

template <typename T>
__global__ void __launch_bounds__(TT) coo_forward(const int* __restrict__ row_ptr,
                                                  const int* __restrict__ cols,
                                                  const T* __restrict__ vals,
                                                  const T* __restrict__ w, int B, int k,
                                                  long long p, T* __restrict__ out) {
  const long long t = blockIdx.x * (long long)TT + threadIdx.x;
  if (t >= (long long)B * k) return;
  const int r = (int)(t / k), c = (int)(t % k);
  const T* wc = w + c * p;
  T acc = 0;
  for (int e = row_ptr[r]; e < row_ptr[r + 1]; ++e) acc += vals[e] * wc[cols[e]];
  out[t] = acc;
}

template <typename T>
__device__ __forceinline__ T warp_sum_t(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(sgd::FULL_MASK, v, o);
  return v;
}

// CTAs [0, light_ctas): one thread per (column, class) over all p columns.
// CTAs after them: one warp per (heavy column, class).
template <typename T>
__global__ void __launch_bounds__(TT) coo_outer(const int* __restrict__ col_seg,
                                                const int* __restrict__ rows_by_col,
                                                const T* __restrict__ vals_by_col,
                                                const int* __restrict__ heavy_cols, int n_heavy,
                                                int heavy_len, const T* __restrict__ gc, int k, long long p,
                                                int light_ctas, T* __restrict__ corr) {
  if ((int)blockIdx.x < light_ctas) {
    const long long t = blockIdx.x * (long long)TT + threadIdx.x;
    if (t >= p * k) return;
    const long long j = t / k;
    const int c = (int)(t % k);
    const int s0 = col_seg[j], s1 = col_seg[j + 1];
    if (s1 - s0 > heavy_len) return;  // a warp of the heavy CTAs writes it
    T acc = 0;
    for (int s = s0; s < s1; ++s) acc += vals_by_col[s] * gc[(long long)rows_by_col[s] * k + c];
    corr[c * p + j] = acc;
    return;
  }
  const int lane = threadIdx.x & 31;
  const long long wi = ((long long)blockIdx.x - light_ctas) * (TT / 32) + (threadIdx.x >> 5);
  if (wi >= (long long)n_heavy * k) return;
  const int c = (int)(wi % k);
  const int j = heavy_cols[wi / k];
  if (j < 0) return;  // this block has fewer heavy columns than the widest
  const int s1 = col_seg[j + 1];
  T acc = 0;
  for (int s = col_seg[j] + lane; s < s1; s += 32) acc += vals_by_col[s] * gc[(long long)rows_by_col[s] * k + c];
  acc = warp_sum_t(acc);
  if (lane == 0) corr[c * p + j] = acc;
}

unsigned grid_of(long long threads) { return (unsigned)((threads + TT - 1) / TT); }

}  // namespace

extern "C" {

// K3 on one block: row_ptr (B + 1), cols / vals (E) are that block's rows of
// the BlockCOO views, w (k, p), out (B, k).  dtype: 0 = float32, 1 = float64.
// Returns a cudaError_t (0 = launched).
int sgd_coo_tail_forward(const int* row_ptr, const int* cols, const void* vals, const void* w, int dtype,
                         int B, int k, long long p, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_of((long long)B * k);
  if (dtype == 1)
    coo_forward<double><<<grid, TT, 0, s>>>(row_ptr, cols, static_cast<const double*>(vals),
                                            static_cast<const double*>(w), B, k, p,
                                            static_cast<double*>(out));
  else
    coo_forward<float><<<grid, TT, 0, s>>>(row_ptr, cols, static_cast<const float*>(vals),
                                           static_cast<const float*>(w), B, k, p,
                                           static_cast<float*>(out));
  return cudaGetLastError();
}

// K4 on one block: col_seg (p + 1), rows_by_col / vals_by_col (E) and
// heavy_cols (n_heavy, -1 past the block's own: every column of the block
// with more than heavy_len entries) are that block's rows of the views, gc
// (B, k); corr (k, p) is written whole.
int sgd_coo_tail_outer(const int* col_seg, const int* rows_by_col, const void* vals_by_col,
                       const int* heavy_cols, int n_heavy, int heavy_len, const void* gc, int dtype, int k,
                       long long p, void* corr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned light = grid_of(p * k);
  const unsigned grid = light + grid_of((long long)n_heavy * k * 32);
  if (dtype == 1)
    coo_outer<double><<<grid, TT, 0, s>>>(col_seg, rows_by_col, static_cast<const double*>(vals_by_col),
                                          heavy_cols, n_heavy, heavy_len, static_cast<const double*>(gc), k, p,
                                          (int)light, static_cast<double*>(corr));
  else
    coo_outer<float><<<grid, TT, 0, s>>>(col_seg, rows_by_col, static_cast<const float*>(vals_by_col),
                                         heavy_cols, n_heavy, heavy_len, static_cast<const float*>(gc), k, p,
                                         (int)light, static_cast<float*>(corr));
  return cudaGetLastError();
}

}  // extern "C"
