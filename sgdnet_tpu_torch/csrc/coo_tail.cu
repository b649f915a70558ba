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
// under a megabyte, i.e. well under a microsecond at 3.35 TB/s; they are
// bound by latency and launch cost.  Design: both are segment sums over
// views built once on the host, so neither needs atomics and two runs give
// identical bits:
//   * K3: rows ascend over a block's true entries, so `row_ptr` gives each
//     batch row a contiguous segment; one thread owns one (row, class) and
//     sums its segment in entry order.  The pad entries after the true
//     prefix are never read.
//   * K4: `col_order` lists the true entries stably sorted by column and
//     `col_ptr` / `col_ids` give each distinct column its segment; one
//     thread owns one (column, class), sums its segment in entry order and
//     writes the column.  Columns the block does not touch stay at the
//     zeros the wrapper allocated.

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
__global__ void __launch_bounds__(TT) coo_outer(const int* __restrict__ col_ptr,
                                                const int* __restrict__ col_ids,
                                                const int* __restrict__ col_order,
                                                const int* __restrict__ n_distinct,
                                                const int* __restrict__ rows,
                                                const T* __restrict__ vals,
                                                const T* __restrict__ gc, int k, long long p,
                                                T* __restrict__ corr) {
  const long long t = blockIdx.x * (long long)TT + threadIdx.x;
  const int u = (int)(t / k), c = (int)(t % k);
  if (u >= *n_distinct) return;
  T acc = 0;
  for (int s = col_ptr[u]; s < col_ptr[u + 1]; ++s) {
    const int e = col_order[s];
    acc += vals[e] * gc[(long long)rows[e] * k + c];
  }
  corr[c * p + col_ids[u]] = acc;
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

// K4 on one block: col_ptr (U + 1), col_ids (U), col_order / rows / vals (E)
// and n_distinct (1) are that block's rows of the views, U the views' padded
// width, gc (B, k), corr (k, p) zeroed by the caller.
int sgd_coo_tail_outer(const int* col_ptr, const int* col_ids, const int* col_order, const int* n_distinct,
                       const int* rows, const void* vals, const void* gc, int dtype, int U, int k,
                       long long p, void* corr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_of((long long)U * k);
  if (dtype == 1)
    coo_outer<double><<<grid, TT, 0, s>>>(col_ptr, col_ids, col_order, n_distinct, rows,
                                          static_cast<const double*>(vals),
                                          static_cast<const double*>(gc), k, p,
                                          static_cast<double*>(corr));
  else
    coo_outer<float><<<grid, TT, 0, s>>>(col_ptr, col_ids, col_order, n_distinct, rows,
                                         static_cast<const float*>(vals),
                                         static_cast<const float*>(gc), k, p,
                                         static_cast<float*>(corr));
  return cudaGetLastError();
}

}  // extern "C"
