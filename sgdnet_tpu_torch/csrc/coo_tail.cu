// The BlockCOO tail's index-driven sums for Hopper (sm_90a): K3 and K4 of
// the port, and K5, the g_sum refresh's tail sum.
//
// Replace the Pallas probes of tools/bench_pallas_gather.py (`pallas_gather`
// :80 and `pallas_gather2` :100, out[e] = v[e] * w[c[e]]; `pallas_cumsum`
// :116, the segment-sum form; `pallas_scatter` :140, a scatter into (p,)),
// which probe the tail ops of sgdnet_tpu/solver/saga.py
// `_coo_batch_predict` / `_coo_batch_outer`.  For block `blk` of a BlockCOO
// tail (core/sparse.py):
//
//   K3 forward   out[r, c]   = ((base[r, c] + sum over entries e of row r  vals[e] * w[c, cols[e]])
//                               + intercept[c]) + offs[r, c]                                          (B, k)
//   K4 outer     corr[c, j]  = sum over entries e of column j vals[e] * gc[rows[e], c]               (k, p)
//
// base, intercept and offs are each optional (a null pointer skips its
// add): K3's epilogue assembles the step's linear predictor in the same
// launch, in the JAX order of `_batch_predict` (head + tail) followed by
// the step's + intercept and + offsets.  K4 is a sum, not the probe's set:
// a column recurs within a block.
//
// What bounds them: at the north-star shapes a block holds ~10k-140k true
// entries of 12 bytes (row, column, value) plus one gather each, at most a
// couple of megabytes, i.e. a microsecond or less at 3.35 TB/s; on the card
// they are bound by the longest chain of dependent loads one thread walks,
// by how much of the card the launch fills, and per call by the host (a
// launch costs more than the kernel runs).  Both are segment sums over
// views built once on the host, so neither needs atomics and two runs give
// identical bits:
//   * K3: rows ascend over a block's true entries, so `row_ptr` gives each
//     batch row a contiguous segment.  A group of G lanes (G a power of two,
//     1 to 32, picked per BlockCOO from its mean row length by
//     `coo_lanes`) owns a row: lane l sums entries l, l + G, ... in entry
//     order, each entry's column and value loaded once and applied to KC
//     classes held in registers (chunks of KC classes where k is larger),
//     and the G lane sums meet in a fixed xor butterfly that leaves the
//     same bits in every lane.  On slice D's tail (~1.5 entries a row at
//     most) G is 1, one thread a row; on slice C's (~4.7: its bf16 head
//     stops at 16384 columns, short of 98% coverage) 4; on slice E's (~17)
//     16: a lane walks one or two entries, not 17, and the launch has 16x
//     the threads.  The pad entries after the true prefix are never read.
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
//
// K5 replaces no TPU kernel: the JAX package's refresh (saga.py
// `_refresh_g_sum`) scatters the padded tail with XLA, as the port's plain
// `PaddedCSR.matvec_T` does with `index_add_`.  It is the tail's part of
// the refresh's X^T g over every block at once, read from the same
// column-ordered views K4 reads, all blocks' rows of each view one
// contiguous (n_blocks, .) tensor:
//
//   K5 tail sum  out[j, c]   = sum over blocks b in order, over column j's segment of block b in order,
//                              vals_by_col[b, s] * g[b B + rows_by_col[b, s], c]                      (p, k)
//
// The index_add_ it replaces ran an atomic per entry of the padded n x L
// tail, k wide, ~80% of them pad entries adding zero to column 0.  K5's
// work is bytes read once (g, the true entries, col_seg; at k 53 on the
// multiclass cell ~160 MB, ~0.05 ms at 3.35 TB/s).  One thread owns an
// output (column, class) and writes it once, zero for a head or empty
// column, so there is no memset, no atomic and no temporary, and the order
// of each sum is fixed by the data: two launches give the same bits.
// Classes run fastest across a warp, so a warp's g loads of one entry are
// one contiguous row of g at k 53 and its col_seg / rows / vals loads are
// broadcasts.  What bounds it is the chain of dependent loads a thread
// walks (segment bounds, then row, then g): the bounds of SU blocks are
// loaded together ahead of their walks.

#include "common.h"

namespace {

constexpr int TT = 256;  // threads per CTA of K4
constexpr int FT = 128;  // threads per CTA of K3: at G = 1, 8192 rows fill 64 CTAs

// K3's lanes a row for a tail of `entries` true entries over `rows` block
// rows (every block, pad rows included): the largest power of two, 1 to 32,
// not above the mean entries a row.  BlockCOO.lanes in core/sparse.py is
// the same expression (tests/test_torch_tail.py evaluates this one).
constexpr int coo_lanes(long long entries, long long rows) {
  return /* LANES-FORMULA */ 1 << ((entries >= 2 * rows) + (entries >= 4 * rows) + (entries >= 8 * rows)
                                   + (entries >= 16 * rows) + (entries >= 32 * rows)) /* END-FORMULA */;
}
// the design points: the tails of slices D (~1.5 entries a row in its
// largest block), C (~4.7 a row) and E (~17), 13 blocks of 8192 rows
static_assert(coo_lanes(160000, 106496) == 1 && coo_lanes(496000, 106496) == 4 &&
                  coo_lanes(1805000, 106496) == 16,
              "K3 lanes formula");

// One group of G lanes a row; KC classes of the row at a time.  Every lane
// of a warp takes part in the butterfly (a lane past the last row walks an
// empty segment), so G must divide 32.
template <typename T, int KC>
__global__ void __launch_bounds__(FT) coo_forward(const int* __restrict__ row_ptr, const int* __restrict__ cols,
                                                  const T* __restrict__ vals, const T* __restrict__ w, int B,
                                                  int k, long long p, int G, const T* __restrict__ base,
                                                  const T* __restrict__ intercept, const T* __restrict__ offs,
                                                  T* __restrict__ out) {
  const int t = blockIdx.x * FT + threadIdx.x;
  const int r = t / G, l = t & (G - 1);
  const bool live = r < B;
  const int e0 = live ? row_ptr[r] : 0, e1 = live ? row_ptr[r + 1] : 0;
  for (int c0 = 0; c0 < k; c0 += KC) {
    T acc[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) acc[j] = 0;
#pragma unroll 4
    for (int e = e0 + l; e < e1; e += G) {
      const long long col = cols[e];
      const T v = vals[e];
#pragma unroll
      for (int j = 0; j < KC; ++j)
        if (c0 + j < k) acc[j] += v * w[(c0 + j) * p + col];
    }
    for (int o = G >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < KC; ++j) acc[j] += __shfl_xor_sync(sgd::FULL_MASK, acc[j], o);
    }
    if (live) {
      // the G lanes hold the same sums; lane j % G writes class c0 + j
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const int c = c0 + j;
        if (c < k && (j & (G - 1)) == l) {
          const long long o = (long long)r * k + c;
          T v = acc[j];
          if (base != nullptr) v = base[o] + v;
          if (intercept != nullptr) v = v + intercept[c];
          if (offs != nullptr) v = v + offs[o];
          out[o] = v;
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch_forward(const int* row_ptr, const int* cols, const void* vals, const void* w, int B, int k,
                           long long p, int G, const void* base, const void* intercept, const void* offs, void* out,
                           cudaStream_t s) {
  const unsigned grid = (unsigned)(((long long)B * G + FT - 1) / FT);
  const T *v = static_cast<const T*>(vals), *wt = static_cast<const T*>(w), *b = static_cast<const T*>(base),
          *ic = static_cast<const T*>(intercept), *of = static_cast<const T*>(offs);
  T* o = static_cast<T*>(out);
  if (k == 1)
    coo_forward<T, 1><<<grid, FT, 0, s>>>(row_ptr, cols, v, wt, B, k, p, G, b, ic, of, o);
  else if (k <= 4)
    coo_forward<T, 4><<<grid, FT, 0, s>>>(row_ptr, cols, v, wt, B, k, p, G, b, ic, of, o);
  else
    coo_forward<T, 8><<<grid, FT, 0, s>>>(row_ptr, cols, v, wt, B, k, p, G, b, ic, of, o);
  return cudaGetLastError();
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

constexpr int SU = 8;  // K5: blocks whose segment bounds a thread loads together

// One thread per (column j, class c); threads over [0, p * k), the
// classes fastest.
template <typename T>
__global__ void __launch_bounds__(TT) coo_tail_sum(const int* __restrict__ col_seg,
                                                   const int* __restrict__ rows_by_col,
                                                   const T* __restrict__ vals_by_col, int n_blocks, long long E,
                                                   int B, const T* __restrict__ g, int k, long long p,
                                                   T* __restrict__ out) {
  const long long t = blockIdx.x * (long long)TT + threadIdx.x;
  if (t >= p * k) return;
  const long long j = t / k;
  const int c = (int)(t % k);
  T acc = 0;
  for (int b0 = 0; b0 < n_blocks; b0 += SU) {
    int s0[SU], s1[SU];
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const bool live = b0 + u < n_blocks;
      const long long o = (long long)(b0 + u) * (p + 1) + j;
      s0[u] = live ? col_seg[o] : 0;
      s1[u] = live ? col_seg[o + 1] : 0;
    }
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const long long b = b0 + u;
      const int* rows = rows_by_col + b * E;
      const T* vals = vals_by_col + b * E;
      const T* gb = g + b * B * k + c;
      for (int s = s0[u]; s < s1[u]; ++s) acc += vals[s] * gb[(long long)rows[s] * k];
    }
  }
  out[t] = acc;
}

template <typename T>
cudaError_t launch_tail_sum(const int* col_seg, const int* rows_by_col, const void* vals_by_col, int n_blocks,
                            long long E, int B, const void* g, int k, long long p, void* out, cudaStream_t s) {
  coo_tail_sum<T><<<grid_of(p * k), TT, 0, s>>>(col_seg, rows_by_col, static_cast<const T*>(vals_by_col),
                                                n_blocks, E, B, static_cast<const T*>(g), k, p,
                                                static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K3 on one block: row_ptr (B + 1), cols / vals (E) are that block's rows of
// the BlockCOO views, w (k, p), `lanes` the BlockCOO's G; base (B, k),
// intercept (k,) and offs (B, k) may each be null; out (B, k).  dtype: 0 =
// float32, 1 = float64.  Returns a cudaError_t (0 = launched).
int sgd_coo_tail_forward(const int* row_ptr, const int* cols, const void* vals, const void* w, int dtype, int B,
                         int k, long long p, int lanes, const void* base, const void* intercept, const void* offs,
                         void* out, void* stream) {
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 || k < 1 || B < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_forward<double>(row_ptr, cols, vals, w, B, k, p, lanes, base, intercept, offs, out, s)
                    : launch_forward<float>(row_ptr, cols, vals, w, B, k, p, lanes, base, intercept, offs, out, s);
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

// K5 over all n_blocks blocks: col_seg (n_blocks, p + 1), rows_by_col /
// vals_by_col (n_blocks, E) are the BlockCOO's views whole, g (n_blocks B,
// k); out (p, k) is written whole.
int sgd_coo_tail_sum(const int* col_seg, const int* rows_by_col, const void* vals_by_col, int n_blocks,
                     long long E, int B, const void* g, int dtype, int k, long long p, void* out, void* stream) {
  if (n_blocks < 0 || B < 1 || k < 1 || p < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_tail_sum<double>(col_seg, rows_by_col, vals_by_col, n_blocks, E, B, g, k, p, out, s)
                    : launch_tail_sum<float>(col_seg, rows_by_col, vals_by_col, n_blocks, E, B, g, k, p, out, s);
}

}  // extern "C"
