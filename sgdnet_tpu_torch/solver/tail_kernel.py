"""K3 / K4: the BlockCOO tail's forward and outer sums (twins of
sgdnet_tpu/solver/saga.py `_coo_batch_predict` / `_coo_batch_outer`; the
Pallas probes they replace are tools/bench_pallas_gather.py:80, 100, 116,
140).

For block `blk` of a BlockCOO tail `bt` (core/sparse.py):

    coo_tail_forward(bt, blk, w (k, p))  -> (B, k):  out[rows[e]] += vals[e] * w[:, cols[e]]
    coo_tail_outer(bt, blk, gc (B, k))   -> (k, p):  corr[:, cols[e]] += vals[e] * gc[rows[e]]

On CUDA tensors each launches its hand-written kernel (csrc/coo_tail.cu,
f32 or f64); on CPU tensors each runs its plain torch version, the JAX
package's scatter-add over all E entries of the block.  Nothing falls
back: a CUDA input the kernel does not take raises.
"""

from __future__ import annotations

import torch

from sgdnet_tpu_torch.core.sparse import HEAVY_LEN
from sgdnet_tpu_torch.utils import build

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def coo_tail_forward_reference(bt, blk: int, w: torch.Tensor) -> torch.Tensor:
    """Plain torch K3: gather w at the block's columns, scatter-add into its rows."""
    r, c, v = bt.rows[blk].long(), bt.cols[blk].long(), bt.vals[blk]
    contrib = v[:, None].to(w.dtype) * w.T[c]  # (E, k)
    return torch.zeros((bt.batch, w.shape[0]), dtype=w.dtype, device=w.device).index_add_(0, r, contrib)


def coo_tail_outer_reference(bt, blk: int, gc: torch.Tensor) -> torch.Tensor:
    """Plain torch K4: gather gc at the block's rows, scatter-add into its columns."""
    r, c, v = bt.rows[blk].long(), bt.cols[blk].long(), bt.vals[blk]
    contrib = v[:, None].to(gc.dtype) * gc[r]  # (E, k)
    corr_t = torch.zeros((bt.n_cols, gc.shape[1]), dtype=gc.dtype, device=gc.device).index_add_(0, c, contrib)
    return corr_t.T


def _check(bt, blk: int, t: torch.Tensor, shape, what: str) -> None:
    if t.dtype not in _DTYPE_CODE or bt.dtype != t.dtype:
        raise ValueError(f"{what}: takes f32/f64 operands of the tail's dtype; got {t.dtype} and {bt.dtype}")
    if bt.device != t.device:
        raise ValueError(f"{what}: the BlockCOO tail must be on {t.device}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous {shape} operand, got {tuple(t.shape)}")
    if not 0 <= blk < len(bt.addr):
        raise ValueError(f"{what}: block {blk} outside the tail's {len(bt.addr)} blocks")


def coo_tail_forward(bt, blk: int, w: torch.Tensor) -> torch.Tensor:
    """K3: the tail's part of the block's linear predictors, (B, k).  The
    block's views go to the kernel by the addresses the BlockCOO computed
    when it was packed: no tensor is indexed here."""
    if not w.is_cuda:
        return coo_tail_forward_reference(bt, blk, w)
    k = w.shape[0]
    _check(bt, blk, w, (k, bt.n_cols), "coo_tail_forward")
    out = torch.empty((bt.batch, k), dtype=w.dtype, device=w.device)
    row_ptr, cols, vals = bt.addr[blk][:3]
    code = build.load_library().sgd_coo_tail_forward(
        row_ptr, cols, vals, w.data_ptr(), _DTYPE_CODE[w.dtype], bt.batch, k, bt.n_cols, out.data_ptr(),
        torch.cuda.current_stream(w.device).cuda_stream,
    )
    build.check(code, "coo_tail_forward")
    coo_tail_forward.launches += 1
    return out


def coo_tail_outer(bt, blk: int, gc: torch.Tensor) -> torch.Tensor:
    """K4: the tail's part of the block's rank-B update, (k, p).  The kernel
    writes every column, so corr is allocated uninitialised."""
    if not gc.is_cuda:
        return coo_tail_outer_reference(bt, blk, gc)
    k = gc.shape[1]
    _check(bt, blk, gc, (bt.batch, k), "coo_tail_outer")
    corr = torch.empty((k, bt.n_cols), dtype=gc.dtype, device=gc.device)
    col_seg, rows_by_col, vals_by_col, heavy_cols = bt.addr[blk][3:]
    code = build.load_library().sgd_coo_tail_outer(
        col_seg, rows_by_col, vals_by_col, heavy_cols, bt.max_heavy, HEAVY_LEN, gc.data_ptr(),
        _DTYPE_CODE[gc.dtype], k, bt.n_cols, corr.data_ptr(), torch.cuda.current_stream(gc.device).cuda_stream,
    )
    build.check(code, "coo_tail_outer")
    coo_tail_outer.launches += 1
    return corr


#: kernel launches since the last reset (the twins never count)
coo_tail_forward.launches = 0
coo_tail_outer.launches = 0
