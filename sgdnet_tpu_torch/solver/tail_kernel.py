"""K3 / K4: the BlockCOO tail's forward and outer sums (twins of
sgdnet_tpu/solver/saga.py `_coo_batch_predict` / `_coo_batch_outer`; the
Pallas probes they replace are tools/bench_pallas_gather.py:80, 100, 116,
140), and K5, the g_sum refresh's tail sum over every block.

For block `blk` of a BlockCOO tail `bt` (core/sparse.py):

    coo_tail_forward(bt, blk, w (k, p), base=None, intercept=None, offs=None) -> (B, k):
        out[rows[e]] += vals[e] * w[:, cols[e]], then ((base + out) + intercept) + offs
    coo_tail_outer(bt, blk, gc (B, k))   -> (k, p):  corr[:, cols[e]] += vals[e] * gc[rows[e]]

and over all blocks at once, g (n_blocks * B, k):

    coo_tail_sum(bt, g) -> (p, k):  the tail's part of x.T @ g, each
        column's sum over the blocks in order, within a block over its
        column-ordered entries in order (K5: no atomics, the same bits
        from every launch)

K3's optional `base` (B, k), `intercept` (k,) and `offs` (B, k) assemble
the step's linear predictor in the kernel's launch, each add in the JAX
order of `_batch_predict` and the step.  On CUDA tensors each launches its
hand-written kernel (csrc/coo_tail.cu, f32 or f64) after checking every
operand; on CPU tensors each runs its plain torch version, the JAX
package's scatter-add over all E entries of the block.  Nothing falls
back: a CUDA input the kernel does not take raises.

`ForwardLauncher` is K3 for the step's hot loop: bound once to a BlockCOO
(its per-block addresses and lanes a row, computed when it was packed), a
class count and a dtype, with those checks made then; `refresh_stream`
reads the stream (once an epoch), and a call is an allocation and a launch.
"""

from __future__ import annotations

import torch

from sgdnet_tpu_torch.core.sparse import HEAVY_LEN
from sgdnet_tpu_torch.utils import build

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def add_epilogue(out, base=None, intercept=None, offs=None):
    """((base + out) + intercept) + offs, each add only where given."""
    if base is not None:
        out = base + out
    if intercept is not None:
        out = out + intercept
    if offs is not None:
        out = out + offs
    return out


def coo_tail_forward_reference(bt, blk: int, w: torch.Tensor, base=None, intercept=None, offs=None) -> torch.Tensor:
    """Plain torch K3: gather w at the block's columns, scatter-add into its
    rows, then the epilogue's adds."""
    r, c, v = bt.rows[blk].long(), bt.cols[blk].long(), bt.vals[blk]
    contrib = v[:, None].to(w.dtype) * w.T[c]  # (E, k)
    out = torch.zeros((bt.batch, w.shape[0]), dtype=w.dtype, device=w.device).index_add_(0, r, contrib)
    return add_epilogue(out, base, intercept, offs)


def coo_tail_outer_reference(bt, blk: int, gc: torch.Tensor) -> torch.Tensor:
    """Plain torch K4: gather gc at the block's rows, scatter-add into its columns."""
    r, c, v = bt.rows[blk].long(), bt.cols[blk].long(), bt.vals[blk]
    contrib = v[:, None].to(gc.dtype) * gc[r]  # (E, k)
    corr_t = torch.zeros((bt.n_cols, gc.shape[1]), dtype=gc.dtype, device=gc.device).index_add_(0, c, contrib)
    return corr_t.T


def coo_tail_sum_reference(bt, g: torch.Tensor) -> torch.Tensor:
    """Plain torch K5: over the blocks in order, each block's products
    vals[e] * g[row] scatter-added into their columns.  A block's entries
    come row-major, and `rows_by_col` is a stable sort of them by column,
    so each column's entries come in the order of its K5 segment: on the
    CPU, where `index_add_` adds in index order, each sum runs in K5's
    order."""
    out = torch.zeros((bt.n_cols, g.shape[1]), dtype=g.dtype, device=g.device)
    for b, e in enumerate(bt.counts.tolist()):
        rows = b * bt.batch + bt.rows[b, :e].long()
        out.index_add_(0, bt.cols[b, :e].long(), bt.vals[b, :e, None].to(g.dtype) * g[rows])
    return out


def _check(bt, blk, t: torch.Tensor, shape, what: str) -> None:
    if t.dtype not in _DTYPE_CODE or bt.dtype != t.dtype:
        raise ValueError(f"{what}: takes f32/f64 operands of the tail's dtype; got {t.dtype} and {bt.dtype}")
    if bt.device != t.device:
        raise ValueError(f"{what}: the BlockCOO tail must be on {t.device}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous {shape} operand, got {tuple(t.shape)}")
    if blk is not None and not 0 <= blk < len(bt.addr):
        raise ValueError(f"{what}: block {blk} outside the tail's {len(bt.addr)} blocks")


class ForwardLauncher:
    """K3 bound to the BlockCOO `bt`, `k` classes and `dtype` on the card:
    the tail's dtype, device and lanes are checked here, once; a call
    `launcher(blk, w, base, intercept, offs)` takes operands of the bound
    shapes (w (k, p), base and offs (B, k), intercept (k,), contiguous, of
    `dtype`, on the tail's device: the step that binds it builds them so)
    and checks nothing.  It launches on the stream `refresh_stream` last
    read."""

    def __init__(self, bt, k: int, dtype: torch.dtype):
        if dtype not in _DTYPE_CODE or bt.dtype != dtype or bt.device.type != "cuda":
            raise ValueError(f"coo_tail_forward: takes an f32/f64 BlockCOO on the card of the operands' dtype; got "
                             f"{bt.dtype} on {bt.device} for {dtype} operands")
        self.shape, self.dtype, self.device = (bt.batch, k), dtype, bt.device
        self.args = (_DTYPE_CODE[dtype], bt.batch, k, bt.n_cols, bt.lanes)
        self.blocks = [a[:3] for a in bt.addr]  # row_ptr, cols, vals of each block
        self.fn = build.load_library().sgd_coo_tail_forward
        self.refresh_stream()

    def refresh_stream(self) -> None:
        self.stream = torch.cuda.current_stream(self.device).cuda_stream

    def __call__(self, blk: int, w, base=None, intercept=None, offs=None) -> torch.Tensor:
        out = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        code = self.fn(*self.blocks[blk], w.data_ptr(), *self.args, 0 if base is None else base.data_ptr(),
                       0 if intercept is None else intercept.data_ptr(), 0 if offs is None else offs.data_ptr(),
                       out.data_ptr(), self.stream)
        if code:
            build.check(code, "coo_tail_forward")
        coo_tail_forward.launches += 1
        return out


def coo_tail_forward(bt, blk: int, w: torch.Tensor, base=None, intercept=None, offs=None) -> torch.Tensor:
    """K3: the tail's part of the block's linear predictors, (B, k), with
    the optional epilogue ((base + tail) + intercept) + offs.  On the card
    every operand is checked, then the kernel launches through a
    `ForwardLauncher` (the block's views go by the addresses the BlockCOO
    computed when it was packed: no tensor is indexed here)."""
    if not w.is_cuda:
        return coo_tail_forward_reference(bt, blk, w, base, intercept, offs)
    k = w.shape[0]
    _check(bt, blk, w, (k, bt.n_cols), "coo_tail_forward")
    for t, shape, name in ((base, (bt.batch, k), "base"), (intercept, (k,), "intercept"),
                           (offs, (bt.batch, k), "offs")):
        if t is not None:
            _check(bt, blk, t, shape, f"coo_tail_forward {name}")
    return ForwardLauncher(bt, k, w.dtype)(blk, w, base, intercept, offs)


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


def coo_tail_sum(bt, g: torch.Tensor) -> torch.Tensor:
    """K5: the tail's part of x.T @ g over every block, (p, k), for g
    (n_blocks * B, k) (the refresh's g_mem).  The kernel writes every
    element, zero on the head's and empty columns, so the output is
    allocated uninitialised.  A g of other rows than the tail's blocks
    hold raises on either device."""
    k = g.shape[1] if g.ndim == 2 else 0
    if not g.is_cuda:
        if tuple(g.shape) != (bt.n_blocks * bt.batch, k):
            raise ValueError(f"coo_tail_sum: expected a {(bt.n_blocks * bt.batch, k)} operand, got {tuple(g.shape)}")
        return coo_tail_sum_reference(bt, g)
    _check(bt, None, g, (bt.n_blocks * bt.batch, k), "coo_tail_sum")
    out = torch.empty((bt.n_cols, k), dtype=g.dtype, device=g.device)
    code = build.load_library().sgd_coo_tail_sum(
        bt.col_seg.data_ptr(), bt.rows_by_col.data_ptr(), bt.vals_by_col.data_ptr(), bt.n_blocks,
        bt.rows_by_col.shape[1], bt.batch, g.data_ptr(), _DTYPE_CODE[g.dtype], k, bt.n_cols, out.data_ptr(),
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    build.check(code, "coo_tail_sum")
    coo_tail_sum.launches += 1
    return out


#: kernel launches since the last reset (the twins never count)
coo_tail_forward.launches = 0
coo_tail_outer.launches = 0
coo_tail_sum.launches = 0
