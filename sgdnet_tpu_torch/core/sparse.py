"""Sparse design-matrix layouts on torch tensors (twin of
sgdnet_tpu/core/sparse.py).

    PaddedCSR  row-padded CSR: indices / values (n, L), nnz (n,)
    BlockCOO   the tail's true nonzeros packed per row block (block
               sampling), with the sorted views the tail kernels K3 / K4 walk
    HeadNNZ    the nonzero form of a quantized int8 head (host numpy)
    HybridCSR  a dense head of the D most frequent columns plus a PaddedCSR
               tail; columns are permuted so the head is [0, D)

The layouts hold the same arrays as the JAX package's, built by the same
host-side numpy (the tests compare them bit for bit), and live on the
device given to their builders (`device=None` is the card).  Head-wide
passes (column statistics, standardization, quantization, the dequantized
products) run over row chunks, so no full-width f64 or bf16 copy of a
multi-GB head is ever made.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from sgdnet_tpu_torch.utils.device import resolve_device

#: elements per row chunk of a head-wide pass (512 MB in f64)
_CHUNK_ELEMS = 1 << 26


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _row_chunks(n: int, width: int):
    step = max(1, _CHUNK_ELEMS // max(width, 1))
    for s in range(0, n, step):
        yield s, min(n, s + step)


def _np_float(dtype: torch.dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def as_head_dtype(dtype) -> torch.dtype | None:
    """None, or the torch dtype of a head given as a torch dtype or a name
    ("bfloat16", "int8", "float32", ...)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else getattr(dtype, "__name__", str(dtype))
    if name not in ("bfloat16", "int8", "float32", "float64"):
        raise ValueError(f"head dtype must be bfloat16, int8, float32 or float64; got {dtype!r}")
    return getattr(torch, name)


def canonical_csr(x):
    """CSR with sorted indices and duplicates summed (scipy's canonical
    form); the caller's matrix is copied first when it is not canonical."""
    x = x.tocsr()
    if not x.has_canonical_format:
        x = x.copy()
        x.sum_duplicates()
    return x


def mm_acc(a: torch.Tensor, b: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """a @ b with products summed in `acc` and returned in `acc`.  On the
    card two bf16 operands go through the GEMM with an f32 result (the
    MXU's preferred_element_type); elsewhere both are upcast, which gives
    the same products, exact in f32."""
    if a.is_cuda and a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16 and acc == torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.to(acc) @ b.to(acc)


# ---------------------------------------------------------------------------
# PaddedCSR
# ---------------------------------------------------------------------------


@dataclass
class PaddedCSR:
    """Row-padded CSR sparse matrix of logical shape (n_rows, n_cols); pad
    entries are (column 0, value 0), inert in every gather and scatter."""

    indices: torch.Tensor  # (n, L) int32
    values: torch.Tensor  # (n, L) float
    nnz: torch.Tensor  # (n,) int32
    n_rows: int
    n_cols: int

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def row_width(self) -> int:
        return self.indices.shape[1]

    @classmethod
    def from_dense(cls, x, dtype=torch.float32, lane_multiple: int = 8, device=None) -> "PaddedCSR":
        import scipy.sparse as sp

        return cls.from_scipy(sp.csr_matrix(np.asarray(x)), dtype=dtype, lane_multiple=lane_multiple,
                              device=device)

    @classmethod
    def from_scipy(cls, x, dtype=torch.float32, lane_multiple: int = 8, device=None) -> "PaddedCSR":
        """Build from a scipy CSR/CSC/COO matrix (host numpy, then one copy
        to `device`)."""
        dev = resolve_device(device)
        x = canonical_csr(x)
        n, p = x.shape
        nnz = np.diff(x.indptr).astype(np.int32)
        L = _round_up(max(int(nnz.max()) if n else 0, 1), lane_multiple)
        indices = np.zeros((n, L), dtype=np.int32)
        values = np.zeros((n, L), dtype=np.float64)
        rows = np.repeat(np.arange(n), nnz)
        pos = np.arange(len(x.data)) - np.repeat(x.indptr[:-1], nnz)
        indices[rows, pos] = x.indices
        values[rows, pos] = x.data
        return cls(
            torch.as_tensor(indices, device=dev),
            torch.as_tensor(values, device=dev).to(dtype),
            torch.as_tensor(nnz, device=dev),
            n, p,
        )

    def take_rows(self, perm: torch.Tensor) -> "PaddedCSR":
        """The rows of self in the order `perm`."""
        return PaddedCSR(self.indices[perm], self.values[perm], self.nnz[perm], self.n_rows, self.n_cols)

    def to(self, device=None, dtype=None) -> "PaddedCSR":
        """The same matrix on `device`, its values in `dtype` (each None: as is)."""
        dev = self.values.device if device is None else device
        return PaddedCSR(self.indices.to(dev), self.values.to(device=dev, dtype=dtype or self.values.dtype),
                         self.nnz.to(dev), self.n_rows, self.n_cols)

    def canonical(self, head_cols: int = 0) -> "PaddedCSR":
        """The checks a scipy input gets at ingestion, for a prebuilt layout:
        shapes, nnz within the row width, columns in [head_cols, n_cols) on
        the true entries and (0, 0) pad entries (ValueError otherwise), and
        duplicate columns within a row summed as `canonical_csr` sums them
        (then rebuilt on the host, rows in column order); no NaN values."""
        n, L = self.indices.shape
        if self.values.shape != (n, L) or self.nnz.shape != (n,) or n != self.n_rows:
            raise ValueError(f"PaddedCSR arrays do not match its shape ({self.n_rows} rows)")
        if bool(torch.isnan(self.values).any()):
            raise ValueError("NA values are not allowed.")
        if bool(((self.nnz < 0) | (self.nnz > L)).any()):
            raise ValueError(f"PaddedCSR nnz must lie in [0, {L}] (its row width)")
        true = torch.arange(L, device=self.nnz.device)[None, :] < self.nnz[:, None]
        idx = self.indices.long()
        if bool((true & ((idx < head_cols) | (idx >= self.n_cols))).any()):
            raise ValueError(f"PaddedCSR columns of true entries must lie in [{head_cols}, {self.n_cols})")
        if bool((~true & ((idx != 0) | (self.values != 0))).any()):
            raise ValueError("PaddedCSR pad entries must be (column 0, value 0)")
        ids = torch.sort(torch.where(true, idx, -1 - torch.arange(L, device=idx.device)[None, :]), dim=1).values
        if not bool(((ids[:, 1:] == ids[:, :-1]) & (ids[:, 1:] >= 0)).any()):
            return self
        import scipy.sparse as sp

        t = true.cpu().numpy()
        rows = np.nonzero(t)[0]
        x = sp.csr_matrix((self.values.cpu().numpy()[t], (rows, self.indices.cpu().numpy()[t])),
                          shape=self.shape)  # COO -> CSR sums the duplicates
        return PaddedCSR.from_scipy(x, dtype=self.values.dtype, lane_multiple=8, device=self.values.device)

    def total_nnz(self) -> int:
        return int(self.nnz.sum())

    def column_stats(self, weights=None):
        """Per-column (mean, population SD) counting implicit zeros; zero
        variance gets SD 1.  With `weights` (n,), the weighted analog."""
        n, p = self.shape
        flat_idx = self.indices.reshape(-1).long()
        flat_val = self.values.reshape(-1).to(torch.float64)
        f64 = dict(dtype=torch.float64, device=self.values.device)
        if weights is None:
            w_flat = 1.0
            W = float(n)
        else:
            w = weights.to(torch.float64)
            w_flat = w.repeat_interleave(self.row_width)
            W = torch.clamp(torch.sum(w), min=1e-12)
        sums = torch.zeros((p,), **f64).index_add_(0, flat_idx, w_flat * flat_val)
        sq_sums = torch.zeros((p,), **f64).index_add_(0, flat_idx, w_flat * flat_val**2)
        mean = sums / W
        var = torch.clamp(sq_sums / W - mean**2, min=0.0)
        sd = torch.where(var == 0.0, torch.ones_like(var), torch.sqrt(var))
        return mean, sd

    def scale_columns(self, scale: torch.Tensor) -> "PaddedCSR":
        """Divide every nonzero by its column's scale (scale-only
        standardization; the solver carries the centering term)."""
        new_values = self.values / scale.to(self.values.dtype)[self.indices.long()]
        return PaddedCSR(self.indices, new_values, self.nnz, self.n_rows, self.n_cols)

    def pad_rows(self, n_total: int) -> "PaddedCSR":
        """Append all-zero rows up to n_total."""
        extra = n_total - self.n_rows
        if extra <= 0:
            return self
        z = lambda t: torch.zeros((extra,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)  # noqa: E731
        return PaddedCSR(torch.cat([self.indices, z(self.indices)]), torch.cat([self.values, z(self.values)]),
                         torch.cat([self.nnz, z(self.nnz)]), n_total, self.n_cols)

    def to_dense(self) -> torch.Tensor:
        """Densify (test/debug only)."""
        n, p = self.shape
        out = torch.zeros((n, p), dtype=self.values.dtype, device=self.values.device)
        rows = torch.arange(n, device=out.device)[:, None].expand(self.indices.shape)
        return out.index_put_((rows, self.indices.long()), self.values, accumulate=True)

    def row_squared_norms(self, center_scaled: torch.Tensor | None = None) -> torch.Tensor:
        """Per-row squared norms in f64; with `center_scaled` c, of the
        centered rows ||x_i - c||^2, without densifying."""
        v64 = self.values.to(torch.float64)
        row_sq = torch.sum(v64**2, dim=1)
        if center_scaled is None:
            return row_sq
        c = center_scaled.to(torch.float64)
        return row_sq - 2.0 * torch.sum(v64 * c[self.indices.long()], dim=1) + torch.sum(c**2)

    def max_squared_row_norm(self, center_scaled: torch.Tensor | None = None):
        """Max squared row norm; with `center_scaled`, of the centered rows."""
        return torch.max(self.row_squared_norms(center_scaled))

    def matvec_T(self, v: torch.Tensor) -> torch.Tensor:
        """x.T @ v for v (n,) or (n, m): (p,) or (p, m) in the values' dtype."""
        flat_idx = self.indices.reshape(-1).long()
        vt = self.values.dtype
        if v.ndim == 1:
            contrib = (self.values * v[:, None]).reshape(-1).to(vt)
            return torch.zeros((self.n_cols,), dtype=vt, device=v.device).index_add_(0, flat_idx, contrib)
        m = v.shape[1]
        contrib = (self.values[:, :, None] * v[:, None, :]).reshape(-1, m).to(vt)
        return torch.zeros((self.n_cols, m), dtype=vt, device=v.device).index_add_(0, flat_idx, contrib)

    def matmul_dense(self, w_t: torch.Tensor) -> torch.Tensor:
        """x @ w_t for dense w_t (p, k): (n, k) by gather."""
        acc = torch.promote_types(self.values.dtype, w_t.dtype)
        gathered = w_t.to(acc)[self.indices.long()]  # (n, L, k)
        return torch.einsum("nl,nlk->nk", self.values.to(acc), gathered)


# ---------------------------------------------------------------------------
# BlockCOO
# ---------------------------------------------------------------------------


def coo_lanes(entries: int, rows: int) -> int:
    """K3's lanes a row (csrc/coo_tail.cu `coo_lanes`, the same expression):
    the largest power of two, 1 to 32, not above the mean true entries a
    row of a tail of `entries` entries over `rows` block rows."""
    return 1 << ((entries >= 2 * rows) + (entries >= 4 * rows) + (entries >= 8 * rows)
                 + (entries >= 16 * rows) + (entries >= 32 * rows))


#: a column of a block with more entries than this is summed by a whole
#: warp of K4 (lanes stride over its segment) instead of one thread; K4's
#: wrapper hands the kernel this number with `heavy_cols`
HEAVY_LEN = 16


@dataclass
class BlockCOO:
    """The tail's true nonzeros packed per row block of `batch` rows (block
    sampling only):

        rows, cols, vals : (n_blocks, E)   row within the block, column, value

    E is the largest per-block count rounded up to 128; the entries of a
    block come row-major (rows ascending) and the pad entries (row 0,
    column 0, value 0) follow them.  The views below are the port's own,
    built once on the host, for the tail kernels:

        counts      (n_blocks,)          true entries per block
        row_ptr     (n_blocks, batch+1)  row segments of the true prefix (K3)
        rows_by_col (n_blocks, E)        the true entries' rows, stably sorted by column (K4)
        vals_by_col (n_blocks, E)        their values, in the same order
        col_seg     (n_blocks, p+1)      column j's segment of that order is
                                         [col_seg[j], col_seg[j+1]): a dense map
                                         over all p columns, empty where the
                                         block has no entry
        heavy_cols  (n_blocks, H)        the columns with more than HEAVY_LEN
                                         entries, ascending, padded with -1

    H = `max_heavy`, the most heavy columns of any block.  `col_seg` is
    dense: 4 (p + 1) n_blocks bytes on the device (2.4 MB for p 47000 and 13
    blocks), which grows with n_blocks x p and not with the tail's entries,
    and K4 runs p x k threads a step over it; a tail much wider than its
    entries a block would want a sparse map instead.  The tensors are
    contiguous and never reallocated or resized after construction, so the
    device address of each block's row of each view is computed once
    (`addr`, Python ints) and the kernels' wrappers index no tensor per
    call; `dataclasses.replace` and every constructor run `__post_init__`,
    which rebuilds the table and picks `lanes`, K3's lanes a row for this
    tail (`coo_lanes` of its true entries over its block rows).
    """

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    batch: int
    n_cols: int
    counts: torch.Tensor
    row_ptr: torch.Tensor
    rows_by_col: torch.Tensor
    vals_by_col: torch.Tensor
    col_seg: torch.Tensor
    heavy_cols: torch.Tensor
    max_heavy: int

    #: the views whose per-block addresses `addr` holds, in its order
    ADDRESSED = ("row_ptr", "cols", "vals", "col_seg", "rows_by_col", "vals_by_col", "heavy_cols")

    def __post_init__(self):
        views = [getattr(self, f) for f in self.ADDRESSED]
        if not all(v.is_contiguous() and v.shape[0] == self.rows.shape[0] for v in views):
            raise ValueError("BlockCOO views must be contiguous, one row a block")
        self.dtype, self.device = self.vals.dtype, self.vals.device
        #: addr[blk] = the device addresses of block blk's rows of ADDRESSED
        self.addr = [tuple(v.data_ptr() + blk * v.stride(0) * v.element_size() for v in views)
                     for blk in range(self.rows.shape[0])]
        self.lanes = coo_lanes(int(self.counts.sum()), self.rows.shape[0] * self.batch)

    @property
    def n_blocks(self) -> int:
        return self.rows.shape[0]

    @classmethod
    def from_padded(cls, tail: PaddedCSR, batch: int, lane_multiple: int = 128) -> "BlockCOO":
        """Pack a padded tail into per-block COO (host numpy; the result
        lands on the tail's device)."""
        indices = tail.indices.cpu().numpy()
        values = tail.values.cpu().numpy()
        nnz = tail.nnz.cpu().numpy()
        n, L = indices.shape
        if n % batch != 0:
            raise ValueError("tail rows must be padded to a batch multiple")
        n_blocks = n // batch
        mask = np.arange(L)[None, :] < nnz[:, None]  # true entries
        per_block = mask.reshape(n_blocks, -1).sum(axis=1)
        E = _round_up(max(int(per_block.max()) if n_blocks else 0, 1), lane_multiple)
        rows = np.zeros((n_blocks, E), np.int32)
        cols = np.zeros((n_blocks, E), np.int32)
        vals = np.zeros((n_blocks, E), values.dtype)
        row_in_block = (np.arange(n) % batch)[:, None]
        for b in range(n_blocks):
            mb = mask[b * batch : (b + 1) * batch]
            e = int(mb.sum())
            sl = slice(b * batch, (b + 1) * batch)
            rows[b, :e] = np.broadcast_to(row_in_block[:batch], (batch, L))[mb]
            cols[b, :e] = indices[sl][mb]
            vals[b, :e] = values[sl][mb]
        return cls.from_arrays(rows, cols, vals, batch, tail.n_cols, counts=per_block,
                               device=tail.values.device)

    @classmethod
    def from_arrays(cls, rows, cols, vals, batch: int, n_cols: int, counts=None, device=None) -> "BlockCOO":
        """BlockCOO from its three packed (n_blocks, E) arrays (numpy), on
        `device` (None: the card, RuntimeError without one).
        Without `counts`, a block's true prefix ends at its last entry that
        is not (0, 0, 0.0): a true entry of that form adds nothing."""
        dev = resolve_device(device)
        rows, cols, vals = (np.asarray(a) for a in (rows, cols, vals))
        n_blocks, E = rows.shape
        if counts is None:
            live = (rows != 0) | (cols != 0) | (vals != 0)
            counts = np.where(live.any(axis=1), E - np.argmax(live[:, ::-1], axis=1), 0)
        counts = np.asarray(counts, np.int32)
        row_ptr = np.zeros((n_blocks, batch + 1), np.int32)
        rows_by_col = np.zeros((n_blocks, E), np.int32)
        vals_by_col = np.zeros((n_blocks, E), vals.dtype)
        col_seg = np.zeros((n_blocks, n_cols + 1), np.int32)
        heavy = []
        for b in range(n_blocks):
            c = int(counts[b])
            r = rows[b, :c]
            if c and np.any(np.diff(r) < 0):
                raise ValueError("BlockCOO rows must ascend over each block's true entries")
            row_ptr[b] = np.searchsorted(r, np.arange(batch + 1), side="left")
            order = np.argsort(cols[b, :c], kind="stable")
            rows_by_col[b, :c] = r[order]
            vals_by_col[b, :c] = vals[b, :c][order]
            per_col = np.bincount(cols[b, :c], minlength=n_cols)
            col_seg[b, 1:] = np.cumsum(per_col)
            heavy.append(np.flatnonzero(per_col > HEAVY_LEN).astype(np.int32))
        max_heavy = max((len(h) for h in heavy), default=0)
        heavy_cols = np.full((n_blocks, max(max_heavy, 1)), -1, np.int32)
        for b, h in enumerate(heavy):
            heavy_cols[b, : len(h)] = h
        t = lambda a: torch.as_tensor(np.array(a), device=dev)  # noqa: E731
        return cls(t(rows), t(cols), t(vals), batch, n_cols, t(counts), t(row_ptr), t(rows_by_col),
                   t(vals_by_col), t(col_seg), t(heavy_cols), max_heavy)

    def to(self, device) -> "BlockCOO":
        """The same packing on `device` (its address table rebuilt there)."""
        moved = {f.name: getattr(self, f.name).to(device) for f in fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return replace(self, **moved)

    def scale_columns(self, scale: torch.Tensor) -> "BlockCOO":
        """The same packing with every value divided by its column's scale,
        on the device: bit for bit what `from_padded` packs from the tail's
        `PaddedCSR.scale_columns(scale)`.  The entries in column order are
        the scaled values gathered by a stable sort of the columns, pad
        entries last."""
        vals = self.vals / scale.to(self.vals.dtype)[self.cols.long()]
        live = torch.arange(self.cols.shape[1], device=self.cols.device)[None, :] < self.counts[:, None]
        order = torch.sort(torch.where(live, self.cols, self.n_cols), dim=1, stable=True).indices
        return replace(self, vals=vals, vals_by_col=torch.gather(vals, 1, order))


# ---------------------------------------------------------------------------
# host-side statistics of a scipy matrix
# ---------------------------------------------------------------------------


def scipy_column_stats(x, weights=None):
    """Host per-column (mean, population SD) of a scipy sparse matrix,
    zeros counted, zero variance -> SD 1; weighted with `weights` (n,)."""
    x = x.tocsr()
    n, p = x.shape
    if weights is None:
        W = float(max(n, 1))
        sums = np.asarray(x.sum(axis=0)).ravel().astype(np.float64)
        sq = np.asarray(x.multiply(x).sum(axis=0)).ravel().astype(np.float64)
    else:
        w = np.asarray(weights, np.float64)
        W = max(float(w.sum()), 1e-12)
        sums = np.asarray(x.T @ w).ravel()
        sq = np.asarray(x.multiply(x).T @ w).ravel()
    mean = sums / W
    var = np.maximum(sq / W - mean**2, 0.0)
    sd = np.where(var == 0.0, 1.0, np.sqrt(var))
    return mean, sd


def scipy_row_sq_norms(x, mean=None, sd=None):
    """Host per-row squared norms of a scipy sparse matrix: raw, or of the
    standardized design (x - mean) / sd when (mean, sd) are given, expanded
    so the centered design is never built."""
    x = x.tocsr()
    xsq = x.multiply(x)
    if mean is None:
        return np.asarray(xsq.sum(axis=1)).ravel().astype(np.float64)
    inv2 = 1.0 / (np.asarray(sd, np.float64) ** 2)
    t1 = np.asarray(xsq @ inv2).ravel()
    t2 = np.asarray(x @ (np.asarray(mean, np.float64) * inv2)).ravel()
    const = float(np.sum(np.asarray(mean, np.float64) ** 2 * inv2))
    return t1 - 2.0 * t2 + const


# ---------------------------------------------------------------------------
# the int8 head in nonzero form
# ---------------------------------------------------------------------------


class HeadNNZ:
    """Host-side nonzero form of a quantized int8 head: the quantized
    entries and the per-column level `q0` of the implicit zeros (nonzero
    when standardization is fused into the quantization)."""

    def __init__(self, rows, cols, vals, q0, n_rows, n_head):
        self.rows = rows  # (nnz_head,) int32
        self.cols = cols  # (nnz_head,) int32
        self.vals = vals  # (nnz_head,) int8
        self.q0 = q0  # (D,) int8
        self.n_rows = n_rows
        self.n_head = n_head

    def take_rows(self, perm) -> "HeadNNZ":
        """The head of x[perm]: each entry moves to its row's new place."""
        perm = np.asarray(perm)
        inv = np.empty(len(perm), np.int64)
        inv[perm] = np.arange(len(perm))
        return HeadNNZ(inv[self.rows].astype(np.int32), self.cols, self.vals, self.q0, self.n_rows, self.n_head)


def materialize_int8_head(hn: HeadNNZ, n_pad: int | None = None, device=None) -> torch.Tensor:
    """The dense (n_pad, D) int8 head, built on `device` from its nonzero
    form: the q0 base on the real rows, zeros on the pad rows, and one
    scatter (`index_put_`) of the entries.  Bit-identical to the dense head
    `split_columns` builds, padded with zero rows."""
    n_pad = hn.n_rows if n_pad is None else int(n_pad)
    if n_pad < hn.n_rows:
        raise ValueError(f"n_pad ({n_pad}) must be at least the head's {hn.n_rows} rows")
    dev = resolve_device(device)
    head = torch.zeros((n_pad, hn.n_head), dtype=torch.int8, device=dev)
    head[: hn.n_rows] = torch.as_tensor(hn.q0, device=dev)
    idx = (torch.as_tensor(hn.rows, device=dev).long(), torch.as_tensor(hn.cols, device=dev).long())
    return head.index_put_(idx, torch.as_tensor(hn.vals, device=dev))


# ---------------------------------------------------------------------------
# HybridCSR
# ---------------------------------------------------------------------------


@dataclass
class HybridCSR:
    """Dense-head / sparse-tail design matrix: the D most frequent columns
    as a dense (n, D) block (f32, f64, bf16 or int8 with per-column
    `head_scale`), the rest as a PaddedCSR tail over the full column
    range.  An exact column split of the same matrix."""

    head: torch.Tensor
    tail: PaddedCSR
    n_rows: int
    n_cols: int
    blk_tail: BlockCOO | None = None
    head_scale: torch.Tensor | None = None

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def n_head(self) -> int:
        return self.head.shape[1]

    @classmethod
    def split_columns(cls, x_scipy, coverage: float = 0.75, max_head: int = 4096, dtype=torch.float32,
                      memory_budget: float | None = None, head_dtype=None, std_stats=None,
                      head_form: str = "dense", device=None):
        """Head = the smallest set of most-frequent columns covering
        `coverage` of all nonzeros (capped at max_head, by
        memory_budget / (n * itemsize), rounded up to 128); returns
        (HybridCSR, perm) with perm mapping new column -> original.

        `head_dtype` sets the head's storage (default `dtype`); "int8"
        quantizes per column on the host, and with `std_stats=(mean, sd)`
        (original column order) quantizes the standardized values, the
        tail then scale-only.  `head_form="nnz"` (int8 only) leaves the head
        as a host `HeadNNZ` for `materialize_int8_head`."""
        dev = resolve_device(device)
        head_dtype = as_head_dtype(head_dtype)
        quant_int8 = head_dtype == torch.int8
        if std_stats is not None and not quant_int8:
            raise ValueError("std_stats is only supported with head_dtype=int8")
        if head_form not in ("dense", "nnz"):
            raise ValueError("head_form must be 'dense' or 'nnz'")
        if head_form == "nnz" and not quant_int8:
            raise ValueError("head_form='nnz' requires head_dtype=int8")
        if quant_int8:
            head_dtype = None
        x = canonical_csr(x_scipy)
        n, p = x.shape
        col_nnz = np.bincount(x.indices, minlength=p)
        order = np.argsort(-col_nnz, kind="stable")  # hottest first
        covered = np.cumsum(col_nnz[order])
        total = max(int(covered[-1]) if len(covered) else 0, 1)
        d = int(np.searchsorted(covered, coverage * total) + 1)
        if memory_budget is not None:  # cap head bytes: n * D * itemsize
            itemsize = (torch.int8 if quant_int8 else head_dtype or dtype).itemsize
            d = min(d, max(int(memory_budget // (n * itemsize)), 1))
        d = max(min(d, max_head, p), 1)
        d = _round_up(d, 128) if d < p else p
        d = min(d, p)
        perm = np.concatenate([order[:d], np.sort(order[d:])]).astype(np.int64)
        new_col = np.empty(p, dtype=np.int64)
        new_col[perm] = np.arange(p)

        mapped = new_col[x.indices]  # new column index per nonzero
        row_of = np.repeat(np.arange(n), np.diff(x.indptr))
        is_head = mapped < d
        head_scale = None

        if quant_int8:
            # quantize sparse-side: only the head's nonzeros are touched, and
            # the zeros never move a symmetric column max
            hv = x.data[is_head].astype(np.float64)
            hc = mapped[is_head]
            hr = row_of[is_head]
            if std_stats is not None:
                mean_o, sd_o = std_stats
                m = np.asarray(mean_o, np.float64)[perm[:d]]
                s = np.asarray(sd_o, np.float64)[perm[:d]]
                hv = (hv - m[hc]) / s[hc]
                z = -m / s  # the level of a column's implicit zeros
                head_col_nnz = np.bincount(hc, minlength=d)
                colmax = np.where(head_col_nnz == n, 0.0, np.abs(z))
            else:
                z = None
                colmax = np.zeros(d, np.float64)
            np.maximum.at(colmax, hc, np.abs(hv))
            scale = colmax / 127.0
            scale[scale == 0.0] = 1.0
            q0 = np.clip(np.rint(z / scale), -127, 127).astype(np.int8) if z is not None else np.zeros(d, np.int8)
            qv = np.clip(np.rint(hv / scale[hc]), -127, 127).astype(np.int8)
            head = HeadNNZ(hr.astype(np.int32), hc.astype(np.int32), qv, q0, n, d)
            if head_form == "dense":
                head = materialize_int8_head(head, device=dev)
            head_scale = torch.as_tensor(scale, device=dev).to(torch.float32)
        else:
            hd = head_dtype if head_dtype is not None else dtype
            head = torch.zeros((n, d), dtype=hd, device=dev)
            hvals = torch.as_tensor(x.data[is_head].astype(_np_float(dtype)), device=dev).to(hd)
            idx = (torch.as_tensor(row_of[is_head], device=dev), torch.as_tensor(mapped[is_head], device=dev))
            head.index_put_(idx, hvals)

        # the tail's entries, packed row-padded
        t_rows = row_of[~is_head]
        t_cols = mapped[~is_head].astype(np.int32)
        t_vals = x.data[~is_head]
        if std_stats is not None:
            sd_new = np.asarray(std_stats[1], np.float64)[perm]
            t_vals = t_vals.astype(np.float64) / sd_new[t_cols]
        t_nnz = np.bincount(t_rows, minlength=n).astype(np.int32)
        L = _round_up(max(int(t_nnz.max()) if n else 0, 1), 8)
        pos = np.arange(len(t_rows)) - np.repeat(np.concatenate([[0], np.cumsum(t_nnz)[:-1]]), t_nnz)
        ti = np.zeros((n, L), np.int32)
        tv = np.zeros((n, L), np.float64)
        ti[t_rows, pos] = t_cols
        tv[t_rows, pos] = t_vals
        tail = PaddedCSR(torch.as_tensor(ti, device=dev), torch.as_tensor(tv, device=dev).to(dtype),
                         torch.as_tensor(t_nnz, device=dev), n, p)
        return cls(head, tail, n, p, head_scale=head_scale), perm

    def ingest(self, device, dtype) -> "HybridCSR":
        """A prebuilt layout as `fit` takes it: on `device`, the tail's
        values in `dtype`, the tail checked by `PaddedCSR.canonical` (its
        true entries off the head's columns), the head's rows those of the
        layout, an int8 head with its (D,) scales and no NaN in a float
        head; the BlockCOO is left out (the fit packs its own)."""
        n, d = self.head.shape
        if n != self.n_rows or self.tail.n_rows != self.n_rows or self.tail.n_cols != self.n_cols or d > self.n_cols:
            raise ValueError(f"HybridCSR parts do not match its shape: head {tuple(self.head.shape)}, tail "
                             f"{self.tail.shape}, layout {self.shape}")
        quantized = self.head.dtype == torch.int8
        if quantized != (self.head_scale is not None) or (quantized and tuple(self.head_scale.shape) != (d,)):
            raise ValueError("an int8 head needs its (D,) head_scale, and only an int8 head has one")
        head = self.head.to(device)
        if not quantized and any(bool(torch.isnan(head[s:e]).any()) for s, e in _row_chunks(n, d)):
            raise ValueError("NA values are not allowed.")
        tail = self.tail.to(device, dtype).canonical(head_cols=d)
        scale = None if self.head_scale is None else self.head_scale.to(device)
        return HybridCSR(head, tail, self.n_rows, self.n_cols, head_scale=scale)

    def quantize_head(self) -> "HybridCSR":
        """Symmetric per-column int8 quantization of the head: scale_j =
        max|head_ij| / 127, q = round(head / scale) (half to even), in f32."""
        if self.head.dtype == torch.int8:
            return self
        n, d = self.head.shape
        colmax = torch.zeros((d,), dtype=torch.float32, device=self.head.device)
        for s, e in _row_chunks(n, d):
            colmax = torch.maximum(colmax, torch.amax(torch.abs(self.head[s:e].to(torch.float32)), dim=0))
        scale = colmax * (1.0 / 127.0)  # as XLA computes max / 127: by the reciprocal, bit for bit
        scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
        q = torch.empty((n, d), dtype=torch.int8, device=self.head.device)
        for s, e in _row_chunks(n, d):
            q[s:e] = torch.clamp(torch.round(self.head[s:e].to(torch.float32) / scale), -127, 127).to(torch.int8)
        return replace(self, head=q, head_scale=scale)

    def column_stats(self, weights=None):
        """Per-column (mean, population SD): the head densely (two passes in
        f64 over row chunks), the tail sparse-aware."""
        if self.head.dtype == torch.int8:
            raise ValueError("column_stats before quantize_head")
        n, d = self.head.shape
        f64 = dict(dtype=torch.float64, device=self.head.device)
        w = None if weights is None else weights.to(torch.float64).reshape(-1, 1)
        W = float(n) if w is None else torch.clamp(torch.sum(w), min=1e-12)
        s1 = torch.zeros((d,), **f64)
        for s, e in _row_chunks(n, d):
            h = self.head[s:e].to(torch.float64)
            s1 += torch.sum(h if w is None else h * w[s:e], dim=0)
        h_mean = s1 / W
        s2 = torch.zeros((d,), **f64)
        for s, e in _row_chunks(n, d):
            r2 = (self.head[s:e].to(torch.float64) - h_mean) ** 2
            s2 += torch.sum(r2 if w is None else w[s:e] * r2, dim=0)
        h_var = s2 / W
        h_sd = torch.where(h_var == 0.0, torch.ones_like(h_var), torch.sqrt(h_var))
        mean, sd = self.tail.column_stats(weights)
        mean[:d] = h_mean
        sd[:d] = h_sd
        return mean, sd

    def standardize(self, mean: torch.Tensor, sd: torch.Tensor, donate: bool = False):
        """Head: center and scale (in f64 per row chunk, back to the head's
        type); tail: scale only, the solver carrying the centering term xc
        (zero on head columns).  `donate=True` overwrites the head in place
        (callers that own it), so a multi-GB head is never duplicated.
        Returns (HybridCSR, xc)."""
        if self.head.dtype == torch.int8:
            raise ValueError("standardize before quantize_head")
        n, d = self.head.shape
        out = self.head if donate else torch.empty_like(self.head)
        m, s_ = mean[:d].to(torch.float64), sd[:d].to(torch.float64)
        for s, e in _row_chunks(n, d):
            out[s:e] = ((self.head[s:e].to(torch.float64) - m) / s_).to(self.head.dtype)
        xc = (mean / sd).clone()
        xc[:d] = 0.0
        return HybridCSR(out, self.tail.scale_columns(sd), self.n_rows, self.n_cols), xc

    def take_rows(self, perm: torch.Tensor) -> "HybridCSR":
        """The rows of self in the order `perm` (head and tail)."""
        return replace(self, head=self.head[perm], tail=self.tail.take_rows(perm))

    def pad_rows(self, n_total: int) -> "HybridCSR":
        extra = n_total - self.n_rows
        if extra <= 0:
            return self
        pad = torch.zeros((extra, self.n_head), dtype=self.head.dtype, device=self.head.device)
        return replace(self, head=torch.cat([self.head, pad]), tail=self.tail.pad_rows(n_total), n_rows=n_total)

    def total_nnz(self) -> int:
        # by row chunks: count_nonzero of the whole head makes bool and int64
        # temporaries of the head's shape (9 bytes an element)
        n, d = self.head.shape
        head_nnz = sum(int(torch.count_nonzero(self.head[s:e])) for s, e in _row_chunks(n, d))
        return head_nnz + self.tail.total_nnz()

    def row_squared_norms(self, xc: torch.Tensor | None = None) -> torch.Tensor:
        """Per-row ||x_i - c||^2 (the head is already centered; c applies to
        the tail)."""
        n, d = self.head.shape
        h = torch.empty((n,), dtype=torch.float64, device=self.head.device)
        sc = None if self.head_scale is None else self.head_scale.to(torch.float64)
        for s, e in _row_chunks(n, d):
            hb = self.head[s:e].to(torch.float64)
            h[s:e] = torch.sum((hb if sc is None else hb * sc) ** 2, dim=1)
        return h + self.tail.row_squared_norms(xc)

    def head_forward(self, hb: torch.Tensor, w_h: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
        """hb @ w_h.T for a row block hb of the head and w_h (k, D), summed
        in `acc`: an int8 head folds its scales into w and multiplies in
        bf16; a bf16 head casts w to bf16."""
        if hb.dtype == torch.int8:
            wh = (w_h * self.head_scale.to(w_h.dtype)).to(torch.bfloat16)
            return mm_acc(hb.to(torch.bfloat16), wh.T, acc)
        return mm_acc(hb, w_h.to(hb.dtype).T, acc)

    def head_backward(self, hb: torch.Tensor, g: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
        """g.T @ hb (k, D) for a row block hb and g (rows, k), summed in
        `acc`; an int8 head applies its scales to the (k, D) result."""
        if hb.dtype == torch.int8:
            return mm_acc(g.to(torch.bfloat16).T, hb.to(torch.bfloat16), acc) * self.head_scale.to(acc)[None, :]
        return mm_acc(g.to(hb.dtype).T, hb, acc)

    def matvec_T(self, v: torch.Tensor, tail: torch.Tensor | None = None) -> torch.Tensor:
        """x.T @ v, v (n,) or (n, m): head by products over row chunks,
        tail by scatter, or `tail`, the tail's part already summed (the
        refresh's K5; written into); in the tail's dtype."""
        v2 = v if v.ndim == 2 else v[:, None]
        if tail is not None and tuple(tail.shape) != (self.n_cols, v2.shape[1]):
            raise ValueError(f"matvec_T: the summed tail is {tuple(tail.shape)}, not ({self.n_cols}, {v2.shape[1]})")
        t = self.tail.matvec_T(v) if tail is None else tail
        if self.head.dtype == torch.int8:
            acc = torch.float32  # the int8 head's products accumulate in f32
        else:
            acc = torch.promote_types(self.head.dtype, v.dtype)
        n, d = self.head.shape
        h = torch.zeros((v2.shape[1], d), dtype=acc, device=v.device)
        for s, e in _row_chunks(n, d):
            h += self.head_backward(self.head[s:e], v2[s:e], acc)
        h = h.T.to(t.dtype)
        if v.ndim == 1:
            t[:d] += h[:, 0]
        else:
            t[:d] += h
        return t

    def matmul_dense(self, w_t: torch.Tensor) -> torch.Tensor:
        """x @ w_t, w_t (p, k) -> (n, k)."""
        n, d = self.head.shape
        if self.head.dtype == torch.int8:
            head_acc, acc = torch.float32, torch.promote_types(torch.float32, w_t.dtype)
        else:
            head_acc = acc = torch.promote_types(self.head.dtype, w_t.dtype)
        w_h = w_t[:d].T.to(head_acc if self.head.dtype == torch.int8 else w_t.dtype)
        h = torch.cat([self.head_forward(self.head[s:e], w_h, head_acc) for s, e in _row_chunks(n, d)])
        return h.to(acc) + self.tail.matmul_dense(w_t).to(acc)
