"""The BlockCOO tail ops K3 / K4 (solver/tail_kernel.py) on the CPU.

  * the twins against the JAX package's `_coo_batch_predict` /
    `_coo_batch_outer` on the same BlockCOO (carried over with
    utils/convert.layout_from_jax), pad entries and repeated columns
    included: within 1e-12 at f64 (both are the same scatter-add);
  * the segment walks the CUDA kernels make over the port's views
    (`row_ptr`; `col_order` / `col_ids` / `col_ptr`), replayed here in
    numpy: they give the twins' sums (1e-12) and never read a pad entry;
  * the views themselves, and the wrappers' CPU dispatch (no launch is
    counted).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sgdnet_tpu.core import sparse as jsparse
from sgdnet_tpu.solver import saga as jsaga
from sgdnet_tpu_torch.core.sparse import BlockCOO, PaddedCSR
from sgdnet_tpu_torch.solver import tail_kernel as tk
from sgdnet_tpu_torch.utils.convert import layout_from_jax

torch.set_num_threads(1)


def _tail(seed, n=192, p=300, per_row=7, B=64):
    """A row-padded tail whose rows repeat columns across a block (Zipf
    columns), with some empty rows, packed for blocks of B rows."""
    rng = np.random.default_rng(seed)
    w = (np.arange(p) + 5.0) ** -1.1
    counts = rng.integers(0, per_row + 1, n)
    counts[::17] = 0
    rows = np.repeat(np.arange(n), counts)
    cols = np.searchsorted(np.cumsum(w) / w.sum(), rng.random(len(rows))).clip(0, p - 1)
    x = sp.csr_matrix((rng.normal(size=len(rows)), (rows, cols)), shape=(n, p))
    x.sum_duplicates()
    jt = jsparse.PaddedCSR.from_scipy(x, dtype=jnp.float64)
    return jsparse.BlockCOO.from_padded(jt, B), x


@pytest.fixture(scope="module", params=[0, 1])
def blocks(request):
    jb, x = _tail(request.param)
    return jb, layout_from_jax(jb), x


def test_block_coo_carries_over_and_views_hold(blocks):
    jb, tb, x = blocks
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)))
    # the port's own packing of the same tail is bit-identical, and its
    # counts are exact
    tp = PaddedCSR.from_scipy(x, dtype=torch.float64, device="cpu")
    own = BlockCOO.from_padded(tp, jb.batch)
    for f in ("rows", "cols", "vals", "counts", "row_ptr", "col_order", "col_ids", "col_ptr", "n_distinct"):
        np.testing.assert_array_equal(getattr(own, f).numpy(), getattr(tb, f).numpy(), err_msg=f)
    B = jb.batch
    for b in range(tb.n_blocks):
        c = int(tb.counts[b])
        assert c == int(x[b * B : (b + 1) * B].nnz)
        rows, cols = tb.rows[b, :c].numpy(), tb.cols[b, :c].numpy()
        np.testing.assert_array_equal(np.diff(tb.row_ptr[b].numpy()), np.bincount(rows, minlength=B))
        order = tb.col_order[b, :c].numpy()
        assert sorted(order) == list(range(c)) and np.all(np.diff(cols[order]) >= 0)
        u = int(tb.n_distinct[b])
        np.testing.assert_array_equal(tb.col_ids[b, :u].numpy(), np.unique(cols))
    assert (tb.counts < tb.rows.shape[1]).all() or tb.rows.shape[1] % 128 == 0


def _walk_forward(tb, blk, w):
    """K3's segment walk: one (row, class) sums its row segment in order."""
    B, k = tb.batch, w.shape[0]
    rp, cols, vals = tb.row_ptr[blk].numpy(), tb.cols[blk].numpy(), tb.vals[blk].numpy()
    out = np.zeros((B, k))
    for r in range(B):
        for e in range(rp[r], rp[r + 1]):
            out[r] += vals[e] * w[:, cols[e]]
    assert rp[B] == int(tb.counts[blk])  # the pad entries are never read
    return out


def _walk_outer(tb, blk, gc):
    """K4's segment walk: one (column, class) sums its column segment."""
    k, p = gc.shape[1], tb.n_cols
    cp, ids, order = tb.col_ptr[blk].numpy(), tb.col_ids[blk].numpy(), tb.col_order[blk].numpy()
    rows, vals = tb.rows[blk].numpy(), tb.vals[blk].numpy()
    corr = np.zeros((k, p))
    for u in range(int(tb.n_distinct[blk])):
        acc = np.zeros(k)
        for s in range(cp[u], cp[u + 1]):
            e = order[s]
            acc += vals[e] * gc[rows[e]]
        corr[:, ids[u]] = acc
    return corr


@pytest.mark.parametrize("k", [1, 3])
def test_tail_twins_match_jax(blocks, k):
    jb, tb, _ = blocks
    rng = np.random.default_rng(k)
    w = rng.normal(size=(k, jb.n_cols))
    gc = rng.normal(size=(jb.batch, k))
    for blk in range(tb.n_blocks):
        f_ref = np.asarray(jsaga._coo_batch_predict(jb, jnp.asarray(w), blk, jb.batch))
        o_ref = np.asarray(jsaga._coo_batch_outer(jb, jnp.asarray(gc), blk))
        f = tk.coo_tail_forward(tb, blk, torch.tensor(w)).numpy()
        o = tk.coo_tail_outer(tb, blk, torch.tensor(gc)).numpy()
        np.testing.assert_allclose(f, f_ref, rtol=0, atol=1e-12 * max(1.0, np.abs(f_ref).max()))
        np.testing.assert_allclose(o, o_ref, rtol=0, atol=1e-12 * max(1.0, np.abs(o_ref).max()))


@pytest.mark.parametrize("k", [1, 2])
def test_kernel_segment_walks_match_twins(blocks, k):
    _, tb, _ = blocks
    rng = np.random.default_rng(10 + k)
    w = rng.normal(size=(k, tb.n_cols))
    gc = rng.normal(size=(tb.batch, k))
    for blk in range(tb.n_blocks):
        f = tk.coo_tail_forward_reference(tb, blk, torch.tensor(w)).numpy()
        o = tk.coo_tail_outer_reference(tb, blk, torch.tensor(gc)).numpy()
        np.testing.assert_allclose(_walk_forward(tb, blk, w), f, rtol=0, atol=1e-12 * max(1.0, np.abs(f).max()))
        np.testing.assert_allclose(_walk_outer(tb, blk, gc), o, rtol=0, atol=1e-12 * max(1.0, np.abs(o).max()))


def test_cpu_tensors_run_the_twins_and_count_no_launch(blocks):
    _, tb, _ = blocks
    before = (tk.coo_tail_forward.launches, tk.coo_tail_outer.launches)
    w = torch.ones((1, tb.n_cols), dtype=torch.float64)
    torch.testing.assert_close(tk.coo_tail_forward(tb, 0, w), tk.coo_tail_forward_reference(tb, 0, w))
    gc = torch.ones((tb.batch, 1), dtype=torch.float64)
    torch.testing.assert_close(tk.coo_tail_outer(tb, 0, gc), tk.coo_tail_outer_reference(tb, 0, gc))
    assert (tk.coo_tail_forward.launches, tk.coo_tail_outer.launches) == before


def test_counts_recovered_from_pad_entries():
    """A JAX BlockCOO carries no counts: the port recovers them from the
    (0, 0, 0) pad entries, and a block that is all padding counts 0."""
    rows = np.array([[0, 1, 1, 0, 0], [0, 0, 0, 0, 0]], np.int32)
    cols = np.array([[4, 2, 4, 0, 0], [0, 0, 0, 0, 0]], np.int32)
    vals = np.array([[1.0, 2.0, 3.0, 0.0, 0.0], [0.0] * 5])
    b = BlockCOO.from_arrays(rows, cols, vals, batch=2, n_cols=6)
    assert b.counts.tolist() == [3, 0] and b.n_distinct.tolist() == [2, 0] and b.max_distinct == 2
    assert b.row_ptr.tolist() == [[0, 1, 3], [0, 0, 0]]
    assert b.col_ids[0].tolist() == [2, 4] and b.col_ptr[0].tolist() == [0, 1, 3]
    assert b.col_order[0, :3].tolist() == [1, 0, 2]
    with pytest.raises(ValueError, match="ascend"):
        BlockCOO.from_arrays(np.array([[1, 0]], np.int32), np.array([[0, 1]], np.int32), np.ones((1, 2)), 2, 3)
