"""The BlockCOO tail ops K3 / K4 (solver/tail_kernel.py) on the CPU.

  * the twins against the JAX package's `_coo_batch_predict` /
    `_coo_batch_outer` on the same BlockCOO (carried over with
    utils/convert.layout_from_jax), pad entries and repeated columns
    included: within 1e-12 at f64 (both are the same scatter-add);
  * the segment walks the CUDA kernels make over the port's views
    (`row_ptr`; `rows_by_col` / `vals_by_col` / `col_seg` / `heavy_cols`),
    replayed here in numpy, K4's warp sum of a heavy column lane by lane:
    they give the twins' sums (1e-12) and never read a pad entry, also on
    a block with a column heavier than HEAVY_LEN and on an empty block;
  * the views themselves, the per-block address table, and the wrappers'
    CPU dispatch (no launch is counted);
  * K3's epilogue: the plain version with base, intercept and offsets
    against the JAX package's `_coo_batch_predict` followed by the same
    adds in the same order, at k 1, 3 and 10 (1e-12 at f64), and the
    step's linear predictor assembled by it against the unfused ops;
  * K3's lane groups: the walk of G lanes a row (entries l, l + G, ... a
    lane, then the xor butterfly) replayed in numpy at every G gives the
    twin's sums, and G is the .cu file's formula of the tail's mean row
    length (the expression between its markers, evaluated here).
"""

import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sgdnet_tpu.core import sparse as jsparse
from sgdnet_tpu.solver import saga as jsaga
from sgdnet_tpu_torch.core.sparse import HEAVY_LEN, BlockCOO, HybridCSR, PaddedCSR, coo_lanes
from sgdnet_tpu_torch.solver import tail_kernel as tk
from sgdnet_tpu_torch.utils.convert import layout_from_jax

torch.set_num_threads(1)


def _tail(seed, n=192, p=300, per_row=7, B=64):
    """A row-padded tail whose rows repeat columns across a block (Zipf
    columns), with some empty rows, packed for blocks of B rows.  Seed 2
    also puts column 3 into most rows (a column of more than 2 x HEAVY_LEN
    entries in a block) and leaves the second of its 4 blocks empty."""
    rng = np.random.default_rng(seed)
    w = (np.arange(p) + 5.0) ** -1.1
    if seed == 2:
        n = 4 * B
    counts = rng.integers(0, per_row + 1, n)
    counts[::17] = 0
    if seed == 2:
        counts[B : 2 * B] = 0
    rows = np.repeat(np.arange(n), counts)
    cols = np.searchsorted(np.cumsum(w) / w.sum(), rng.random(len(rows))).clip(0, p - 1)
    if seed == 2:
        cols[np.r_[True, np.diff(rows) > 0]] = 3  # each non-empty row's first entry
    x = sp.csr_matrix((rng.normal(size=len(rows)), (rows, cols)), shape=(n, p))
    x.sum_duplicates()
    jt = jsparse.PaddedCSR.from_scipy(x, dtype=jnp.float64)
    return jsparse.BlockCOO.from_padded(jt, B), x


@pytest.fixture(scope="module", params=[0, 1, 2])
def blocks(request):
    jb, x = _tail(request.param)
    return jb, layout_from_jax(jb, device="cpu"), x


def test_block_coo_carries_over_and_views_hold(blocks):
    jb, tb, x = blocks
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)))
    # the port's own packing of the same tail is bit-identical, and its
    # counts are exact
    tp = PaddedCSR.from_scipy(x, dtype=torch.float64, device="cpu")
    own = BlockCOO.from_padded(tp, jb.batch)
    fields = ("rows", "cols", "vals", "counts", "row_ptr", "rows_by_col", "vals_by_col", "col_seg", "heavy_cols")
    for f in fields:
        np.testing.assert_array_equal(getattr(own, f).numpy(), getattr(tb, f).numpy(), err_msg=f)
    assert own.max_heavy == tb.max_heavy
    B = jb.batch
    for b in range(tb.n_blocks):
        c = int(tb.counts[b])
        assert c == int(x[b * B : (b + 1) * B].nnz)
        rows, cols, vals = tb.rows[b, :c].numpy(), tb.cols[b, :c].numpy(), tb.vals[b, :c].numpy()
        np.testing.assert_array_equal(np.diff(tb.row_ptr[b].numpy()), np.bincount(rows, minlength=B))
        # the column-ordered copy is the stable sort by column, and col_seg
        # maps every one of the p columns to its segment of it
        order = np.argsort(cols, kind="stable")
        np.testing.assert_array_equal(tb.rows_by_col[b, :c].numpy(), rows[order])
        np.testing.assert_array_equal(tb.vals_by_col[b, :c].numpy(), vals[order])
        seg = tb.col_seg[b].numpy()
        assert seg[0] == 0 and seg[-1] == c and len(seg) == tb.n_cols + 1
        np.testing.assert_array_equal(np.diff(seg), np.bincount(cols, minlength=tb.n_cols))
        heavy = tb.heavy_cols[b].numpy()
        np.testing.assert_array_equal(heavy[heavy >= 0], np.flatnonzero(np.diff(seg) > HEAVY_LEN))
        assert (heavy[: (heavy >= 0).sum()] >= 0).all()  # the -1 pad comes last
    assert (tb.counts < tb.rows.shape[1]).all() or tb.rows.shape[1] % 128 == 0
    # the address table: one tuple a block, each view's row of that block;
    # any new BlockCOO (dataclasses.replace too) rebuilds it from its own tensors
    assert len(tb.addr) == tb.n_blocks and tb.dtype == tb.vals.dtype and tb.device == tb.vals.device
    for b in range(tb.n_blocks):
        for a, f in zip(tb.addr[b], BlockCOO.ADDRESSED):
            assert a == getattr(tb, f)[b].data_ptr(), f
    moved = dataclasses.replace(tb, vals=tb.vals.clone())
    assert moved.addr[0][2] == moved.vals.data_ptr() != tb.addr[0][2]
    with pytest.raises(ValueError, match="contiguous"):
        dataclasses.replace(tb, col_seg=tb.col_seg[:, ::2])


def test_heavy_and_empty_blocks_are_in_the_cases():
    """Seed 2 is the case the balanced K4 walk exists for: a column above
    2 x HEAVY_LEN entries in a block, and a block without entries."""
    tb = layout_from_jax(_tail(2)[0], device="cpu")
    per_col = np.diff(tb.col_seg.numpy(), axis=1)
    assert per_col.max() > 2 * HEAVY_LEN and tb.max_heavy >= 1
    assert tb.counts.tolist()[1] == 0 and (tb.heavy_cols[1] == -1).all() and (tb.col_seg[1] == 0).all()
    # and a tail without heavy columns packs a -1 column
    assert layout_from_jax(_tail(0)[0], device="cpu").max_heavy == 0


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
    """K4's walk: every column of corr is written.  A light (column, class)
    is one thread summing its segment of the column-ordered copy in order;
    a heavy column is a warp: lane l sums entries l, l + 32, ... in order,
    then the 32 lane sums meet in the xor butterfly of `warp_sum_t`."""
    k, p = gc.shape[1], tb.n_cols
    seg, heavy = tb.col_seg[blk].numpy(), tb.heavy_cols[blk].numpy()
    rows, vals = tb.rows_by_col[blk].numpy(), tb.vals_by_col[blk].numpy()
    corr = np.full((k, p), np.nan)
    for j in range(p):
        if seg[j + 1] - seg[j] > HEAVY_LEN:
            continue  # a warp of the heavy CTAs writes it
        acc = np.zeros(k)
        for s in range(seg[j], seg[j + 1]):
            acc += vals[s] * gc[rows[s]]
        corr[:, j] = acc
    for j in heavy[heavy >= 0]:
        lanes = np.zeros((32, k))
        for lane in range(32):
            for s in range(seg[j] + lane, seg[j + 1], 32):
                lanes[lane] += vals[s] * gc[rows[s]]
        for o in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[np.arange(32) ^ o]
        assert (lanes == lanes[0]).all()  # every lane ends with the same bits
        corr[:, j] = lanes[0]
    assert seg[p] == int(tb.counts[blk]) and not np.isnan(corr).any()  # no pad entry read, no column left out
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
    b = BlockCOO.from_arrays(rows, cols, vals, batch=2, n_cols=6, device="cpu")
    assert b.counts.tolist() == [3, 0] and b.max_heavy == 0 and b.heavy_cols.tolist() == [[-1], [-1]]
    assert b.row_ptr.tolist() == [[0, 1, 3], [0, 0, 0]]
    assert b.col_seg.tolist() == [[0, 0, 0, 1, 1, 3, 3], [0] * 7]
    assert b.rows_by_col[0, :3].tolist() == [1, 0, 1] and b.vals_by_col[0, :3].tolist() == [2.0, 1.0, 3.0]
    with pytest.raises(ValueError, match="ascend"):
        BlockCOO.from_arrays(np.array([[1, 0]], np.int32), np.array([[0, 1]], np.int32), np.ones((1, 2)), 2, 3,
                             device="cpu")


# ---------------------------------------------------------------------------
# K3's epilogue and lane groups
# ---------------------------------------------------------------------------

EPILOGUES = {"none": (), "base": ("base",), "intercept_offs": ("intercept", "offs"),
             "all": ("base", "intercept", "offs")}


@pytest.mark.parametrize("which", list(EPILOGUES))
@pytest.mark.parametrize("k", [1, 3, 10])
def test_forward_epilogue_matches_jax(blocks, k, which):
    """((base + tail) + intercept) + offs: the JAX package's tail forward
    followed by the step's adds, in that order, against K3's plain version
    with the same operands, 1e-12 at f64."""
    jb, tb, _ = blocks
    rng = np.random.default_rng(100 + k)
    w = rng.normal(size=(k, jb.n_cols))
    ops = {"base": rng.normal(size=(jb.batch, k)), "intercept": rng.normal(size=k),
           "offs": rng.normal(size=(jb.batch, k))}
    given = {name: ops[name] for name in EPILOGUES[which]}
    for blk in range(tb.n_blocks):
        ref = jsaga._coo_batch_predict(jb, jnp.asarray(w), blk, jb.batch)
        if "base" in given:
            ref = jnp.asarray(given["base"]) + ref
        if "intercept" in given:
            ref = ref + jnp.asarray(given["intercept"])
        if "offs" in given:
            ref = ref + jnp.asarray(given["offs"])
        ref = np.asarray(ref)
        out = tk.coo_tail_forward(tb, blk, torch.tensor(w), **{n: torch.tensor(v) for n, v in given.items()})
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12 * max(1.0, np.abs(ref).max()))


def _walk_forward_lanes(tb, blk, w, G):
    """K3's walk at G lanes a row: lane l of row r sums entries
    row_ptr[r] + l, + l + G, ... in order, then the G lane sums meet in the
    xor butterfly (offsets G/2, ..., 1), which leaves the same bits in
    every lane of the group."""
    B, k = tb.batch, w.shape[0]
    rp, cols, vals = tb.row_ptr[blk].numpy(), tb.cols[blk].numpy(), tb.vals[blk].numpy()
    out = np.zeros((B, k))
    for r in range(B):
        lanes = np.zeros((G, k))
        for lane in range(G):
            for e in range(rp[r] + lane, rp[r + 1], G):
                lanes[lane] += vals[e] * w[:, cols[e]]
        o = G // 2
        while o:
            lanes = lanes + lanes[np.arange(G) ^ o]
            o //= 2
        assert (lanes == lanes[0]).all()
        out[r] = lanes[0]
    return out


@pytest.mark.parametrize("G", [1, 2, 4, 8, 16, 32])
def test_lane_group_walk_matches_twin(G):
    tb = layout_from_jax(_tail(2)[0], device="cpu")  # a heavy column and an empty block
    w = np.random.default_rng(G).normal(size=(3, tb.n_cols))
    for blk in range(tb.n_blocks):
        f = tk.coo_tail_forward_reference(tb, blk, torch.tensor(w)).numpy()
        np.testing.assert_allclose(_walk_forward_lanes(tb, blk, w, G), f, rtol=0,
                                   atol=1e-12 * max(1.0, np.abs(f).max()))


CU = os.path.join(os.path.dirname(__file__), os.pardir, "sgdnet_tpu_torch", "csrc", "coo_tail.cu")


def test_lanes_formula_is_the_cu_files():
    """The .cu file's `coo_lanes` expression, evaluated here, is
    core/sparse.py's; a BlockCOO's lanes are it at its entries and block
    rows; and the design points of the slices' tails on the card (13 blocks
    of 8192 rows): slice D's ~1.5 entries a row give 1 lane, slice C's ~4.7
    give 4, slice E's ~17 give 16."""
    expr = " ".join(re.search(r"/\* LANES-FORMULA \*/(.*?)/\* END-FORMULA \*/", open(CU).read(), re.S)
                    .group(1).split())
    rng = np.random.default_rng(0)
    for _ in range(500):
        rows = int(rng.integers(1, 200000))
        entries = int(rng.integers(0, 40 * rows))
        assert eval(expr, {}, {"entries": entries, "rows": rows}) == coo_lanes(entries, rows)
    assert [coo_lanes(m * 100, 100) for m in (0, 1, 2, 3, 4, 8, 16, 17, 31, 32, 64)] == \
        [1, 1, 2, 2, 4, 8, 16, 16, 16, 32, 32]
    assert [coo_lanes(int(m * 106496), 106496) for m in (1.5, 4.66, 16.95)] == [1, 4, 16]
    for seed in (0, 1, 2):
        tb = layout_from_jax(_tail(seed)[0], device="cpu")
        assert tb.lanes == coo_lanes(int(tb.counts.sum()), tb.n_blocks * tb.batch)


def test_step_linear_predictor_through_the_epilogue():
    """The step's and the loss pass's linear predictor on the BlockCOO
    path, ((head + tail) + intercept) + offs assembled by K3's epilogue,
    equals the unfused ops in the same order (1e-12, f64); with xc the
    centering term sits between the adds and the unfused ops run.  On
    CPU tensors the step binds no launcher."""
    from sgdnet_tpu_torch.families import get_family
    from sgdnet_tpu_torch.penalties import select_penalty
    from sgdnet_tpu_torch.solver import saga as tsaga

    _, x = _tail(1)
    B = 64
    h, _ = HybridCSR.split_columns(x, coverage=0.6, max_head=128, dtype=torch.float64, device="cpu")
    h = dataclasses.replace(h, blk_tail=BlockCOO.from_padded(h.tail, B))
    rng = np.random.default_rng(5)
    k = 3
    w = torch.tensor(rng.normal(size=(k, h.n_cols)))
    icpt = torch.tensor(rng.normal(size=k))
    offs = torch.tensor(rng.normal(size=(h.n_rows, k)))
    xc = torch.tensor(rng.normal(size=h.n_cols))
    xc[: h.n_head] = 0.0
    for sel in range(0, h.n_rows, B):
        ob = offs[sel : sel + B]
        fused = tsaga._linear_predictor(h, None, w, icpt, ob, sel, B)
        plain = (tsaga._batch_predict(h, None, w, sel, B) + icpt) + ob
        torch.testing.assert_close(fused, plain, rtol=0, atol=1e-12)
        centered = tsaga._linear_predictor(h, xc, w, icpt, ob, sel, B)
        torch.testing.assert_close(centered, (tsaga._batch_predict(h, xc, w, sel, B) + icpt) + ob, rtol=0, atol=0)
    y = torch.zeros((h.n_rows, k), dtype=torch.float64)
    step = tsaga._make_step(h, y, torch.ones(h.n_rows, dtype=torch.float64), float(h.n_rows),
                            get_family("multinomial", n_classes=k), select_penalty(1.0, "multinomial", "ungrouped"),
                            tsaga.SolverConfig(batch_size=B, sampling="block"))
    assert step.tail_forward is None


def test_profile_sparse_slices_on_the_cpu():
    """tools/profile_sparse_slices.py end to end on the CPU at a tiny size
    (two blocks of 8192 rows, one lambda, two epochs): the fit's own step
    is captured and run for an epoch, its tail's lanes are the formula's,
    the device numbers are None off the card, and `_make_step` is restored."""
    from sgdnet_tpu_torch.solver import saga as tsaga
    from sgdnet_tpu_torch.tools import profile_sparse_slices as pss

    orig = tsaga._make_step
    out = pss.run("cpu", seed=1, slices="CE", n=16384, p=2000, nlambda=1, maxit=2)
    assert tsaga._make_step is orig and out["device"] == "cpu" and set(out["slices"]) == {"C", "E"}
    for s in out["slices"].values():
        assert s["tail_kernel"] is True and s["k3_launches"] == 0 and s["epochs"] >= 2
        assert s["step"]["steps"] == 2 and s["step"]["ms_per_step"] > 0 and s["step"]["kernels_per_step"] is None
        assert s["k3"]["ms"] is None and s["k3"]["lanes"] >= 1


# ---------------------------------------------------------------------------
# K5: the g_sum refresh's tail sum over every block
# ---------------------------------------------------------------------------

TAIL_SUM_CASES = ("seed0", "seed1", "heavy_and_empty_block", "pad_rows", "scaled")


def _tail_sum_case(case):
    """(PaddedCSR tail, its BlockCOO) of a `_tail` design, f64: seeds 0 and
    1; seed 2 (a column above 2 x HEAVY_LEN in a block, an empty block);
    seed 1 with a block of pad rows appended; seed 1 scale-standardized
    (`scale_columns` on the padded tail and on the packed one)."""
    jb, x = _tail({"seed0": 0, "seed1": 1, "heavy_and_empty_block": 2}.get(case, 1))
    tp = PaddedCSR.from_scipy(x, dtype=torch.float64, device="cpu")
    B = jb.batch
    if case == "pad_rows":
        tp = tp.pad_rows(tp.n_rows + B)
    bt = BlockCOO.from_padded(tp, B)
    if case == "scaled":
        scale = torch.tensor(np.random.default_rng(7).uniform(0.5, 2.0, tp.n_cols))
        tp, bt = tp.scale_columns(scale), bt.scale_columns(scale)
    return tp, bt


def _walk_tail_sum(bt, g):
    """K5's walk: the thread of (column j, class chunk) sums over the blocks
    in order, within a block over j's segment of the column-ordered copy
    in order, and writes every column (zero where no block has an entry)."""
    B, p = bt.batch, bt.n_cols
    seg, rows, vals = bt.col_seg.numpy(), bt.rows_by_col.numpy(), bt.vals_by_col.numpy()
    out = np.full((p, g.shape[1]), np.nan)
    for j in range(p):
        acc = np.zeros(g.shape[1])
        for b in range(bt.n_blocks):
            for s in range(seg[b, j], seg[b, j + 1]):
                acc += vals[b, s] * g[b * B + rows[b, s]]
        out[j] = acc
    assert all(seg[b, p] == int(bt.counts[b]) for b in range(bt.n_blocks))  # no pad entry read
    return out


@pytest.mark.parametrize("case", TAIL_SUM_CASES)
@pytest.mark.parametrize("k", [1, 3, 53])
def test_tail_sum_twin_matches_padded_matvec_T(case, k):
    """K5's twin equals the padded tail's `matvec_T` (the scatter the
    refresh ran before) within 1e-12 relative at f64, and K5's walk
    replayed in numpy equals the twin; the CPU call runs the twin and
    counts no launch."""
    tp, bt = _tail_sum_case(case)
    g = torch.tensor(np.random.default_rng(k).normal(size=(tp.n_rows, k)))
    ref = tp.matvec_T(g)
    before = tk.coo_tail_sum.launches
    got = tk.coo_tail_sum(bt, g)
    assert tk.coo_tail_sum.launches == before and got.shape == (tp.n_cols, k)
    scale = max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(_walk_tail_sum(bt, g.numpy()), got.numpy(), rtol=0, atol=1e-12 * scale)


def _refresh_problem(k, seed=3, n=256, B=64):
    """The JAX package's HybridCSR (f64, a BlockCOO tail, the last block's
    rows empty) and the port's copy of it, a random g_mem (pad rows
    zero), the row weights and a centering term zero on the head."""
    rng = np.random.default_rng(seed)
    p = 300
    wz = (np.arange(p) + 5.0) ** -1.1
    counts = rng.integers(0, 9, n)
    counts[n - B:] = 0
    rows = np.repeat(np.arange(n), counts)
    cols = np.searchsorted(np.cumsum(wz) / wz.sum(), rng.random(len(rows))).clip(0, p - 1)
    x = sp.csr_matrix((rng.normal(size=len(rows)), (rows, cols)), shape=(n, p))
    x.sum_duplicates()
    jh, _ = jsparse.HybridCSR.split_columns(x, coverage=0.5, max_head=64, dtype=jnp.float64)
    jh = dataclasses.replace(jh, blk_tail=jsparse.BlockCOO.from_padded(jh.tail, B))
    g_mem = rng.normal(size=(n, k))
    g_mem[n - B + 10:] = 0.0
    xc = rng.normal(size=p)
    xc[: jh.head.shape[1]] = 0.0
    return jh, layout_from_jax(jh, device="cpu"), g_mem, xc


@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("k", [1, 3])
def test_refresh_through_tail_sum_matches_jax(k, centered):
    """`_refresh_g_sum` on the BlockCOO route (K5's twin on the CPU) against
    the JAX package's `_refresh_g_sum` on the same f64 state, with and
    without the centering term: g_sum and g_sum_intercept within 1e-12
    relative, as the scatter route is."""
    from sgdnet_tpu_torch.solver import saga as tsaga

    jh, th, g_mem, xc = _refresh_problem(k)
    n, p = g_mem.shape[0], th.n_cols
    jstate = jsaga.SagaState(jnp.zeros((k, p)), jnp.zeros(k), jnp.asarray(g_mem), jnp.zeros((k, p)), jnp.zeros(k))
    jxc = jnp.asarray(xc) if centered else None
    ref = jsaga._refresh_g_sum(jh, jxc, jnp.ones(n), float(n), jstate, jsaga.SolverConfig(batch_size=th.blk_tail.batch))
    tstate = tsaga.init_state(n, p, k, torch.float64, "cpu")._replace(g_mem=torch.tensor(g_mem))
    txc = torch.tensor(xc) if centered else None
    for kernels in (True, False):
        got = tsaga._refresh_g_sum(th, float(n), tstate, txc, kernels=kernels)
        for f in ("g_sum", "g_sum_intercept"):
            r = np.asarray(getattr(ref, f))
            np.testing.assert_allclose(getattr(got, f).numpy(), r, rtol=0, atol=1e-12 * max(1.0, np.abs(r).max()))


ROUTES = {
    "blockcoo": ("hybrid", True, 1),
    "use_tail_kernel_false": ("hybrid", False, 0),
    "no_blk_tail": ("hybrid_unpacked", True, 0),
    "blocks_short_of_g_mem": ("hybrid_short", True, None),
    "padded_csr": ("padded", True, 0),
    "dense": ("dense", True, 0),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_refresh_takes_tail_sum_only_on_its_route(route, monkeypatch):
    """K5 runs in `_make_epoch`'s refresh only where the design is a
    HybridCSR with a BlockCOO tail and the config keeps `use_tail_kernel`:
    once a refresh (refresh every 2 epochs, 4 epochs); PaddedCSR, dense and
    unpacked designs and `use_tail_kernel=False` keep the `matvec_T` route.
    Either route gives the same g_sum (1e-12, f64).  A BlockCOO short of
    g_mem's rows raises at the first refresh, as the step raises on a
    tail it cannot take."""
    from sgdnet_tpu_torch.families import get_family
    from sgdnet_tpu_torch.penalties import select_penalty
    from sgdnet_tpu_torch.solver import saga as tsaga

    layout, kernels, per_refresh = ROUTES[route]
    _, th, _, _ = _refresh_problem(2)
    B, n, k = th.blk_tail.batch, th.n_rows, 2
    x = {"hybrid": th, "hybrid_unpacked": dataclasses.replace(th, blk_tail=None),
         "hybrid_short": dataclasses.replace(th, blk_tail=BlockCOO.from_padded(th.tail.take_rows(
             torch.arange(n // 2)), B // 2)),  # the steps skip it too: packed for another batch
         "padded": th.tail, "dense": th.matmul_dense(torch.eye(th.n_cols, dtype=torch.float64))}[layout]
    calls = []
    real = tk.coo_tail_sum
    monkeypatch.setattr(tk, "coo_tail_sum", lambda bt, g: calls.append(g.shape) or real(bt, g))
    rng = np.random.default_rng(9)
    y = torch.tensor(np.eye(k)[rng.integers(0, k, n)])
    config = tsaga.SolverConfig(batch_size=B, sampling="block", g_sum_refresh_every=2, use_tail_kernel=kernels)
    fam, pen = get_family("multinomial", n_classes=k), select_penalty(1.0, "multinomial", "ungrouped")
    epoch = tsaga._make_epoch(x, y, torch.ones(n, dtype=torch.float64), float(n), fam, pen, config)
    state = tsaga.init_state(n, th.n_cols, k, torch.float64, "cpu")
    if per_refresh is None:
        with pytest.raises(ValueError, match="coo_tail_sum"):
            for it in range(2):
                state = epoch(state, torch.randperm(n // B, generator=torch.Generator().manual_seed(it)), 0.05,
                              1e-3, 0.0, it=it)
        assert len(calls) == 1
        return
    for it in range(4):
        state = epoch(state, torch.randperm(n // B, generator=torch.Generator().manual_seed(it)), 0.05, 1e-3, 0.0,
                      it=it)
    assert len(calls) == 2 * per_refresh
    plain = tsaga._refresh_g_sum(x, float(n), state, kernels=False)
    torch.testing.assert_close(state.g_sum, plain.g_sum, rtol=0, atol=1e-12 * max(1.0, float(plain.g_sum.abs().max())))
