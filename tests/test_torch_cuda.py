"""The hand-written CUDA kernels against their torch twins, on the card.

Every test here needs an NVIDIA GPU with nvcc and skips without one.  The
file imports neither jax nor the JAX package, so it runs on a CUDA
machine that has only torch (tests/conftest.py needs jax, hence
--noconftest):

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Bounds: K2 as tests/test_pallas.py (f32: g atol 1e-5, corr atol 2e-3;
bf16: g 3e-2, corr 2e-2 x max|corr|) and bit-identical across two runs; K1
one epoch at 1e-5 x scale, a chunk of epochs (every variant) at 1e-4 x
scale with the twin's epoch count and stop flag, bit-identical across two
runs; K3 / K4 / K5
at 1e-5 relative (f32 reassociation only; f64 at 1e-12) and bit-identical
across two runs, K3 at every lane count with and without its epilogue,
K5 also through the g_sum refresh (two refreshes, the same bits);
fits through a kernel vs the plain step path on the card at 1e-4 x scale;
K6 (the step's finish) against the chain of torch ops it replaces, run on
the card: in f32 w and g_sum the same bits, the intercept within 1e-6
relative (its sum's order differs); f64 within 1e-12; the same bits over
two launches;
the probes P1 at 1e-5 x max and bit-identical across two runs, P2 / P3
within 1e-6 x sum |x| per column, P2 bit-identical.
"""

import numpy as np
import pytest
import torch

import scipy.sparse as sp

import sgdnet_tpu_torch as st
from sgdnet_tpu_torch.core.sparse import HEAVY_LEN, BlockCOO, PaddedCSR
from sgdnet_tpu_torch.families import get_family
from sgdnet_tpu_torch.penalties import select_penalty
from sgdnet_tpu_torch.solver import epoch_kernel as ek
from sgdnet_tpu_torch.solver import finish_kernel as fk
from sgdnet_tpu_torch.solver import saga
from sgdnet_tpu_torch.solver import head_kernel as hk
from sgdnet_tpu_torch.solver import tail_kernel as tk
from sgdnet_tpu_torch.solver.saga import SagaState
from sgdnet_tpu_torch.tools import bench_head_streamed as bhs
from sgdnet_tpu_torch.tools import probe_kernels as pk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda", 0)


def _head_args(dev, family, k, dtype, n_pad, B, D, start, seed):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    head = t(rng.standard_normal((n_pad, D), dtype=np.float32)).to(dtype)
    w = t(rng.normal(size=(k, D)) / np.sqrt(D))
    lpe = t(0.1 * rng.normal(size=(B, k)))
    if family == "binomial":
        y = t(rng.random((B, k)) < 0.5)
    elif family == "multinomial":
        y = t(np.eye(k)[rng.integers(0, k, B)])
    else:
        y = t(rng.normal(size=(B, k)))
    gm, wb = t(0.1 * rng.normal(size=(B, k))), t(rng.random(B) < 0.9)
    return (head, start, w, lpe, y, gm, wb, family)


def _head_check(args, dtype):
    """K2 against its twin at the bounds of tests/test_pallas.py (f32: the
    two differ by summation order only; bf16: w and gc are rounded to bf16
    in both, and a g near a rounding boundary of gc moves corr by one bf16
    ulp of gc times a head entry), and identical bits over two runs (no
    atomics: every sum has a fixed order)."""
    before = hk.fused_head_step_at.launches
    g, corr = hk.fused_head_step_at(*args)
    assert hk.fused_head_step_at.launches == before + 1
    g_ref, corr_ref = hk.fused_head_step_reference(*args)
    g2, corr2 = hk.fused_head_step_at(*args)
    torch.cuda.synchronize()
    assert torch.equal(g, g2) and torch.equal(corr, corr2)
    if dtype == torch.float32:
        torch.testing.assert_close(g, g_ref, atol=1e-5, rtol=0)
        torch.testing.assert_close(corr, corr_ref, atol=2e-3, rtol=0)
    else:
        torch.testing.assert_close(g, g_ref, atol=3e-2, rtol=0)
        torch.testing.assert_close(corr, corr_ref, atol=2e-2 * max(float(corr_ref.abs().max()), 1.0), rtol=0)


# (n_pad, B, D): the dense shape; a row that is not a multiple of 16 bytes
# with a B that only 8 divides; slice C's width (a cluster of 8 strips)
HEAD_SHAPES = [(8192, 1024, 784), (4128, 1032, 785), (24576, 8192, 16384)]


@pytest.mark.parametrize("shape", HEAD_SHAPES, ids=lambda s: f"B{s[1]}-D{s[2]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("family,k", [("gaussian", 1), ("binomial", 1), ("multinomial", 10), ("mgaussian", 3)])
def test_head_kernel_matches_twin(dev, family, k, dtype, shape):
    n_pad, B, D = shape
    _head_check(_head_args(dev, family, k, dtype, n_pad, B, D, n_pad - B - (B if D < 16384 else 0), k), dtype)


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 256), (torch.bfloat16, 787), (torch.float32, 785),
                                     (torch.bfloat16, 16384)])
def test_head_kernel_at_128_classes(dev, dtype, D):
    """k = MAX_K: the class-chunked accumulators in shared memory on the
    narrow heads, the streamed tile kernel at D 16384 (no cluster holds a
    128 x 16384 w); D 787 in bf16 is a row only 2-byte aligned."""
    B = 1032 if D < 16384 else 1024
    assert hk.plan(B, D, 128, dtype).resident is (D < 16384)
    _head_check(_head_args(dev, "multinomial", 128, dtype, 2 * B, B, D, B, D), dtype)


@pytest.mark.parametrize("case", bhs.CASES, ids=lambda c: f"{c[0]}-{str(c[5])[6:]}-D{c[3]}-k{c[4]}-B{c[2]}")
def test_head_streamed_matches_twin(dev, case):
    """K2's streamed design at chip_smoke.py phase 3's shapes (k just past
    the resident limit at D 16384, slice M's 53 classes, MAX_K, an
    elementwise family, CIFAR-100's f32 shape, rows only 4-byte aligned,
    a B only 8 divides; launched through its own plan where `plan` keeps
    the shape resident): `run_shape` raises where it disagrees with its
    twin beyond its bounds (tools/bench_head_streamed.py), gives other
    bits on a second launch, or
    a profile misses one of its three kernels."""
    before = hk.fused_head_step_at.launches
    r = bhs.run_shape(dev, 0, *case, timed=False)
    assert "kp" in r["plan"] and hk.fused_head_step_at.launches > before  # a StreamPlan launched


def test_head_kernel_rejects_what_it_does_not_take(dev):
    head = torch.zeros((256, 64), device=dev)
    args = (torch.zeros(64, device=dev), torch.zeros((64, 1), device=dev), torch.zeros((64, 1), device=dev),
            torch.zeros((64, 1), device=dev), torch.ones(64, device=dev))
    w = torch.zeros((1, 64), device=dev)
    with pytest.raises(ValueError):
        hk.fused_head_step_at(head, 0, w, args[1], args[2], args[3], args[4], "poisson")
    with pytest.raises(ValueError):
        hk.fused_head_step_at(head, 224, w, args[1], args[2], args[3], args[4], "gaussian")  # past the end
    with pytest.raises(ValueError):
        hk.fused_head_step_at(head.double(), 0, w, args[1], args[2], args[3], args[4], "gaussian")


# K1's variants and the shapes that take them: one warp (slice A's B 32, p
# <= 32), many warps with column groups, 16 lanes a row, and l2 (a ring
# does not fit beside the state at B 2048)
K1_SHAPES = {"ring_warp": (500, 11, 32), "ring_warp20": (600, 20, 32), "ring_groups": (1000, 9, 256),
             "ring_lanes": (300, 200, 32), "l2": (4096, 9, 2048)}
K1_FAMILIES = [("gaussian", 1), ("binomial", 1), ("poisson", 1), ("multinomial", 3), ("mgaussian", 2)]
K1_PENALTIES = [(0.0, "ungrouped"), (0.7, "ungrouped"), (0.7, "grouped")]  # ridge, elastic net, group lasso


def _k1_problem(dev, family, k, n, p, B, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p))
    y = {"binomial": lambda: (rng.random((n, 1)) < 0.4).astype(float),
         "poisson": lambda: rng.poisson(1.5, (n, 1)).astype(float),
         "multinomial": lambda: np.eye(3)[rng.integers(0, 3, n)]}.get(family, lambda: rng.normal(size=(n, k)))()
    n_pad = -(-n // B) * B
    pad = lambda a: torch.tensor(  # noqa: E731
        np.concatenate([a, np.zeros((n_pad - n,) + a.shape[1:])]), dtype=torch.float32, device=dev)
    fam = get_family(family, n_classes=k, smoothness=8.0)
    fam.n_classes = k
    data = ek.pad_data(pad(x), pad(y), pad(rng.uniform(0.5, 1.5, n)), pad(0.2 * rng.normal(size=(n, k))),
                       torch.tensor(rng.uniform(0, 2, p), dtype=torch.float32, device=dev))
    st0 = SagaState(*(torch.tensor(0.1 * rng.normal(size=s), dtype=torch.float32, device=dev)
                      for s in [(k, p), (k,), (n_pad, k), (k, p), (k,)]))
    orders = torch.tensor(np.stack([rng.permutation(n_pad // B) for _ in range(4)]) * B, dtype=torch.int32,
                          device=dev)
    return data, ek.pad_state(st0, p), fam, orders


def _k1_check(data, ps, orders, B, fam, pen, run, scale_tol=1e-4):
    """saga_epochs against epochs_reference: the same epochs run and stop
    flag, the state at scale_tol x scale, pad lanes zero, the same bits
    over two launches."""
    out, stats = ek.saga_epochs(data, ps, orders, B, fam, pen, **run)
    again, stats2 = ek.saga_epochs(data, ps, orders, B, fam, pen, **run)
    ref, rstats = ek.epochs_reference(data, ps, orders, B, fam, pen, **run)
    torch.cuda.synchronize()
    ran, mc, ms, fin = stats.tolist()
    assert ran == rstats[0] and fin == rstats[3]
    for a, b, c in zip(out, ref, again):
        torch.testing.assert_close(a, b, atol=scale_tol * max(1.0, float(b.abs().max())), rtol=0)
        assert torch.equal(a, c)
    assert torch.equal(stats, stats2)
    k, p = data.k, data.p
    assert float(out.w[:, p:].abs().max()) == 0.0 and float(out.w[k:].abs().max() if k < ek.KP else 0.0) == 0.0
    return stats


@pytest.mark.parametrize("pen", range(len(K1_PENALTIES)))
@pytest.mark.parametrize("family,k", K1_FAMILIES)
@pytest.mark.parametrize("shape", list(K1_SHAPES))
def test_epoch_kernel_variants_match_twin(dev, shape, family, k, pen):
    """Every variant on the five families and three penalties, with
    offsets and penalty factors: four epochs in one launch, the refresh
    every second one, against the twin at 1e-4 x scale."""
    n, p, B = K1_SHAPES[shape]
    alpha, tm = K1_PENALTIES[pen]
    data, ps, fam, orders = _k1_problem(dev, family, k, n, p, B)
    pl = ek.plan(p, k, B, True)
    assert pl.variant == shape.split("_")[0]
    before = dict(ek.saga_epochs.launches_by_variant)
    run = dict(gamma=0.01, l1=0.02 * alpha, l2=0.02 * (1 - alpha), w_total=float(n), it0=0, t_conv=0.0,
               refresh_every=2)
    stats = _k1_check(data, ps, orders, B, fam, select_penalty(alpha, family, tm), run)
    assert stats[0] == 4
    assert ek.saga_epochs.launches_by_variant[pl.variant] == before[pl.variant] + 2


@pytest.mark.parametrize("family,alpha,grouped", [
    ("gaussian", 0.8, False), ("binomial", 0.0, False), ("poisson", 0.5, False),
    ("multinomial", 0.9, True), ("mgaussian", 0.5, False),
])
def test_epoch_kernel_matches_twin(dev, family, alpha, grouped):
    """One epoch (saga_epoch, a chunk of one), refresh on and off."""
    k = {"multinomial": 3, "mgaussian": 2}.get(family, 1)
    n, B = 500, 32
    data, ps, fam, orders = _k1_problem(dev, family, k, n, 11, B)
    pen = select_penalty(alpha, family, "grouped" if grouped else "ungrouped")
    run = (data, ps, orders[0], B, fam, pen, 0.01, 0.02, 0.03, float(n))
    for refresh in (True, False):
        out = ek.saga_epoch(*run, refresh=refresh)
        ref = ek.epoch_reference(*run, refresh=refresh)
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, atol=1e-5 * max(1.0, float(b.abs().max())), rtol=0)
        assert float(out.w[:, 11:].abs().max()) == 0.0 and float(out.w[k:].abs().max()) == 0.0


@pytest.mark.parametrize("shape", list(K1_SHAPES))
def test_epoch_kernel_stops_where_the_twin_does(dev, shape):
    """A convergence tolerance that stops mid-chunk: the same epoch, and
    epochs e + 1 and on never run."""
    n, p, B = K1_SHAPES[shape]
    data, ps, fam, orders = _k1_problem(dev, "gaussian", 1, n, p, B, seed=5)
    orders = torch.cat([orders, orders.flip(0)])
    pen = select_penalty(0.5, "gaussian", "ungrouped")
    run = dict(gamma=0.01, l1=0.01, l2=0.01, w_total=float(n), it0=0, refresh_every=1)
    # the relative change of epoch 3 (counting from 1) as the tolerance
    cut = ek.epochs_reference(data, ps, orders[:2], B, fam, pen, **run)[0]
    third, st3 = ek.epochs_reference(data, cut, orders[2:3], B, fam, pen, **run)
    t_conv = float(st3[1] / st3[2]) * 1.0001
    stats = _k1_check(data, ps, orders, B, fam, pen, dict(run, t_conv=t_conv))
    assert 1 <= stats[0] < orders.shape[0]


@pytest.mark.parametrize("shape", list(K1_SHAPES))
def test_epoch_kernel_block_that_recurs_across_epochs(dev, shape):
    """Epoch e's last block is epoch e + 1's first: the prefetch must read
    the g_mem that the end of epoch e wrote."""
    n, p, B = K1_SHAPES[shape]
    data, ps, fam, orders = _k1_problem(dev, "binomial", 1, n, p, B, seed=7)
    o = orders.cpu()
    for e in range(o.shape[0] - 1):
        first = o[e + 1].tolist().index(int(o[e, -1]))
        o[e + 1, [0, first]] = o[e + 1, [first, 0]]
    run = dict(gamma=0.02, l1=0.0, l2=0.01, w_total=float(n), it0=1, t_conv=0.0, refresh_every=3)
    stats = _k1_check(data, ps, o.to(dev), B, fam, select_penalty(0.0, "binomial", "ungrouped"), run)
    assert stats[0] == o.shape[0]


def test_epoch_kernel_divergence_and_all_zero(dev):
    """A step far too large stops at the first non-finite epoch (NaN and
    inf read as not finite, as torch.max on the host sees them); a lasso
    that keeps w at zero stops after one epoch."""
    n, p, B = K1_SHAPES["ring_warp"]
    data, ps, fam, orders = _k1_problem(dev, "gaussian", 1, n, p, B, seed=9)
    pen = select_penalty(1.0, "gaussian", "ungrouped")
    for gamma in (40.0, 400.0):
        run = dict(gamma=gamma, l1=1e-3, l2=0.0, w_total=float(n), it0=0, t_conv=0.0, refresh_every=1)
        out, stats = ek.saga_epochs(data, ps, orders, B, fam, pen, **run)
        _, rstats = ek.epochs_reference(data, ps, orders, B, fam, pen, **run)
        assert stats[3] == 0.0 and rstats[3] == 0.0 and stats[0] == rstats[0] < orders.shape[0]
    zero = ps._replace(w=torch.zeros_like(ps.w), g_sum=torch.zeros_like(ps.g_sum))
    run = dict(gamma=0.01, l1=1e3, l2=0.0, w_total=float(n), it0=0, t_conv=0.0, refresh_every=1)
    out, stats = ek.saga_epochs(data, zero, orders, B, fam, pen, **run)
    assert stats.tolist() == [1.0, 0.0, 0.0, 1.0] and float(out.w.abs().max()) == 0.0


@pytest.mark.parametrize("name,family", [("heart", "binomial"), ("wine", "multinomial")])
def test_fit_through_kernels_matches_plain_path(dev, name, family):
    x, y = st.load_dataset(name)["x"], st.load_dataset(name)["y"]
    common = dict(family=family, nlambda=8, sampling="block", seed=3, device=dev, batch_size=32)
    f_plain = st.fit(x, y, use_epoch_kernel=False, **common)
    f_k1 = st.fit(x, y, **common)  # K1 is the default on CUDA
    f_k2 = st.fit(x, y, use_epoch_kernel=False, use_pallas=True, lambda_path=f_plain.lambda_,
                  **{k: v for k, v in common.items() if k != "nlambda"})
    assert f_k1.stats["epoch_kernel"] is True and f_k2.stats["head_kernel"] is True
    scale = max(1.0, np.abs(f_plain.beta).max())
    for f in (f_k1, f_k2):
        assert np.abs(f.beta - f_plain.beta).max() / scale < 1e-4


def _zipf_tail(dev, dtype, n=4096, p=3000, per_row=9, B=1024, seed=0):
    """A Zipf-column tail (columns recur within a block), packed per block.
    Every eighth row also holds column 7, so each block has a column of
    more than 4 x HEAVY_LEN entries (a warp of K4 sums it), and the last
    block's rows from 64 on are empty (its light columns stay short)."""
    rng = np.random.default_rng(seed)
    wz = (np.arange(p) + 10.0) ** -1.15
    cols = np.searchsorted(np.cumsum(wz) / wz.sum(), rng.random((n, per_row))).clip(0, p - 1)
    cols[::8, 0] = 7
    counts = rng.integers(1, per_row + 1, n)
    counts[n - B + 64:] = 0
    keep = np.arange(per_row)[None, :] < counts[:, None]
    rows = np.repeat(np.arange(n)[:, None], per_row, 1)[keep]
    x = sp.csr_matrix((rng.normal(size=keep.sum()), (rows, cols[keep])), shape=(n, p))
    x.sum_duplicates()
    bt = BlockCOO.from_padded(PaddedCSR.from_scipy(x, dtype=dtype, device=dev), B)
    seg = bt.col_seg.cpu().numpy()
    assert (np.diff(seg, axis=1)[:-1].max(axis=1) > 4 * HEAVY_LEN).all() and bt.max_heavy > 1
    return bt


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 3])
def test_tail_kernels_match_twins(dev, dtype, k):
    bt = _zipf_tail(dev, dtype)
    rng = np.random.default_rng(k)
    w = torch.tensor(rng.normal(size=(k, bt.n_cols)), dtype=dtype, device=dev)
    gc = torch.tensor(rng.normal(size=(bt.batch, k)), dtype=dtype, device=dev)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for blk in range(bt.n_blocks):
        before = (tk.coo_tail_forward.launches, tk.coo_tail_outer.launches)
        f, o = tk.coo_tail_forward(bt, blk, w), tk.coo_tail_outer(bt, blk, gc)
        assert (tk.coo_tail_forward.launches, tk.coo_tail_outer.launches) == (before[0] + 1, before[1] + 1)
        f_ref, o_ref = tk.coo_tail_forward_reference(bt, blk, w), tk.coo_tail_outer_reference(bt, blk, gc)
        torch.cuda.synchronize()
        torch.testing.assert_close(f, f_ref, atol=tol * max(1.0, float(f_ref.abs().max())), rtol=0)
        torch.testing.assert_close(o, o_ref, atol=tol * max(1.0, float(o_ref.abs().max())), rtol=0)
        # no atomics: a second run gives the same bits
        assert torch.equal(f, tk.coo_tail_forward(bt, blk, w)) and torch.equal(o, tk.coo_tail_outer(bt, blk, gc))


def test_tail_kernels_reject_what_they_do_not_take(dev):
    bt = _zipf_tail(dev, torch.float32, n=2048)
    with pytest.raises(ValueError):
        tk.coo_tail_forward(bt, 0, torch.zeros((1, bt.n_cols), dtype=torch.float64, device=dev))
    with pytest.raises(ValueError):
        tk.coo_tail_forward(bt, bt.n_blocks, torch.zeros((1, bt.n_cols), device=dev))
    with pytest.raises(ValueError):
        tk.coo_tail_outer(bt, 0, torch.zeros((bt.batch + 1, 1), device=dev))
    n = bt.n_blocks * bt.batch
    for g in (torch.zeros((n - 1, 2), device=dev), torch.zeros((n, 2), dtype=torch.float64, device=dev),
              torch.zeros((2, n), device=dev).T, torch.zeros(n, device=dev)):
        with pytest.raises(ValueError):
            tk.coo_tail_sum(bt, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("G", [1, 2, 4, 8, 16, 32])
def test_tail_forward_at_each_lane_count(dev, dtype, G):
    """K3 with G lanes a row (forced on a copy of the tail), with and
    without its epilogue, at k 1, 3 and 10, against its plain version
    (1e-5 relative at f32, 1e-12 at f64), identical bits over two runs;
    the bound launcher the step uses gives the checked call's bits."""
    import dataclasses

    bt = dataclasses.replace(_zipf_tail(dev, dtype, per_row=40 if G >= 16 else 9))
    bt.lanes = G
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for k in (1, 3, 10):
        rng = np.random.default_rng(G * k)
        t = lambda a: torch.tensor(a, dtype=dtype, device=dev)  # noqa: E731
        w = t(rng.normal(size=(k, bt.n_cols)))
        ops = dict(base=t(rng.normal(size=(bt.batch, k))), intercept=t(rng.normal(size=k)),
                   offs=t(rng.normal(size=(bt.batch, k))))
        launcher = tk.ForwardLauncher(bt, k, dtype)
        for given in ({}, ops, {"intercept": ops["intercept"]}):
            for blk in range(bt.n_blocks):
                before = tk.coo_tail_forward.launches
                f = tk.coo_tail_forward(bt, blk, w, **given)
                assert tk.coo_tail_forward.launches == before + 1
                ref = tk.coo_tail_forward_reference(bt, blk, w, **given)
                torch.cuda.synchronize()
                torch.testing.assert_close(f, ref, atol=tol * max(1.0, float(ref.abs().max())), rtol=0)
                assert torch.equal(f, tk.coo_tail_forward(bt, blk, w, **given))
                assert torch.equal(f, launcher(blk, w, **given))


def test_tail_forward_rejects_what_it_does_not_take(dev):
    bt = _zipf_tail(dev, torch.float32, n=2048)
    w = torch.zeros((2, bt.n_cols), device=dev)
    bad = {"base": torch.zeros((bt.batch, 3), device=dev), "intercept": torch.zeros(3, device=dev),
           "offs": torch.zeros((bt.batch, 2), dtype=torch.float64, device=dev)}
    for name, t in bad.items():
        with pytest.raises(ValueError):
            tk.coo_tail_forward(bt, 0, w, **{name: t})
    with pytest.raises(ValueError):
        tk.coo_tail_forward(bt, 0, w, offs=torch.zeros((2, bt.batch), device=dev).T)  # not contiguous
    with pytest.raises(ValueError):
        tk.ForwardLauncher(bt, 2, torch.float64)  # the tail is f32
    with pytest.raises(ValueError):
        tk.ForwardLauncher(BlockCOO.from_padded(PaddedCSR.from_scipy(sp.random(64, 30, 0.2, format="csr"),
                                                                     device="cpu"), 32), 1, torch.float32)


def _cell_tail(dev, dtype, n_blocks=3, B=8192, p=47236, head=16384, seed=0):
    """The benchmark cells' tail cut to `n_blocks` blocks of B rows: rcv1's
    47236 columns drawn 76 a row by bench.py's Zipf use (rank + 10)^-1.15,
    the entries past the 16384-column head kept (~5 a row), N(0, 1)
    values."""
    rng = np.random.default_rng(seed)
    n = n_blocks * B
    wz = (np.arange(p) + 10.0) ** -1.15
    cols = np.searchsorted(np.cumsum(wz) / wz.sum(), rng.random((n, 76))).clip(0, p - 1)
    keep = cols >= head
    rows = np.repeat(np.arange(n)[:, None], 76, 1)[keep]
    x = sp.csr_matrix((rng.normal(size=keep.sum()), (rows, cols[keep])), shape=(n, p))
    x.sum_duplicates()
    return BlockCOO.from_padded(PaddedCSR.from_scipy(x, dtype=dtype, device=dev), B), x


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case,k", [("cell", 1), ("cell", 53), ("zipf", 3), ("zipf", 10)])
def test_tail_sum_matches_twin(dev, dtype, case, k):
    """K5 over every block against its twin and the padded tail's
    scatter (1e-5 relative at f32, 1e-12 at f64): at the cells' shape cut
    to 3 blocks at k 1 and 53, and on `_zipf_tail` (heavy columns, empty
    rows) at k 3 (a column's classes in registers) and 10; one launch a
    call, and a second launch gives the same bits."""
    if case == "cell":
        bt, x = _cell_tail(dev, dtype)
        tail = PaddedCSR.from_scipy(x, dtype=dtype, device=dev)
    else:
        bt = _zipf_tail(dev, dtype)
        tail = None
    g = torch.tensor(np.random.default_rng(k).normal(size=(bt.n_blocks * bt.batch, k)), dtype=dtype, device=dev)
    before = tk.coo_tail_sum.launches
    out = tk.coo_tail_sum(bt, g)
    assert tk.coo_tail_sum.launches == before + 1
    ref = tk.coo_tail_sum_reference(bt, g)
    torch.cuda.synchronize()
    tol = (1e-5 if dtype == torch.float32 else 1e-12) * max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(out, ref, atol=tol, rtol=0)
    if tail is not None:
        torch.testing.assert_close(out, tail.matvec_T(g), atol=tol, rtol=0)
    assert torch.equal(out, tk.coo_tail_sum(bt, g))


def test_refresh_runs_tail_sum_once_and_repeats_its_bits(dev):
    """The g_sum refresh on a HybridCSR with a BlockCOO tail launches K5
    once a refresh (4 epochs at refresh every 2 through `_make_epoch`: 2
    launches) and none with `use_tail_kernel=False`; two refreshes of the
    same state give bit-identical g_sum; the route's g_sum equals the
    scatter route's within 1e-5 relative (f32)."""
    import dataclasses

    from sgdnet_tpu_torch.core.sparse import HybridCSR

    _, x = _cell_tail(dev, torch.float32, n_blocks=2, B=2048)
    h, _ = HybridCSR.split_columns(sp.hstack([sp.random(x.shape[0], 256, 0.3, format="csr", random_state=1), x],
                                             format="csr"), coverage=0.5, max_head=256, device=dev)
    B, n, k = 2048, x.shape[0], 3
    h = dataclasses.replace(h, blk_tail=BlockCOO.from_padded(h.tail, B))
    rng = np.random.default_rng(2)
    y = torch.tensor(np.eye(k)[rng.integers(0, k, n)], dtype=torch.float32, device=dev)
    fam, pen = get_family("multinomial", n_classes=k), select_penalty(1.0, "multinomial", "ungrouped")
    for kernels, per_refresh in ((True, 1), (False, 0)):
        config = saga.SolverConfig(batch_size=B, sampling="block", g_sum_refresh_every=2, use_tail_kernel=kernels)
        epoch = saga._make_epoch(h, y, torch.ones(n, device=dev), float(n), fam, pen, config)
        state = saga.init_state(n, h.n_cols, k, torch.float32, dev)
        before = tk.coo_tail_sum.launches
        for it in range(4):
            state = epoch(state, torch.randperm(n // B), 0.05, 1e-3, 0.0, it=it)
        torch.cuda.synchronize()
        assert tk.coo_tail_sum.launches == before + 2 * per_refresh
    a = saga._refresh_g_sum(h, float(n), state, kernels=True)
    b = saga._refresh_g_sum(h, float(n), state, kernels=True)
    plain = saga._refresh_g_sum(h, float(n), state, kernels=False)
    torch.cuda.synchronize()
    assert torch.equal(a.g_sum, b.g_sum) and torch.equal(a.g_sum_intercept, b.g_sum_intercept)
    torch.testing.assert_close(a.g_sum, plain.g_sum, atol=1e-5 * max(1.0, float(plain.g_sum.abs().max())), rtol=0)


@pytest.mark.parametrize("head", ["bfloat16", "int8", "float32"])
def test_hybrid_fit_through_kernels_matches_plain_path(dev, head):
    """A hybrid fit on the card through K3 / K4 (and K2 on a bf16 / f32
    head) vs the same fit on plain torch ops: the same batch orders, so the
    paths differ by reassociation only, and meet at the solution within
    1e-3 x scale, the fit's own tolerance (1e-2 on a bf16 head, whose w is
    rounded to bf16 in every product).  Standardized, the step's finish
    stays the chain (the centering term xc); unstandardized it is K6,
    one call a step, and that fit meets its plain twin the same way."""
    rng = np.random.default_rng(4)
    n, p = 6000, 2500
    wz = (np.arange(p) + 10.0) ** -1.15
    cols = np.searchsorted(np.cumsum(wz) / wz.sum(), rng.random((n, 20))).clip(0, p - 1)
    x = sp.csr_matrix((rng.normal(size=n * 20), cols.ravel(), np.arange(0, n * 20 + 1, 20)), shape=(n, p))
    x.sum_duplicates()
    beta = rng.normal(size=p) * (rng.random(p) < 0.05)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x @ beta)))).astype(float)
    common = dict(family="binomial", nlambda=4, lambda_min_ratio=0.1, batch_size=1024, sampling="block",
                  hybrid_max_head=256, hybrid_coverage=0.8, hybrid_head_dtype=head, device=dev, maxit=60)
    launches = (tk.coo_tail_forward.launches, tk.coo_tail_outer.launches, hk.fused_head_step_at.launches)
    sums, finishes = tk.coo_tail_sum.launches, fk.finish_step.launches
    f_k = st.fit(x, y, use_pallas=head != "int8", **common)
    assert f_k.stats["tail_kernel"] is True and f_k.stats["head_kernel"] is (head != "int8")
    assert tk.coo_tail_forward.launches > launches[0] and tk.coo_tail_outer.launches > launches[1]
    assert (hk.fused_head_step_at.launches > launches[2]) is (head != "int8")
    assert tk.coo_tail_sum.launches > sums  # the refresh's tail sum (K5)
    # standardized sparse input carries the centering term xc, which keeps
    # the step's finish on the chain of torch ops
    assert fk.finish_step.launches == finishes
    sums = tk.coo_tail_sum.launches
    f_p = st.fit(x, y, use_pallas=False, use_tail_kernel=False, lambda_path=f_k.lambda_,
                 **{k: v for k, v in common.items() if k != "nlambda"})
    assert f_p.stats["tail_kernel"] is False and f_p.stats["head_kernel"] is False
    assert tk.coo_tail_sum.launches == sums and fk.finish_step.launches == finishes
    scale = max(1.0, np.abs(f_p.beta).max())
    assert np.abs(f_k.beta - f_p.beta).max() / scale < (1e-2 if head == "bfloat16" else 1e-3)
    assert np.isfinite(f_k.dev_ratio).all() and f_k.dev_ratio[-1] > f_k.dev_ratio[0]
    # unstandardized (no xc), every step's finish is one K6 call, as many
    # as K4's launches, and the fit meets the plain one as above
    k4 = tk.coo_tail_outer.launches
    f_u = st.fit(x, y, use_pallas=head != "int8", standardize=False, **common)
    assert fk.finish_step.launches - finishes == tk.coo_tail_outer.launches - k4 > 0
    finishes = fk.finish_step.launches
    f_up = st.fit(x, y, use_pallas=False, use_tail_kernel=False, standardize=False, lambda_path=f_u.lambda_,
                  **{k: v for k, v in common.items() if k != "nlambda"})
    assert fk.finish_step.launches == finishes
    scale = max(1.0, np.abs(f_up.beta).max())
    assert np.abs(f_u.beta - f_up.beta).max() / scale < (1e-2 if head == "bfloat16" else 1e-3)


# ---------------------------------------------------------------------------
# K6, the step's finish (solver/finish_kernel.py)
# ---------------------------------------------------------------------------


def _finish_operands(dev, dtype, k, p, D, B, seed, pf=False, box=False):
    """A seeded state and step operands on the card: wb of 0s and 1s (as
    the cells' weights), so the chain's bw is the same in any order."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=dev)  # noqa: E731
    state = SagaState(w=t(0.05 * rng.normal(size=(k, p))), intercept=t(rng.normal(size=k)),
                      g_mem=torch.zeros((B, k), dtype=dtype, device=dev), g_sum=t(1e-3 * rng.normal(size=(k, p))),
                      g_sum_intercept=t(1e-3 * rng.normal(size=k)))
    ops = dict(wb=t(rng.random(B) < 0.95), g_change=t(0.1 * rng.normal(size=(B, k))),
               corr=t(rng.normal(size=(k, p))), corr_head=t(rng.normal(size=(k, D))) if D else None)
    bound = dict(pf=t(rng.uniform(0.0, 2.0, p)) if pf else None,
                 box=(t(-0.04 * np.abs(rng.normal(size=(k, p)))), t(0.03 * np.abs(rng.normal(size=(k, p)))))
                 if box else None)
    return state, ops, bound


def _finish_check(dev, dtype, k, p, D, B, penalty, fit_intercept=True, seed=0, **bound_kw):
    """K6 through a bound launcher against the chain (`finish_step_reference`)
    on the card, one step from a seeded state; two launches alike, one
    counted call each, the inputs untouched and the outputs fresh storage."""
    state, ops, bound = _finish_operands(dev, dtype, k, p, D, B, seed, **bound_kw)
    scal = saga._scalars(2e-3, 5.0, 0.1, 1.0, saga.np_dtype(dtype))
    w_total = float(B)
    launcher = fk.FinishLauncher(B, k, p, D, dtype, dev, penalty, w_total, fit_intercept, **bound)
    inputs = [t.clone() for t in (*state, *[v for v in ops.values() if v is not None])]
    before = fk.finish_step.launches
    a = launcher(launcher.prepare(state), scal, **ops)
    b = launcher(launcher.prepare(state), scal, **ops)
    assert fk.finish_step.launches == before + 2
    ref = fk.finish_step_reference(state, scal, ops["wb"], ops["g_change"], ops["corr"], penalty, w_total,
                                   fit_intercept, corr_head=ops["corr_head"], **bound)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert all(torch.equal(u, v) for u, v in zip(inputs, (*state, *[v for v in ops.values() if v is not None])))
    ins = {t.data_ptr() for t in (*state, *ops.values()) if t is not None}
    assert a.w.data_ptr() not in ins and a.g_sum.data_ptr() not in ins and a.g_mem is state.g_mem
    if dtype == torch.float32:
        assert torch.equal(a.w, ref.w) and torch.equal(a.g_sum, ref.g_sum)
        torch.testing.assert_close(a.intercept, ref.intercept, rtol=1e-6, atol=1e-6 * float(ref.intercept.abs().max()))
        torch.testing.assert_close(a.g_sum_intercept, ref.g_sum_intercept, rtol=1e-6,
                                   atol=1e-6 * float(ref.g_sum_intercept.abs().max()))
    else:
        for u, v in zip(a, ref):
            torch.testing.assert_close(u, v, rtol=0, atol=1e-12 * max(1.0, float(v.abs().max())))
    if not fit_intercept:
        assert a.intercept is state.intercept and a.g_sum_intercept is state.g_sum_intercept
    return a, ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 53])
def test_finish_kernel_matches_chain_at_the_cells_shapes(dev, dtype, k):
    """The cells' step: p 47236, a bf16 head of 16384 columns, B 8192,
    elastic net, the intercept fitted."""
    from sgdnet_tpu_torch.penalties import ElasticNet

    a, _ = _finish_check(dev, dtype, k, 47236, 16384, 8192, ElasticNet(), seed=k)
    assert (a.w == 0).any() and (a.w != 0).any()


@pytest.mark.parametrize("case", ["ridge", "en-pf", "en-box", "ridge-pf-box-no-icpt", "en-odd", "en-no-head"])
def test_finish_kernel_options(dev, case):
    """Ridge and elastic net with pf, a box and no intercept (f32, the
    same bits as the chain), at 16-byte loads (p 4096, D 512), at one
    column a thread (p 1001, D 101: 4 divides neither) and without a head."""
    from sgdnet_tpu_torch.penalties import ElasticNet, Ridge

    pen = Ridge() if case.startswith("ridge") else ElasticNet()
    p, D = (1001, 101) if case == "en-odd" else (4096, 0 if case == "en-no-head" else 512)
    _finish_check(dev, torch.float32, 3, p, D, 1000, pen, fit_intercept=not case.endswith("no-icpt"), seed=7,
                  pf="pf" in case, box="box" in case)


def test_finish_kernel_on_a_misaligned_state(dev):
    """A contiguous state whose w starts 4 bytes past a 16-byte boundary
    takes the one-column path, with the chain's bits."""
    from sgdnet_tpu_torch.penalties import ElasticNet

    k, p, B = 2, 4096, 512
    state, ops, _ = _finish_operands(dev, torch.float32, k, p, 256, B, 3)
    buf = torch.empty(k * p + 1, dtype=torch.float32, device=dev)
    w = buf[1:].view(k, p)
    w.copy_(state.w)
    assert w.data_ptr() % 16 == 4
    state = state._replace(w=w)
    scal = saga._scalars(2e-3, 5.0, 0.1, 1.0, np.float32)
    out = fk.finish_step(state, scal, ops["wb"], ops["g_change"], ops["corr"], ElasticNet(), float(B),
                         corr_head=ops["corr_head"])
    ref = fk.finish_step_reference(state, scal, ops["wb"], ops["g_change"], ops["corr"], ElasticNet(), float(B), True,
                                   corr_head=ops["corr_head"])
    torch.cuda.synchronize()
    assert torch.equal(out.w, ref.w) and torch.equal(out.g_sum, ref.g_sum)


def test_finish_kernel_rejects_what_it_does_not_take(dev):
    """The bind-time checks: a wrong dtype, shape, device or layout of a
    bound operand, of the state `prepare` passes, or of a checked call's
    operands raises, and nothing launches."""
    from sgdnet_tpu_torch.penalties import ElasticNet

    k, p, D, B = 2, 64, 16, 32
    pen = ElasticNet()
    f32 = dict(dtype=torch.float32, device=dev)
    bind = (B, k, p, D, torch.float32, dev, pen, float(B), True)
    before = fk.finish_step.launches
    for kw, what in ((dict(pf=torch.ones(p, dtype=torch.float64, device=dev)), "pf"),
                     (dict(pf=torch.ones(p + 1, **f32)), "pf"),
                     (dict(pf=torch.ones(p)), "pf"),
                     (dict(box=(torch.zeros((p, k), **f32).T, torch.ones((k, p), **f32))), "box lo"),
                     (dict(box=(torch.zeros((k, p), **f32), torch.ones((1, p), **f32))), "box hi"),
                     (dict(weights=torch.ones(B, dtype=torch.float64, device=dev)), "weights")):
        with pytest.raises(ValueError, match=what):
            fk.FinishLauncher(*bind, **kw)
    launcher = fk.FinishLauncher(*bind)
    state = saga.init_state(B, p, k, torch.float32, dev)
    with pytest.raises(ValueError, match="state.w"):
        launcher.prepare(state._replace(w=torch.zeros((k, p + 1), **f32)))
    with pytest.raises(ValueError, match="state.g_sum"):
        launcher.prepare(state._replace(g_sum=torch.zeros((k, p), dtype=torch.float64, device=dev)))
    with pytest.raises(ValueError, match="state.intercept"):
        launcher.prepare(state._replace(intercept=torch.zeros(k)))
    assert launcher.prepare(state._replace(w=torch.zeros((p, k), **f32).T)).w.is_contiguous()
    scal = saga._scalars(1e-3, 1e-3, 0.0, 1.0, np.float32)
    args = dict(wb=torch.ones(B, **f32), g_change=torch.zeros((B, k), **f32), corr=torch.zeros((k, p), **f32),
                corr_head=torch.zeros((k, D), **f32))
    for name, bad in (("wb", torch.ones(B, dtype=torch.float64, device=dev)),
                      ("g_change", torch.zeros((B, k + 1), **f32)), ("corr_head", torch.zeros((D, k), **f32).T)):
        with pytest.raises(ValueError, match=name):
            fk.finish_step(state, scal, penalty=pen, w_total=float(B), **{**args, name: bad})
    assert fk.finish_step.launches == before


def test_meshed_and_group_lasso_fits_run_the_chain(dev):
    """A group-lasso fit and a fit on a one-rank mesh (gloo, through the
    host) on the card take the chain: K6 counts no launch.  An elastic-net
    fit of the same data on the card counts one a step."""
    import torch.distributed as dist

    from sgdnet_tpu_torch.parallel.dist import make_mesh

    x, y = st.load_heart()
    common = dict(nlambda=4, device=dev, use_epoch_kernel=False, sampling="block", batch_size=32, maxit=50)
    before = fk.finish_step.launches
    rng = np.random.default_rng(0)
    y01 = (y == np.unique(y)[0]).astype(float)
    st.fit(x, np.stack([y01, y01 + rng.normal(size=y.shape)], axis=1), family="mgaussian", **common)
    assert fk.finish_step.launches == before
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        f = st.fit(x, y, family="binomial", mesh=make_mesh(device=dev), **common)
    finally:
        if made:
            dist.destroy_process_group()
    assert f.stats["mesh"]["size"] == 1 and fk.finish_step.launches == before
    f = st.fit(x, y, family="binomial", **common)
    assert fk.finish_step.launches - before == f.npasses * (-(-x.shape[0] // 32)) > 0


# ---------------------------------------------------------------------------
# the probes P1-P3 (sgdnet_tpu_torch/tools/probe_kernels.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,p,batch", [(512, 32, 32), (4224, 128, 32), (1024, 64, 16), (4096, 8, 1024)])
def test_epoch_probe_matches_twin(dev, n, p, batch):
    """P1 two epochs against its twin at 1e-5 of each array's max (f32 sums
    in another order), and identical bits over two launches: one warp, many
    warps with one and with many column groups, two rows a row slot."""
    rng = np.random.default_rng(n)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    x, y, wt = t(rng.normal(size=(n, p))), t(rng.normal(size=(n, 8))), t(rng.uniform(0.5, 1.5, (n, 8)))
    init = [t(0.1 * rng.normal(size=s)) for s in [(8, p), (n, 8), (8, p)]]
    T = n // batch
    starts = [torch.tensor(rng.permutation(T) * batch, dtype=torch.int32, device=dev) for _ in range(2)]
    runs = []
    for _ in range(2):
        state = [a.clone() for a in init]
        before = pk.epoch_probe.launches
        for s in starts:
            pk.epoch_probe(s, x, y, wt, *state, batch)
        assert pk.epoch_probe.launches == before + 2
        runs.append(state)
    ref = [a.clone() for a in init]
    for s in starts:
        pk.epoch_probe_reference(s, x, y, wt, *ref, batch)
    torch.cuda.synchronize()
    for a, b, r in zip(*runs, ref):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, r, atol=1e-5 * float(r.abs().max()), rtol=0)


def _colsum_ok(out, ref, head, start, batch):
    absum = head[start : start + batch].float().abs().sum(0)
    assert bool(((out - ref).abs() <= 1e-6 * absum).all())


@pytest.mark.parametrize("n_pad,D,batch", [(2048, 768, 256), (2048, 1000, 256), (106496, 16384, 8192)])
def test_block_colsum_kernels_match_twin(dev, n_pad, D, batch):
    """P2 at each tile height and P3 at each ring config, at the first and
    the last block, against the twin within 1e-6 x sum |x| per column, with
    identical bits over two launches and one launch a call; at D 1000 P3's
    last strip is partial."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    head = torch.randn((n_pad, D), generator=gen, dtype=torch.bfloat16, device=dev)
    for start in (0, n_pad - batch):  # the first block and the last: the largest offsets
        for bt in (32, 256, 1024):
            if batch % bt:
                continue
            before = pk.block_colsum.launches
            out = pk.block_colsum(head, start, batch, bt)
            assert pk.block_colsum.launches == before + 1
            assert torch.equal(out, pk.block_colsum(head, start, batch, bt))
            _colsum_ok(out, pk.block_colsum_reference(head, start, batch, bt), head, start, batch)
        for n_buf, chunk_rows in ((2, 512), (4, 256), (4, 512), (8, 256), (8, 128), (2, 64), (8, 32)):
            if batch % chunk_rows:
                continue
            plan = pk.launch_plan(dev, n_buf, chunk_rows, D, batch)
            assert plan.grid == min(plan.sms * plan.ctas_per_sm, plan.stages)
            if D == 1000:
                assert D % plan.width != 0
            before = pk.block_colsum_pipelined.launches
            out = pk.block_colsum_pipelined(head, start, batch, n_buf, chunk_rows)
            assert pk.block_colsum_pipelined.launches == before + 1
            assert torch.equal(out, pk.block_colsum_pipelined(head, start, batch, n_buf, chunk_rows))
            assert pk.block_colsum_pipelined.launches == before + 2
            _colsum_ok(out, pk.block_colsum_reference(head, start, batch, chunk_rows), head, start, batch)
    torch.cuda.synchronize()


def test_block_colsum_pipelined_refuses_what_it_does_not_take(dev):
    """A CUDA head P3 does not take raises, and nothing launches: a ring
    depth it is not built for, chunks that do not tile B, D off 16 bytes,
    a head off 16 bytes."""
    head = torch.zeros((512, 256), dtype=torch.bfloat16, device=dev)
    shifted = torch.zeros(512 * 256 + 1, dtype=torch.bfloat16, device=dev)[1:].view(512, 256)
    narrow = torch.zeros((512, 100), dtype=torch.bfloat16, device=dev)
    before = pk.block_colsum_pipelined.launches
    for h, args in ((head, (0, 128, 3, 64)), (head, (0, 128, 8, 96)), (narrow, (0, 128, 2, 64)),
                    (shifted, (0, 128, 2, 64))):
        with pytest.raises(ValueError):
            pk.block_colsum_pipelined(h, *args)
    assert pk.block_colsum_pipelined.launches == before


# ---------------------------------------------------------------------------
# cross-validation and screening through the kernels
# ---------------------------------------------------------------------------


def _fold_launches(monkeypatch):
    """Record the K1-K4 launches of each fold of parallel/cv.py."""
    from sgdnet_tpu_torch.parallel import cv as pcv

    wrappers = (ek.saga_epochs, hk.fused_head_step_at, tk.coo_tail_forward, tk.coo_tail_outer)
    folds, real = [], pcv._fold_fit_and_score

    def counted(*a, **kw):
        before = [w.launches for w in wrappers]
        out = real(*a, **kw)
        folds.append([w.launches - b for w, b in zip(wrappers, before)])
        return out

    monkeypatch.setattr(pcv, "_fold_fit_and_score", counted)
    return folds


def test_cv_through_epoch_kernel(dev, monkeypatch):
    """cv_fit on the card, serial and fold-parallel: every fit and every
    fold runs K1 (the default for a dense f32 fit), and the two agree as
    tests/test_parallel.py holds the JAX package's (rtol 0.05, atol 1e-3;
    lambda_min equal)."""
    x, y = st.load_heart()
    kw = dict(family="binomial", nfolds=3, nlambda=8, thresh=1e-5, device=dev)
    before = ek.saga_epochs.launches
    cs = st.cv_fit(x, y, **kw)
    assert cs.fit.stats["epoch_kernel"] is True and ek.saga_epochs.launches - before > cs.fit.stats["epoch_chunks"]
    folds = _fold_launches(monkeypatch)
    cp = st.cv_fit(x, y, parallel=True, **kw)
    assert len(folds) == 3 and all(f[0] > 0 for f in folds)
    np.testing.assert_allclose(cp.cv_raw[0], cs.cv_raw[0], rtol=0.05, atol=1e-3)
    assert abs(np.log(cp.lambda_min) - np.log(cs.lambda_min)) < 1e-9


def test_fold_parallel_cv_hybrid_through_kernels(dev, monkeypatch):
    """Fold-parallel CV on a small f32-head hybrid under block sampling:
    every fold runs K2 (use_pallas=True), K3 and K4 on its scaled BlockCOO,
    and the scores match the same call on plain torch ops within 1e-3
    relative."""
    from sgdnet_tpu_torch.parallel.cv import parallel_fold_scores

    rng = np.random.default_rng(5)
    n, p = 6000, 2500
    wz = (np.arange(p) + 10.0) ** -1.15
    cols = np.searchsorted(np.cumsum(wz) / wz.sum(), rng.random((n, 20))).clip(0, p - 1)
    x = sp.csr_matrix((rng.normal(size=n * 20), cols.ravel(), np.arange(0, n * 20 + 1, 20)), shape=(n, p))
    x.sum_duplicates()
    beta = rng.normal(size=p) * (rng.random(p) < 0.05)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x @ beta)))).astype(float)
    kw = dict(family="binomial", batch_size=1024, sampling="block", hybrid=True, hybrid_max_head=256,
              hybrid_coverage=0.8, hybrid_head_dtype="float32", maxit=60, device=dev)
    lam = st.fit(x, y, nlambda=4, lambda_min_ratio=0.1, **kw).lambda_
    foldid = np.arange(n) % 3
    folds = _fold_launches(monkeypatch)
    s_k = parallel_fold_scores(x, y, foldid, 3, 1.0, lam, use_pallas=True, **kw)
    assert len(folds) == 3 and all(f[1] > 0 and f[2] > 0 and f[3] > 0 for f in folds)
    s_p = parallel_fold_scores(x, y, foldid, 3, 1.0, lam, use_pallas=False, use_tail_kernel=False, **kw)
    assert all(sum(f[1:]) == 0 for f in folds[3:])
    assert np.isfinite(s_k).all()
    np.testing.assert_allclose(s_k, s_p, rtol=1e-3, atol=0)


def test_screened_fit_runs_head_kernel_on_subsets(dev):
    """A screened dense fit with use_pallas=True under block sampling: its
    column subsets (dense f32) go through K2, no group falls back to the
    full layout, and it matches the unscreened fit at the tolerance of
    tests/test_screening.py (2e-3 x scale)."""
    rng = np.random.default_rng(6)
    n, p = 8192, 1024
    x = rng.normal(size=(n, p)).astype(np.float32)
    beta = np.zeros(p)
    beta[rng.choice(p, 10, replace=False)] = rng.normal(size=10) * 2
    y = x @ beta + rng.normal(size=n)
    kw = dict(nlambda=8, lambda_min_ratio=0.1, thresh=1e-5, maxit=500, batch_size=1024, sampling="block",
              use_pallas=True, use_epoch_kernel=False, device=dev)
    full = st.fit(x, y, **kw)
    before = hk.fused_head_step_at.launches
    scr = st.fit(x, y, screen=True, **{**kw, "nlambda": None, "lambda_path": full.lambda_})
    s = scr.stats["screening"]
    assert scr.stats["head_kernel"] is True and hk.fused_head_step_at.launches > before
    assert s["full_fallback_groups"] == 0 and s["mean_active"] < 0.35 * p
    scale = max(1.0, np.abs(full.beta).max())
    assert np.abs(scr.beta - full.beta).max() / scale < 2e-3
