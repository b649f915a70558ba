"""The port's kernel twins against the JAX package's Pallas kernels.

On the CPU the port's wrappers run the plain torch twin of each Hopper
kernel; here each twin is held against the Pallas kernel it replaces, run
in interpret mode as the JAX package's own tests run it:

  * K2 (head_kernel.fused_head_step_reference) vs
    pallas_kernels.fused_head_step_at(interpret=True) at the
    tests/test_pallas.py cases, with its bounds (f32: g atol 1e-5, corr
    atol 2e-3; bf16: g atol 3e-2, corr atol 2e-2 * max|corr|);
  * K1 (epoch_kernel.saga_epochs' twin, a chunk of one epoch) vs
    epoch_kernel.build(interpret=True) for one f32 epoch from the same
    state and block starts, across
    5 families x 3 penalties with offsets / penalty factors / refresh on
    and off, at 1e-5 relative;
  * K2's launch plan (head_kernel.plan) over a grid of shapes: shared
    memory within a CTA's 232448 bytes, strips that tile D, a grid that
    tiles B, every shape the gate took before still taken, and the two
    shapes the fit paths run;
  * K2's summation order on the card (strip and segment parts of lp in
    rank and segment order; rows in order within a tile, tiles in order
    within a cluster; the clusters' partials in `sum_partials` order),
    replayed in numpy f32: against the twin at 1e-5 x scale and against
    the Pallas kernel at the bounds above;
  * the Hopper gates.

The kernels themselves run only on the card: tests/test_torch_cuda.py
holds them against these twins there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdnet_tpu.families import get_family as jget_family
from sgdnet_tpu.penalties import select_penalty as jselect_penalty
from sgdnet_tpu.solver import epoch_kernel as jek
from sgdnet_tpu.solver.pallas_kernels import fused_head_step_at as j_head_step
from sgdnet_tpu.solver.saga import SagaState as JState
from sgdnet_tpu.solver.saga import SolverConfig as JConfig
from sgdnet_tpu_torch.families import get_family
from sgdnet_tpu_torch.penalties import select_penalty
from sgdnet_tpu_torch.solver import epoch_kernel as ek
from sgdnet_tpu_torch.solver import head_kernel as hk
from sgdnet_tpu_torch.solver.saga import SagaState, SolverConfig, uses_head_kernel

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# K2: fused head step
# ---------------------------------------------------------------------------


def _head_case(family, k, seed, n_pad=256, B=128, D=256):
    rng = np.random.default_rng(seed)
    head = rng.normal(size=(n_pad, D)).astype(np.float32)
    # w scaled so |lp| = O(1) as on a fitted path: at the unscaled |lp| ~ 16
    # of tests/test_pallas.py, torch's and XLA's f32 summation orders alone
    # differ by ~1e-5 in g
    w = (rng.normal(size=(k, D)) / np.sqrt(D)).astype(np.float32)
    lpe = rng.normal(size=(B, k)).astype(np.float32)
    if family == "binomial":
        y = (rng.random((n_pad, k)) < 0.5).astype(np.float32)
    elif family == "multinomial":
        y = np.eye(k, dtype=np.float32)[rng.integers(0, k, n_pad)]
    else:
        y = rng.normal(size=(n_pad, k)).astype(np.float32)
    gm = rng.normal(size=(n_pad, k)).astype(np.float32)
    wb = (rng.random(B) < 0.9).astype(np.float32)
    return head, w, lpe, y, gm, wb


@pytest.mark.parametrize("kp_lanes", [8, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("start", [0, 128])
@pytest.mark.parametrize("family,k", [("gaussian", 1), ("binomial", 1), ("multinomial", 3), ("mgaussian", 2),
                                      ("multinomial", 53), ("multinomial", 128)])
def test_head_twin_matches_pallas(family, k, start, dtype, kp_lanes):
    B = 128
    head, w, lpe, y, gm, wb = _head_case(family, k, seed=k)
    yb, gmb = y[start:start + B], gm[start:start + B]
    jhead = jnp.asarray(head).astype(getattr(jnp, dtype))
    g_j, corr_j = j_head_step(jhead, jnp.int32(start), jnp.asarray(w), jnp.asarray(lpe), jnp.asarray(yb),
                              jnp.asarray(gmb), jnp.asarray(wb), B, family, interpret=True, kp_lanes=kp_lanes)
    thead = torch.tensor(head).to(getattr(torch, dtype))
    g_t, corr_t = hk.fused_head_step_at(thead, start, torch.tensor(w), torch.tensor(lpe), torch.tensor(yb),
                                        torch.tensor(gmb), torch.tensor(wb), family)
    assert g_t.dtype == torch.float32 and corr_t.shape == (k, head.shape[1])
    g_j, corr_j = np.asarray(g_j), np.asarray(corr_j)
    if dtype == "float32":
        np.testing.assert_allclose(g_t.numpy(), g_j, atol=1e-5)
        np.testing.assert_allclose(corr_t.numpy(), corr_j, atol=2e-3)
    else:
        np.testing.assert_allclose(g_t.numpy(), g_j, atol=3e-2)
        np.testing.assert_allclose(corr_t.numpy(), corr_j, atol=2e-2 * max(np.abs(corr_j).max(), 1.0))


def test_head_wrapper_on_cpu_is_the_twin():
    head, w, lpe, y, gm, wb = (torch.tensor(a) for a in _head_case("multinomial", 3, seed=9))
    before = hk.fused_head_step_at.launches
    a = hk.fused_head_step_at(head, 128, w, lpe, y[128:], gm[128:], wb, "multinomial")
    b = hk.fused_head_step_reference(head, 128, w, lpe, y[128:], gm[128:], wb, "multinomial")
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert hk.fused_head_step_at.launches == before  # the twin never counts as a launch


#: the streamed design's tiles by item size: (BK columns of an lp stage, BR rows of a corr stage, row padding)
STREAM_TILES = {2: (64, 64, 8), 4: (32, 32, 4)}


def _stream_plan_ok(p, B, D, k, dtype, max_ctas=hk.N_SM):
    """A StreamPlan: classes padded to the mma's 16, tiles and strips that
    cover B and D, clusters of 1-8 CTAs with no CTA left without columns
    (lp) or rows (corr), one wave of `max_ctas` CTAs unless the clusters
    are single CTAs, each kernel's shared memory within a CTA's, and a
    scratch of w rounded and gc alone (no partial corr)."""
    es = dtype.itemsize
    bk, br, pad = STREAM_TILES[es]
    assert p.kp % 16 == 0 and k <= p.kp < k + 16
    assert p.tiles * 128 >= B > (p.tiles - 1) * 128 and p.strips * 128 >= D > (p.strips - 1) * 128
    assert p.n_kc * bk >= D > (p.n_kc - 1) * bk
    assert p.C in (1, 2, 4, 8) and p.C <= p.n_kc and (p.C == 1 or p.tiles * p.C <= max_ctas)
    assert p.R in (1, 2, 4, 8) and p.R <= p.tiles * 128 // br and (p.R == 1 or p.strips * p.R <= max_ctas)
    ring = 4 * (128 + p.kp) * (bk + pad) * es  # 4 stages of a 128 x BK head chunk and a kp x BK w chunk
    assert ring >= 4 * 128 * p.kp and p.smem == ring + 4 * (128 // p.C) * p.kp  # the lp part fits the drained ring
    ring2 = 4 * br * (128 + pad + p.kp + pad) * es  # 4 stages of a BR x 128 head chunk and a BR x kp gc chunk
    assert ring2 >= 4 * p.kp * 128 and p.smem2 == ring2
    assert max(p.smem, p.smem2) <= hk.SMEM_LIMIT


def _plan_ok(p, B, D, k, dtype):
    if not p.resident:
        _stream_plan_ok(p, B, D, k, dtype)
        return
    es = dtype.itemsize
    ve = 16 // es
    assert p.smem <= hk.SMEM_LIMIT == 232448 and B % p.bt == 0 and p.bt in (8, 16, 32)
    n_tiles = B // p.bt
    assert p.C in (1, 2, 4, 8) and p.W % ve == 0
    assert p.C * p.W >= D > (p.C - 1) * p.W  # C strips tile D, none empty
    assert 1 <= p.S <= min(3, p.tpc)
    assert p.n_parts * p.tpc >= n_tiles > (p.n_parts - 1) * p.tpc  # the clusters tile B, none idle
    assert p.ctas <= hk.N_SM * hk.ctas_per_sm(p.smem, k)  # a persistent grid: all resident at once
    kc = 1 if k == 1 else 64 // ve
    assert p.single is (k <= kc and p.W // ve <= hk.THREADS)
    part_rows = max(p.bt, 16)  # 8-row tiles are cut into two column segments
    assert p.smem == (p.S * p.bt * p.W * es + k * p.W * es + (0 if p.single else 4 * k * p.W)
                      + 4 * k * (2 * part_rows + 2 * p.bt))


@pytest.mark.parametrize("B", [8, 1032, 4096, 8192])
@pytest.mark.parametrize("D", [1, 9, 784, 785, 4096, 16384])
def test_head_plan_grid(B, D):
    for dtype in (torch.float32, torch.bfloat16):
        for k in (1, 3, 10, 128):
            p = hk.plan(B, D, k, dtype)
            _plan_ok(p, B, D, k, dtype)
            # cut to fewer CTAs (a card that holds fewer clusters) it still tiles B
            q = hk.plan(B, D, k, dtype, max_ctas=40)
            _plan_ok(q, B, D, k, dtype)
            assert not q.resident or q.ctas <= 40
            # every shape the gate took before (8 | B, D >= 1, k <= 128) is taken
            assert hk.supported(B, D, k, dtype, "gaussian")
    assert hk.plan(B + 4, D, 1, torch.float32) is None and not hk.supported(B + 4, D, 1)


def test_head_plan_at_the_paths_shapes():
    # the sparse north-star shape: eight strips of 2048 bf16 columns, the
    # tile resident between the two products (one read of the head), three
    # CTAs an SM, one partial corr per cluster
    p = hk.plan(8192, 16384, 1, torch.bfloat16)
    assert p.resident and p.single and (p.C, p.W, p.bt) == (8, 2048, 16)
    assert hk.ctas_per_sm(p.smem, 1) == 3 and p.ctas <= 3 * 132
    assert p.n_parts * 1 * 16384 * 4 <= 4 * 2**20  # partials: a few MB where one per 32-row tile was 16.8 MB
    # the dense multinomial shape: a whole 16-row tile of 784 f32 columns in one CTA
    p = hk.plan(4096, 784, 10, torch.float32)
    assert p.resident and p.single and (p.C, p.W, p.bt, p.tpc) == (1, 784, 16, 1)
    # no cluster of eight holds a 128 x 16384 w: the streamed kernel
    assert not hk.plan(8192, 16384, 128, torch.bfloat16).resident


@pytest.mark.parametrize("B,D,k,dtype,want", [
    (8192, 16384, 53, torch.bfloat16, (64, 2, 256, 1, 64, 128)),  # slice M: 64 tiles x 2, 128 strips
    (4096, 3072, 100, torch.float32, (112, 4, 96, 4, 32, 24)),  # CIFAR-100: 32 tiles x 4, 24 strips x 4
    (8192, 16384, 17, torch.bfloat16, (32, 2, 256, 1, 64, 128)),  # just past the resident limit
    (8192, 16384, 128, torch.bfloat16, (128, 2, 256, 1, 64, 128)),  # MAX_K
    (1032, 4096, 128, torch.bfloat16, (128, 8, 64, 4, 9, 32)),  # a B only 8 divides: 9 tiles, the last 8 rows
])
def test_stream_plan_at_the_many_class_shapes(B, D, k, dtype, want):
    """The shapes no resident plan holds take the streamed design: its
    grids fill the card once (at most 132 CTAs), its shared memory fits a
    CTA, and its scratch (w rounded, gc) is a few MB where the tile
    kernel's partials, one (k, D) f32 per 32-row tile, were hundreds."""
    p = hk.plan(B, D, k, dtype)
    assert not p.resident and not list(hk.resident_plans(B, D, k, dtype))
    assert (p.kp, p.C, p.n_kc, p.R, p.tiles, p.strips) == want
    _stream_plan_ok(p, B, D, k, dtype)
    lp_ctas, corr_ctas = p.ctas
    assert 64 <= lp_ctas <= hk.N_SM and 64 <= corr_ctas <= hk.N_SM
    bk = STREAM_TILES[dtype.itemsize][0]
    scratch = (p.kp * p.n_kc * bk + p.tiles * 128 * p.kp) * dtype.itemsize
    assert scratch <= 8 * 2**20 and 20 * scratch < (B // 32) * k * D * 4
    # a card that holds fewer CTAs gets smaller clusters
    q = hk.plan(B, D, k, dtype, max_ctas=40)
    _stream_plan_ok(q, B, D, k, dtype, max_ctas=40)
    assert q.C <= p.C and q.R <= p.R


def _round_to(a, dtype):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype).float().numpy()


def _sum_partials(parts):
    """csrc/common.h `sum_partials`: part t goes to group t % 8, each group
    adds its parts in order, the 8 group sums are added in group order."""
    groups = [np.zeros_like(parts[0]) for _ in range(8)]
    for t, part in enumerate(parts):
        groups[t % 8] = groups[t % 8] + part
    acc = groups[0]
    for grp in groups[1:]:
        acc = acc + grp
    return acc


def _replay_head_step(head, start, w, lpe, yb, gm, wb, family, p, dtype):
    """The resident K2 kernel's sums in its own order, in numpy f32 (within
    a warp's segment numpy's own order stands in for the lanes')."""
    f32 = np.float32
    B, k = yb.shape
    D = head.shape[1]
    x = _round_to(head, dtype)[start:start + B]
    wq = _round_to(w, dtype)
    nseg = max(8 // (p.bt // 2), 1)
    g_out = np.zeros((B, k), f32)
    partials = []
    for q in range(p.n_parts):
        corr = np.zeros((k, D), f32)
        for t in range(q * p.tpc, min((q + 1) * p.tpc, B // p.bt)):
            rows = slice(t * p.bt, (t + 1) * p.bt)
            lp = np.zeros((p.bt, k), f32)
            for rank in range(p.C):  # rank order; within a rank segment 0 + segment 1
                lo, hi = rank * p.W, min((rank + 1) * p.W, D)
                nvec = -(-(hi - lo) // (16 // dtype.itemsize))
                vps = -(-nvec // nseg) * (16 // dtype.itemsize)
                segs = [x[rows, lo + s * vps:min(lo + (s + 1) * vps, hi)] @ wq[:, lo + s * vps:min(lo + (s + 1) * vps, hi)].T
                        for s in range(2)]
                lp = lp + (segs[0].astype(f32) + (segs[1].astype(f32) if nseg > 1 else f32(0)))
            lp = lp + lpe[rows]
            if family == "multinomial":
                e = np.exp(lp - lp.max(1, keepdims=True))
                g = e / e.sum(1, keepdims=True) - yb[rows]
            elif family == "binomial":
                g = 1 / (1 + np.exp(-lp)) - yb[rows]
            else:
                g = lp - yb[rows]
            g = (g * wb[rows, None]).astype(f32)
            g_out[rows] = g
            gc = _round_to(g - gm[rows], dtype)
            for r in range(p.bt):  # rows in order, tiles in order
                corr = corr + gc[r][:, None] * x[t * p.bt + r][None, :]
        partials.append(corr)
    return g_out, partials[0] if len(partials) == 1 else _sum_partials(partials)


@pytest.mark.parametrize("cut", ["planned", "cluster of 4, 8-row tiles", "sixteen 8-row tiles"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family,k", [("binomial", 1), ("multinomial", 3), ("mgaussian", 2)])
def test_head_kernel_order_replayed(family, k, dtype, cut):
    B, start, tdt = 128, 128, getattr(torch, dtype)
    head, w, lpe, y, gm, wb = _head_case(family, k, seed=10 + k)
    yb, gmb = y[start:start + B], gm[start:start + B]
    D = head.shape[1]
    if cut == "planned":
        p = hk.plan(B, D, k, tdt)
        _plan_ok(p, B, D, k, tdt)
    elif cut == "cluster of 4, 8-row tiles":  # 12 CTAs: 3 clusters walk 6 tiles each, two segments a row pair
        p = next(q for q in hk.resident_plans(B, D, k, tdt, max_ctas=12) if (q.C, q.bt) == (4, 8))
        assert (p.n_parts, p.tpc) == (3, 6)
    else:  # 16 partials: sum_partials' groups of 8 wrap
        p = next(q for q in hk.resident_plans(B, D, k, tdt) if (q.C, q.bt) == (1, 8))
        assert p.n_parts == 16
    g_r, corr_r = _replay_head_step(head, start, w, lpe, yb, gmb, wb, family, p, tdt)
    g_t, corr_t = hk.fused_head_step_reference(torch.tensor(head).to(tdt), start, torch.tensor(w), torch.tensor(lpe),
                                               torch.tensor(yb), torch.tensor(gmb), torch.tensor(wb), family)
    g_j, corr_j = j_head_step(jnp.asarray(head).astype(getattr(jnp, dtype)), jnp.int32(start), jnp.asarray(w),
                              jnp.asarray(lpe), jnp.asarray(yb), jnp.asarray(gmb), jnp.asarray(wb), B, family,
                              interpret=True)
    scale = max(float(corr_t.abs().max()), 1.0)
    if dtype == "float32":  # summation order only
        np.testing.assert_allclose(g_r, g_t.numpy(), atol=1e-5)
        np.testing.assert_allclose(corr_r, corr_t.numpy(), atol=1e-5 * scale)
        np.testing.assert_allclose(g_r, np.asarray(g_j), atol=1e-5)
        np.testing.assert_allclose(corr_r, np.asarray(corr_j), atol=2e-3)
    else:  # a g next to a rounding boundary of gc moves corr by a bf16 ulp of gc times a head entry
        np.testing.assert_allclose(g_r, g_t.numpy(), atol=3e-2)
        np.testing.assert_allclose(corr_r, corr_t.numpy(), atol=2e-2 * scale)
        np.testing.assert_allclose(g_r, np.asarray(g_j), atol=3e-2)
        np.testing.assert_allclose(corr_r, np.asarray(corr_j), atol=2e-2 * max(np.abs(np.asarray(corr_j)).max(), 1.0))


def _replay_streamed(head, start, w, lpe, yb, gm, wb, family, p, dtype):
    """The streamed design's sums in its own order, in numpy f32 (within a
    chunk numpy's order stands in for the mma's or the FMA chain's): a
    tile's lp, C runs of BK-column chunks, each run's chunks in order, the
    runs added in rank order, then lp_extra; corr, a strip's R runs of
    BR-row chunks, each run's chunks in order, the runs added in rank
    order.  Past B and D the operands are zero, as the kernels fill them."""
    f32 = np.float32
    B, k = yb.shape
    D = head.shape[1]
    bk, br, _ = STREAM_TILES[dtype.itemsize]
    rows = p.tiles * 128
    x = np.zeros((rows, p.n_kc * bk), f32)
    x[:B, :D] = _round_to(head, dtype)[start:start + B]
    wq = np.zeros((k, p.n_kc * bk), f32)
    wq[:, :D] = _round_to(w, dtype)
    lp = f32(0)
    for rank in range(p.C):
        part = np.zeros((rows, k), f32)
        for kc in range(rank * p.n_kc // p.C, (rank + 1) * p.n_kc // p.C):
            cols = slice(kc * bk, (kc + 1) * bk)
            part = part + x[:, cols] @ wq[:, cols].T
        lp = lp + part
    lp = lp[:B] + lpe
    if family == "multinomial":
        e = np.exp(lp - lp.max(1, keepdims=True))
        g = e / e.sum(1, keepdims=True) - yb
    elif family == "binomial":
        g = 1 / (1 + np.exp(-lp)) - yb
    else:
        g = lp - yb
    g = (g * wb[:, None]).astype(f32)
    gc = np.zeros((rows, k), f32)
    gc[:B] = _round_to(g - gm, dtype)
    n_ch = rows // br
    corr = f32(0)
    for rank in range(p.R):
        part = np.zeros((k, x.shape[1]), f32)
        for ch in range(rank * n_ch // p.R, (rank + 1) * n_ch // p.R):
            r = slice(ch * br, (ch + 1) * br)
            part = part + gc[r].T @ x[r]
        corr = corr + part
    return g, corr[:, :D]


@pytest.mark.parametrize("cut", [(1, 1), (2, 4), (4, 2)], ids=lambda c: f"C{c[0]}-R{c[1]}")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family,k", [("binomial", 1), ("multinomial", 20), ("mgaussian", 3)])
def test_head_streamed_order_replayed(family, k, dtype, cut):
    """The streamed design's order (`_replay_streamed`) at lp clusters of C
    and corr clusters of R, on a head 200 wide (a ragged last chunk and
    strip) and B 136 (two tiles, the second of 8 rows): against the twin
    at 1e-5 x scale in f32 (summation order only) and against the Pallas
    kernel at phase 3's bounds."""
    B, start, tdt = 136, 64, getattr(torch, dtype)
    head, w, lpe, y, gm, wb = _head_case(family, k, seed=20 + k, n_pad=256, B=B, D=200)
    yb, gmb = y[start:start + B], gm[start:start + B]
    p = hk.stream_plan(B, 200, k, tdt, *cut)
    _stream_plan_ok(p, B, 200, k, tdt, max_ctas=64)
    g_r, corr_r = _replay_streamed(head, start, w, lpe, yb, gmb, wb, family, p, tdt)
    g_t, corr_t = hk.fused_head_step_reference(torch.tensor(head).to(tdt), start, torch.tensor(w), torch.tensor(lpe),
                                               torch.tensor(yb), torch.tensor(gmb), torch.tensor(wb), family)
    g_j, corr_j = j_head_step(jnp.asarray(head).astype(getattr(jnp, dtype)), jnp.int32(start), jnp.asarray(w),
                              jnp.asarray(lpe), jnp.asarray(yb), jnp.asarray(gmb), jnp.asarray(wb), B, family,
                              interpret=True)
    scale = max(float(corr_t.abs().max()), 1.0)
    if dtype == "float32":
        np.testing.assert_allclose(g_r, g_t.numpy(), atol=1e-5)
        np.testing.assert_allclose(corr_r, corr_t.numpy(), atol=1e-5 * scale)
        np.testing.assert_allclose(g_r, np.asarray(g_j), atol=1e-5)
        np.testing.assert_allclose(corr_r, np.asarray(corr_j), atol=2e-3)
    else:
        np.testing.assert_allclose(g_r, g_t.numpy(), atol=3e-2)
        np.testing.assert_allclose(corr_r, corr_t.numpy(), atol=2e-2 * scale)
        np.testing.assert_allclose(g_r, np.asarray(g_j), atol=3e-2)
        np.testing.assert_allclose(corr_r, np.asarray(corr_j), atol=2e-2 * max(np.abs(np.asarray(corr_j)).max(), 1.0))


# ---------------------------------------------------------------------------
# K1: whole-epoch kernel
# ---------------------------------------------------------------------------

FAMILIES = ["gaussian", "binomial", "poisson", "multinomial", "mgaussian"]
PENALTIES = [(0.0, "ungrouped"), (0.7, "ungrouped"), (0.7, "grouped")]  # ridge, elastic net, group lasso


def _epoch_problem(family, seed, n=60, p=7, B=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p))
    x = (x - x.mean(0)) / x.std(0)
    if family == "gaussian":
        y = rng.normal(size=(n, 1))
    elif family == "binomial":
        y = (rng.random((n, 1)) < 0.4).astype(float)
    elif family == "poisson":
        y = rng.poisson(1.5, size=(n, 1)).astype(float)
    elif family == "multinomial":
        y = np.eye(3)[rng.integers(0, 3, n)]
    else:
        y = rng.normal(size=(n, 2))
    k = y.shape[1]
    n_pad = -(-n // B) * B
    pad = lambda a: np.concatenate([a, np.zeros((n_pad - n,) + a.shape[1:])]).astype(np.float32)  # noqa: E731
    weights = pad(rng.uniform(0.5, 1.5, n))
    state = dict(
        w=0.2 * rng.normal(size=(k, p)), intercept=0.1 * rng.normal(size=k),
        g_mem=pad(0.1 * rng.normal(size=(n, k))), g_sum=0.05 * rng.normal(size=(k, p)),
        g_sum_intercept=0.05 * rng.normal(size=k),
    )
    state = {f: np.asarray(v, np.float32) for f, v in state.items()}
    offs = pad(0.3 * rng.normal(size=(n, k)))
    pf = rng.uniform(0.0, 2.0, p).astype(np.float32)
    return pad(x), pad(y), weights, state, offs, pf


@pytest.mark.parametrize("pen", range(len(PENALTIES)))
@pytest.mark.parametrize("family", FAMILIES)
def test_epoch_twin_matches_pallas(family, pen):
    alpha, tm = PENALTIES[pen]
    case = FAMILIES.index(family) * 3 + pen
    # options rotate over the 15 cases: offsets, penalty factors, in-kernel
    # refresh on/off, intercept on/off
    with_offs, with_pf = case % 3 == 1, case % 3 == 2
    refresh_every = 1 if case % 2 == 0 else 2
    fit_intercept = case % 4 != 3
    B = 16
    x, y, weights, state, offs, pf = _epoch_problem(family, seed=case)
    n_pad, p = x.shape
    k = y.shape[1]
    smooth = {"smoothness": 4.0} if family == "poisson" else {}
    jfam, tfam = jget_family(family, **smooth), get_family(family, **smooth)
    jfam.n_classes = tfam.n_classes = k
    jpen, tpen = jselect_penalty(alpha, family, tm), select_penalty(alpha, family, tm)
    assert jpen.name == tpen.name
    gamma, l1, l2, w_total = 0.05, 0.02, 0.03, float(weights.sum())
    jcfg = JConfig(batch_size=B, fit_intercept=fit_intercept, intercept_decay=0.5,
                   g_sum_refresh_every=refresh_every, use_epoch_kernel=True, sampling="block")
    tcfg = SolverConfig(batch_size=B, fit_intercept=fit_intercept, intercept_decay=0.5,
                        g_sum_refresh_every=refresh_every, use_epoch_kernel=True, sampling="block")
    key = jax.random.PRNGKey(case)
    order = np.asarray(jax.random.permutation(key, n_pad // B))  # the JAX epoch's block order

    jx = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    epoch_j = jek.build(jx(x), jx(y), jx(weights), jnp.float32(w_total), jfam, jpen, jcfg, interpret=True,
                        offs=jx(offs) if with_offs else None, pf=jx(pf) if with_pf else None)
    ps_j = jek.pad_state(JState(**{f: jnp.asarray(v) for f, v in state.items()}), p)
    out_j = epoch_j(ps_j, key, jnp.float32(gamma), jnp.float32(l1), jnp.float32(l2), it=0)

    tt = lambda a: None if a is None else torch.tensor(a)  # noqa: E731
    epochs_t = ek.build_epochs(tt(x), tt(y), tt(weights), w_total, tfam, tpen, tcfg,
                               offs=tt(offs) if with_offs else None, pf=tt(pf) if with_pf else None)
    ps_t = ek.pad_state(SagaState(**{f: torch.tensor(v) for f, v in state.items()}), p)
    out_t, stats = epochs_t(ps_t, torch.tensor(order)[None], gamma, l1, l2, it0=0)
    assert stats[0] == 1  # a chunk of one epoch

    for name, a, b in zip(ek.PadState._fields, out_t, out_j):
        b = np.asarray(b)
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5 * scale, err_msg=name)
    # pad lanes stay exactly zero
    assert float(out_t.w[k:].abs().max() if k < ek.KP else 0.0) == 0.0
    assert float(out_t.w[:, p:].abs().max()) == 0.0
    assert float(out_t.g_mem[:, k:].abs().max() if k < ek.KP else 0.0) == 0.0
    # and the epoch is functional: the input state is untouched
    assert torch.equal(ps_t.w, ek.pad_state(SagaState(**{f: torch.tensor(v) for f, v in state.items()}), p).w)


def test_pad_state_roundtrip():
    rng = np.random.default_rng(0)
    st = SagaState(*(torch.tensor(rng.normal(size=s)) for s in [(3, 5), (3,), (32, 3), (3, 5), (3,)]))
    ps = ek.pad_state(st, 5)
    assert ps.w.shape == (ek.KP, 128) and ps.g_mem.shape == (32, ek.KP) and ps.ivec.shape == (2, ek.KP)
    back = ek.unpad_state(ps, 3, 5)
    for a, b in zip(back, st):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args,ok", [
    ((4192, 9, 1, 32, torch.float64), False),  # f32 only
    ((4192, 9, 9, 32), False),  # k > 8
    ((4190, 9, 1, 10), False),  # B not 8-aligned
    ((4192, 9, 1, 48), False),  # B does not tile n_pad
    ((3_000_000, 512, 1, 8192), False),  # beyond the L2 budget
    ((65536, 784, 10, 4096), False),  # the dense multinomial shape: K2's, not K1's
    ((1024, 3600, 1, 8), False),  # the (KP, P) state exceeds shared memory
    ((4192, 9, 1, 32), True),
    ((4192, 9, 8, 32), True),
])
def test_epoch_gate(args, ok):
    assert ek.supported(*args) is ok


def test_epoch_gate_counts_offsets():
    n_pad, p = 26112, 384  # just inside the L2 budget without offsets
    assert ek.supported(n_pad, p, 1, 32)
    assert not ek.supported(n_pad, p, 1, 32, with_offs=True)


@pytest.mark.parametrize("args,ok", [
    ((4096, 784, 10, torch.float32, "multinomial"), True),
    ((4096, 784, 10, torch.bfloat16, "mgaussian"), True),
    ((128, 256, 1, torch.float32, "binomial"), True),
    ((128, 256, 1, torch.float32, "poisson"), False),  # no poisson gradient in K2
    ((128, 256, 1, torch.float64, "gaussian"), False),
    ((128, 256, 129, torch.float32, "multinomial"), False),
    ((100, 256, 1, torch.float32, "gaussian"), False),  # B not 8-aligned
])
def test_head_gate(args, ok):
    assert hk.supported(*args) is ok


def test_head_gate_in_the_step():
    x = torch.zeros((256, 16))
    block = SolverConfig(batch_size=64, use_pallas=True, sampling="block")
    assert uses_head_kernel(x, get_family("binomial"), block)
    # a poisson fit never selects K2 (the JAX gate would let it through and
    # fail at trace time)
    assert not uses_head_kernel(x, get_family("poisson"), block)
    assert not uses_head_kernel(x, get_family("binomial"), SolverConfig(batch_size=64, use_pallas=True))
    assert not uses_head_kernel(x.double(), get_family("binomial"), block)
