"""The measurement probes P1-P3 (sgdnet_tpu_torch/tools) on the CPU.

  * P1's twin (probe_kernels.epoch_probe_reference) against the Pallas body
    it replaces, tools/bench_epoch_kernel.py `_epoch_kernel` run through
    `pl.pallas_call(interpret=True)` with `run_pallas`'s specs, and against
    the file's own `run_xla`: two epochs at the probe's size (N 4224, P 128,
    B 32), 1e-5 relative to each array's max (f32 sums in another order);
    the lanes and rows outside the model pass through untouched;
  * P2's and P3's twin (block_colsum_reference) against verbatim copies of
    the TPU bodies (`reduce_kernel`, `kernel`: closures inside the tools'
    `main`, so they cannot be imported) in interpret mode at n_pad 256,
    D 256, B 64: within 1e-6 x sum |x| per column;
  * the CUDA kernels' summation orders replayed in numpy (P1's lanes and
    column groups, P2's tiles, P3's strips, thread groups and ring), P1's
    launch plan (K1's lane mapping) and shared-memory expression, and P3's
    strip-width choice;
  * each probe entry point end to end on device="cpu" at a tiny size, and
    device=None raising without a card.
"""

import importlib.util
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sgdnet_tpu_torch.tools import bench_dma_streams, bench_epoch_kernel, bench_head_dma
from sgdnet_tpu_torch.tools import probe_kernels as pk

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# P1
# ---------------------------------------------------------------------------


def _p1_pallas(mod):
    """`run_pallas`'s pallas_call (bench_epoch_kernel.py:65-91), interpreted."""
    N, P = mod.N, mod.P
    full = lambda shape: pl.BlockSpec(shape, lambda i, s: (0, 0))  # noqa: E731
    return pl.pallas_call(
        mod._epoch_kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(1,),
            in_specs=[full((N, P)), full((N, 8)), full((N, 8)), full((8, P)), full((N, 8)), full((8, P))],
            out_specs=[full((8, P)), full((N, 8)), full((8, P))],
        ),
        out_shape=[jax.ShapeDtypeStruct((8, P), jnp.float32), jax.ShapeDtypeStruct((N, 8), jnp.float32),
                   jax.ShapeDtypeStruct((8, P), jnp.float32)],
        input_output_aliases={4: 0, 5: 1, 6: 2},
        interpret=True,
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_p1_twin_matches_pallas_and_xla(seed):
    mod = _load_tool("bench_epoch_kernel")
    N, P, B, T = mod.N, mod.P, mod.B, mod.T
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    x, y = f32(N, P), f32(N, 8)
    wt = rng.uniform(0.5, 1.5, (N, 8)).astype(np.float32)
    w, gm, gs = 0.1 * f32(8, P), 0.1 * f32(N, 8), 0.01 * f32(8, P)
    starts = np.stack([rng.permutation(T) * B for _ in range(2)]).astype(np.int32)

    f = _p1_pallas(mod)
    state = (jnp.asarray(w), jnp.asarray(gm), jnp.asarray(gs))
    for st in starts:
        state = f(jnp.asarray(st), jnp.asarray(x), jnp.asarray(y), jnp.asarray(wt), *state)
    xla = mod.run_xla(jnp.asarray(starts), jnp.asarray(x), jnp.asarray(y), jnp.asarray(wt), jnp.asarray(w),
                      jnp.asarray(gm), jnp.asarray(gs))

    tw = [torch.tensor(a.copy()) for a in (w, gm, gs)]
    before = pk.epoch_probe.launches
    for st in starts:
        out = pk.epoch_probe(torch.tensor(st), torch.tensor(x), torch.tensor(y), torch.tensor(wt), *tw, B)
    assert pk.epoch_probe.launches == before and all(o is t for o, t in zip(out, tw))  # in place, no launch
    for name, t, a, b, init in zip(("w", "g_mem", "g_sum"), tw, state, xla, (w, gm, gs)):
        a, b, t = np.asarray(a), np.asarray(b), t.numpy()
        # only row / lane 0 is the model: the Pallas kernel copies the rest
        # from its aliased input, and so does the twin (run_xla zero-pads it)
        model, rest = (np.s_[:, 0], np.s_[:, 1:]) if name == "g_mem" else (np.s_[0], np.s_[1:])
        np.testing.assert_allclose(t, a, rtol=0, atol=1e-5 * np.abs(a).max(), err_msg=name)
        np.testing.assert_allclose(t[model], b[model], rtol=0, atol=1e-5 * np.abs(b[model]).max(), err_msg=name)
        np.testing.assert_array_equal(t[rest], init[rest], err_msg=name)
        np.testing.assert_array_equal(a[rest], init[rest], err_msg=name)


def _p1_kernel_epoch(starts, x, y, wt, w, gm, gs, B, lanes, groups):
    """P1's kernel order in f32 numpy: a row's L lanes each sum the
    16-byte chunks 4q, 4q + 4L, ... (four FMAs a chunk), the lane sums meet
    in the xor butterfly; the column phase sums rows gi, gi + groups, ...
    of each group (with groups 1: four interleaved sums, added pairwise),
    then the groups in order; one reciprocal of B and of N multiplied in."""
    f = np.float32
    N, P = x.shape
    shrink, thr = f(1) - pk.GAMMA * pk.L2, pk.GAMMA * pk.L1
    inv_b, inv_n = f(1) / f(B), f(1) / f(N)
    for s in starts:
        xb = x[s : s + B]
        gc = np.zeros(B, f)
        for b in range(B):
            lanes_acc = np.zeros(lanes, f)
            for q in range(lanes):
                for j in range(4 * q, P, 4 * lanes):
                    for u in range(4):
                        lanes_acc[q] = f(lanes_acc[q] + xb[b, j + u] * w[0, j + u])
            o = lanes // 2
            while o:
                lanes_acc = lanes_acc + lanes_acc[np.arange(lanes) ^ o]
                o //= 2
            g = (lanes_acc[0] - y[s + b, 0]) * wt[s + b, 0]
            gc[b] = g - gm[s + b, 0]
            gm[s + b, 0] = g
        if groups == 1:
            acc = np.zeros((4, P), f)
            for b in range(B - B % 4):
                acc[b % 4] += gc[b] * xb[b]
            for b in range(B - B % 4, B):
                acc[0] += gc[b] * xb[b]
            corr = (acc[0] + acc[1]) + (acc[2] + acc[3])
        else:
            parts = [np.zeros(P, f) for _ in range(groups)]
            for gi in range(groups):
                for b in range(gi, B, groups):
                    parts[gi] += gc[b] * xb[b]
            corr = np.zeros(P, f)
            for gi in range(groups):
                corr += parts[gi]
        wh = w[0] * shrink - pk.GAMMA * (corr * inv_b + gs[0])
        w[0] = np.sign(wh) * np.maximum(np.abs(wh) - thr, f(0))
        gs[0] += corr * inv_n
    return w, gm, gs


@pytest.mark.parametrize("P,B", [(128, 32), (16, 32), (64, 16)])
def test_p1_kernel_order_matches_twin(P, B):
    """The redesigned P1's summation order (at the lanes and column groups
    `epoch_probe_plan` picks) gives its twin's epoch within 1e-5 of each
    array's max."""
    N = 8 * B
    threads, lanes, groups, stages = pk.epoch_probe_plan(P, B)
    rng = np.random.default_rng(P + B)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    x, y, wt = f32(N, P), f32(N, 8), rng.uniform(0.5, 1.5, (N, 8)).astype(np.float32)
    init = (0.1 * f32(8, P), 0.1 * f32(N, 8), 0.01 * f32(8, P))
    starts = rng.permutation(N // B) * B
    k = _p1_kernel_epoch(starts, x, y, wt, *(a.copy() for a in init), B, lanes, groups)
    t = pk.epoch_probe_reference(torch.tensor(starts), torch.tensor(x), torch.tensor(y), torch.tensor(wt),
                                 *(torch.tensor(a.copy()) for a in init), B)
    for a, b in zip(k, t):
        np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=1e-5 * np.abs(b.numpy()).max())


def test_p1_plan_is_k1s_lane_mapping():
    """P1 launches with K1's threads, lanes a row and column groups, the
    deepest ring that fits by the .cu file's shared-memory expression
    (evaluated here), and refuses shapes its ring cannot take."""
    import re

    from sgdnet_tpu_torch.solver import epoch_kernel as ek

    src = open(os.path.join(ROOT, "sgdnet_tpu_torch", "csrc", "probes.cu")).read()
    expr = " ".join(re.search(r"/\* SMEM-FORMULA \*/(.*?)/\* END-FORMULA \*/", src, re.S).group(1).split())
    rng = np.random.default_rng(0)
    for _ in range(200):
        v = dict(B=2 * int(rng.integers(1, 600)), P=4 * int(rng.integers(1, 900)), stages=int(rng.choice([2, 3])),
                 groups=int(rng.integers(1, 40)))
        assert eval(expr, {}, dict(v)) == pk.epoch_probe_smem_floats(v["B"], v["P"], v["stages"], v["groups"])
    assert pk.epoch_probe_plan(128, 32) == (256, 8, 2, 3)  # the probe's shape: 8 warps, 8 lanes a row
    assert pk.epoch_probe_plan(32, 32) == (32, 1, 1, 3)  # one warp
    for P, B in ((128, 32), (64, 16), (8, 1024), (512, 32)):
        pl = ek.plan(P, 1, B)
        assert pk.epoch_probe_plan(P, B)[:3] == (pl.threads, pl.lanes, pl.groups)
    for P, B in ((130, 32), (128, 33), (2000, 32)):  # P % 4, an odd batch, no ring fits
        with pytest.raises(ValueError):
            pk.epoch_probe_plan(P, B)


# ---------------------------------------------------------------------------
# P2 and P3: verbatim copies of the TPU bodies
# ---------------------------------------------------------------------------


def _p2_pallas(head, start, B, bt):
    """tools/bench_pallas_dma.py `mk_reduce` (:51-79) for one block, interpreted."""
    D = head.shape[1]

    # verbatim: tools/bench_pallas_dma.py:38-49
    def reduce_kernel(s_ref, x_ref, o_ref, acc_ref):
        i = pl.program_id(0)

        @pl.when(i == 0)
        def _():
            acc_ref[:] = jnp.zeros_like(acc_ref)

        acc_ref[:] += jnp.sum(x_ref[:].astype(jnp.float32), axis=0, keepdims=True)

        @pl.when(i == pl.num_programs(0) - 1)
        def _():
            o_ref[:] = acc_ref[:]

    start_blocks = jnp.asarray([start // bt], jnp.int32)
    out = pl.pallas_call(
        reduce_kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(B // bt,),
            in_specs=[pl.BlockSpec((bt, D), lambda i, s: (s[0] + i, 0))],
            out_specs=pl.BlockSpec((1, D), lambda i, s: (0, 0)),
            scratch_shapes=[pltpu.VMEM((1, D), jnp.float32)],
        ),
        out_shape=jax.ShapeDtypeStruct((1, D), jnp.float32),
        interpret=True,
    )(start_blocks, head)
    return np.asarray(out)[0]


def _p3_pallas(head, start, B, n_buf, chunk_rows):
    """tools/bench_dma_streams.py `mk` (:51-113) for one block, interpreted."""
    D = head.shape[1]
    n_chunks = B // chunk_rows

    # verbatim: tools/bench_dma_streams.py:54-88
    def kernel(s_ref, hbm_ref, o_ref):
        start_row = s_ref[0]

        def body(scratch, sems):
            def get_dma(slot, idx):
                row0 = pl.multiple_of(start_row + idx * chunk_rows, chunk_rows)
                return pltpu.make_async_copy(
                    hbm_ref.at[pl.ds(row0, chunk_rows), :],
                    scratch.at[slot],
                    sems.at[slot],
                )

            for s in range(n_buf):
                if s < n_chunks:
                    get_dma(s, s).start()

            def loop(i, acc):
                slot = jax.lax.rem(i, n_buf)
                get_dma(slot, i).wait()
                acc = acc + jnp.sum(scratch[slot].astype(jnp.float32), axis=0, keepdims=True)

                @pl.when(i + n_buf < n_chunks)
                def _():
                    get_dma(slot, i + n_buf).start()

                return acc

            acc = jax.lax.fori_loop(0, n_chunks, loop, jnp.zeros((1, D), jnp.float32))
            o_ref[:] = acc

        pl.run_scoped(
            body,
            pltpu.VMEM((n_buf, chunk_rows, D), jnp.bfloat16),
            pltpu.SemaphoreType.DMA((n_buf,)),
        )

    out = pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(1,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        ),
        out_shape=jax.ShapeDtypeStruct((1, D), jnp.float32),
        interpret=True,
    )(jnp.asarray([start], jnp.int32), head)
    return np.asarray(out)[0]


N_PAD, D, B = 256, 256, 64


@pytest.fixture(scope="module")
def head():
    rng = np.random.default_rng(5)
    return jnp.asarray(rng.normal(size=(N_PAD, D)), jnp.bfloat16)


def _as_torch(head):
    return torch.tensor(np.asarray(head.astype(jnp.float32))).to(torch.bfloat16)


def _check_colsum(out, ref, head_t, start):
    """|out - ref| <= 1e-6 * sum |x| per column (f32 sums in another order)."""
    absum = head_t[start : start + B].float().abs().sum(0).numpy()
    np.testing.assert_array_less(np.abs(np.asarray(out) - np.asarray(ref)), 1e-6 * absum + 1e-30)


@pytest.mark.parametrize("bt", [16, 32, 64])
def test_p2_twin_matches_pallas(head, bt):
    ht = _as_torch(head)
    for start in (0, B, N_PAD - B):
        ref = _p2_pallas(head, start, B, bt)
        before = pk.block_colsum.launches
        out = pk.block_colsum(ht, start, B, bt)
        assert pk.block_colsum.launches == before and out.dtype == torch.float32 and out.shape == (D,)
        _check_colsum(out.numpy(), ref, ht, start)


@pytest.mark.parametrize("n_buf,chunk_rows", [(2, 16), (4, 8), (3, 16), (8, 8), (2, 64)])
def test_p3_twin_matches_pallas(head, n_buf, chunk_rows):
    ht = _as_torch(head)
    for start in (0, 3 * B):
        ref = _p3_pallas(head, start, B, n_buf, chunk_rows)
        before = pk.block_colsum_pipelined.launches
        out = pk.block_colsum_pipelined(ht, start, B, n_buf, chunk_rows)
        assert pk.block_colsum_pipelined.launches == before and out.shape == (D,)
        _check_colsum(out.numpy(), ref, ht, start)


# ---------------------------------------------------------------------------
# the CUDA kernels' summation orders, replayed
# ---------------------------------------------------------------------------


def _replay_p2(h, start, B, bt, ct=256):
    """csrc/probes.cu colsum_tile + sum_partials: CTA (strip, tile), one
    thread per column pair summing its tile's rows in order, then the tiles'
    partial rows added in `sum_partials`' fixed order (8 groups of every
    eighth part, each in order, then the groups in order)."""
    D = h.shape[1]
    part = np.zeros((B // bt, D), np.float32)
    for tile in range(B // bt):
        for strip in range(-(-(D // 2) // ct)):
            for t in range(ct):
                j2 = strip * ct + t
                if 2 * j2 >= D:
                    continue
                acc = np.zeros(2, np.float32)
                for r in range(bt):
                    acc += h[start + tile * bt + r, 2 * j2 : 2 * j2 + 2]
                part[tile, 2 * j2 : 2 * j2 + 2] = acc
    groups = np.zeros((8, D), np.float32)  # part t goes to group t % 8, in order
    for tile in range(B // bt):
        groups[tile % 8] += part[tile]
    out = groups[0].copy()
    for grp in groups[1:]:  # the 8 group sums in group order
        out += grp
    return out


def _replay_p3(h, start, B, n_buf, chunk_rows, plan):
    """csrc/probes.cu colsum_pipelined + colsum_pipelined_pieces at `plan`:
    CTA g streams its stages (`pipeline_deal`) through its ring.  The
    producer lands stage k in slot k % n_buf once its wait on the slot's
    empty barrier passes (parity (k // n_buf & 1) ^ 1), the consumers' wait
    on the full barrier (parity k // n_buf & 1) must pass on exactly that
    stage, and the slot is refilled only after they release it.  Thread
    (group, v) adds rows group, group + groups, ... of each stage to its 8
    columns (columns past D land as zeros); where a piece ends the groups
    meet in order into its partial row, and the second pass adds a strip's
    rows in CTA order."""
    D = h.shape[1]
    W, groups = plan.width, plan.groups
    hp = np.zeros((h.shape[0], plan.strips * W), np.float32)
    hp[:, :D] = h
    part = np.full((plan.pieces, D), np.nan, np.float32)
    for g in range(plan.grid):
        deal = pk.pipeline_deal(plan, g)
        full, empty, ring = [0] * n_buf, [0] * n_buf, [None] * n_buf  # phase completions, slot contents
        kp = 0
        acc = np.zeros((groups, W), np.float32)
        for k, (s, c, row, ends) in enumerate(deal):
            while kp < len(deal) and empty[kp % n_buf] % 2 != ((kp // n_buf) & 1) ^ 1:
                assert ring[kp % n_buf] is None  # never over a stage not yet read
                ring[kp % n_buf] = kp
                full[kp % n_buf] += 1
                kp += 1
            slot = k % n_buf
            assert full[slot] % 2 != (k // n_buf) & 1  # the consumers' wait passes ...
            assert ring[slot] == k and full[slot] == k // n_buf + 1  # ... on this stage
            stage = hp[start + c * chunk_rows : start + (c + 1) * chunk_rows, s * W : (s + 1) * W]
            for q in range(-(-chunk_rows // groups)):
                rows = np.arange(groups) + q * groups
                ok = rows < chunk_rows
                acc[ok] += stage[rows[ok]]
            ring[slot] = None
            empty[slot] += 1
            if ends:
                total = acc[0].copy()
                for q in range(1, groups):
                    total += acc[q]
                cols = min(W, D - s * W)
                part[row, s * W : s * W + cols] = total[:cols]
                acc[:] = 0
        assert kp == len(deal)
    out = np.zeros(D, np.float32)
    left = (plan.strips - plan.rounds * plan.grid) * plan.chunks
    for s in range(plan.strips):
        cols = np.s_[s * W : min((s + 1) * W, D)]
        u = (s - plan.rounds * plan.grid) * plan.chunks  # a leftover strip's first stage
        n = 1 if u < 0 else pk.pipeline_cta_of(u + plan.chunks - 1, left, plan.grid) - pk.pipeline_cta_of(
            u, left, plan.grid) + 1
        acc = part[0, cols].copy()
        for p in range(1, n):
            acc += part[p, cols]
        out[cols] = acc
    assert np.isfinite(out).all()  # every column's pieces were written
    return out


@pytest.mark.parametrize("n_buf,chunk_rows,d,sms", [(2, 16, 256, 3), (4, 8, 256, 5), (8, 8, 256, 2),
                                                    (2, 16, 600, 5), (4, 32, 600, 2), (8, 64, 600, 2),
                                                    (2, 16, 1000, 3), (4, 16, 1000, 2)])
def test_kernel_orders_match_twin(head, n_buf, chunk_rows, d, sms):
    """P3's order (the dealt stages, the ring's slots and parities, the row
    groups, the pieces) and P2's give the twin's sums within 1e-6 x sum |x|
    a column, at the first and the last block.  At D 600 and 1000 the last
    strip is partial; grids of 2-5 CTAs give leftover strips alone (D 256,
    600 at 5 CTAs), rounds and leftovers (600 at 2, 1000 at 3) and rounds
    alone (1000 at 2)."""
    if d == D:
        ht = _as_torch(head)
    else:
        ht = torch.tensor(np.random.default_rng(d + n_buf).normal(size=(N_PAD, d)), dtype=torch.float32)
        ht = ht.to(torch.bfloat16)
    h = ht.float().numpy()
    plan = pk.pipeline_plan(n_buf, chunk_rows, d, B, sms, 1)
    assert plan.grid == min(sms, plan.stages) and (d % plan.width == 0) == (d == D)
    for start in (0, N_PAD - B):
        ref = pk.block_colsum_reference(ht, start, B, chunk_rows).numpy()
        _check_colsum(_replay_p3(h, start, B, n_buf, chunk_rows, plan), ref, ht, start)
        if d == D:
            _check_colsum(_replay_p2(h, start, B, chunk_rows), ref, ht, start)


def _cu_expression(begin, end):
    src = open(os.path.join(ROOT, "sgdnet_tpu_torch", "csrc", "probes.cu")).read()
    return " ".join(re.search(re.escape(begin) + r"(.*?)" + re.escape(end), src, re.S).group(1).split())


def test_pipeline_plan_mirrors_the_cu():
    """The .cu's shared-memory expression and the CTA its runs give a
    leftover stage are the Python plan's (evaluated here, C's / on
    non-negative ints as //)."""
    smem = _cu_expression("/* P3-SMEM */", "/* END-P3-SMEM */")
    cta_of = _cu_expression("/* P3-CTA-OF */", "/* END-P3-CTA-OF */").replace("/", "//")
    rng = np.random.default_rng(0)
    for _ in range(200):
        v = dict(n_buf=int(rng.choice([2, 4, 8])), rows=int(rng.integers(1, 600)), W=16 * int(rng.integers(1, 17)),
                 groups=int(rng.integers(1, 33)))
        assert eval(smem, {}, dict(v)) == pk.pipeline_smem_bytes(**v)
        RC = int(rng.integers(1, 20000))
        G, u = int(rng.integers(1, min(RC, 1000) + 1)), int(rng.integers(0, RC))
        g = eval(cta_of, {}, dict(u=u, RC=RC, G=G))
        assert g == pk.pipeline_cta_of(u, RC, G) and RC * g // G <= u < RC * (g + 1) // G


#: P3's strip width at the TPU probe's configs, D 16384: the widest multiple
#: of 16 columns whose ring fits one CTA (a 1024-row ring 96 columns, 192
#: bytes a row; a 2048-row ring 48 columns)
PLAN_WIDTHS = {(2, 512): 96, (4, 256): 96, (4, 512): 48, (8, 256): 48, (8, 128): 96}


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n_buf,chunk_rows", list(bench_dma_streams.CONFIGS))
def test_pipeline_plan(n_buf, chunk_rows, sms):
    """At the probe's shape each TPU ring fits one CTA at the widest width,
    one CTA on every SM (the SM count is the caller's: 132 on an H100 SXM,
    114 on a PCIe card), every stage dealt once, within one of each other,
    whole strips in lockstep rounds first, and the pieces as the .cu
    launcher checks them."""
    Dp, Bp = 16384, 8192
    plan = pk.pipeline_plan(n_buf, chunk_rows, Dp, Bp, sms)
    W = plan.width
    assert W == PLAN_WIDTHS[(n_buf, chunk_rows)] and W % 16 == 0
    assert plan.smem == pk.pipeline_smem_bytes(n_buf, chunk_rows, W, plan.groups) <= pk.SMEM_LIMIT
    assert pk.pipeline_smem_bytes(n_buf, chunk_rows, W + 16, 256 // ((W + 16) // 8)) > pk.SMEM_LIMIT
    assert plan.groups == 256 // (W // 8) and plan.box_rows * plan.boxes == chunk_rows and plan.box_rows <= 256
    assert plan.strips == -(-Dp // W) and plan.chunks == Bp // chunk_rows
    assert plan.ctas_per_sm == 1 and plan.grid == sms and plan.stages == plan.strips * plan.chunks
    deals = [pk.pipeline_deal(plan, g) for g in range(sms)]
    counts = [len(d) for d in deals]
    assert max(counts) - min(counts) <= 1 and tuple(plan.stages_per_cta) == (min(counts), max(counts))
    stages = sorted((s, c) for d in deals for s, c, _, _ in d)
    assert stages == [(s, c) for s in range(plan.strips) for c in range(plan.chunks)]  # each stage once
    # in a round every CTA streams a whole strip, the card one row band at a time
    assert plan.rounds == plan.strips // sms >= 1
    for i in range(plan.rounds * plan.chunks):
        assert {d[i][1] for d in deals} == {i % plan.chunks}
        assert sorted(d[i][0] for d in deals) == list(range(i // plan.chunks * sms, (i // plan.chunks + 1) * sms))
    # a round's strip is one piece (row 0); a leftover strip one piece for each CTA it is dealt to, in CTA order
    dealt = {}
    for g, d in enumerate(deals):
        for s, c, row, ends in d:
            dealt.setdefault(s, []).append((g, row))
            if s < plan.rounds * sms:
                assert (row, ends) == (0, c == plan.chunks - 1)
    ctas = {s: sorted({g for g, _ in v}) for s, v in dealt.items()}
    assert all(row == ctas[s].index(g) for s, v in dealt.items() for g, row in v)
    assert plan.pieces == max(len(v) for v in ctas.values())
    assert pk.pipeline_plan(n_buf, chunk_rows, Dp, Bp, sms, 2).grid == 2 * sms  # a second CTA an SM, if it held


@pytest.mark.parametrize("n_buf,chunk_rows,d,batch", [(3, 64, 256, 512), (2, 64, 100, 512), (2, 24, 256, 512),
                                                      (2, 6, 256, 48), (2, 520, 256, 1040)])
def test_pipeline_plan_refuses(n_buf, chunk_rows, d, batch):
    """A ring depth the launcher is not built for, D off 16 bytes, chunks
    that do not tile B, boxes off 128-byte boundaries, a chunk that splits
    into no equal boxes of at most 256 rows."""
    with pytest.raises(ValueError):
        pk.pipeline_plan(n_buf, chunk_rows, d, batch, 132)


def test_pipeline_plan_has_no_width_for_a_deep_tall_ring():
    assert pk.pipeline_plan(8, 2048, 16384, 8192, 132) is None  # even 16 columns do not fit
    assert pk.pipeline_plan(2, 16, 256, 64, 132).width == 256  # a strip no wider than D


def test_wrappers_reject_what_they_do_not_take():
    ht = torch.zeros((N_PAD, D), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        pk._check_block(ht, N_PAD - B + 1, B, 16, "block_colsum")  # past the end
    with pytest.raises(ValueError):
        pk._check_block(ht, 0, B, 24, "block_colsum")  # tiles do not divide B
    with pytest.raises(ValueError):
        pk._check_block(ht.float(), 0, B, 16, "block_colsum")


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

TINY = {
    bench_epoch_kernel: ["--n", "256", "--p", "16", "--batch", "32", "--epochs", "3", "--twin-epochs", "2",
                         "--reps", "2"],
    bench_head_dma: ["--n-pad", "512", "--d", "64", "--batch", "128", "--bts", "32,64", "--steps", "3",
                     "--reps", "1"],
    bench_dma_streams: ["--n-pad", "512", "--d", "64", "--batch", "128", "--configs", "2x32,4x16,8x4096",
                        "--steps", "3", "--reps", "1"],
}


@pytest.mark.parametrize("tool", list(TINY), ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_entry_point_runs_on_the_cpu(tool, capsys):
    assert tool.main(["--device", "cpu", "--seed", "3", *TINY[tool]]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu"
    if tool is bench_epoch_kernel:
        for row in (out["kernel"], out["twin"]):
            assert row["ms_per_epoch"] > 0 and np.isfinite(row["checksum"])
        assert out["steps_per_epoch"] == 8 and out["kernel"]["epochs"] == 3 and out["twin"]["epochs"] == 2
    elif tool is bench_head_dma:
        assert [r["bt"] for r in out["p2"]] == [32, 64] and all(r["gb_per_s"] > 0 for r in out["p2"])
        assert out["k2"]["ms_per_step"] > 0
    else:
        assert out["full_head_sum"]["gb_per_s"] > 0
        ran, skipped = out["p3"][:2], out["p3"][2]
        assert [r["strip_width"] for r in ran] == [64, 64] and all(r["ms_per_step"] > 0 for r in ran)
        assert [(r["strips"], r["chunks"], r["boxes"]) for r in ran] == [(1, 4, 1), (1, 8, 1)]
        assert all(r["smem_bytes"] <= pk.SMEM_LIMIT for r in ran)
        # the grid is the card's: none on the CPU, where the twin runs
        assert all(r[k] is None for r in ran for k in ("sms", "ctas_per_sm", "grid", "rounds", "stages_per_cta",
                                                          "pieces"))
        assert skipped["n_buf"] == 8 and "skipped" in skipped


@pytest.mark.parametrize("tool", list(TINY), ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_entry_point_needs_a_card(tool, monkeypatch):
    """--device defaults to the card: without one the probe raises, it never
    measures the CPU in the card's place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main(TINY[tool])
