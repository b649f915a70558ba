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


def _replay_p3(h, start, B, n_buf, chunk_rows, W, ct=256):
    """csrc/probes.cu colsum_pipelined: CTA per W-column strip; chunk i lands
    in ring slot i % n_buf and is refilled with chunk i + n_buf only after
    it is read; thread (pair, group) sums rows group, group + groups, ...
    of each chunk; the groups meet in order."""
    D = h.shape[1]
    out = np.zeros(D, np.float32)
    pairs = W // 2
    groups = ct // pairs
    n_chunks = B // chunk_rows
    for col0 in range(0, D, W):
        ring = [None] * n_buf
        for s in range(min(n_buf, n_chunks)):
            ring[s] = s
        acc = np.zeros((groups, pairs, 2), np.float32)
        for i in range(n_chunks):
            slot = i % n_buf
            assert ring[slot] == i  # the chunk waited for is the one in its slot
            rows = h[start + i * chunk_rows : start + (i + 1) * chunk_rows, col0 : col0 + W]
            for g in range(groups):
                for r in range(g, chunk_rows, groups):
                    acc[g] += rows[r].reshape(pairs, 2)
            if i + n_buf < n_chunks:
                ring[slot] = i + n_buf
        s = np.zeros((pairs, 2), np.float32)
        for g in range(groups):
            s += acc[g]
        out[col0 : col0 + W] = s.reshape(-1)
    return out


@pytest.mark.parametrize("n_buf,chunk_rows", [(2, 16), (4, 8), (8, 8)])
def test_kernel_orders_match_twin(head, n_buf, chunk_rows):
    ht = _as_torch(head)
    h = ht.float().numpy()
    start = B
    ref = pk.block_colsum_reference(ht, start, B, chunk_rows).numpy()
    W = pk.pipeline_strip_width(n_buf, chunk_rows, D)
    _check_colsum(_replay_p3(h, start, B, n_buf, chunk_rows, W), ref, ht, start)
    _check_colsum(_replay_p2(h, start, B, chunk_rows), ref, ht, start)


def test_pipeline_strip_width():
    # the TPU probe's configs at D = 16384: every one fits at some width
    widths = {c: pk.pipeline_strip_width(*c, 16384) for c in bench_dma_streams.CONFIGS}
    assert widths == {(2, 512): 64, (4, 256): 64, (4, 512): 32, (8, 256): 32, (8, 128): 64}
    for (n_buf, chunk_rows), w in widths.items():
        assert n_buf * chunk_rows * w * 2 + 256 * 8 <= pk.SMEM_LIMIT < n_buf * chunk_rows * 2 * w * 2 + 256 * 8
    assert pk.pipeline_strip_width(2, 16, 256) == 256  # a strip no wider than D
    assert pk.pipeline_strip_width(8, 2048, 16384) is None  # even 8 columns do not fit
    assert pk.pipeline_strip_width(2, 16, 100) is None  # no power-of-two width >= 8 divides D


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
        assert skipped["n_buf"] == 8 and "skipped" in skipped


@pytest.mark.parametrize("tool", list(TINY), ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_entry_point_needs_a_card(tool, monkeypatch):
    """--device defaults to the card: without one the probe raises, it never
    measures the CPU in the card's place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main(TINY[tool])
