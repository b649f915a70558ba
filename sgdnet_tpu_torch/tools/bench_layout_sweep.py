"""The layout sweep on the card: the bench's epoch at eight head widths,
head types, refresh periods and batches, on data synthesized on the
device (the counterpart of tools/bench_layout_sweep.py).

    python -m sgdnet_tpu_torch.tools.bench_layout_sweep [--device cuda|cpu] [--seed 42]

For each head width D the tail's true entry count comes from the bench
generator's column counts on the host (`tail_entries_for`, the JAX tool's
numpy), so a layout has the shapes of the real one: a random (n_pad, D)
int8 or bf16 head (int8 scales of 1), per-block COO entries with E =
ceil(tail / blocks) rounded up to 128 (rows ascending within a block, as
the BlockCOO takes them), a zero padded tail of width L, drawn from one
torch.Generator on the device.  The values are random: the epoch's time
depends on the shapes, not on them.  Each row is the bench's epoch
(binomial, block sampling, gamma 3e-3, l1 1e-5, w_total n) with the head
step plain or through K2 ("pallas" in the row's name) and K3 / K4 on the
tail: a warm-up run, then the best of 3 runs of 5 epochs.  Prints
a line a row on stderr and one JSON line of nnz/s and ms an epoch by
row, ranked.  `--device` defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

#: the JAX tool's eight rows (tools/bench_layout_sweep.py:136-143)
ROWS = (
    ("bf16 D=16384 (r1 winner)", dict(D=16384, B=8192, head_dtype="bfloat16")),
    ("int8 D=16384", dict(D=16384, B=8192, head_dtype="int8")),
    ("int8 D=24576", dict(D=24576, B=8192, head_dtype="int8")),
    ("int8 D=32768", dict(D=32768, B=8192, head_dtype="int8")),
    ("int8 D=32768 r8", dict(D=32768, B=8192, head_dtype="int8", refresh=8)),
    ("int8 D=32768 B=16384", dict(D=32768, B=16384, head_dtype="int8")),
    ("bf16 D=16384 pallas", dict(D=16384, B=8192, head_dtype="bfloat16", use_pallas=True)),
    ("bf16 D=32768", dict(D=32768, B=8192, head_dtype="bfloat16")),
)


def tail_entries_for(D: int, n=100_000, p=47_000, nnz_row=76, seed=0):
    """True tail nnz for head width D under the bench generator's Zipf."""
    rng = np.random.default_rng(seed)
    weights = (np.arange(p) + 10.0) ** -1.15
    cdf = np.cumsum(weights) / weights.sum()
    cols = np.searchsorted(cdf, rng.random((n, nnz_row))).astype(np.int32).clip(0, p - 1)
    col_nnz = np.bincount(cols.reshape(-1), minlength=p)
    order = np.argsort(-col_nnz)
    cum = np.cumsum(col_nnz[order])
    return int(cum[-1] - cum[min(D, p) - 1])


def synth_shapes(D, B, n=100_000, p=47_000, nnz_row=76):
    """(n_pad, blocks, true tail entries, E a block, padded tail width L),
    the JAX tool's arithmetic (tools/bench_layout_sweep.py:41-64)."""
    n_pad = ((n + B - 1) // B) * B
    blocks = n_pad // B
    e_total = tail_entries_for(D, n, p, nnz_row)
    E = ((e_total // blocks + 127) // 128) * 128
    L = ((max(e_total // n, 1) + 7) // 8) * 8
    return n_pad, blocks, e_total, E, L


def build_synth(D, B, head_dtype, n=100_000, p=47_000, nnz_row=76, device=None, seed=42):
    """The synthesized layout, y and weights on `device`: (x, y, weights, n_pad)."""
    from sgdnet_tpu_torch.core.sparse import BlockCOO, HybridCSR, PaddedCSR, as_head_dtype
    from sgdnet_tpu_torch.tools.bench import log
    from sgdnet_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    hd = as_head_dtype(head_dtype)
    n_pad, blocks, e_total, E, L = synth_shapes(D, B, n, p, nnz_row)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if hd == torch.int8:
        head = torch.randint(-127, 128, (n_pad, D), generator=gen, dtype=torch.int8, device=dev)
    else:
        head = torch.randn((n_pad, D), generator=gen, dtype=hd, device=dev)
    rows = torch.sort(torch.randint(0, B, (blocks, E), generator=gen, dtype=torch.int32, device=dev), dim=1).values
    cols = torch.randint(D, p, (blocks, E), generator=gen, dtype=torch.int32, device=dev)
    vals = torch.randn((blocks, E), generator=gen, device=dev)
    y = (torch.rand((n_pad, 1), generator=gen, device=dev) < 0.5).to(torch.float32)
    # the BlockCOO's views are packed on the host; the padded tail (zeros)
    # feeds only the refresh's matvec_T
    blk = BlockCOO.from_arrays(rows.cpu().numpy(), cols.cpu().numpy(), vals.cpu().numpy(), B, p,
                               counts=np.full(blocks, E), device=dev)
    tail = PaddedCSR(torch.zeros((n_pad, L), dtype=torch.int32, device=dev),
                     torch.zeros((n_pad, L), device=dev), torch.zeros((n_pad,), dtype=torch.int32, device=dev),
                     n_pad, p)
    scale = torch.ones((D,), device=dev) if hd == torch.int8 else None
    x = HybridCSR(head, tail, n_pad, p, blk_tail=blk, head_scale=scale)
    weights = (torch.arange(n_pad, device=dev) < n).to(torch.float32)
    log(f"synth layout: D={D} B={B} dtype={hd} E/block={E} (true tail nnz {e_total})")
    return x, y, weights, n_pad


def bench_config(D, B, head_dtype, use_pallas=False, refresh=4, epochs=5, n=100_000, p=47_000, nnz_row=76,
                 device=None, seed=42):
    """One row: a warm-up run and the best of 3 runs of `epochs` epochs on
    its synthesized layout; nnz/s (n x nnz_row x epochs over the run) and
    ms an epoch, with K2 / K3 / K4 launches an epoch over the four runs."""
    from sgdnet_tpu_torch.solver import saga
    from sgdnet_tpu_torch.tools import bench

    x, y, weights, n_pad = build_synth(D, B, head_dtype, n, p, nnz_row, device, seed)
    dev = y.device
    config = bench.solver_config(B, "block", g_sum_refresh_every=refresh, use_pallas=use_pallas)
    n_orders = saga.order_count(config, n_pad)

    def run(r, state):
        order_fn = saga.default_order_fn(seed + r, n_orders)
        with saga._fp32_matmul():
            return bench.run_epochs(x, y, weights, state, [order_fn(0, 0, i) for i in range(epochs)], config, n,
                                    l1=1e-5)

    before = bench._launch_counts()
    best, _ = bench.best_of_runs(run, saga.init_state(n_pad, p, 1, torch.float32, dev), 3, dev)
    k2, k3, k4 = ((a - b) / (4 * epochs) for a, b in zip(bench._launch_counts(), before))
    rate = n * nnz_row * epochs / best
    bench.log(f"  {epochs} epochs best {best:.4f}s -> {rate:.4e} nnz/s ({best / epochs * 1e3:.3f} ms/epoch); "
              f"launches an epoch K2 {k2:g} K3 {k3:g} K4 {k4:g}")
    return {"nnz_per_s": rate, "ms_per_epoch": best / epochs * 1e3, "k2_per_epoch": k2, "k3_per_epoch": k3,
            "k4_per_epoch": k4}


def sweep(device=None, seed=42) -> dict:
    """The eight rows, each measured in turn with its layout freed after
    it; a row that fails raises."""
    from sgdnet_tpu_torch.tools.bench import log
    from sgdnet_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    results = {}
    for name, kw in ROWS:
        log(f"[{name}]")
        results[name] = bench_config(**kw, device=dev, seed=seed)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card; raises without one)")
    ap.add_argument("--seed", type=int, default=42, help="seed of the synthesized layouts and the block orders")
    a = ap.parse_args(argv)
    from sgdnet_tpu_torch.tools.bench import log
    from sgdnet_tpu_torch.utils.device import describe, resolve_device

    dev = resolve_device(a.device)
    results = sweep(dev, a.seed)
    log("== sweep results ==")
    ranked = sorted(results.items(), key=lambda kv: -kv[1]["nnz_per_s"])
    for name, r in ranked:
        log(f"{name}: {r['nnz_per_s']:.4e} nnz/s, {r['ms_per_epoch']:.3f} ms an epoch")
    print(json.dumps({"device": describe(dev), "rows": dict(ranked)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
