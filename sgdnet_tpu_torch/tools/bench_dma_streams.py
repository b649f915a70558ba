"""Time the head stream's ceiling and P3's pipelined column sum at each ring
depth and chunk height (the counterpart of tools/bench_dma_streams.py).

    python -m sgdnet_tpu_torch.tools.bench_dma_streams [--device cuda|cpu] [--seed 0]
        [--n-pad 106496] [--d 16384] [--batch 8192]
        [--configs 2x512,4x256,4x512,8x256,8x128] [--steps 26] [--reps 3]

The ceiling is one `torch.sum(head, dtype=torch.float32)` over the whole
seeded bf16 head (the rate the layout planner takes as STREAM_BYTES_PER_S),
best of `reps` after a warm-up.  P3 runs each (n_buf, chunk_rows) config as
tools/bench_head_dma.py runs P2; a config whose n_buf stages do not fit one
CTA's shared memory at any strip width is skipped and listed, as the TPU
probe skips configs above its VMEM limit.  Prints one JSON line, with each
config's plan (`probe_kernels.pipeline_plan`): strip width, strips, chunks a
strip, TMA boxes a chunk and shared memory a CTA; on the card also the SMs,
the CTAs an SM holds, the grid, the rounds of whole strips, the stages a
CTA (min, max) and the rows of partial sums (None on the CPU, where the
twin runs).  `--device` defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from sgdnet_tpu_torch.tools.bench_head_dma import best_step_seconds, seeded_head
from sgdnet_tpu_torch.tools.probe_kernels import block_colsum_pipelined, launch_plan, pipeline_plan
from sgdnet_tpu_torch.utils.device import describe, resolve_device, sync

CONFIGS = ((2, 512), (4, 256), (4, 512), (8, 256), (8, 128))


def full_head_sum_seconds(head: torch.Tensor, reps: int) -> float:
    """Best seconds of one f32 sum over the whole head, after a warm-up."""
    best = float("inf")
    for r in range(reps + 1):
        sync(head.device)
        t0 = time.perf_counter()
        float(torch.sum(head, dtype=torch.float32))
        if r > 0:
            best = min(best, time.perf_counter() - t0)
    return best


def plan_keys(plan, on_card: bool) -> dict:
    """A P3 plan as the keys of its config's row (the card's own keys None
    off the card)."""
    card = {"sms": plan.sms, "ctas_per_sm": plan.ctas_per_sm, "grid": plan.grid, "rounds": plan.rounds,
            "stages_per_cta": list(plan.stages_per_cta), "pieces": plan.pieces}
    return {"strip_width": plan.width, "strips": plan.strips, "chunks": plan.chunks, "boxes": plan.boxes,
            "smem_bytes": plan.smem, **(card if on_card else dict.fromkeys(card))}


def run(device=None, seed: int = 0, n_pad: int = 106496, d: int = 16384, batch: int = 8192, configs=CONFIGS,
        steps: int = 26, reps: int = 3) -> dict:
    dev = resolve_device(device)
    if n_pad % batch != 0:
        raise ValueError(f"n_pad={n_pad} must be a multiple of batch={batch}")
    head = seeded_head(n_pad, d, seed, dev)
    rng = np.random.default_rng(seed)
    sec = full_head_sum_seconds(head, reps)
    ceiling = {"ms": sec * 1e3, "gb_per_s": n_pad * d * 2 / sec / 1e9}
    rows = []
    for n_buf, chunk_rows in configs:
        row = {"n_buf": n_buf, "chunk_rows": chunk_rows}
        on_card = dev.type == "cuda"
        plan = None
        if batch % chunk_rows == 0:
            plan = launch_plan(dev, n_buf, chunk_rows, d, batch) if on_card else pipeline_plan(
                n_buf, chunk_rows, d, batch, 1)
        if plan is None:
            rows.append({**row, "skipped": "no strip width fits one CTA's shared memory, or chunks do not tile B"})
            continue
        sec = best_step_seconds(lambda s: block_colsum_pipelined(head, s, batch, n_buf, chunk_rows),
                                n_pad // batch, batch, steps, reps, rng, dev)
        rows.append({**row, **plan_keys(plan, on_card), "ms_per_step": sec * 1e3,
                     "gb_per_s": batch * d * 2 / sec / 1e9})
    return {"probe": "P3 block_colsum_pipelined", "device": describe(dev), "n_pad": n_pad, "d": d, "batch": batch,
            "steps": steps, "full_head_sum": ceiling, "p3": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card; raises without one)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-pad", type=int, default=106496)
    ap.add_argument("--d", type=int, default=16384)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--configs", default=",".join(f"{b}x{c}" for b, c in CONFIGS),
                    help="n_buf x chunk_rows pairs, comma-separated")
    ap.add_argument("--steps", type=int, default=26)
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    configs = tuple(tuple(int(v) for v in c.split("x")) for c in a.configs.split(","))
    print(json.dumps(run(a.device, a.seed, a.n_pad, a.d, a.batch, configs, a.steps, a.reps)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
