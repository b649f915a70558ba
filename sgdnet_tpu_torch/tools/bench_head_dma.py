"""Time the head stream: P2's tiled column sum at each tile height, and K2,
the fused head step, over the same block starts (the counterpart of
tools/bench_pallas_dma.py).

    python -m sgdnet_tpu_torch.tools.bench_head_dma [--device cuda|cpu] [--seed 0]
        [--n-pad 106496] [--d 16384] [--batch 8192] [--bts 256,512,1024] [--steps 26] [--reps 3]

The head is a seeded (n_pad, d) bf16 normal matrix on the device.  A run is
`steps` block reads at starts drawn from `--seed` (a block index in
[0, n_pad / batch) times batch), ended by a synchronise; after a warm-up
run, the best of `reps` runs gives ms a step and GB/s (batch * d * 2 bytes
a step).  K2 runs the binomial step with k = 1 at the same starts, its w
moved by 1e-9 * corr after each step as the TPU probe does; it has one
tile height.  Prints one JSON line.  `--device` defaults to the card and
raises without one.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from sgdnet_tpu_torch.solver.head_kernel import fused_head_step_at
from sgdnet_tpu_torch.tools.probe_kernels import block_colsum
from sgdnet_tpu_torch.utils.device import describe, resolve_device, sync


def seeded_head(n_pad: int, d: int, seed: int, dev: torch.device) -> torch.Tensor:
    """The probes' (n_pad, d) bf16 normal head, made on the device."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randn((n_pad, d), generator=gen, dtype=torch.bfloat16, device=dev)


def best_step_seconds(step, n_blocks: int, batch: int, steps: int, reps: int, rng, dev: torch.device) -> float:
    """Seconds a step of the best of `reps` runs of `steps` calls
    step(start), after one warm-up run; each run draws its block starts."""
    best = float("inf")
    for r in range(reps + 1):
        starts = (rng.integers(0, n_blocks, steps) * batch).tolist()
        sync(dev)
        t0 = time.perf_counter()
        for s in starts:
            step(s)
        sync(dev)
        if r > 0:
            best = min(best, time.perf_counter() - t0)
    return best / steps


def run(device=None, seed: int = 0, n_pad: int = 106496, d: int = 16384, batch: int = 8192,
        bts=(256, 512, 1024), steps: int = 26, reps: int = 3) -> dict:
    dev = resolve_device(device)
    if n_pad % batch != 0:
        raise ValueError(f"n_pad={n_pad} must be a multiple of batch={batch}")
    head = seeded_head(n_pad, d, seed, dev)
    rng = np.random.default_rng(seed)
    n_blocks, step_bytes = n_pad // batch, batch * d * 2
    rows = []
    for bt in bts:
        sec = best_step_seconds(lambda s: block_colsum(head, s, batch, bt), n_blocks, batch, steps, reps, rng, dev)
        rows.append({"bt": bt, "ms_per_step": sec * 1e3, "gb_per_s": step_bytes / sec / 1e9})

    k = 1
    f32 = dict(dtype=torch.float32, device=dev)
    w = torch.as_tensor(rng.normal(size=(k, d)).astype(np.float32), device=dev)
    y = torch.as_tensor((rng.random((n_pad, k)) < 0.5).astype(np.float32), device=dev)
    g_mem, wb, lpe = torch.zeros((n_pad, k), **f32), torch.ones((n_pad,), **f32), torch.zeros((batch, k), **f32)

    def k2_step(s):
        nonlocal w
        _, corr = fused_head_step_at(head, s, w, lpe, y[s : s + batch], g_mem[s : s + batch], wb[s : s + batch],
                                     "binomial")
        w = w - 1e-9 * corr

    sec = best_step_seconds(k2_step, n_blocks, batch, steps, reps, rng, dev)
    return {"probe": "P2 block_colsum", "device": describe(dev), "n_pad": n_pad, "d": d, "batch": batch,
            "steps": steps, "p2": rows,
            "k2": {"family": "binomial", "k": k, "ms_per_step": sec * 1e3, "gb_per_s": step_bytes / sec / 1e9}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card; raises without one)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-pad", type=int, default=106496)
    ap.add_argument("--d", type=int, default=16384)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--bts", default="256,512,1024", help="tile heights, comma-separated")
    ap.add_argument("--steps", type=int, default=26)
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    bts = tuple(int(v) for v in a.bts.split(","))
    print(json.dumps(run(a.device, a.seed, a.n_pad, a.d, a.batch, bts, a.steps, a.reps)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
