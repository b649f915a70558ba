"""K2 (the fused head step) at other launch parameters than `plan` picks.

    python -m sgdnet_tpu_torch.tools.tune_head_step [--seed N]

At the two shapes the fit paths run (bf16 D 16384 k 1 B 8192 on a
106496-row head; f32 D 784 k 10 B 4096 on a 65536-row head) it launches
the kernel with every (C, bt, S) that fits shared memory
(`resident_plans`), holds each against the planned launch (identical up
to summation order: 1e-4 of max|corr|), and prints one JSON line a shape: the planned parameters and,
per candidate, the ms a call (CUDA events over 20 calls, cycling over the
head's blocks so that no call finds its block in L2) and the device time
a call (torch.profiler), fastest on the device first.  It answers whether
`plan`'s order of preference is the fastest on this card.  CUDA only.
"""

from __future__ import annotations

import argparse
import itertools
import json

import torch

from sgdnet_tpu_torch.solver import head_kernel as hk
from sgdnet_tpu_torch.utils.profiling import kernel_device_ms


def _time(fn, reps: int = 20) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def run_shape(dev, seed: int, n_pad: int, B: int, D: int, k: int, dtype, family: str) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    head = torch.randn((n_pad, D), generator=gen, device=dev, dtype=dtype)
    w = torch.randn((k, D), generator=gen, device=dev) / D**0.5
    lpe = 0.1 * torch.randn((B, k), generator=gen, device=dev)
    y = torch.nn.functional.one_hot(torch.randint(0, max(k, 2), (B,), generator=gen, device=dev), max(k, 2))
    y = y[:, :k].float().contiguous()
    gm = 0.1 * torch.randn((B, k), generator=gen, device=dev)
    wb = torch.ones((B,), device=dev)
    last = n_pad - B

    def at(plan, start):
        return hk.head_step_with(plan, head, start, w, lpe, y, gm, wb, family)

    def cycling(plan):
        starts = itertools.cycle(range(0, last + 1, B))
        return lambda: at(plan, next(starts))

    planned = hk.device_plan(head, B, k)
    g0, c0 = at(planned, last)
    rows = []
    for p in hk.resident_plans(B, D, k, dtype):
        # p's (C, bt, S) on a grid the card holds at once
        p = next((q for q in hk.plans_on_card(head, B, k, p) if (q.C, q.bt, q.S) == (p.C, p.bt, p.S)))
        g, c = at(p, last)
        torch.cuda.synchronize()
        err = float((c - c0).abs().max()) / max(float(c0.abs().max()), 1e-30)
        if err > 1e-4 or float((g - g0).abs().max()) > 1e-5:
            raise RuntimeError(f"K2 at {p} disagrees with the planned launch: corr {err:.3e}")
        rows.append({"C": p.C, "bt": p.bt, "S": p.S, "tpc": p.tpc, "n_parts": p.n_parts, "smem": p.smem,
                     "ctas_per_sm": hk.ctas_per_sm(p.smem, k), "ms": _time(cycling(p)),
                     "device_ms": kernel_device_ms(cycling(p), 10, hk.KERNEL_NAMES), "rel_err_vs_planned": err})
    rows.sort(key=lambda r: r["device_ms"] or r["ms"])
    return {"shape": {"n_pad": n_pad, "B": B, "D": D, "k": k, "dtype": str(dtype)[6:]},
            "planned": planned._asdict(), "planned_ms": _time(cycling(planned)),
            "block_bytes": B * D * dtype.itemsize, "candidates": rows}


def run(dev, seed: int) -> list:
    out = [run_shape(dev, seed, 106496, 8192, 16384, 1, torch.bfloat16, "binomial"),
           run_shape(dev, seed, 65536, 4096, 784, 10, torch.float32, "multinomial")]
    for r in out:
        r["device"] = torch.cuda.get_device_name(0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("tune_head_step needs a CUDA device")
    for r in run(torch.device("cuda", 0), args.seed):
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
