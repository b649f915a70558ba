"""Time P1, the single-block whole-epoch prototype, against its plain
torch twin (the counterpart of tools/bench_epoch_kernel.py).

    python -m sgdnet_tpu_torch.tools.bench_epoch_kernel [--device cuda|cpu] [--seed 0]
        [--n 4224] [--p 128] [--batch 32] [--epochs 200] [--twin-epochs 20] [--reps 3]

A gaussian SAGA epoch is T = n / batch strictly dependent steps, so its
time is the per-step floor of a one-CTA loop on the card.  Each of `reps`
runs starts from the zero state and runs `epochs` epochs (one launch each,
block starts a fresh permutation per epoch, drawn from `--seed`), then
reads the state back; the best run gives ms an epoch and ns a step, and the
last run's checksum is sum(w) + sum(g_sum).  The twin runs `twin_epochs`
the same way.  Prints one JSON line.  `--device` defaults to the card and
raises without one.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from sgdnet_tpu_torch.tools.probe_kernels import LANES, epoch_probe, epoch_probe_reference
from sgdnet_tpu_torch.utils.device import describe, resolve_device, sync


def _time_epochs(fn, x, y, wt, batch, epochs, reps, rng, dev) -> dict:
    n, p = x.shape
    T = n // batch
    best, chk = float("inf"), None
    for _ in range(reps):
        starts = torch.as_tensor(np.stack([rng.permutation(T) * batch for _ in range(epochs)]).astype(np.int32),
                                 device=dev)
        w, g_sum = (torch.zeros((LANES, p), dtype=torch.float32, device=dev) for _ in range(2))
        g_mem = torch.zeros((n, LANES), dtype=torch.float32, device=dev)
        sync(dev)
        t0 = time.perf_counter()
        for e in range(epochs):
            fn(starts[e], x, y, wt, w, g_mem, g_sum, batch)
        chk = float(w.sum()) + float(g_sum.sum())  # reads the state back
        best = min(best, time.perf_counter() - t0)
    return {"epochs": epochs, "ms_per_epoch": best / epochs * 1e3, "ns_per_step": best / (epochs * T) * 1e9,
            "checksum": chk}


def run(device=None, seed: int = 0, n: int = 4224, p: int = 128, batch: int = 32, epochs: int = 200,
        twin_epochs: int = 20, reps: int = 3) -> dict:
    """Time `epochs` epochs through P1 and `twin_epochs` through its twin."""
    dev = resolve_device(device)
    if n % batch != 0:
        raise ValueError(f"n={n} must be a multiple of batch={batch}")
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(n, p)).astype(np.float32), device=dev)
    y = torch.as_tensor(rng.normal(size=(n, LANES)).astype(np.float32), device=dev)
    wt = torch.ones((n, LANES), dtype=torch.float32, device=dev)
    return {
        "probe": "P1 epoch_probe", "device": describe(dev), "n": n, "p": p, "batch": batch,
        "steps_per_epoch": n // batch,
        "kernel": _time_epochs(epoch_probe, x, y, wt, batch, epochs, reps, rng, dev),
        "twin": _time_epochs(epoch_probe_reference, x, y, wt, batch, twin_epochs, reps, rng, dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card; raises without one)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=4224)
    ap.add_argument("--p", type=int, default=128)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--twin-epochs", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    print(json.dumps(run(a.device, a.seed, a.n, a.p, a.batch, a.epochs, a.twin_epochs, a.reps)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
