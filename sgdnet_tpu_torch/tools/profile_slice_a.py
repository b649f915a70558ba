"""Slice A on the card: the abalone gaussian path (alpha 0.8, 100 lambdas,
B 32, through K1 by default on CUDA) with its wall, epochs, K1 launches,
host syncs and device busy share.

    python -m sgdnet_tpu_torch.tools.profile_slice_a [--device cuda|cpu] [--reps 3] [--nlambda 100]

After a warm-up fit, `reps` timed fits give the wall (host clock around fit(), which returns
host arrays); one more fit under `torch.cuda.set_sync_debug_mode("warn")`
counts the host syncs torch reports; one more under torch.profiler gives
the kernels' device time, and busy share = device time / the median
timed wall.  Prints one JSON line.  `--device` defaults to the card and
raises without one; on the CPU the device numbers are None.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
import warnings

import torch


def run(device=None, reps: int = 3, nlambda: int = 100) -> dict:
    import sgdnet_tpu_torch as st
    from sgdnet_tpu_torch.solver import epoch_kernel as ek
    from sgdnet_tpu_torch.utils.device import describe, resolve_device, sync
    from sgdnet_tpu_torch.utils.profiling import device_kernels, self_device_us

    dev = resolve_device(device)
    x, y = st.load_abalone()

    def fit():
        return st.fit(x, y, family="gaussian", alpha=0.8, nlambda=nlambda, device=dev)

    fit()
    walls, launches = [], []
    for _ in range(reps):
        sync(dev)
        before = ek.saga_epochs.launches
        t0 = time.perf_counter()
        f = fit()
        walls.append(time.perf_counter() - t0)
        launches.append(ek.saga_epochs.launches - before)
    out = {"device": describe(dev),
           "lambdas": f.n_lambda, "epochs": f.npasses, "epoch_kernel": f.stats["epoch_kernel"],
           "k1_launches": launches[-1], "k1_chunks": f.stats.get("epoch_chunks"), "walls_s": walls,
           "wall_s": statistics.median(walls), "host_syncs": None, "device_s": None, "busy_share": None,
           "top": []}
    if dev.type != "cuda":
        return out
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fit()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    out["host_syncs"] = sum("synchronizing" in str(w.message) for w in seen)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fit()
        sync(dev)
    kern = device_kernels(prof)
    out["device_s"] = sum(self_device_us(e) for e in kern) / 1e6
    out["busy_share"] = out["device_s"] / out["wall_s"]
    out["top"] = [{"kernel": e.key[:60], "calls": e.count, "device_ms": self_device_us(e) / 1e3}
                  for e in sorted(kern, key=self_device_us, reverse=True)[:5]]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card; raises without one)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--nlambda", type=int, default=100)
    a = ap.parse_args(argv)
    print(json.dumps(run(a.device, a.reps, a.nlambda)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
