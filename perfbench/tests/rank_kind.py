"""A toy traffic kind for the rank runner's tests, and the cells that run it.

Every rank all-reduces (rank + 1) over the group and gathers which card
it holds; its numbers tell the ranks apart (rate 1000 + rank, attempted
10 + rank, peak 1000 (rank + 1) bytes, traced busy 0.1 (rank + 1) s of
a 1 s window).  The traffic's `fault` breaks rank `fault_rank`: "raise",
"sleep" (past any deadline), "exit" (code 7, no report) or "forbid" (a
stub `jax` in its modules); `gaps` gives each rank's compared reading
besides the all-reduce's error, and `failed_ranks` the ranks that count
a failure."""

import os
import sys
import time
import types

import torch
import torch.distributed as dist

from perfbench import manifest, trace, workload

HERE = os.path.dirname(os.path.abspath(__file__))
KIND = "rank_kind"


def cell(chips: int = 2, **traffic) -> manifest.Cell:
    """A cell of this kind on `chips` ranks, with its traffic's parameters."""
    e2e = ({"name": "rate", "unit": "1/s"}, {"name": "setup_s", "unit": "s"})
    return manifest.Cell("toy.ranks", chips, {}, dict(traffic, kind=KIND), {"sum_gap": 1e-6, "cards_shared": 0.0},
                         e2e, ({"name": "device_idle.epochs", "unit": "%"},))


def run(cell, seed, seconds, traced, device, t0):
    rank, n = dist.get_rank(), dist.get_world_size()
    tr = cell.traffic
    print(f"toy rank {rank} of {n} on {device}")
    if tr.get("fault_rank") == rank:
        fault = tr["fault"]
        if fault == "raise":
            raise RuntimeError(f"the toy's fault on rank {rank}")
        if fault == "sleep":
            time.sleep(3600)
        if fault == "exit":
            os._exit(7)
        if fault == "forbid":
            sys.modules["jax"] = types.ModuleType("jax")
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        card = (torch.cuda.current_device(), str(getattr(props, "uuid", "")))
    else:
        card = (rank, "")
    cards = [None] * n
    dist.all_gather_object(cards, card)
    t = torch.full((4,), float(rank + 1), device=device)
    dist.all_reduce(t)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    got, want = t.cpu().tolist(), n * (n + 1) / 2
    readings = {"sum_gap": max(abs(v - want) for v in got) + tr.get("gaps", [0.0] * n)[rank],
                "cards_shared": float(n - len(set(cards)))}
    summary = trace.Summary([("toy_kernel", 0.0, 0.1 * (rank + 1))], (0.0, 1.0), {"toy > host": 0.9 - 0.1 * rank}) \
        if traced else None
    ctx = {"kind": "epochs", "epochs": 1, "rank": rank, "sum": got[0], "cards": cards}
    e2e = {"rate": 1000.0 + rank, "setup_s": time.perf_counter() - t0}
    return workload.Outcome(e2e, 10 + rank, int(rank in tr.get("failed_ranks", ())), readings, 1000 * (rank + 1),
                            ctx, summary)
