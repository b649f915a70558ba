"""Scaling-efficiency harness: nnz/s at 1, 2, ..., N ranks (twin of
sgdnet_tpu/parallel/scaling.py).

The BASELINE.md target is >= 80% nnz/s efficiency from 1 host to N hosts
on a sparse binomial workload.  This harness runs the same sharded SAGA
workload over growing sub-meshes (the first 1, 2, 4, ... ranks of the
process group) and reports throughput and efficiency.

Between cards joined by NCCL the numbers are a scaling measurement.  Ranks
that share one card (gloo, every all-reduce through the host) or run on
the CPU validate the mechanism and the collective layout only: the result
says so (`shared_device`).
"""

from __future__ import annotations

import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from sgdnet_tpu_torch.families import get_family
from sgdnet_tpu_torch.parallel.dist import fit_path_sharded, make_mesh, pad_to_shards
from sgdnet_tpu_torch.penalties import select_penalty
from sgdnet_tpu_torch.solver.saga import SolverConfig, init_state
from sgdnet_tpu_torch.utils.device import sync


def measure_scaling(
    n=20_000,
    p=512,
    density=0.1,
    batch_per_device=256,
    epochs=3,
    device_counts=None,
    seed=0,
    device=None,
):
    """Returns {n_ranks: nnz_per_s} plus an 'efficiency' entry and a
    'shared_device' flag, the same on every rank.  Every rank of the
    default process group calls it; the ranks of the process group are
    the devices (`device`: this rank's, None meaning its card).  Each count
    runs `epochs` epochs at tol 0 without step backoff, best of 3 after a
    warm-up."""
    world = dist.get_world_size()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= world]

    rng = np.random.default_rng(seed)
    x_np = (rng.random((n, p)) < density) * rng.normal(size=(n, p))
    lp = x_np[:, 0] - x_np[:, 1]
    y_np = (rng.random(n) < 1 / (1 + np.exp(-lp))).astype(np.float32).reshape(-1, 1)
    nnz = int(np.count_nonzero(x_np))

    family = get_family("binomial")
    penalty = select_penalty(1.0, "binomial")

    results = {}
    shared = False
    for nd in device_counts:
        # every rank makes the sub-group; the ranks outside it wait
        mesh = make_mesh(nd, device=device)
        if mesh is not None:
            dev = mesh.device
            n_pad = pad_to_shards(n, nd, batch_per_device)
            x = torch.zeros((n_pad, p), dtype=torch.float32, device=dev)
            x[:n] = torch.as_tensor(x_np, dtype=torch.float32, device=dev)
            y = torch.zeros((n_pad, 1), dtype=torch.float32, device=dev)
            y[:n] = torch.as_tensor(y_np, device=dev)
            w = torch.zeros((n_pad,), dtype=torch.float32, device=dev)
            w[:n] = 1.0
            # fixed-epoch throughput: tol 0 always exits at max_iter, which
            # must NOT trigger the backoff's retries (they would triple the
            # measured work)
            config = SolverConfig(batch_size=batch_per_device, max_iter=epochs, fit_intercept=True,
                                  step_backoff=False)

            def run(s):
                state0 = init_state(n_pad, p, 1, torch.float32, dev)
                t0 = time.perf_counter()
                fit_path_sharded(x, y, w, [1e-3], [1e-4], [0.0], 0.0, state0, family, penalty, config, mesh,
                                 seed=s)
                sync(dev)
                return time.perf_counter() - t0

            run(seed)
            best = min(run(seed + r) for r in range(1, 4))
            ranks = [None] * nd
            dist.all_gather_object(ranks, (socket.gethostname(), str(dev), best), group=mesh.group)
            shared = shared or dev.type != "cuda" or len({r[:2] for r in ranks}) < nd
            # the slowest rank sets the time of an SPMD run
            results[nd] = nnz * epochs / max(r[2] for r in ranks)
        dist.barrier()
    box = [(results, shared)]
    dist.broadcast_object_list(box, src=0)
    results, shared = box[0]
    base = results[device_counts[0]] / device_counts[0]
    results["efficiency"] = {nd: results[nd] / (nd * base) for nd in device_counts}
    results["shared_device"] = shared
    return results


if __name__ == "__main__":
    import json

    from sgdnet_tpu_torch.parallel.multihost import init_multihost

    init_multihost()
    r = measure_scaling()
    if dist.get_rank() == 0:
        print(json.dumps({str(k): v for k, v in r.items()}, default=str, indent=2))
    dist.destroy_process_group()
