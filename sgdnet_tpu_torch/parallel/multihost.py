"""Multi-process execution helpers (twin of sgdnet_tpu/parallel/multihost.py).

Each process is one rank and drives one device.  `init_multihost()` wires
the processes together with `torch.distributed` (from the variables that
`torchrun` sets, or a tcp:// coordinator address), and
`global_data_mesh()` builds the 1-D 'data' mesh over every rank.  The
data-parallel layer (parallel/dist.py) does not care where the ranks run:
one host's cards or several hosts'.

`run_ranks` starts the ranks of one machine itself (spawned processes, a
free local port): the tests' gloo groups on the CPU, the ranks that share
one card, and `graft_entry.dryrun_multichip`.
"""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

from sgdnet_tpu_torch.parallel.dist import AXIS, make_mesh


def init_multihost(coordinator_address: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None):
    """Initialize the default process group; a no-op once it is.  With a
    `coordinator_address` ("host:port"), this process is rank `process_id`
    of `num_processes`; without one, the group comes from the environment
    (env://: MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE, as torchrun
    sets them).  CPU tensors go through gloo; CUDA tensors through NCCL,
    one card a rank (this process's card is LOCAL_RANK), or through gloo
    when this host runs more ranks (LOCAL_WORLD_SIZE) than it has cards,
    which NCCL refuses.  Returns (rank, world size)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    backend = "gloo"
    if torch.cuda.is_available():
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
        if local_size <= torch.cuda.device_count():
            backend = "cpu:gloo,cuda:nccl"
    if coordinator_address is None:
        kw = dict(init_method="env://")
        if num_processes is not None:
            kw["world_size"] = num_processes
        if process_id is not None:
            kw["rank"] = process_id
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator_address needs num_processes and process_id")
        address = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        kw = dict(init_method=address, world_size=num_processes, rank=process_id)
    dist.init_process_group(backend, **kw)
    return dist.get_rank(), dist.get_world_size()


def global_data_mesh(device=None):
    """1-D 'data' mesh over every rank of the default process group, on
    this process's card (or `device`)."""
    return make_mesh(axis=AXIS, device=device)


def free_port() -> int:
    """A TCP port on this host that was free a moment ago (bound to port 0,
    then released)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, args, rank: int, nprocs: int, port: int, out) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(nprocs),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nprocs))
    try:
        init_multihost()
        out.put((rank, True, fn(*args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, nprocs: int, args=(), timeout: float = 600.0) -> list:
    """fn(*args) in `nprocs` spawned processes, each one rank of a new
    process group on this host (init_multihost from the environment, on a
    free local port); returns each rank's result in rank order.  `fn` and
    its arguments and results must pickle (a module-level function).  A
    rank that raises or exits non-zero, or a group not done within
    `timeout` seconds, fails the call: every rank still running is killed
    and RuntimeError names the rank and its traceback."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, args, r, nprocs, port, out), daemon=True)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    results, failure = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(results) < nprocs and failure is None:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    failure = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                elif time.monotonic() > deadline:
                    failure = f"the ranks did not finish within {timeout} s"
                continue
            if ok:
                results[rank] = value
            else:
                failure = f"rank {rank} failed:\n{value}"
        if failure is None:
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 5.0))
            codes = [p.exitcode for p in procs]
            if any(c != 0 for c in codes):
                failure = f"ranks exited with codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
    if failure is not None:
        raise RuntimeError(f"run_ranks({getattr(fn, '__name__', fn)}, {nprocs}): {failure}")
    return [results[r] for r in range(nprocs)]
