"""One run of a cell over its `chips` ranks: one process a card, one
process group, one result line.

`run.py` hands a cell whose `chips` is above 1 to `main`; a one-chip
cell keeps its own path.  The parent starts `chips` processes from the
`spawn` context and creates no CUDA context itself (rank 0 shares card
0 with it).  Rank r:
- sends what it prints to standard error, and sets the environment as
  torchrun does: MASTER_ADDR 127.0.0.1, a free port, RANK, WORLD_SIZE,
  LOCAL_RANK and LOCAL_WORLD_SIZE;
- takes card r (`torch.cuda.set_device`) and forms the default group
  ("cpu:gloo,cuda:nccl", env://) through torch.distributed alone, so
  the port's `init_multihost()` finds it formed and `global_data_mesh()`
  spans it.  With `device_type="cpu"`, which the tests use and `run.py`
  never does, the ranks are gloo ranks on the CPU;
- runs the cell's kind (`workload.run`; the contract it keeps is
  `perfbench/kinds/__init__.py`'s) with the parent's start `t0`, so that
  `setup_s` counts from the parent's start and holds the spawn and the
  group's set-up: `time.perf_counter()` reads CLOCK_MONOTONIC on Linux,
  one clock for every process of the host;
- once the kind has returned, its window closed, looks for JAX and the
  JAX package among its own modules (`run.forbidden_modules`), and sends
  the parent its report, plain data only (`_plain`).

The parent makes the one result line of the reports (`combine`):
- `end_to_end` and `attempted` are rank 0's: a kind makes the group's
  rate on rank 0 itself;
- `failed` is the sum over the ranks;
- each number compared is the worst (largest) over the ranks that give
  it, a non-finite one or None counting as infinite, so `correct` holds
  only where it holds on every rank;
- `device.memory_peak_bytes` is the fullest card's, beside
  `memory_peak_bytes_by_rank`;
- `device.count` is `chips`, `kind` the cards' name (their distinct
  names joined by " + " where they differ), `power_limit_w` the lowest
  of the cards';
- under --trace 1 the per-layer readers and the breakdown read rank 0's
  `ctx` and Summary; `device.busy_s` and `window_s` are the means over
  the ranks, beside `busy_s_by_rank` and `window_s_by_rank`.

A rank that raises or exits with another code than 0, or a group that
has not finished `SETUP_ALLOWANCE_S` after `--seconds` from the run's
start, ends the run: every rank still running is killed, standard error
names each rank that failed, with its traceback, in the order the
failures were seen (or the ranks still running), no result is printed
and the exit code is 1.  A rank that loaded JAX or the JAX package ends
it with exit code 3.
"""

from __future__ import annotations

import math
import multiprocessing as mp
import numbers
import os
import queue
import signal
import socket
import statistics
import sys
import time
import traceback
from dataclasses import asdict

#: seconds a run may take besides `--seconds` before its group is ended:
#: ~5x the longest first set-up the cells have read (41.7-49.2 s in the
#: ledger, the kernels' build included), for four processes that each
#: reach their card (~8 s), a group's set-up, the comparison after the
#: window and the trace's reduction; with --seconds 51 a hung group ends
#: at 291 s, inside the 360 s a run may take
SETUP_ALLOWANCE_S = 240.0
#: seconds to gather the other ranks' failures once one rank has failed
GRACE_S = 2.0


class RankFailure(RuntimeError):
    """A run of ranks that ended without a result; `code` is its exit code."""

    def __init__(self, message: str, code: int = 1):
        super().__init__(message)
        self.code = code


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _plain(x, where: str = "report"):
    """`x` as plain data (numbers, strings, None, lists, tuples, dicts with
    string keys); TypeError naming where anything else sits."""
    if x is None or isinstance(x, (bool, str)):
        return x
    if isinstance(x, numbers.Integral):
        return int(x)
    if isinstance(x, numbers.Real):
        return float(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v, f"{where}[{i}]") for i, v in enumerate(x))
    if isinstance(x, dict) and all(isinstance(k, str) for k in x):
        return {k: _plain(v, f"{where}[{k!r}]") for k, v in x.items()}
    raise TypeError(f"{where} is a {type(x).__name__}: what a rank returns crosses to the parent as plain data")


def report(rank: int, outcome, device_info: dict) -> dict:
    """What rank `rank` sends the parent of its Outcome: its own numbers,
    and on rank 0 the ctx and Summary the readers read."""
    s = outcome.summary
    rep = {"end_to_end": outcome.end_to_end, "attempted": outcome.attempted,
           "failed": outcome.failed, "readings": outcome.readings, "peak_bytes": outcome.peak_bytes,
           "device": device_info, "busy_s": None if s is None else s.busy_s,
           "window_s": None if s is None else s.window_s}
    if rank == 0:
        rep["ctx"] = outcome.ctx
        rep["summary"] = None if s is None else {"ops": s.ops, "window": s.window, "gaps": s.gaps}
    return _plain(rep)


def _worst(values) -> float:
    return max(math.inf if v is None or not math.isfinite(v) else float(v) for v in values)


def combine(reports: list, chips: int):
    """(Outcome, device info, the device's further keys) of the ranks'
    reports, in rank order, by the rules of this module's docstring."""
    from perfbench import trace, workload

    r0 = reports[0]
    names = dict.fromkeys(k for r in reports for k in r["readings"])
    readings = {k: _worst(r["readings"][k] for r in reports if k in r["readings"]) for k in names}
    s = r0.get("summary")
    summary = None if s is None else trace.Summary([tuple(o) for o in s["ops"]], tuple(s["window"]), dict(s["gaps"]))
    peaks = [r["peak_bytes"] for r in reports]
    outcome = workload.Outcome(dict(r0["end_to_end"]), r0["attempted"], sum(r["failed"] for r in reports), readings,
                               max(peaks), r0.get("ctx") or {}, summary)
    limits = [r["device"]["power_limit_w"] for r in reports if r["device"].get("power_limit_w") is not None]
    kinds = dict.fromkeys(r["device"]["kind"] for r in reports)
    info = {"platform": r0["device"]["platform"], "kind": " + ".join(kinds), "count": chips,
            "power_limit_w": min(limits) if limits else None}
    extra = {"memory_peak_bytes_by_rank": peaks}
    busy, window = [r["busy_s"] for r in reports], [r["window_s"] for r in reports]
    if summary is not None and None not in busy and None not in window:
        extra.update(busy_s=statistics.fmean(busy), window_s=statistics.fmean(window), busy_s_by_rank=busy,
                     window_s_by_rank=window)
    return outcome, info, extra


def _rank_main(rank: int, chips: int, port: int, cell: dict, seed: int, seconds: float, traced: bool, t0: float,
               device_type: str, kinds_dir: str, out) -> None:
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(chips),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(chips))
    import torch
    import torch.distributed as dist

    try:
        from perfbench import manifest, run, workload

        if device_type == "cuda":
            torch.cuda.set_device(rank)
            device = torch.device("cuda", rank)
            info = run.card(device)
        else:
            device = torch.device("cpu")
            info = {"platform": "cpu", "kind": "cpu", "power_limit_w": None}
        dist.init_process_group("cpu:gloo,cuda:nccl" if device_type == "cuda" else "gloo", init_method="env://")
        outcome = workload.run(manifest.Cell(**cell), seed, seconds, traced, device, t0, kinds_dir)
        bad = run.forbidden_modules()
        if bad:
            out.put(("forbidden", rank, bad))
            sys.exit(3)
        out.put(("report", rank, report(rank, outcome, info)))
    except Exception:
        out.put(("error", rank, traceback.format_exc()))
        sys.exit(1)
    if dist.is_initialized():
        dist.destroy_process_group()


def run_group(cell, seed: int, seconds: float, traced: bool, t0: float, device_type: str = "cuda",
              deadline_s: float | None = None, kinds_dir: str | None = None) -> list:
    """The reports of the cell's `chips` ranks, in rank order; RankFailure
    where a rank failed or the group was not done `deadline_s` (by default
    `seconds` + SETUP_ALLOWANCE_S) after `t0`.  Once one rank has failed,
    the others' failures are gathered for GRACE_S more (a rank that waits
    on a failed one in a collective may fail in turn), and every failure
    is named, in the order they were seen.  Every rank has ended when it
    returns or raises."""
    from perfbench import workload

    chips = cell.chips
    deadline_s = seconds + SETUP_ALLOWANCE_S if deadline_s is None else deadline_s
    end = t0 + deadline_s
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    args = (chips, _free_port(), asdict(cell), seed, seconds, traced, t0, device_type,
            kinds_dir or workload.KINDS_DIR, out)
    procs = [ctx.Process(target=_rank_main, args=(r, *args), name=f"perfbench-rank-{r}") for r in range(chips)]
    reports, errors, seen, late = {}, {}, {}, None  # seen: rank -> when its failure was first seen
    term = signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))  # so that `finally` ends the ranks
    try:
        for p in procs:
            p.start()
        while len(reports) < chips:
            now = time.perf_counter()
            if seen and now >= min(seen.values()) + GRACE_S:
                break
            if now >= end:
                late = [r for r, p in enumerate(procs) if p.is_alive()]
                break
            try:
                message = out.get(timeout=max(0.05, min(0.5, end - now)))
            except queue.Empty:
                message = None
            for r, p in enumerate(procs):  # before the message: a rank that died may have made it
                if p.exitcode not in (None, 0):
                    seen.setdefault(r, time.perf_counter())
            if message is not None:
                tag, rank, value = message
                if tag == "report":
                    reports[rank] = value
                else:
                    errors[rank] = (tag, value)
                    seen.setdefault(rank, time.perf_counter())
        if not seen and late is None:
            for p in procs:
                p.join(timeout=max(end - time.perf_counter(), 5.0))
        failures = []
        for r in sorted(seen, key=seen.get):  # in the order they were seen
            tag, v = errors.get(r, ("exit", None))
            failures.append(f"rank {r} of {chips} failed:\n{v}" if tag == "error" else
                            f"rank {r} of {chips} loaded {', '.join(v)}: no result" if tag == "forbidden" else
                            f"rank {r} of {chips} exited with code {procs[r].exitcode}"
                            + (" after its report" if r in reports else " and sent no report"))
        if late is not None:
            failures.append(f"the group of {chips} ranks did not finish within {deadline_s:g} s of the run's start "
                            f"(--seconds {seconds:g} + {deadline_s - seconds:g} s); ranks still running: {late}, "
                            f"reported: {sorted(reports)}")
        elif not failures and any(p.exitcode != 0 for p in procs):
            failures.append(f"every rank reported, but their exit codes were {[p.exitcode for p in procs]} "
                            f"(None: still running {deadline_s:g} s after the run's start)")
        if failures:
            raise RankFailure("\n".join(failures), 3 if any(t == "forbidden" for t, _ in errors.values()) else 1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
        out.close()
        signal.signal(signal.SIGTERM, term)
    return [reports[r] for r in range(chips)]


def main(cell, seed: int, seconds: float, traced: bool, t0: float, device_type: str = "cuda",
         deadline_s: float | None = None, kinds_dir: str | None = None) -> int:
    """Run the cell over its ranks and print its one result line (exit code
    0), or print no result and name the failure on standard error (1; 3
    where a rank or this process loaded JAX or the JAX package)."""
    from perfbench import run

    try:
        reports = run_group(cell, seed, seconds, traced, t0, device_type, deadline_s, kinds_dir)
    except RankFailure as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return e.code
    bad = run.forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}: no result", file=sys.stderr)
        return 3
    outcome, info, extra = combine(reports, cell.chips)
    out = run.result(cell, outcome, traced, info)
    out["device"].update(extra)
    run.emit(out)
    return 0
