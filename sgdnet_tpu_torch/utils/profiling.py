"""Profiling hooks (twin of sgdnet_tpu/utils/profiling.py) on
torch.profiler, and the device-time readings the port's tools share.

`trace(log_dir)` profiles the CPU and the card and writes a Chrome trace
into `log_dir`; `time_fn` measures the steady-state wall time of a call,
waiting for the card when its output holds CUDA tensors.

`span(name)` marks a layer of the program (the solver's epoch, a step's
phases, the g_sum refresh).  While a torch.profiler profile runs (so
under `trace()`), a span enters `record_function(name)`, which puts it in
the profile beside the device's operations, and keeps a record in memory
(`span_records()`): its name, its enclosing span's name, the epoch it
belongs to, and its start and end on `time.time_ns()`, the clock of the
profile's events; a span given the device its work runs on also times
that work with a pair of CUDA events.  With no profile running a span
costs one `torch.autograd._profiler_enabled()` check and records nothing.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import NamedTuple

import torch

TRACE_FILE = "trace.json"
#: the most span records kept; later spans still reach the profile, but
#: keep no record until `reset_spans()`
MAX_SPANS = 1 << 16


class SpanRecord(NamedTuple):
    """One span: times in ns on `time.time_ns()`'s clock; `device_ms` the
    CUDA events' time between its entry and exit (None without a CUDA
    device, or while the card has not reached the exit)."""

    name: str
    parent: str | None  # the enclosing span's name
    epoch: int | None  # the epoch it belongs to: its own, else its parent's
    start_ns: int
    end_ns: int | None  # None while the span is open
    device_ms: float | None


_OFF = contextlib.nullcontext()
_records: list = []  # [name, parent, epoch, start_ns, end_ns, device_ms, events]
_open = threading.local()  # .stack: this thread's open spans, innermost last


class _Span:
    __slots__ = ("rec", "fn", "events")

    def __init__(self, name: str, epoch, device):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        parent = stack[-1] if stack else None
        if epoch is None and parent is not None:
            epoch = parent[2]
        self.rec = [name, None if parent is None else parent[0], epoch, 0, None, None, None]
        self.fn = torch.profiler.record_function(name)
        self.events = None
        if device is not None and torch.device(device).type == "cuda":
            stream = torch.cuda.current_stream(device)
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True), stream)

    def __enter__(self):
        rec = self.rec
        _open.stack.append(rec)
        if len(_records) < MAX_SPANS:
            _records.append(rec)
        rec[3] = time.time_ns()
        self.fn.__enter__()
        if self.events is not None:
            self.events[0].record(self.events[2])
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self.events[2])
            self.rec[6] = self.events[:2]
        self.fn.__exit__(*exc)
        self.rec[4] = time.time_ns()
        _open.stack.pop()
        return False


def span(name: str, *, epoch: int | None = None, device=None):
    """A context manager marking one layer's work: with a profile running,
    a `record_function(name)` and a record (see the module's docstring),
    `device` the torch.device the work runs on (CUDA: its time by events
    on the current stream); else a shared no-op."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, epoch, device)


def span_records() -> list:
    """The spans recorded since the last `reset_spans()`, in the order they
    were entered (at most MAX_SPANS), as SpanRecords; a device time is
    read once the card has passed the span's exit."""
    out = []
    for rec in _records:
        if rec[6] is not None and rec[6][1].query():
            rec[5], rec[6] = rec[6][0].elapsed_time(rec[6][1]), None
        out.append(SpanRecord(*rec[:6]))
    return out


def reset_spans() -> None:
    """Forget the recorded spans."""
    _records.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU and, where there is one, CUDA activity) and
    write the Chrome trace to `log_dir`/trace.json (chrome://tracing,
    Perfetto); yields the torch.profiler.profile, whose `key_averages()`
    stay readable after the block."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _wait(out) -> None:
    """Wait for the card if `out` (a tensor, or a tuple, list or dict of
    them, nested) holds a CUDA tensor."""
    stack = [out]
    while stack:
        o = stack.pop()
        if isinstance(o, torch.Tensor):
            if o.is_cuda:
                torch.cuda.synchronize(o.device)
                return
        elif isinstance(o, (tuple, list)):
            stack.extend(o)
        elif isinstance(o, dict):
            stack.extend(o.values())


def time_fn(fn, *args, iters: int = 3, warmup: int = 1, **kwargs) -> float:
    """Steady-state seconds per call of `fn` (waits on the result)."""
    for _ in range(warmup):
        _wait(fn(*args, **kwargs))
    t0 = time.perf_counter()
    for _ in range(iters):
        _wait(fn(*args, **kwargs))
    return (time.perf_counter() - t0) / iters


def self_device_us(event) -> float:
    """A torch.profiler key average's own device time in microseconds
    (the attribute's name changed between torch releases)."""
    return getattr(event, "self_device_time_total", 0.0) or getattr(event, "self_cuda_time_total", 0.0)


def device_kernels(prof) -> list:
    """The profile's key averages that ran on the card, with device time."""
    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and self_device_us(e) > 0]


def kernel_device_ms(fn, reps: int, names) -> float | None:
    """Device time per call of fn, whose wrapper launches each kernel named
    in `names` once: torch.profiler over `reps` calls after a warm-up, each
    kernel's device time per recorded launch, summed over the kernels.  Per
    recorded launch, not over `reps`: a profile can keep fewer kernel
    records than launches, and their sum over `reps` then reads below the
    kernel's bytes bound.  A profile now and then keeps no record of a
    kernel that ran: it is taken again, three times at most.  None when
    none of them saw device time for the kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in device_kernels(prof) if any(nm in e.key for nm in names)]
        if kern:
            return sum(self_device_us(e) / e.count for e in kern) / 1e3
    return None
