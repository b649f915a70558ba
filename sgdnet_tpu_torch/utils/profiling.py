"""Profiling hooks (twin of sgdnet_tpu/utils/profiling.py) on
torch.profiler, and the device-time readings the port's tools share.

`trace(log_dir)` profiles the CPU and the card and writes a Chrome trace
into `log_dir`; `time_fn` measures the steady-state wall time of a call,
waiting for the card when its output holds CUDA tensors.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

TRACE_FILE = "trace.json"


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
