"""Where the port's entry points put their tensors.

`device=None` means the CUDA card: an entry point never carries on on the
CPU because no card was found.  A CPU run asks for it by name
(`device="cpu"`), as the tests do.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device`; None is the current CUDA device, and
    raises RuntimeError when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: device=None means the card (torch.cuda.is_available() is False); "
                "pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def sync(dev: torch.device) -> None:
    """Wait for the device's queued work (a no-op off the card), so that a
    host clock read after it covers the work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def describe(dev: torch.device) -> str:
    """The device a measurement ran on: for the card, its name and power
    limit as `nvidia-smi --query-gpu=name,power.limit` prints them (a card
    may be set below its maximum power and then runs slower); else the
    device's name."""
    if dev.type != "cuda":
        return str(dev)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def self_device_us(event) -> float:
    """A torch.profiler key average's own device time in microseconds
    (the attribute's name changed between torch releases)."""
    return getattr(event, "self_device_time_total", 0.0) or getattr(event, "self_cuda_time_total", 0.0)


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
        kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
                and self_device_us(e) > 0 and any(nm in e.key for nm in names)]
        if kern:
            return sum(self_device_us(e) / e.count for e in kern) / 1e3
    return None
