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


def card_line() -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them (a card
    may be set below its maximum power and then runs slower); raises where
    nvidia-smi cannot read them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def describe(dev: torch.device) -> str:
    """The device a measurement ran on: for the card, `card_line()`; else
    the device's name."""
    if dev.type != "cuda":
        return str(dev)
    try:
        return card_line()
    except (OSError, subprocess.CalledProcessError, IndexError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"
