"""Where the port's entry points put their tensors.

`device=None` means the CUDA card: an entry point never carries on on the
CPU because no card was found.  A CPU run asks for it by name
(`device="cpu"`), as the tests do.
"""

from __future__ import annotations

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
