"""Core numeric helpers on torch tensors (twin of sgdnet_tpu/core/linalg.py).

The same population-SD and zero-variance-guard semantics as the JAX
package, vectorized over whole matrices.
"""

from __future__ import annotations

import math

import torch


def logsumexp(x: torch.Tensor, axis: int = -1, keepdims: bool = False) -> torch.Tensor:
    """Numerically-stable log(sum(exp(x))) with a non-finite-max guard."""
    x_max = torch.amax(x, dim=axis, keepdim=True)
    x_max = torch.where(torch.isfinite(x_max), x_max, torch.zeros_like(x_max))
    out = torch.log(torch.sum(torch.exp(x - x_max), dim=axis, keepdim=True)) + x_max
    return out if keepdims else out.squeeze(axis)


def logspace(start: float, stop: float, num: int, dtype=torch.float64) -> torch.Tensor:
    """Log-spaced sequence from `start` to `stop` inclusive."""
    return torch.exp(torch.linspace(math.log(start), math.log(stop), num, dtype=dtype))


def column_mean(x: torch.Tensor) -> torch.Tensor:
    """Per-column arithmetic mean."""
    return torch.mean(x, dim=0)


def column_sd(x: torch.Tensor, center: torch.Tensor | None = None) -> torch.Tensor:
    """Per-column population SD; zero-variance columns get SD 1.0."""
    if center is None:
        center = column_mean(x)
    var = torch.mean((x - center) ** 2, dim=0)
    return torch.where(var == 0.0, torch.ones_like(var), torch.sqrt(var))


def standardize(x: torch.Tensor, center=None, scale=None):
    """Center/scale columns; returns (x_std, center, scale)."""
    if center is None:
        center = column_mean(x)
    if scale is None:
        scale = column_sd(x, center)
    return (x - center) / scale, center, scale


def clamp(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Clamp to [lo, hi]."""
    return torch.clamp(x, lo, hi)


def proportions(y_codes: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Class proportions from integer class codes."""
    onehot = y_codes.reshape(-1, 1) == torch.arange(n_classes, device=y_codes.device).reshape(1, -1)
    return torch.mean(onehot.to(torch.float64), dim=0)


def soft_threshold(x: torch.Tensor, a) -> torch.Tensor:
    """Elementwise soft-thresholding prox of the L1 norm."""
    return torch.sign(x) * torch.clamp(torch.abs(x) - a, min=0.0)
