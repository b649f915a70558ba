"""SAGA step sizes, serial and minibatch (twin of sgdnet_tpu/solver/stepsize.py).

Serial step: gamma = 1 / (2L + min(L, 2n*l2)) with
L = (max_i ||x_i||^2 + fit_intercept) * L_scaling + l2.  For B > 1 the
expected-smoothness batch constant (Gazagnadou, Gower & Salmon 2019)

    L_B = (n (B-1)) / (B (n-1)) * L_full  +  (n - B) / (B (n-1)) * L_max

interpolates between L_max (B = 1) and L_full = lambda_max(X^T X) / n.
"""

from __future__ import annotations

import numpy as np
import torch


def power_iteration_sq_norm(x, n_iter: int = 30, seed: int = 0, v0: torch.Tensor | None = None,
                            x_center_scaled: torch.Tensor | None = None):
    """lambda_max(X^T X) by power iteration; x dense (n, p), PaddedCSR or
    HybridCSR.  With `x_center_scaled` (the sparse standardized path) the
    operator is X - 1 c^T, applied without densifying.

    The start vector is standard normal from a `torch.Generator` seeded
    with `seed`, unless `v0` is given (the lockstep tests inject the JAX
    package's start vector).  Returns a 0-d tensor on x's device.
    """
    from sgdnet_tpu_torch.core.sparse import HybridCSR, PaddedCSR

    if isinstance(x, (PaddedCSR, HybridCSR)):
        p = x.n_cols
        # a bf16 or int8 head must not drag the iteration vectors below f32
        dtype = torch.promote_types(x.values.dtype if isinstance(x, PaddedCSR) else x.head.dtype, torch.float32)
        device = x.tail.values.device if isinstance(x, HybridCSR) else x.values.device
        c = None if x_center_scaled is None else x_center_scaled.to(dtype)

        def matvec(v):
            xv = x.matmul_dense(v.reshape(-1, 1).to(dtype))[:, 0]
            if c is not None:
                xv = xv - torch.dot(c.to(xv.dtype), v.to(xv.dtype))
            ytx = x.matvec_T(xv)
            if c is not None:
                ytx = ytx - torch.sum(xv) * c.to(xv.dtype)
            return ytx.to(dtype)

    else:
        p, dtype, device = x.shape[1], x.dtype, x.device

        def matvec(v):
            return x.T @ (x @ v)

    if v0 is None:
        gen = torch.Generator().manual_seed(seed)
        v0 = torch.randn(p, generator=gen, dtype=torch.float64)
    v = v0.to(device=device, dtype=dtype)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(n_iter):
        w = matvec(v)
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
    return torch.dot(matvec(v), v)  # Rayleigh quotient ~ top eigenvalue


def saga_step_sizes(
    max_sq_norm: float,
    mean_sq_norm_top,  # lambda_max(X^T X) / n  (None -> serial formula)
    l2_path,  # per-lambda L2 strengths
    n_samples: float,
    batch_size: int,
    fit_intercept: bool,
    L_scaling: float,
) -> np.ndarray:
    """Per-lambda step sizes in float64 (host numpy)."""
    fi = 1.0 if fit_intercept else 0.0
    l2_path = np.asarray(l2_path, dtype=np.float64)
    n = float(n_samples)
    B = float(batch_size)

    L_max = (float(max_sq_norm) + fi) * L_scaling + l2_path
    if batch_size <= 1:
        mu_n = 2.0 * n * l2_path
        return 1.0 / (2.0 * L_max + np.minimum(L_max, mu_n))

    L_full = (float(mean_sq_norm_top) + fi) * L_scaling + l2_path
    denom = max(B * (n - 1.0), 1.0)
    L_B = (n * (B - 1.0)) / denom * L_full + max(n - B, 0.0) / denom * L_max
    L_B = np.maximum(L_B, L_full)  # guard tiny-n edge cases
    mu_n = 2.0 * n * l2_path / B
    return 1.0 / (2.0 * L_B + np.minimum(L_B, mu_n))
