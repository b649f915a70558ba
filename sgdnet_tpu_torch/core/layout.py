"""Hybrid-layout planner (twin of sgdnet_tpu/core/layout.py): pick the
dense-head width from a measured cost model of the card.

The dense-head / sparse-tail split (core/sparse.py HybridCSR) has one free
parameter that matters, the head width D:

  * the head streams  (2 + 1/refresh) * n_pad * D * itemsize  bytes an
    epoch through device memory at the card's sustained dense-load rate
    (STREAM_BYTES_PER_S), whatever share of those values are nonzeros;
  * every tail entry costs TAIL_OPS_PER_ENTRY element-ops a step (forward
    gather + scatter, outer gather + scatter) at ELEM_OP_S each.

A column belongs in the head when its nonzero count exceeds

    break_even = passes * n_pad * itemsize / stream / (4 * elem_op_s),

and the optimal D is where the column-popularity curve crosses that line,
capped by the head memory budget.  `plan_layout` computes it exactly from
the column counts; `fit(hybrid_max_head="auto")` calls it.  The formula and
defaults are the JAX package's; the two constants are the H100's own.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: sustained dense-load rate: one f32 `torch.sum` over the whole 106496 x
#: 16384 bf16 head, the ceiling of the probe P3 (chip_smoke.py phase 12,
#: which prints this constant beside its run's rate): 3.489 GB in 1.1443 ms
#: on an NVIDIA H100 80GB HBM3, 700.00 W.  A bf16 rate, taken for every
#: head itemsize: the port's int8 head products run far below it, so the
#: model's head_ms is not yet the int8 head's time on the card
STREAM_BYTES_PER_S = 3.05e12
#: device time of one tail element-op: K3 + K4's device time (0.0034 +
#: 0.0045 ms) on the largest block of the 100000 x 47000 sparse binomial's
#: tail, 40994 entries, over 4 x its entries (chip_smoke.py phase 7; phase
#: 13 prints this constant beside its run's value), on an NVIDIA H100 80GB
#: HBM3, 700.00 W.  Device time, not the host-bound time a call: the model
#: has no fixed per-step term
ELEM_OP_S = 4.78e-11
#: element-ops per tail entry per step: fwd gather + fwd scatter + outer
#: gather + outer scatter
TAIL_OPS_PER_ENTRY = 4


@dataclass(frozen=True)
class LayoutPlan:
    """Planner output: the head width plus the predicted per-epoch costs."""

    max_head: int  # recommended head width D (multiple of 128)
    head_ms: float  # predicted head stream time per epoch
    tail_ms: float  # predicted tail element-op time per epoch
    coverage: float  # fraction of nonzeros landing in the head
    head_bytes: int  # resident head size at n_pad rows
    break_even_nnz: float  # column-count threshold that set D


def plan_layout(
    x,
    *,
    batch_size: int = 8192,
    head_itemsize: int = 1,
    g_sum_refresh_every: int = 8,
    hbm_budget: float = 12e9,
    stream_bytes_per_s: float = STREAM_BYTES_PER_S,
    elem_op_s: float = ELEM_OP_S,
    max_head_cap: int | None = None,
) -> LayoutPlan:
    """Choose the hybrid head width for a scipy sparse matrix.

    `head_itemsize` is the storage itemsize of the head (1 for int8, 2 for
    bfloat16, 4 for float32: pass what you will pass as
    `hybrid_head_dtype`).  `hbm_budget` caps the resident head bytes.
    """
    x = x.tocsr()
    n, p = x.shape
    n_pad = ((n + batch_size - 1) // batch_size) * batch_size
    col_nnz = np.bincount(x.indices, minlength=p)
    order = np.argsort(-col_nnz, kind="stable")
    sorted_nnz = col_nnz[order].astype(np.int64)
    total = max(int(sorted_nnz.sum()), 1)

    passes = 2.0 + 1.0 / max(g_sum_refresh_every, 1)
    head_cost_per_col = passes * n_pad * head_itemsize / stream_bytes_per_s
    tail_cost_per_entry = TAIL_OPS_PER_ENTRY * elem_op_s
    # a column pays head_cost_per_col dense or c_nnz * tail_cost_per_entry
    # sparse: it moves into the head while its count clears the break-even
    break_even = head_cost_per_col / tail_cost_per_entry
    d = int(np.searchsorted(-sorted_nnz, -break_even, side="right"))

    budget_cols = int(hbm_budget // max(n_pad * head_itemsize, 1))
    d = min(d, budget_cols)
    if max_head_cap is not None:
        d = min(d, max_head_cap)
    d = min(max(d, 1), p)
    d = min(((d + 127) // 128) * 128, p)  # lane-align (pad up, then cap)

    cum = np.cumsum(sorted_nnz)
    head_nnz = int(cum[d - 1]) if d >= 1 else 0
    tail_nnz = total - head_nnz
    head_ms = passes * n_pad * d * head_itemsize / stream_bytes_per_s * 1e3
    tail_ms = tail_nnz * tail_cost_per_entry * 1e3
    return LayoutPlan(
        max_head=d,
        head_ms=head_ms,
        tail_ms=tail_ms,
        coverage=head_nnz / total,
        head_bytes=n_pad * d * head_itemsize,
        break_even_nnz=break_even,
    )
