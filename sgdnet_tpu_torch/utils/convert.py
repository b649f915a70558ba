"""Carry solver states and fits across from the JAX package, as numpy.

`state_from_numpy` takes the five SagaState fields in the format
`sgdnet_tpu.utils.checkpoint.save_state` writes (a mapping or an open
.npz with keys w, intercept, g_mem, g_sum, g_sum_intercept), so a JAX
`final_state` resumes here as `warm_state`.  `fit_from_numpy` rebuilds an
`SgdnetFit` from the JAX fit's arrays, so `predict` / `score` can be held
against the JAX package on the same fit.  `layout_from_jax` takes a JAX
PaddedCSR / HybridCSR / BlockCOO / HeadNNZ, read through numpy, into the
port's layout, so both packages can be fed the same design.  Nothing of
JAX is imported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sgdnet_tpu_torch.api.fit import SgdnetFit, as_torch_dtype
from sgdnet_tpu_torch.core.sparse import BlockCOO, HeadNNZ, HybridCSR, PaddedCSR
from sgdnet_tpu_torch.solver.saga import SagaState
from sgdnet_tpu_torch.utils.device import resolve_device

STATE_FIELDS = SagaState._fields


def state_from_numpy(d, dtype=None, device=None) -> SagaState:
    """SagaState from a mapping of the five fields (numpy arrays), on
    `device` (None: the card, RuntimeError without one)."""
    missing = [f for f in STATE_FIELDS if f not in d]
    if missing:
        raise KeyError(f"state is missing fields {missing}")
    conv = {} if dtype is None else {"dtype": as_torch_dtype(dtype)}
    dev = resolve_device(device)
    return SagaState(*(torch.as_tensor(np.asarray(d[f])).to(device=dev, **conv) for f in STATE_FIELDS))


def fit_from_numpy(**fields) -> SgdnetFit:
    """SgdnetFit from its array and scalar fields (a0, beta, lambda_,
    dev_ratio, df, nulldev, npasses, return_codes, alpha, family, ...);
    fields not given take empty defaults."""
    names = {f.name for f in dataclasses.fields(SgdnetFit)}
    unknown = set(fields) - names
    if unknown:
        raise TypeError(f"unknown SgdnetFit fields {sorted(unknown)}")
    beta = np.asarray(fields["beta"], dtype=np.float64)
    defaults = dict(
        dfmat=None, nulldev=float("nan"), npasses=0, return_codes=np.zeros(beta.shape[0], np.int32),
        alpha=1.0, classnames=None, grouped=False, nobs=0,
        df=(np.abs(beta) > 0).any(axis=1).sum(axis=1),
        dev_ratio=np.full(beta.shape[0], np.nan),
    )
    args = {**defaults, **fields}
    for f in ("a0", "beta", "lambda_", "dev_ratio"):
        args[f] = np.asarray(args[f], dtype=np.float64)
    return SgdnetFit(**args)


def _tensor(a, device) -> torch.Tensor:
    """A tensor from an array; bfloat16 (numpy's ml_dtypes type) by its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a), device=device)


def layout_from_jax(layout, device=None):
    """The port's layout holding the same arrays as a JAX package layout
    (dispatched on the class name: PaddedCSR, BlockCOO, HeadNNZ or
    HybridCSR; a JAX BlockCOO's true-entry counts are recovered from its
    (0, 0, 0) pad entries), on `device` (None: the card, RuntimeError
    without one; a HeadNNZ stays on the host)."""
    kind = type(layout).__name__
    if kind != "HeadNNZ":
        device = resolve_device(device)
    if kind == "PaddedCSR":
        return PaddedCSR(_tensor(layout.indices, device), _tensor(layout.values, device),
                         _tensor(layout.nnz, device), int(layout.n_rows), int(layout.n_cols))
    if kind == "BlockCOO":
        return BlockCOO.from_arrays(np.asarray(layout.rows), np.asarray(layout.cols), np.asarray(layout.vals),
                                    int(layout.batch), int(layout.n_cols), device=device)
    if kind == "HeadNNZ":
        return HeadNNZ(*(np.asarray(a) for a in (layout.rows, layout.cols, layout.vals, layout.q0)),
                       int(layout.n_rows), int(layout.n_head))
    if kind == "HybridCSR":
        head = layout.head
        head = layout_from_jax(head) if type(head).__name__ == "HeadNNZ" else _tensor(head, device)
        return HybridCSR(
            head, layout_from_jax(layout.tail, device), int(layout.n_rows), int(layout.n_cols),
            blk_tail=None if layout.blk_tail is None else layout_from_jax(layout.blk_tail, device),
            head_scale=None if layout.head_scale is None else _tensor(layout.head_scale, device),
        )
    raise TypeError(f"not a JAX package layout: {kind}")
