"""Carry solver states and fits across from the JAX package, as numpy.

`state_from_numpy` takes the five SagaState fields in the format
`sgdnet_tpu.utils.checkpoint.save_state` writes (a mapping or an open
.npz with keys w, intercept, g_mem, g_sum, g_sum_intercept), so a JAX
`final_state` resumes here as `warm_state`.  `fit_from_numpy` rebuilds an
`SgdnetFit` from the JAX fit's arrays, so `predict` / `score` can be held
against the JAX package on the same fit.  Nothing of JAX is imported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sgdnet_tpu_torch.api.fit import SgdnetFit, as_torch_dtype
from sgdnet_tpu_torch.solver.saga import SagaState

STATE_FIELDS = SagaState._fields


def state_from_numpy(d, dtype=None, device="cpu") -> SagaState:
    """SagaState from a mapping of the five fields (numpy arrays)."""
    missing = [f for f in STATE_FIELDS if f not in d]
    if missing:
        raise KeyError(f"state is missing fields {missing}")
    conv = {} if dtype is None else {"dtype": as_torch_dtype(dtype)}
    return SagaState(*(torch.as_tensor(np.asarray(d[f])).to(device=device, **conv) for f in STATE_FIELDS))


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
