"""Checkpoint / resume of the SAGA solver state (twin of
sgdnet_tpu/utils/checkpoint.py).

The full warm-start state (coefficients, intercept, per-sample gradient
memory, gradient average) is written to one .npz so that a path fit can be
resumed in another process: `save_state(path, fit.final_state)`, then
`load_state(path)` and `fit(..., warm_state=state)`.

The format is the JAX package's, field for field: the arrays `w`,
`intercept`, `g_mem`, `g_sum`, `g_sum_intercept` and `__meta__` (JSON as
UTF-8 bytes) in one `np.savez_compressed` file, so a checkpoint written by
either package loads in the other.
"""

from __future__ import annotations

import json

import numpy as np

from sgdnet_tpu_torch.solver.saga import SagaState
from sgdnet_tpu_torch.utils.convert import STATE_FIELDS, state_from_numpy


def save_state(path: str, state: SagaState, meta: dict | None = None) -> None:
    """Serialize a SagaState (+ JSON-able metadata) to `path` (.npz); the
    tensors are copied to the host as they are, bit for bit."""
    arrays = {f: getattr(state, f).detach().cpu().numpy() for f in STATE_FIELDS}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode("utf-8"), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_state(path: str, dtype=None, device=None):
    """(SagaState on `device`, meta) from `path`; `device=None` means the
    card (RuntimeError without one).  `dtype` (float32 / float64, numpy or
    torch) converts every field; None keeps the file's."""
    with np.load(path) as z:
        state = state_from_numpy(z, dtype=dtype, device=device)
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode("utf-8"))
    return state, meta
