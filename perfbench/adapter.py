"""Every call the benchmark makes into the system under test, the PyTorch
and CUDA port `sgdnet_tpu_torch`, is in this file.

The epoch cells drive the solver's epoch (`solver.saga._make_epoch`)
over the layout `core.sparse` builds on the card
(`HybridCSR.split_columns`, the tail packed by `BlockCOO.from_padded`),
the entry the port's own bench drives; the path cells call
`sgdnet_tpu_torch.fit` on the host's scipy matrix, as a user does.
"""

from __future__ import annotations

import contextlib
from dataclasses import replace

import numpy as np
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad_rows(x, n_pad: int):
    """The scipy CSR x with empty rows appended up to n_pad."""
    import scipy.sparse as sp

    extra = n_pad - x.shape[0]
    indptr = np.concatenate([x.indptr, np.full(extra, x.indptr[-1], x.indptr.dtype)])
    return sp.csr_matrix((x.data, x.indices, indptr), shape=(n_pad, x.shape[1]))


@contextlib.contextmanager
def fp32_products():
    """float32 products in true FP32 (TF32 off), as the port's fit runs them."""
    from sgdnet_tpu_torch.solver import saga

    with saga._fp32_matmul():
        yield


class Epochs:
    """One configuration's epoch as the solver runs it: the layout on the
    device, the response (n_pad, k) and row weights, and `_make_epoch`'s
    epoch under block sampling with the fused head step (K2) and the
    BlockCOO tail kernels (K3 / K4)."""

    def __init__(self, x, y, k: int, layout: dict, solver: dict, device):
        from sgdnet_tpu_torch.core.sparse import BlockCOO, HybridCSR, as_head_dtype
        from sgdnet_tpu_torch.families import get_family
        from sgdnet_tpu_torch.penalties import select_penalty
        from sgdnet_tpu_torch.solver import saga

        n, p = x.shape
        B = layout["batch_size"]
        self.n_pad = _round_up(n, B)
        xh, self.perm = HybridCSR.split_columns(
            _pad_rows(x, self.n_pad), coverage=layout["coverage"], max_head=layout["max_head"],
            head_dtype=as_head_dtype(layout["head_dtype"]), device=device)
        self.x = replace(xh, blk_tail=BlockCOO.from_padded(xh.tail, B))
        if k == 1:
            yv = torch.as_tensor(np.asarray(y, np.float32)).reshape(-1, 1)
        else:
            yv = torch.nn.functional.one_hot(torch.as_tensor(np.asarray(y), dtype=torch.long), k).float()
        pad = self.n_pad - n
        self.y = torch.cat([yv, torch.zeros((pad, k))]).to(device)
        self.weights = torch.cat([torch.ones(n), torch.zeros(pad)]).to(device)
        self.k, self.p, self.device = k, p, device
        family = get_family(solver["family"], n_classes=k)
        penalty = select_penalty(solver["alpha"], solver["family"])
        self.config = saga.SolverConfig(
            batch_size=B, fit_intercept=True, sparse_mode="gather", intercept_decay=solver["intercept_decay"],
            use_pallas=True, sampling="block", g_sum_refresh_every=layout["g_sum_refresh_every"],
            use_tail_kernel=True)
        if not saga.uses_head_kernel(self.x, family, self.config):
            raise RuntimeError("the fused head step (K2) does not take this layout")
        self._epoch = saga._make_epoch(self.x, self.y, self.weights, float(n), family, penalty, self.config)
        self.gamma = solver["gamma"]
        self.l1 = solver["lambda"]

    @property
    def n_blocks(self) -> int:
        return self.n_pad // self.config.batch_size

    def init_state(self):
        from sgdnet_tpu_torch.solver import saga

        return saga.init_state(self.n_pad, self.p, self.k, torch.float32, self.device)

    def epoch(self, state, order: torch.Tensor, it: int):
        """Epoch `it` (from 0) over the blocks in `order`; returns the state."""
        return self._epoch(state, order, self.gamma, self.l1, 0.0, it=it)

    def snapshot(self, state) -> dict:
        """The state on the host, float64, its columns in the input's order."""
        out = {}
        for name in ("w", "g_sum"):
            a = getattr(state, name).double().cpu().numpy()
            o = np.empty_like(a)
            o[:, self.perm] = a
            out[name] = o
        for name in ("intercept", "g_mem", "g_sum_intercept"):
            out[name] = getattr(state, name).double().cpu().numpy()
        return out

    @staticmethod
    def finite(state) -> bool:
        return bool(torch.isfinite(state.w).all()) and bool(torch.isfinite(state.intercept).all())


@contextlib.contextmanager
def _epoch_log():
    """{(lambda index, attempt): epochs}, counted as the path draws each
    epoch's block order (`saga.default_order_fn`'s order_fn, called once an
    epoch by the path's epoch loop)."""
    from sgdnet_tpu_torch.solver import saga

    log, make = {}, saga.default_order_fn

    def counting(*a, **kw):
        order_fn = make(*a, **kw)

        def counted(lam_idx, attempt, epoch):
            key = (int(lam_idx), int(attempt))
            log[key] = max(log.get(key, 0), int(epoch) + 1)
            return order_fn(lam_idx, attempt, epoch)

        return counted

    saga.default_order_fn = counting
    try:
        yield log
    finally:
        saga.default_order_fn = make


def fit(x, y, settings: dict, seed: int, device) -> dict:
    """One call of `sgdnet_tpu_torch.fit` on the scipy design x; returns the
    path (lambdas, beta (n_lambda, k, p) and a0 in the original units), its
    epochs an attempt (`epoch_log`) and the fit's own accounting
    (`stats["wall_time_s"]`: the lambda loop alone; `stats["epochs"]`)."""
    import sgdnet_tpu_torch as st

    with _epoch_log() as log:
        f = st.fit(x, y, device=device, seed=seed, **settings)
    return {"lambda": np.asarray(f.lambda_), "beta": np.asarray(f.beta), "a0": np.asarray(f.a0),
            "path_s": float(f.stats["wall_time_s"]), "epochs": int(f.stats["epochs"]), "epoch_log": log,
            "head_kernel": bool(f.stats["head_kernel"]), "tail_kernel": bool(f.stats["tail_kernel"])}
