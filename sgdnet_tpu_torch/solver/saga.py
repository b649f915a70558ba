"""Batched SAGA engine on torch tensors (twin of sgdnet_tpu/solver/saga.py).

Minibatch SAGA: each step takes B samples, computes their linear
predictors and the rank-B coefficient update as two matrix products, and
applies the L2 decay and the prox densely once per step:

    w <- prox_{gamma*l1}( w (1 - gamma*l2) - gamma * ((1/B) sum_b (g_b - m_b) x_b + g_sum) )

The JAX package runs the whole path as one compiled program; here the
path is a host loop over lambdas and epochs with one scalar sync per epoch
for the convergence test.  Two hand-written kernels replace the plain step
where their gates allow: K1 (solver/epoch_kernel.py) runs a chunk of a
lambda attempt's epochs per launch, with the convergence test on the card
(one sync a chunk); K2 (solver/head_kernel.py) fuses the dense part of a
step, and K6 (solver/finish_kernel.py) its finish: the SAGA estimate, the
prox and the g_sum and intercept updates.

The design matrix is dense, a PaddedCSR (the 'densify' or 'gather'
`sparse_mode`) or a HybridCSR (core/sparse.py): a dense head driven by
matrix products (bf16 heads multiply in bf16, int8 heads fold their
scales into w, both summing in the fit's dtype) and a sparse tail.  Under
block sampling the tail's ops go through the BlockCOO kernels K3 / K4
(solver/tail_kernel.py).  Standardized sparse data stays scale-only; the
centering rides as the correction term `xc` (zero on head columns).

Sampling is pluggable: `fit_path` takes `order_fn(lam_idx, attempt,
epoch) -> LongTensor`, a permutation of the T = n_pad/B blocks (block
sampling) or of the n_pad rows (permutation sampling).  The default draws
`torch.randperm` from a `torch.Generator` seeded from (seed, lam_idx,
attempt, epoch), so like the JAX package's folded keys an epoch's order
does not depend on how many epochs came before it.

Data-parallel fits (`SolverConfig.mesh`, parallel/dist.py): x, y, the
weights and g_mem hold the rank's rows, w, the intercept and g_sum are
replicated.  A step reduces one packed buffer [sum wb, sum gc, corr] with
one all-reduce (the JAX package's three psums), the g_sum refresh one
[g_sum, col_sum], the dataset loss one scalar; everything else (the prox,
the box, the stop test, the backoff, the divergence guard) is computed
from reduced or replicated values, so every rank takes the same branches.
Each rank draws its own orders (its rank in the seed, as the JAX package
folds the axis index into the epoch key).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from sgdnet_tpu_torch.core.sparse import HybridCSR, PaddedCSR
from sgdnet_tpu_torch.families.families import Family
from sgdnet_tpu_torch.penalties.penalties import Penalty
from sgdnet_tpu_torch.solver import epoch_kernel as ek
from sgdnet_tpu_torch.solver import finish_kernel, head_kernel, tail_kernel
from sgdnet_tpu_torch.utils import profiling


class SagaState(NamedTuple):
    """Warm-started solver state carried across the lambda path."""

    w: torch.Tensor  # (k, p) coefficients
    intercept: torch.Tensor  # (k,)
    g_mem: torch.Tensor  # (n_pad, k) per-sample gradient memory
    g_sum: torch.Tensor  # (k, p) gradient average
    g_sum_intercept: torch.Tensor  # (k,)


@dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration."""

    batch_size: int = 32
    max_iter: int = 1000
    fit_intercept: bool = True
    #: learning-rate multiplier of the intercept step
    intercept_decay: float = 1.0
    #: recompute g_sum exactly from g_mem at epoch ends (kills float32
    #: accumulation drift in the gradient average)
    g_sum_refresh: bool = True
    #: refresh cadence in epochs (1 = every epoch)
    g_sum_refresh_every: int = 1
    #: 'densify' or 'gather' (PaddedCSR x only)
    sparse_mode: str = "densify"
    #: record the epoch loss trace
    debug: bool = False
    #: use the fused head-step kernel K2 for the step (block sampling,
    #: f32/bf16, supported shapes and family — gated in _make_step)
    use_pallas: bool = False
    #: "permutation" (fresh row permutation per epoch) or "block" (fixed
    #: contiguous blocks in random order; fit() pre-shuffles rows once)
    sampling: str = "permutation"
    #: retry a lambda that hits max_iter at a halved step, keeping the
    #: attempt with the lower penalized objective
    step_backoff: bool = True
    #: run whole epochs with the epoch kernel K1 (solver/epoch_kernel.py)
    use_epoch_kernel: bool = False
    #: BlockCOO tail ops through K3 / K4, the refresh's tail sum through K5
    #: (solver/tail_kernel.py) and the step's finish through K6
    #: (solver/finish_kernel.py); False runs the plain torch versions on any
    #: device (the comparison path)
    use_tail_kernel: bool = True
    #: data-parallel execution (the JAX package's `axis_name`): a
    #: parallel.dist.Mesh whose ranks each hold a shard of the rows; its
    #: `all_reduce(tensor, what)` sums in place over the ranks
    mesh: object = None


def np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def init_state(n_pad: int, n_features: int, n_classes: int, dtype, device=None) -> SagaState:
    z = dict(dtype=dtype, device=device)
    return SagaState(
        w=torch.zeros((n_classes, n_features), **z),
        intercept=torch.zeros((n_classes,), **z),
        g_mem=torch.zeros((n_pad, n_classes), **z),
        g_sum=torch.zeros((n_classes, n_features), **z),
        g_sum_intercept=torch.zeros((n_classes,), **z),
    )


# ---------------------------------------------------------------------------
# batched linear algebra on the design matrix
# ---------------------------------------------------------------------------
#
# A batch selection `sel` is either a Python int block start (block
# sampling: a contiguous slice, no copy) or an index tensor (a slice of the
# per-epoch row permutation: a gather).


def _rows(a, sel, B: int):
    """B rows of `a` by contiguous start or index vector."""
    if isinstance(sel, int):
        return a[sel : sel + B]
    return a[sel]


def _set_rows(a, sel, vals, B: int) -> None:
    """Write B rows of `a` in place (only ever the epoch's own g_mem copy)."""
    if isinstance(sel, int):
        a[sel : sel + B] = vals
    else:
        a[sel] = vals


def _csr_batch_predict(csr: PaddedCSR, w, sel, B: int):
    ib = _rows(csr.indices, sel, B).long()  # (B, L)
    vb = _rows(csr.values, sel, B)
    return torch.einsum("bl,blk->bk", vb.to(w.dtype), w.T[ib])


def _csr_batch_outer(csr: PaddedCSR, g_change, sel, B: int):
    """Tail/CSR scatter part of the rank-B update: (k, p)."""
    ib = _rows(csr.indices, sel, B).long()
    vb = _rows(csr.values, sel, B)
    k = g_change.shape[1]
    contrib = (vb[:, :, None].to(g_change.dtype) * g_change[:, None, :]).reshape(-1, k)
    corr_t = torch.zeros((csr.n_cols, k), dtype=g_change.dtype, device=g_change.device)
    return corr_t.index_add_(0, ib.reshape(-1), contrib).T


def _use_blk_tail(x, sel, B: int) -> bool:
    """The BlockCOO tail ops (K3 / K4) apply when the batch is a block start
    of the size the tail was packed for."""
    return isinstance(x, HybridCSR) and x.blk_tail is not None and isinstance(sel, int) and x.blk_tail.batch == B


def _tail_predict(x: HybridCSR, w, sel, B: int, kernels: bool = True, fwd=None, **epilogue):
    """The tail's part of the block's linear predictors; on the BlockCOO
    path K3 also adds the `epilogue` operands (base, intercept, offs) in
    its launch, through the step's bound launcher `fwd` where it has one."""
    if _use_blk_tail(x, sel, B):
        if kernels and fwd is not None:
            return fwd(sel // B, w.contiguous(), **epilogue)
        fn = tail_kernel.coo_tail_forward if kernels else tail_kernel.coo_tail_forward_reference
        return fn(x.blk_tail, sel // B, w.contiguous(), **epilogue)
    return tail_kernel.add_epilogue(_csr_batch_predict(x.tail, w, sel, B), **epilogue)


def _tail_outer(x: HybridCSR, g_change, sel, B: int, kernels: bool = True):
    if _use_blk_tail(x, sel, B):
        fn = tail_kernel.coo_tail_outer if kernels else tail_kernel.coo_tail_outer_reference
        return fn(x.blk_tail, sel // B, g_change.contiguous())
    return _csr_batch_outer(x.tail, g_change, sel, B)


def _batch_predict(x, xc, w, sel, B: int, kernels: bool = True):
    """Linear predictors of the selected rows, (B, k), with the centering
    correction lp -= w . xc."""
    if isinstance(x, HybridCSR):
        d = x.n_head
        lp = x.head_forward(_rows(x.head, sel, B), w[:, :d], w.dtype) + _tail_predict(x, w, sel, B, kernels)
    elif isinstance(x, PaddedCSR):
        lp = _csr_batch_predict(x, w, sel, B)
    else:
        lp = _rows(x, sel, B) @ w.T
    if xc is not None:
        lp = lp - w @ xc.to(w.dtype)
    return lp


def _batch_outer(x, xc, g_change, sel, B: int, sparse_mode: str, kernels: bool = True):
    """corr[k, j] = sum_b g_change[b, k] x_eff[b, j], x_eff the centered,
    scaled row: the rank-B coefficient update."""
    if isinstance(x, HybridCSR):
        d = x.n_head
        corr = _tail_outer(x, g_change, sel, B, kernels)
        corr[:, :d] += x.head_backward(_rows(x.head, sel, B), g_change, g_change.dtype)
    elif isinstance(x, PaddedCSR):
        if sparse_mode == "densify":
            ib = _rows(x.indices, sel, B).long()
            vb = _rows(x.values, sel, B)
            rows = torch.arange(B, device=ib.device)[:, None].expand(ib.shape)
            xb = torch.zeros((B, x.n_cols), dtype=vb.dtype, device=vb.device).index_put_((rows, ib), vb,
                                                                                         accumulate=True)
            corr = g_change.T @ xb.to(g_change.dtype)
        else:
            corr = _csr_batch_outer(x, g_change, sel, B)
    else:
        corr = g_change.T @ _rows(x, sel, B)
    if xc is not None:
        corr = corr - torch.outer(torch.sum(g_change, dim=0), xc.to(corr.dtype))
    return corr


def _linear_predictor(x, xc, w, intercept, offs_b, sel, B: int, kernels: bool = True, fwd=None):
    """((x_b w^T + intercept) + offs_b) of the selected rows, (B, k), the
    centering term between the first two adds where `xc` is given.  On the
    BlockCOO path without `xc`, K3 takes the head's product as its base and
    assembles the whole sum in its launch (same adds, same order)."""
    if xc is None and _use_blk_tail(x, sel, B):
        base = x.head_forward(_rows(x.head, sel, B), w[:, : x.n_head], w.dtype)
        return _tail_predict(x, w, sel, B, kernels, fwd, base=base, intercept=intercept, offs=offs_b)
    lp = _batch_predict(x, xc, w, sel, B, kernels) + intercept
    return lp if offs_b is None else lp + offs_b


def _dataset_loss(x, y, weights, w, intercept, family: Family, offs=None, report: bool = True, xc=None,
                  block: int = 1024, kernels: bool = True, mesh=None):
    """Weighted total loss over the dataset (0-d tensor).  `report=True`
    uses the family's exact reporting loss, `report=False` the solver loss.
    A sparse layout is read in row blocks of `block` (halved until it
    divides n_pad), so no head-wide temporary is made.  Under a mesh the
    ranks' totals are summed by one all-reduce."""
    loss_fn = family.loss_report if report else family.loss
    if not isinstance(x, (PaddedCSR, HybridCSR)):
        lp = x @ w.T + intercept
        if offs is not None:
            lp = lp + offs
        total = torch.sum(loss_fn(lp, y) * weights)
    else:
        n_pad = y.shape[0]
        block = min(block, n_pad)
        while n_pad % block != 0:
            block = max(block // 2, 1)
        total = torch.zeros((), dtype=w.dtype, device=w.device)
        for start in range(0, n_pad, block):
            lp = _linear_predictor(x, xc, w, intercept, None if offs is None else offs[start : start + block],
                                   start, block, kernels)
            total = total + torch.sum(loss_fn(lp, y[start : start + block]) * weights[start : start + block])
    if mesh is not None:
        mesh.all_reduce(total.reshape(1), "loss")
    return total


class _Scalars(NamedTuple):
    """Per-attempt step scalars, rounded to the fit's dtype as the JAX
    package computes them (Python floats of dtype-exact values)."""

    gamma: float
    shrink: float  # 1 - gamma * l2
    gl1: float  # gamma * l1
    gl2: float  # gamma * l2
    gdecay: float  # gamma * intercept_decay


def _scalars(gamma, l1, l2, decay: float, dt) -> _Scalars:
    g, a, b = dt(gamma), dt(l1), dt(l2)
    gl2 = g * b
    return _Scalars(float(g), float(dt(1.0) - gl2), float(g * a), float(gl2), float(g * dt(decay)))


# ---------------------------------------------------------------------------
# one batched SAGA step / epoch
# ---------------------------------------------------------------------------


def uses_head_kernel(x, family: Family, config: SolverConfig) -> bool:
    """The K2 gate: `use_pallas`, block sampling (the kernel takes a block
    start), a dense design or a HybridCSR head (never a PaddedCSR), and
    the Hopper `supported` check on the head's width and type (f32/bf16;
    an int8 head takes the plain step) and the family (never poisson)."""
    if isinstance(x, PaddedCSR):
        return False
    head = x.head if isinstance(x, HybridCSR) else x
    return (
        config.use_pallas
        and config.sampling == "block"
        and head_kernel.supported(config.batch_size, head.shape[1], family.n_classes, head.dtype, family.name)
    )


def _make_step(x, y, weights, w_total: float, family: Family, penalty: Penalty, config: SolverConfig,
               offs=None, pf=None, box=None, xc=None):
    """Return `step(state, scal, sel) -> state`.  The returned state shares
    the input's g_mem, which the step updates in place (the epoch owns a
    private copy).  On K6's route (`finish_kernel.uses_finish_kernel`) the
    finish is one call of a launcher bound here (`step.finish`), which
    takes a state its `prepare` passed."""
    B = config.batch_size
    hybrid = isinstance(x, HybridCSR)
    kernels = config.use_tail_kernel
    mesh = config.mesh
    reduce = None
    if mesh is not None:
        # the step's one collective: [sum wb, sum gc (k), corr (k, p)] in one
        # buffer, written through its views, reduced in place and read
        # before the next step writes it again
        k, p = family.n_classes, x.shape[1]
        red = torch.empty((1 + k + k * p,), dtype=y.dtype, device=y.device)
        red_bw, red_gc, red_corr = red[0], red[1 : 1 + k], red[1 + k :].view(k, p)

        def reduce(wb, g_change, corr):
            torch.sum(wb, dim=0, out=red_bw)
            torch.sum(g_change, dim=0, out=red_gc)
            red_corr.copy_(corr)
            mesh.all_reduce(red, "step")
            return torch.clamp(red_bw, min=1e-12), red_gc, red_corr
    # K3 bound once for the step's blocks (its checks run here, not a call)
    fwd = None
    if kernels and hybrid and x.blk_tail is not None and x.blk_tail.batch == B and x.blk_tail.device.type == "cuda":
        if x.blk_tail.n_cols != x.n_cols or tuple(y.shape) != (x.blk_tail.n_blocks * B, family.n_classes):
            raise ValueError("the BlockCOO tail does not match the design and the response")
        fwd = tail_kernel.ForwardLauncher(x.blk_tail, family.n_classes, y.dtype)
    pallas = uses_head_kernel(x, family, config)
    # K6 bound once for the step (its checks run here, not a call); on
    # step_pallas's hybrid route it also merges the head's corr
    finish = None
    if finish_kernel.uses_finish_kernel(y.device, y.dtype, penalty, config, xc):
        finish = finish_kernel.FinishLauncher(B, family.n_classes, x.shape[1], x.n_head if pallas and hybrid else 0,
                                              y.dtype, y.device, penalty, w_total, config.fit_intercept, pf=pf,
                                              box=box, weights=weights)

    def step_pallas(state: SagaState, scal: _Scalars, sel):
        # K2 takes the FULL head and the block start, and lp_extra carries
        # everything but the head's product: the tail forward, the
        # intercept, the offsets and the centering term (a block's rows
        # are views: slicing launches nothing)
        offs_b = None if offs is None else _rows(offs, sel, B)
        with profiling.span("sgdnet.step.tail_forward"):
            if hybrid:
                lp_extra = _tail_predict(x, state.w, sel, B, kernels, fwd, intercept=state.intercept, offs=offs_b)
            else:
                lp_extra = state.intercept.expand(B, family.n_classes)
                if offs_b is not None:
                    lp_extra = lp_extra + offs_b
            if xc is not None:
                lp_extra = lp_extra - state.w @ xc.to(state.w.dtype)
        with profiling.span("sgdnet.step.head"):
            yb = _rows(y, sel, B)
            wb = _rows(weights, sel, B)
            g_mem_b = _rows(state.g_mem, sel, B)
            head, w_head = (x.head, state.w[:, : x.n_head]) if hybrid else (x, state.w)
            g, corr_head = head_kernel.fused_head_step_at(head, sel, w_head, lp_extra, yb, g_mem_b, wb, family.name)
            g = g.to(state.w.dtype)
            g_change = g - g_mem_b
            _set_rows(state.g_mem, sel, g, B)
        with profiling.span("sgdnet.step.tail_outer"):
            if hybrid:
                corr = _tail_outer(x, g_change, sel, B, kernels)
                corr_head = corr_head.to(corr.dtype)
                if finish is None:  # K6 merges the head's corr itself
                    corr[:, : x.n_head] += corr_head
                    corr_head = None
                if xc is not None:  # xc is zero on head columns
                    corr = corr - torch.outer(torch.sum(g_change, dim=0), xc.to(corr.dtype))
            else:
                corr, corr_head = corr_head.to(state.w.dtype), None
        return _finish_step(state, scal, wb, g_change, corr, corr_head)

    def step_xla(state: SagaState, scal: _Scalars, sel):
        yb = _rows(y, sel, B)
        wb = _rows(weights, sel, B)
        lp = _linear_predictor(x, xc, state.w, state.intercept, None if offs is None else _rows(offs, sel, B), sel,
                               B, kernels, fwd)
        g = family.gradient(lp, yb) * wb[:, None]  # weighted; pad rows -> 0
        g_change = g - _rows(state.g_mem, sel, B)  # (B, k)
        _set_rows(state.g_mem, sel, g, B)
        corr = _batch_outer(x, xc, g_change, sel, B, config.sparse_mode, kernels)
        return _finish_step(state, scal, wb, g_change, corr)

    def _finish_step(state: SagaState, scal: _Scalars, wb, g_change, corr, corr_head=None):
        with profiling.span("sgdnet.step.finish"):
            if finish is not None:
                # corr comes transposed from a PaddedCSR's scatter
                return finish(state, scal, wb, g_change, corr.contiguous(), corr_head)
            return finish_kernel.finish_step_reference(state, scal, wb, g_change, corr, penalty, w_total,
                                                       config.fit_intercept, pf=pf, box=box, reduce=reduce)

    step = step_pallas if pallas else step_xla
    #: the bound K3 and K6 launchers (None off their routes): the epoch
    #: reads their streams once and passes its input state through K6's
    #: `prepare`
    step.tail_forward = fwd
    step.finish = finish
    return step


def _refresh_g_sum(x, w_total: float, state: SagaState, xc=None, mesh=None, *, kernels: bool) -> SagaState:
    """Exact recompute g_sum = (1/W) X_eff^T g_mem (one pass over x); under
    a mesh the ranks' [g_sum, col_sum] are summed by one all-reduce.  With
    `kernels` (the config's `use_tail_kernel`), a HybridCSR with a BlockCOO
    tail sums its tail by K5 (`tail_kernel.coo_tail_sum`, in a fixed order;
    its twin on the CPU), which raises where that tail does not cover
    g_mem's rows or x's columns; else `matvec_T` scatters the tail."""
    with profiling.span("sgdnet.refresh", device=state.g_mem.device):
        bt = x.blk_tail if isinstance(x, HybridCSR) else None
        if kernels and bt is not None:
            g_sum = x.matvec_T(state.g_mem, tail_kernel.coo_tail_sum(bt, state.g_mem)).T.contiguous() / w_total
        elif isinstance(x, (PaddedCSR, HybridCSR)):
            g_sum = x.matvec_T(state.g_mem).T.contiguous() / w_total
        else:
            g_sum = (state.g_mem.T @ x) / w_total
        col_sum = torch.sum(state.g_mem, dim=0)
        if xc is not None:
            g_sum = g_sum - torch.outer(col_sum, xc.to(g_sum.dtype)) / w_total
        if mesh is not None:
            k, p = g_sum.shape
            buf = torch.cat([g_sum.reshape(-1), col_sum])
            mesh.all_reduce(buf, "refresh")
            g_sum, col_sum = buf[: k * p].view(k, p), buf[k * p :]
        return state._replace(g_sum=g_sum, g_sum_intercept=col_sum / w_total)


def _make_epoch(x, y, weights, w_total: float, family, penalty, config: SolverConfig, offs=None, pf=None, box=None,
                xc=None):
    n_pad = y.shape[0]
    B = config.batch_size
    if n_pad % B != 0:
        raise ValueError("n_pad must be a multiple of batch_size")
    n_batches = n_pad // B
    step = _make_step(x, y, weights, w_total, family, penalty, config, offs=offs, pf=pf, box=box, xc=xc)
    every = config.g_sum_refresh_every
    dt = np_dtype(y.dtype)

    def epoch(state: SagaState, order, gamma, l1, l2, it=None) -> SagaState:
        with profiling.span("sgdnet.epoch", epoch=it):
            scal = _scalars(gamma, l1, l2, config.intercept_decay, dt)
            state = state._replace(g_mem=state.g_mem.clone())
            # a wrapper of the step may carry only `tail_forward`
            finish = getattr(step, "finish", None)
            for launcher in (step.tail_forward, finish):
                if launcher is not None:
                    launcher.refresh_stream()
            if finish is not None:
                state = finish.prepare(state)
            if config.sampling == "block":
                # contiguous blocks in random order (rows pre-shuffled by fit())
                sels = [int(s) * B for s in order.tolist()]
            else:
                idx = order.to(y.device).reshape(n_batches, B)
                sels = list(idx)
            for sel in sels:
                with profiling.span("sgdnet.step"):
                    state = step(state, scal, sel)
            if config.g_sum_refresh and (every <= 1 or it is None or (it + 1) % every == 0):
                state = _refresh_g_sum(x, w_total, state, xc, config.mesh, kernels=config.use_tail_kernel)
            return state

    return epoch


# ---------------------------------------------------------------------------
# the path: warm-started loop over the lambda sequence
# ---------------------------------------------------------------------------


class PathResults(NamedTuple):
    w: np.ndarray  # (n_lambda, k, p) on the standardized scale
    intercept: np.ndarray  # (n_lambda, k)
    deviance: np.ndarray  # (n_lambda,)
    n_epochs: np.ndarray  # (n_lambda,) int32
    return_codes: np.ndarray  # (n_lambda,) int32: 0 converged, 1 hit max_iter
    losses: np.ndarray  # (n_lambda, max_iter) epoch losses (debug; else (n_lambda, 0))
    clamp_gap: np.ndarray  # (n_lambda,) exact-vs-solver loss gap (poisson; else 0)
    #: relative change max|dw|/max|w| at the last epoch (inf on divergence)
    final_change: np.ndarray  # (n_lambda,)
    #: K1 launches (chunks of epochs) over all attempts; 0 off the K1 path
    n_chunks: np.ndarray  # (n_lambda,) int32


@dataclass
class PathCounts:
    """Operator accounting summed over the fit_path calls given this object
    (fit's `stats`): the epochs each (lambda index along the whole path,
    attempt) ran, and the host's reads of device values."""

    epochs_by_attempt: dict = field(default_factory=dict)
    host_syncs: int = 0


def order_count(config: SolverConfig, n_pad: int) -> int:
    """What an order permutes: the n_pad / B blocks (block sampling, and
    K1, which takes block orders) or the n_pad rows."""
    return n_pad // config.batch_size if config.sampling == "block" or config.use_epoch_kernel else n_pad


def default_order_fn(seed: int, n: int, salt: int | None = None, rank: int | None = None):
    """Permutations of range(n), one per (lam_idx, attempt, epoch), each
    from its own `torch.Generator` seeded from those indices and `seed`;
    a caller that tells its fit_path calls apart by a `salt` (screening's
    λ groups, KKT rounds and retries) gets orders seeded from it too, as
    the JAX package folds it into its key.  A mesh's rank draws orders
    seeded from its `rank` as well, so each shard has its own."""
    head = [seed] if salt is None else [seed, salt]
    tail = [] if rank is None else [rank]

    def order_fn(lam_idx: int, attempt: int, epoch: int) -> torch.Tensor:
        s = np.random.SeedSequence(head + [lam_idx, attempt, epoch] + tail).generate_state(1, np.uint64)[0]
        return torch.randperm(n, generator=torch.Generator().manual_seed(int(s)))

    return order_fn


@contextlib.contextmanager
def _fp32_matmul():
    """Within the block CUDA float32 products run in true FP32 (TF32 off,
    the JAX package's "highest" precision); the previous setting is
    restored on exit, so nothing changes globally."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def fit_path(
    x,
    y,
    weights,
    gammas,
    l1s,
    l2s,
    tol,
    state0: SagaState,
    family: Family,
    penalty: Penalty,
    config: SolverConfig,
    offs=None,
    pf=None,
    box=None,
    seed: int = 0,
    order_fn=None,
    xc=None,
    counts: PathCounts | None = None,
    lam0: int = 0,
):
    """Fit the whole lambda path with warm starts.

    State (w, intercept, g_mem, g_sum) carries from one lambda to the next;
    each lambda runs epochs until max|dw| <= tol * max|w| or max_iter, with
    the divergence guard and (config.step_backoff) the halved-step retries
    of the JAX package.  `gammas`, `l1s`, `l2s` are per-lambda sequences
    and `tol` a scalar; they are rounded to the fit's dtype (y's).  `x` is
    dense, a PaddedCSR or a HybridCSR, with `xc` its centering term.
    `counts` (a PathCounts) adds this call's epochs and host reads, its
    lambdas indexed from `lam0`.
    Returns (final state, total epochs, PathResults of numpy arrays).
    """
    with _fp32_matmul():
        return _fit_path_impl(x, y, weights, gammas, l1s, l2s, tol, state0, family, penalty, config,
                              offs, pf, box, seed, order_fn, xc, PathCounts() if counts is None else counts, lam0)


def _fit_path_impl(x, y, weights, gammas, l1s, l2s, tol, state0, family, penalty, config, offs, pf, box,
                   seed, order_fn, xc, counts, lam0):
    dt = np_dtype(y.dtype)
    gammas = np.asarray(gammas, dt).reshape(-1)
    l1s = np.asarray(l1s, dt).reshape(-1)
    l2s = np.asarray(l2s, dt).reshape(-1)
    tol = dt(tol)
    n_pad = y.shape[0]
    mesh = config.mesh
    if mesh is not None and config.use_epoch_kernel:
        raise ValueError("the epoch kernel runs a whole epoch on one device: a meshed fit takes the step path")
    w_sum = torch.sum(weights).reshape(1)
    if mesh is not None:
        mesh.all_reduce(w_sum, "setup")
    w_total = float(torch.clamp(w_sum, min=1e-12))
    counts.host_syncs += 1
    k, p = state0.w.shape
    if order_fn is None:
        n_orders = order_count(config, n_pad)
        order_fn = default_order_fn(seed, n_orders) if mesh is None else default_order_fn(seed, n_orders,
                                                                                             rank=mesh.rank)

    if config.use_epoch_kernel:
        # small-problem path: state rides in the kernel's padded layout
        # across the whole path; pads stay zero, so the convergence check
        # below works unchanged on the padded tiles
        epochs_fn = ek.build_epochs(x, y, weights, w_total, family, penalty, config, offs=offs, pf=pf)
        state0 = ek.pad_state(state0, p)

        def unpad(s):
            return ek.unpad_state(s, k, p)
    else:
        epoch_fn = _make_epoch(x, y, weights, w_total, family, penalty, config, offs=offs, pf=pf, box=box, xc=xc)

        def unpad(s):
            return s

    max_iter = config.max_iter

    def _loss(st):
        s = unpad(st)
        counts.host_syncs += 1
        return float(_dataset_loss(x, y, weights, s.w, s.intercept, family, offs=offs, xc=xc,
                                   kernels=config.use_tail_kernel, mesh=mesh)) / w_total

    n_chunks = [0]

    def fit_one_chunks(state, gamma, l1, l2, lam_idx, attempt, t_conv):
        # K1: the attempt's epochs in chunks of one launch each, growing
        # from CHUNK_FIRST to CHUNK_CAP epochs (one epoch a chunk under
        # debug, for the loss trace); the kernel stops at the epoch where
        # the rule below would, and one sync a chunk reads its statistics;
        # a chunk returns a new state, so the warm start stays as it was for
        # fit_one_robust's retries
        losses = np.full((max_iter if config.debug else 0,), np.nan, dt)

        def draw(it0, n):
            return torch.stack([torch.as_tensor(order_fn(lam_idx, attempt, it0 + e)) for e in range(n)])

        it, done, rel = 0, False, dt(0.0)
        size = 1 if config.debug else ek.CHUNK_FIRST
        orders = draw(0, min(size, max_iter))
        while not done and it < max_iter:
            n = orders.shape[0]
            state, stats = epochs_fn(state, orders, gamma, l1, l2, it0=it, t_conv=float(t_conv))
            # the next chunk's orders are drawn while this one runs (used
            # only if it runs to its end)
            size = min(2 * size, ek.CHUNK_CAP) if not config.debug else 1
            if it + n < max_iter:
                orders = draw(it + n, min(size, max_iter - it - n))
            ran, max_change, max_size, finite = stats.tolist()
            counts.host_syncs += 1
            done, rel = ek.stop_rule(max_change, max_size, finite == 1.0, t_conv, dt)
            if ran < n and not done:
                # the next orders were drawn for epoch it + n onwards
                raise RuntimeError(f"epoch kernel stopped after {int(ran)} of {n} epochs where the host's rule "
                                   "would go on")
            if config.debug:
                losses[it] = _loss(state)
            it += int(ran)
            n_chunks[0] += 1
        return state, it, losses, rel

    def fit_one_epochs(state, gamma, l1, l2, lam_idx, attempt, t_conv):
        losses = np.full((max_iter if config.debug else 0,), np.nan, dt)
        it, done, rel = 0, False, dt(0.0)
        w_prev = state.w
        while not done and it < max_iter:
            state = epoch_fn(state, order_fn(lam_idx, attempt, it), gamma, l1, l2, it=it)
            max_change, max_size, finite = ek.epoch_stats(state.w, w_prev, state.intercept)
            counts.host_syncs += 1
            # divergence guard: a non-finite epoch is terminal; report it as
            # not converged (final_change = inf), never as converged
            done, rel = ek.stop_rule(max_change, max_size, finite == 1.0, t_conv, dt)
            if config.debug:
                losses[it] = _loss(state)
            w_prev = state.w
            it += 1
        return state, it, losses, rel

    def fit_one(state, gamma, l1, l2, lam_idx, attempt, t_conv):
        # t_conv: the relative-change criterion is blind to the step size,
        # so retries pass tol scaled by their step multiplier
        run = fit_one_chunks if config.use_epoch_kernel else fit_one_epochs
        state, it, losses, rel = run(state, gamma, l1, l2, lam_idx, attempt, t_conv)
        key = (lam0 + lam_idx, attempt)
        counts.epochs_by_attempt[key] = counts.epochs_by_attempt.get(key, 0) + it
        if np.isinf(rel):  # a divergence exit must read as NOT converged
            it = max_iter
        return state, it, losses, rel

    # poisson: the exact reporting loss differs from the clamped solver loss
    track_clamp_gap = type(family).loss_report is not Family.loss_report

    def _dev(st, report=True):
        s = unpad(st)
        return 2.0 * _dataset_loss(x, y, weights, s.w, s.intercept, family, offs=offs, report=report, xc=xc,
                                   kernels=config.use_tail_kernel, mesh=mesh)

    def _lmean(st):
        s = unpad(st)
        return _dataset_loss(x, y, weights, s.w, s.intercept, family, offs=offs, report=False, xc=xc,
                             kernels=config.use_tail_kernel, mesh=mesh) / w_total

    def _objective(st, lmean, l1, l2):
        """Penalized objective: mean loss + l1*P1(w) + l2/2*||w||_pf^2 —
        attempts are compared on this, not on deviance."""
        s = unpad(st)
        sq = s.w * s.w
        if pf is not None:
            sq = sq * pf
        return lmean + float(l1) * penalty.value(s.w, pf) + 0.5 * float(l2) * torch.sum(sq)

    def fit_one_robust(state_in, gamma, l1, l2, lam_idx, bk):
        """fit_one with oscillation recovery: a code-1 exit is retried from
        the same warm start at half the step; a second halving only for a
        suspicious exit (final change far above tol, or divergence).  The
        attempt with the lowest penalized objective is kept; the halving
        sticks for deeper lambdas only when the winning retry converged."""
        best = dict(state=state_in, it=max_iter, losses=np.full((max_iter if config.debug else 0,), np.nan, dt),
                    rel=dt(np.inf), code=True, obj=dt(np.inf), lm=None)
        bk_out, tot, attempt, stop = bk, 0, 0, False
        while not stop and attempt < 3:
            gmul = bk * dt(0.5) ** attempt
            state_new, it_new, losses_new, rel_new = fit_one(
                state_in, gamma * gmul, l1, l2, lam_idx, attempt, tol * max(gmul, dt(0.25))
            )
            code_new = it_new >= max_iter
            lm_new = _lmean(state_new)
            obj_new = dt(float(_objective(state_new, lm_new, l1, l2)))
            counts.host_syncs += 1
            if not np.isfinite(obj_new):  # a diverged attempt never wins
                obj_new = dt(np.inf)
            better = obj_new < best["obj"]
            if better:
                best.update(state=state_new, it=it_new, losses=losses_new, rel=rel_new, code=code_new,
                            obj=obj_new, lm=lm_new)
            if attempt > 0 and better and not code_new:
                bk_out = gmul
            suspicious = code_new and rel_new > 10.0 * tol
            retry = code_new if attempt == 0 else suspicious
            attempt += 1
            stop = not retry
            tot += it_new
        return best, bk_out, tot

    n_lambda = len(gammas)
    state, n_iter, bk = state0, 0, dt(1.0)
    outs = {f: [] for f in PathResults._fields}
    for i in range(n_lambda):
        gamma, l1, l2 = gammas[i], l1s[i], l2s[i]
        chunks_before = n_chunks[0]
        if config.step_backoff:
            best, bk, att_it = fit_one_robust(state, gamma, l1, l2, i, bk)
            state, it, losses, rel, code = best["state"], best["it"], best["losses"], best["rel"], best["code"]
            # every attempt diverged: the finite warm start is kept, with an
            # inf solver deviance
            dev_solver = np.inf if best["lm"] is None else float(2.0 * w_total * best["lm"])
            counts.host_syncs += best["lm"] is not None
            if track_clamp_gap:
                dev = float(_dev(state))  # exact reporting deviance (poisson)
                counts.host_syncs += 1
                gap = dev - dev_solver
            else:
                dev, gap = dev_solver, 0.0
        else:
            state, it, losses, rel = fit_one(state, gamma, l1, l2, i, 0, tol)
            code = it >= max_iter
            dev = _dev(state)
            att_it = it
            gap = float(dev - _dev(state, report=False)) if track_clamp_gap else 0.0
            counts.host_syncs += 1 + track_clamp_gap  # the gap's read, and the deviance's below
        s_real = unpad(state)
        outs["w"].append(s_real.w)
        outs["intercept"].append(s_real.intercept)
        outs["deviance"].append(float(dev))
        outs["n_epochs"].append(it)
        outs["return_codes"].append(int(code))
        outs["losses"].append(losses)
        outs["clamp_gap"].append(gap)
        outs["final_change"].append(float(rel))
        outs["n_chunks"].append(n_chunks[0] - chunks_before)
        n_iter += att_it

    counts.host_syncs += 2  # the path's coefficients and intercepts
    results = PathResults(
        w=torch.stack(outs["w"]).cpu().numpy(),
        intercept=torch.stack(outs["intercept"]).cpu().numpy(),
        deviance=np.asarray(outs["deviance"], dt),
        n_epochs=np.asarray(outs["n_epochs"], np.int32),
        return_codes=np.asarray(outs["return_codes"], np.int32),
        losses=np.stack(outs["losses"]).astype(dt),
        clamp_gap=np.asarray(outs["clamp_gap"], dt),
        final_change=np.asarray(outs["final_change"], dt),
        n_chunks=np.asarray(outs["n_chunks"], np.int32),
    )
    return unpad(state), n_iter, results


def backoff_path(run_one, bk: int, tol: float, account):
    """The step backoff of a call of fit_path over a part of the path (a
    screening group, a `lambda_chunk` chunk), sticky along the path:
    `run_one(gmul, try_)` returns fit_path's (state, epochs, PathResults)
    at gammas times gmul.  A suspicious result (a lambda that hit max_iter
    with a final change above 10 x tol) is refit at half the step, twice at
    most, and the refit is kept only if it is better (fewer lambdas at
    max_iter, then a lower total deviance); the halving then sticks.
    `account(out)` sees every attempt.  Returns (the kept attempt, bk)."""

    def suspicious(res):
        return bool(np.any((res.return_codes == 1) & (res.final_change > 10.0 * tol)))

    def better(a, b):
        ca, cb = int((a.return_codes == 1).sum()), int((b.return_codes == 1).sum())
        if ca != cb:
            return ca < cb
        return float(np.sum(a.deviance)) < float(np.sum(b.deviance))

    best = run_one(0.5 ** bk, 0)
    account(best)
    for try_ in (1, 2):
        if not suspicious(best[2]):
            break
        cand = run_one(0.5 ** (bk + 1), try_)
        account(cand)
        if not better(cand[2], best[2]):
            break  # slow but stable: the original trajectory stays
        best, bk = cand, bk + 1
    return best, bk
