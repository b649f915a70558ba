"""Batched SAGA engine on torch tensors (twin of sgdnet_tpu/solver/saga.py,
dense branches).

Minibatch SAGA: each step takes B samples, computes their linear
predictors and the rank-B coefficient update as two matrix products, and
applies the L2 decay and the prox densely once per step:

    w <- prox_{gamma*l1}( w (1 - gamma*l2) - gamma * ((1/B) sum_b (g_b - m_b) x_b + g_sum) )

The JAX package runs the whole path as one compiled program; here the
path is a host loop over lambdas and epochs with one scalar sync per epoch
for the convergence test.  Two hand-written kernels replace the plain step
where their gates allow: K1 (solver/epoch_kernel.py) runs a whole epoch
per launch, K2 (solver/head_kernel.py) fuses the dense part of a step.

Sampling is pluggable: `fit_path` takes `order_fn(lam_idx, attempt,
epoch) -> LongTensor`, a permutation of the T = n_pad/B blocks (block
sampling) or of the n_pad rows (permutation sampling).  The default draws
`torch.randperm` from a `torch.Generator` seeded from (seed, lam_idx,
attempt, epoch), so like the JAX package's folded keys an epoch's order
does not depend on how many epochs came before it.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from sgdnet_tpu_torch.families.families import Family
from sgdnet_tpu_torch.penalties.penalties import Penalty
from sgdnet_tpu_torch.solver import head_kernel


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


def _dataset_loss(x, y, weights, w, intercept, family: Family, offs=None, report: bool = True):
    """Weighted total loss over the dataset (0-d tensor).  `report=True`
    uses the family's exact reporting loss, `report=False` the solver loss."""
    lp = x @ w.T + intercept
    if offs is not None:
        lp = lp + offs
    loss_fn = family.loss_report if report else family.loss
    return torch.sum(loss_fn(lp, y) * weights)


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
    start), and the Hopper `supported` check (f32/bf16 head, shapes, and a
    family the kernel has a gradient for — never poisson)."""
    return (
        config.use_pallas
        and config.sampling == "block"
        and head_kernel.supported(config.batch_size, x.shape[1], family.n_classes, x.dtype, family.name)
    )


def _make_step(x, y, weights, w_total: float, family: Family, penalty: Penalty, config: SolverConfig,
               offs=None, pf=None, box=None):
    """Return `step(state, scal, sel) -> state`.  The returned state shares
    the input's g_mem, which the step updates in place (the epoch owns a
    private copy)."""
    B = config.batch_size

    def step_pallas(state: SagaState, scal: _Scalars, sel):
        yb = _rows(y, sel, B)
        wb = _rows(weights, sel, B)
        g_mem_b = _rows(state.g_mem, sel, B)
        lp_extra = state.intercept.expand(B, family.n_classes)
        if offs is not None:
            lp_extra = lp_extra + _rows(offs, sel, B)
        g, corr = head_kernel.fused_head_step_at(x, sel, state.w, lp_extra, yb, g_mem_b, wb, family.name)
        g = g.to(state.w.dtype)
        g_change = g - g_mem_b
        _set_rows(state.g_mem, sel, g, B)
        return _finish_step(state, scal, wb, g_change, corr.to(state.w.dtype))

    def step_xla(state: SagaState, scal: _Scalars, sel):
        yb = _rows(y, sel, B)
        wb = _rows(weights, sel, B)
        xb = _rows(x, sel, B)
        lp = xb @ state.w.T + state.intercept
        if offs is not None:
            lp = lp + _rows(offs, sel, B)
        g = family.gradient(lp, yb) * wb[:, None]  # weighted; pad rows -> 0
        g_change = g - _rows(state.g_mem, sel, B)  # (B, k)
        _set_rows(state.g_mem, sel, g, B)
        corr = g_change.T @ xb
        return _finish_step(state, scal, wb, g_change, corr)

    def _finish_step(state: SagaState, scal: _Scalars, wb, g_change, corr):
        bw = torch.clamp(torch.sum(wb), min=1e-12)
        sum_gc = torch.sum(g_change, dim=0)  # (k,)
        grad_est = corr / bw + state.g_sum
        # per-feature penalty factors scale both the L2 decay and the prox
        # threshold (glmnet `penalty.factor`); pf is (p,), broadcast over k
        if pf is None:
            w_half = state.w * scal.shrink - scal.gamma * grad_est
            w_new = penalty.prox(w_half, scal.gl1)
        else:
            w_half = state.w * (1.0 - scal.gl2 * pf) - scal.gamma * grad_est
            w_new = penalty.prox(w_half, scal.gl1 * pf)
        if box is not None:
            # box constraints: project onto [lo, hi] after the prox
            w_new = torch.minimum(torch.maximum(w_new, box[0]), box[1])
        g_sum = state.g_sum + corr / w_total
        if config.fit_intercept:
            # intercept step with the same SAGA estimator: fresh batch-mean
            # gradient change + stale average
            grad_est_b = sum_gc / bw + state.g_sum_intercept
            intercept = state.intercept - scal.gdecay * grad_est_b
            g_sum_i = state.g_sum_intercept + sum_gc / w_total
        else:
            intercept = state.intercept
            g_sum_i = state.g_sum_intercept
        return SagaState(w_new, intercept, state.g_mem, g_sum, g_sum_i)

    return step_pallas if uses_head_kernel(x, family, config) else step_xla


def _refresh_g_sum(x, w_total: float, state: SagaState) -> SagaState:
    """Exact recompute g_sum = (1/W) X^T g_mem (one pass over x)."""
    g_sum = (state.g_mem.T @ x) / w_total
    col_sum = torch.sum(state.g_mem, dim=0)
    return state._replace(g_sum=g_sum, g_sum_intercept=col_sum / w_total)


def _make_epoch(x, y, weights, w_total: float, family, penalty, config: SolverConfig, offs=None, pf=None, box=None):
    n_pad = y.shape[0]
    B = config.batch_size
    if n_pad % B != 0:
        raise ValueError("n_pad must be a multiple of batch_size")
    n_batches = n_pad // B
    step = _make_step(x, y, weights, w_total, family, penalty, config, offs=offs, pf=pf, box=box)
    every = config.g_sum_refresh_every
    dt = np_dtype(x.dtype)

    def epoch(state: SagaState, order, gamma, l1, l2, it=None) -> SagaState:
        scal = _scalars(gamma, l1, l2, config.intercept_decay, dt)
        state = state._replace(g_mem=state.g_mem.clone())
        if config.sampling == "block":
            # contiguous blocks in random order (rows pre-shuffled by fit())
            sels = [int(s) * B for s in order.tolist()]
        else:
            idx = order.to(x.device).reshape(n_batches, B)
            sels = list(idx)
        for sel in sels:
            state = step(state, scal, sel)
        if config.g_sum_refresh and (every <= 1 or it is None or (it + 1) % every == 0):
            state = _refresh_g_sum(x, w_total, state)
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


def default_order_fn(seed: int, n: int):
    """Permutations of range(n), one per (lam_idx, attempt, epoch), each
    from its own `torch.Generator` seeded from those indices and `seed`."""

    def order_fn(lam_idx: int, attempt: int, epoch: int) -> torch.Tensor:
        s = np.random.SeedSequence([seed, lam_idx, attempt, epoch]).generate_state(1, np.uint64)[0]
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
):
    """Fit the whole lambda path with warm starts.

    State (w, intercept, g_mem, g_sum) carries from one lambda to the next;
    each lambda runs epochs until max|dw| <= tol * max|w| or max_iter, with
    the divergence guard and (config.step_backoff) the halved-step retries
    of the JAX package.  `gammas`, `l1s`, `l2s` are per-lambda sequences
    and `tol` a scalar; they are rounded to x's dtype.  Returns
    (final state, total epochs, PathResults of numpy arrays).
    """
    with _fp32_matmul():
        return _fit_path_impl(x, y, weights, gammas, l1s, l2s, tol, state0, family, penalty, config,
                              offs, pf, box, seed, order_fn)


def _fit_path_impl(x, y, weights, gammas, l1s, l2s, tol, state0, family, penalty, config, offs, pf, box,
                   seed, order_fn):
    dt = np_dtype(x.dtype)
    gammas = np.asarray(gammas, dt).reshape(-1)
    l1s = np.asarray(l1s, dt).reshape(-1)
    l2s = np.asarray(l2s, dt).reshape(-1)
    tol = dt(tol)
    n_pad = y.shape[0]
    B = config.batch_size
    w_total = float(torch.clamp(torch.sum(weights), min=1e-12))
    k, p = state0.w.shape
    if order_fn is None:
        blocks = config.sampling == "block" or config.use_epoch_kernel
        order_fn = default_order_fn(seed, n_pad // B if blocks else n_pad)

    if config.use_epoch_kernel:
        # small-problem path: state rides in the kernel's padded layout
        # across the whole path; pads stay zero, so the convergence check
        # below works unchanged on the padded tiles
        from sgdnet_tpu_torch.solver import epoch_kernel as ek

        epoch_fn = ek.build_epoch(x, y, weights, w_total, family, penalty, config, offs=offs, pf=pf)
        state0 = ek.pad_state(state0, p)

        def unpad(s):
            return ek.unpad_state(s, k, p)

        def intercept_of(s):
            return s.ivec[0]
    else:
        epoch_fn = _make_epoch(x, y, weights, w_total, family, penalty, config, offs=offs, pf=pf, box=box)

        def unpad(s):
            return s

        def intercept_of(s):
            return s.intercept

    max_iter = config.max_iter

    def fit_one(state, gamma, l1, l2, lam_idx, attempt, t_conv):
        # t_conv: the relative-change criterion is blind to the step size,
        # so retries pass tol scaled by their step multiplier
        losses = np.full((max_iter if config.debug else 0,), np.nan, dt)
        it, done, rel = 0, False, dt(0.0)
        w_prev = state.w
        while not done and it < max_iter:
            state = epoch_fn(state, order_fn(lam_idx, attempt, it), gamma, l1, l2, it=it)
            stats = torch.stack([
                torch.max(torch.abs(state.w - w_prev)),
                torch.max(torch.abs(state.w)),
                torch.all(torch.isfinite(intercept_of(state))).to(state.w.dtype),
            ]).tolist()
            max_change, max_size = dt(stats[0]), dt(stats[1])
            # divergence guard: a non-finite epoch is terminal; report it as
            # not converged (final_change = inf), never as converged
            finite = bool(np.isfinite(max_size) and np.isfinite(max_change) and stats[2] == 1.0)
            all_zero = max_size == 0.0 and max_change == 0.0
            no_change = finite and max_size != 0.0 and max_change <= t_conv * max_size
            done = all_zero or no_change or not finite
            if finite and max_size > 0.0:
                rel = max_change / max(max_size, dt(1e-30))
            else:
                rel = dt(0.0) if finite else dt(np.inf)
            if config.debug:
                s = unpad(state)
                losses[it] = float(_dataset_loss(x, y, weights, s.w, s.intercept, family, offs=offs)) / w_total
            w_prev = state.w
            it += 1
        if np.isinf(rel):  # a divergence exit must read as NOT converged
            it = max_iter
        return state, it, losses, rel

    # poisson: the exact reporting loss differs from the clamped solver loss
    track_clamp_gap = type(family).loss_report is not Family.loss_report

    def _dev(st, report=True):
        s = unpad(st)
        return 2.0 * _dataset_loss(x, y, weights, s.w, s.intercept, family, offs=offs, report=report)

    def _lmean(st):
        s = unpad(st)
        return _dataset_loss(x, y, weights, s.w, s.intercept, family, offs=offs, report=False) / w_total

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
        if config.step_backoff:
            best, bk, att_it = fit_one_robust(state, gamma, l1, l2, i, bk)
            state, it, losses, rel, code = best["state"], best["it"], best["losses"], best["rel"], best["code"]
            # every attempt diverged: the finite warm start is kept, with an
            # inf solver deviance
            dev_solver = np.inf if best["lm"] is None else float(2.0 * w_total * best["lm"])
            if track_clamp_gap:
                dev = float(_dev(state))  # exact reporting deviance (poisson)
                gap = dev - dev_solver
            else:
                dev, gap = dev_solver, 0.0
        else:
            state, it, losses, rel = fit_one(state, gamma, l1, l2, i, 0, tol)
            code = it >= max_iter
            dev = _dev(state)
            att_it = it
            gap = float(dev - _dev(state, report=False)) if track_clamp_gap else 0.0
        s_real = unpad(state)
        outs["w"].append(s_real.w)
        outs["intercept"].append(s_real.intercept)
        outs["deviance"].append(float(dev))
        outs["n_epochs"].append(it)
        outs["return_codes"].append(int(code))
        outs["losses"].append(losses)
        outs["clamp_gap"].append(gap)
        outs["final_change"].append(float(rel))
        n_iter += att_it

    results = PathResults(
        w=torch.stack(outs["w"]).cpu().numpy(),
        intercept=torch.stack(outs["intercept"]).cpu().numpy(),
        deviance=np.asarray(outs["deviance"], dt),
        n_epochs=np.asarray(outs["n_epochs"], np.int32),
        return_codes=np.asarray(outs["return_codes"], np.int32),
        losses=np.stack(outs["losses"]).astype(dt),
        clamp_gap=np.asarray(outs["clamp_gap"], dt),
        final_change=np.asarray(outs["final_change"], dt),
    )
    return unpad(state), n_iter, results
