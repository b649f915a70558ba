"""Sequential strong-rule screening for the lambda path (twin of
sgdnet_tpu/solver/screening.py).

Moving from lambda_{k-1} to lambda_k, feature j is discarded when

    score_j  =  || (1/W) X_eff^T g ||  <  pf_j * (2*l1_k - l1_{k-1})

with g the per-sample gradients at the lambda_{k-1} solution, the norm over
classes and pf_j the penalty factor (pf_j = 0: always active).  After a fit
on the screened set the full KKT conditions are checked, and every
violating feature is added back and the lambdas refitted until they are
clean: the result is exact, not heuristic.

As in the JAX package, the active set is a dense, fully centred (n_pad, K)
column subset of any layout (a dense gather, a PaddedCSR scatter through a
col -> slot table, a HybridCSR head gather plus tail scatter), K a
power-of-two bucket that ends in an all-zero dummy column; consecutive
lambdas are screened and fitted in groups that share one active set (the
union strong rule at the group's smallest lambda), one fit_path call and
one batched KKT check a group.  On the card a subset goes to K2 wherever
`uses_head_kernel` admits it and to K1 wherever fit's gate admitted the
full problem, as the TPU path does.  Each fit_path call draws its batch
orders from `saga.default_order_fn(seed, n, salt)`, the salt that of the
JAX package's folded key: li*7 + kkt_round + 1000*try.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from sgdnet_tpu_torch.core.sparse import HybridCSR, PaddedCSR
from sgdnet_tpu_torch.solver import saga
from sgdnet_tpu_torch.solver.saga import SagaState, SolverConfig, _refresh_g_sum, fit_path, order_count


def _bucket(size: int, minimum: int = 128) -> int:
    b = minimum
    while b < size:
        b *= 2
    return b


def _full_lp(x, xc, w, dtype, b=None, offs=None):
    """Linear predictors of the rows of w (m, p) on the full data, any
    layout, the centering term xc taken off, then offs and b added;
    (n_pad, m)."""
    if isinstance(x, (PaddedCSR, HybridCSR)):
        lp = x.matmul_dense(w.T.to(dtype)).to(dtype)
    else:
        lp = x @ w.T
    if xc is not None:
        lp = lp - w @ xc.to(w.dtype)
    if offs is not None:
        lp = lp + offs.to(dtype)
    return lp if b is None else lp + b


def _xtg(x, xc, g, w_total: float, dtype):
    """(1/W) X_eff^T g with the sparse centering correction; (k, p)."""
    if isinstance(x, (PaddedCSR, HybridCSR)):
        xtg = x.matvec_T(g.to(dtype)).T.to(dtype) / w_total
    else:
        xtg = (g.T @ x) / w_total
    if xc is not None:
        xtg = xtg - torch.outer(torch.sum(g, dim=0), xc.to(xtg.dtype)) / w_total
    return xtg


def _column_subset(x, xc, cols_np: np.ndarray, p: int, dtype):
    """Dense, fully centred (n_pad, K) block of the selected columns.

    cols_np has K entries in [0, p]; index p selects the all-zero dummy.
    The block needs no centering term (pad rows carry weight 0, so their
    nonzero centred values are inert).  Sparse entries are summed into a
    (n_pad, K + 1) buffer whose last column takes every entry of an
    unselected column; the head part is added to the tail's sums."""
    K = len(cols_np)
    dev = x.tail.values.device if isinstance(x, HybridCSR) else (x.values.device if isinstance(x, PaddedCSR)
                                                                  else x.device)
    cols = torch.as_tensor(cols_np, device=dev).long()
    real = cols < p
    safe = torch.clamp(cols, max=p - 1)
    if isinstance(x, (HybridCSR, PaddedCSR)):
        slot = np.full(p + 1, K, dtype=np.int64)
        sel = cols_np < p
        slot[cols_np[sel]] = np.arange(K)[sel]
        slot_dev = torch.as_tensor(slot, device=dev)
        csr = x.tail if isinstance(x, HybridCSR) else x
        n_pad = csr.indices.shape[0]
        rows = torch.arange(n_pad, device=dev)[:, None].expand(csr.indices.shape)
        buf = torch.zeros((n_pad, K + 1), dtype=dtype, device=dev)
        buf.index_put_((rows, slot_dev[csr.indices.long()]), csr.values.to(dtype), accumulate=True)
        sub = buf[:, :K]
        if isinstance(x, HybridCSR):
            d = x.n_head
            head_cols = torch.where(cols < d, cols, 0)
            head_part = x.head[:, head_cols].to(dtype) * (cols < d).to(dtype)[None, :]
            if x.head_scale is not None:
                head_part = head_part * x.head_scale[head_cols].to(dtype)[None, :]
            sub = head_part + sub
            head_part = None
        else:
            sub = sub.contiguous()
        buf = None
    else:
        sub = torch.where(real[None, :], x[:, safe].to(dtype), torch.zeros((), dtype=dtype, device=dev))
    if xc is not None:
        c_sub = torch.where(real, xc.to(dtype)[safe], torch.zeros((), dtype=dtype, device=dev))
        sub = sub - c_sub[None, :]
    return sub


def screened_path(
    x,  # standardized design (dense, PaddedCSR or HybridCSR), padded rows
    y,
    weights,
    gammas,
    l1s,
    l2s,
    tol,
    family,
    penalty,
    config: SolverConfig,
    xc=None,  # sparse centering term (center/scale), or None
    pf=None,  # (p,) penalty factors (solver scale), or None
    box=None,  # ((k, p) lo, (k, p) hi) standardized-scale bounds, or None
    always_inactive=None,  # (p,) bool: excluded features, pinned to zero
    offs=None,  # (n_pad, k) linear-predictor offsets, or None
    intercept0=None,  # (k,) initial intercept (offset-aware null), or None
    group_size: int = 4,
    kkt_slack: float = 1e-5,
    max_kkt_rounds: int = 3,
    full_fallback_frac: float = 0.35,
    subset_mem_budget: float = 8e9,
    auto_full_tail: bool = False,
    full_tail_chunk: int | None = None,
    seed: int = 0,
    counts=None,  # a saga.PathCounts that adds every fit_path call's epochs and host reads
):
    """Strong-rule screened warm-started path.  Returns (w_path (nl, k, p),
    intercept_path (nl, k), deviance (nl,), n_epochs (nl,), return_codes,
    total_epochs, stats dict), host numpy.

    `auto_full_tail` is the screen="auto" policy: the first group that
    trips the dense-regime fallback (more than `full_fallback_frac` of the
    features active, or a subset over `subset_mem_budget`) runs the rest of
    the path as one warm-started full-layout fit_path call, the
    screen=False schedule; stats["full_tail_from"] is the switch's lambda
    index (None: the whole path stayed screened).  `full_tail_chunk` runs
    that tail in warm-started chunks of as many lambdas, one call each (fit
    passes its `lambda_chunk`)."""
    n_pad, p = x.shape[0], x.shape[1]
    k = family.n_classes
    dtype, dev = y.dtype, y.device
    nl = len(np.asarray(l1s))
    w_total = float(torch.clamp(torch.sum(weights), min=1e-12))
    n_orders = order_count(config, n_pad)

    pf_np = np.ones(p) if pf is None else pf.cpu().numpy().astype(np.float64)
    excl_np = np.zeros(p, dtype=bool) if always_inactive is None else np.asarray(always_inactive)

    w_full = np.zeros((k, p), dtype=np.float64)
    if intercept0 is not None:
        intercept = np.asarray(intercept0, dtype=np.float64)
    else:
        intercept = family.null_intercept(y.to(torch.float64), config.fit_intercept,
                                          weights.to(torch.float64)).cpu().numpy()
    g_mem = torch.zeros((n_pad, k), dtype=dtype, device=dev)

    def tens(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def gradient_scores(w, b):
        g = family.gradient(_full_lp(x, xc, w, dtype, b=b, offs=offs), y) * weights[:, None]  # (n_pad, k)
        xtg = _xtg(x, xc, g, w_total, dtype)
        return torch.sqrt(torch.sum(xtg.to(torch.float64) ** 2, dim=0)).cpu().numpy()

    def dataset_deviance(w, b):
        losses = family.loss_report(_full_lp(x, xc, w, dtype, b=b, offs=offs), y) * weights
        return float(2.0 * torch.sum(losses))

    w_out = np.zeros((nl, k, p))
    b_out = np.zeros((nl, k))
    dev_out = np.zeros(nl)
    iters_out = np.zeros(nl, dtype=np.int32)
    codes_out = np.zeros(nl, dtype=np.int32)
    totals = {"epochs": 0, "work": 0, "chunks": 0}
    ran_k2 = ran_tail = False  # a fit_path call ran K2; a full-layout call ran K3 / K4
    active_hist = []
    kkt_rounds_hist = []

    l1s_np = np.asarray(l1s, dtype=np.float64)
    gammas_np = np.asarray(gammas, dtype=np.float64)
    l2s_np = np.asarray(l2s, dtype=np.float64)

    # work basis for a full-layout group: the elements the solver streams an
    # epoch on the native layout (nnz for sparse layouts, n*p dense)
    full_elems = x.total_nnz() if isinstance(x, (PaddedCSR, HybridCSR)) else n_pad * p
    full_groups = 0

    # step backoff, sticky along the path: a suspicious group (a lambda that
    # hit max_iter with a final change far above tol) is retried at half
    # the step, and the smaller step sticks only when it won
    bk = 0
    tol_f = float(np.asarray(tol))
    full_tail_from = None
    in_full_tail = False

    def tail_end(li):
        """Where the full-layout tail's call from li ends."""
        return min(li + (full_tail_chunk or nl - li), nl)

    def fit_backoff(run_one, count_work):
        nonlocal bk

        def account(out):
            n_it = int(out[1])
            totals["epochs"] += n_it
            totals["work"] += n_it * count_work
            totals["chunks"] += int(out[2].n_chunks.sum())

        best, bk = saga.backoff_path(run_one, bk, tol_f, account)
        return best

    def run_path(x_fit, xc_fit, state0, li, hi, gmul, salt, pf_fit, box_fit):
        nonlocal ran_k2, ran_tail
        ran_k2 |= not config.use_epoch_kernel and saga.uses_head_kernel(x_fit, family, config)
        ran_tail |= isinstance(x_fit, HybridCSR) and x_fit.blk_tail is not None and config.use_tail_kernel
        return fit_path(x_fit, y, weights, gammas_np[li:hi] * gmul, l1s_np[li:hi], l2s_np[li:hi], tol, state0,
                        family, penalty, config, offs=offs, pf=pf_fit, box=box_fit, xc=xc_fit,
                        order_fn=saga.default_order_fn(seed, n_orders, salt), counts=counts, lam0=li)

    li = 0
    while li < nl:
        hi = min(li + group_size, nl)
        G = hi - li
        w_dev = tens(w_full)
        b_dev = tens(intercept)

        # the dense-regime fallback: a group whose strong rule keeps more
        # than full_fallback_frac of the features, or whose subset would
        # outgrow the memory budget, is fitted on the full design in its
        # native layout (exact: every feature present), warm-started
        def fit_group_full(active_count):
            nonlocal w_full, intercept, g_mem, full_groups
            state0 = SagaState(w=tens(w_full), intercept=b_dev, g_mem=g_mem,
                               g_sum=torch.zeros((k, p), dtype=dtype, device=dev),
                               g_sum_intercept=torch.zeros((k,), dtype=dtype, device=dev))
            state0 = _refresh_g_sum(x, w_total, state0, xc, kernels=config.use_tail_kernel)
            state, _, results = fit_backoff(
                lambda gmul, try_: run_path(x, xc, state0, li, hi, gmul, li * 7 + 1000 * try_, pf, box), full_elems)
            w_grp = np.asarray(results.w, dtype=np.float64)
            b_grp = np.asarray(results.intercept, dtype=np.float64)
            g_mem = state.g_mem
            w_out[li:hi] = w_grp
            b_out[li:hi] = b_grp
            dev_out[li:hi] = np.asarray(results.deviance, dtype=np.float64)
            iters_out[li:hi] = results.n_epochs
            codes_out[li:hi] = results.return_codes
            active_hist.append(int(active_count))
            kkt_rounds_hist.append(0)
            full_groups += 1
            w_full = w_grp[-1]
            intercept = b_grp[-1]

        if in_full_tail:  # past the switch: full-layout chunks, no scores pass
            hi = tail_end(li)
            fit_group_full(p)
            li = hi
            continue

        scores = gradient_scores(w_dev, b_dev)

        # the union of the per-lambda sequential strong rules over the
        # group: active if score >= pf * min_g(2*l1_g - l1_{g-1}); the
        # lambda-max proxy at the path's start counts penalized features
        # only.  The batched KKT check below keeps the result exact.
        if li > 0:
            l1_prev = l1s_np[li - 1]
        else:
            pen = (pf_np > 0) & ~excl_np
            l1_prev = float(np.max(scores[pen] / pf_np[pen])) if pen.any() else 0.0
        prevs = np.concatenate([[l1_prev], l1s_np[li : hi - 1]])
        threshold = float(np.min(2.0 * l1s_np[li:hi] - prevs))
        active = ((scores >= pf_np * threshold) | (np.abs(w_full).sum(axis=0) > 0) | (pf_np == 0)) & ~excl_np

        K_limit = max(256, int(subset_mem_budget // (16 * n_pad)))
        if active.sum() > full_fallback_frac * p or _bucket(max(int(active.sum()), 1)) > K_limit:
            if auto_full_tail:  # the rest of the path on the full layout
                full_tail_from, in_full_tail, hi = li, True, tail_end(li)
            fit_group_full(int(active.sum()))
            li = hi
            continue

        # the KKT loop: the active set only grows, and at the full set the
        # violation check is empty, so iterating until clean terminates;
        # past max_kkt_rounds a RuntimeWarning says screening saves little
        kkt_round = 0
        went_full = False
        while True:
            idx = np.flatnonzero(active)
            K = min(_bucket(max(len(idx), 1)), p)
            if K > K_limit or len(idx) > K:
                # the expansion outgrew the subset budget: the group
                # finishes on the full native layout
                if auto_full_tail:
                    full_tail_from, in_full_tail, hi = li, True, tail_end(li)
                fit_group_full(len(idx))
                went_full = True
                break
            padded = np.full(K, p, dtype=np.int64)  # the dummy column
            padded[: len(idx)] = idx[:K]

            x_sub = _column_subset(x, xc, padded, p, dtype)
            real = padded < p
            safe = np.minimum(padded, p - 1)
            w_sub = tens(w_full[:, safe] * real)
            pf_sub = None if pf is None else tens(np.where(real, pf_np[safe], 1.0))
            box_sub = None
            if box is not None:
                lo = np.where(real[None, :], box[0].cpu().numpy()[:, safe], 0.0)
                hi_b = np.where(real[None, :], box[1].cpu().numpy()[:, safe], 0.0)
                box_sub = (tens(lo), tens(hi_b))
            # the gradient average on the active set: one product
            state0 = SagaState(w=w_sub, intercept=b_dev, g_mem=g_mem, g_sum=(g_mem.T @ x_sub) / w_total,
                               g_sum_intercept=torch.sum(g_mem, dim=0) / w_total)

            def run_one(gmul, try_, _x=x_sub, _st=state0, _pf=pf_sub, _bx=box_sub, _kr=kkt_round):
                return run_path(_x, None, _st, li, hi, gmul, li * 7 + _kr + 1000 * try_, _pf, _bx)

            # the work counter: the dense (n_pad, K) subset the solver
            # streamed (bucket padding included), not the full design
            state, _, results = fit_backoff(run_one, n_pad * K)
            w_grp_sub = np.asarray(results.w, dtype=np.float64)  # (G, k, K)
            w_grp = np.zeros((G, k, p))
            w_grp[:, :, padded[real]] = w_grp_sub[:, :, real]
            b_grp = np.asarray(results.intercept, dtype=np.float64)  # (G, k)
            g_mem_new = state.g_mem
            x_sub = state0 = None

            # the batched KKT check: scores at each group solution against
            # its own l1
            s_grp = np.stack([gradient_scores(tens(w_grp[gi]), tens(b_grp[gi])) for gi in range(G)])  # (G, p)
            viol = ((s_grp > pf_np[None, :] * l1s_np[li:hi, None] * (1 + kkt_slack))
                    & ~active[None, :] & ~excl_np[None, :]).any(axis=0)
            if not viol.any():
                g_mem = g_mem_new
                break
            active |= viol
            kkt_round += 1
            if kkt_round == max_kkt_rounds:
                warnings.warn(
                    f"strong-rule screening needed more than {max_kkt_rounds} "
                    f"KKT expansion rounds for lambdas [{li}, {hi}); continuing "
                    "until the KKT conditions are clean (the result stays exact, "
                    "but screening is saving little work on this problem)",
                    RuntimeWarning,
                    stacklevel=2,
                )

        if not went_full:  # fit_group_full wrote this group's outputs
            w_out[li:hi] = w_grp
            b_out[li:hi] = b_grp
            iters_out[li:hi] = results.n_epochs
            codes_out[li:hi] = results.return_codes
            for gi in range(G):
                dev_out[li + gi] = dataset_deviance(tens(w_grp[gi]), tens(b_grp[gi]))
            active_hist.append(int(active.sum()))
            kkt_rounds_hist.append(kkt_round)
            w_full = w_grp[-1]
            intercept = b_grp[-1]
        li = hi

    stats = {
        "active_per_group": active_hist,
        "mean_active": float(np.mean(active_hist)) if active_hist else 0.0,
        "p": p,
        # epochs x n_pad x K (bucket) summed over the fit_path calls: the
        # design elements the solver streamed, the work basis of a screened
        # fit's nnz_per_s
        "work_elems": totals["work"],
        # every returned solution met the full-width KKT conditions
        "kkt_clean": True,
        "kkt_rounds_per_group": kkt_rounds_hist,
        # lambda groups fitted on the full native layout (dense regime)
        "full_fallback_groups": full_groups,
        # screen="auto": the lambda index where the rest of the path
        # switched to full-layout fits (None: the whole path stayed screened)
        "full_tail_from": full_tail_from,
        # K1 launches over every fit_path call (0 off K1), whether a call
        # ran K2, and whether a full-layout call ran K3 / K4
        "epoch_chunks": totals["chunks"],
        "head_kernel": ran_k2,
        "tail_kernel": ran_tail,
    }
    return w_out, b_out, dev_out, iters_out, codes_out, totals["epochs"], stats
