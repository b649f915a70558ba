"""Fold-parallel cross-validation (twin of sgdnet_tpu/parallel/cv.py).

Every fold is a 0/1 sample-weight mask (times the user's weights) over
the same padded design, which stays on the device: no fold copies x.  Each
fold standardizes with its training weights (dense layouts centred and
scaled; PaddedCSR / HybridCSR scale-only with the rank-1 centering term
xc), fits the lambda path with the port's `fit_path` and scores its held-
out rows on the device.  The JAX package maps a device's folds one after
another with `lax.map`; here that is a loop over folds.  Over a fold mesh
(parallel/dist.py `make_mesh(axis="folds")`) the folds are padded to a
multiple of the ranks and rank r runs its contiguous share of them with
that loop; one all-gather collects the scores.  Fold fits take no rank in
their orders (the JAX package's fold shard_map folds none in), so a fold
scores the same on whichever rank runs it.

Every option of the JAX code is carried: all layouts, sample weights,
penalty factors (mean-normalised), exclusions and box limits (on each
fold's scale), offsets (absorbed into y for identity links, carried
through fit and score for the others), poisson's bound from the whole
response, the top-eigenvalue hint from the full data (x 1.2 / n), bf16 and
int8 heads (an int8 head is quantized after each fold's standardization)
and every score.  A HybridCSR under block sampling has its tail packed as
a BlockCOO once, after the row shuffle and the padding; each fold scales
the packed values by its column scales (`BlockCOO.scale_columns`, bit for
bit the values a re-pack of the scaled tail gives).

Kernels: K1 follows `fit`'s gate (sampling included), K2 only an explicit
`use_pallas=True` (as the JAX code honours only an explicit opt-in), K3 /
K4 the packed tail unless `use_tail_kernel=False`.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from sgdnet_tpu_torch.api.fit import (
    _as_design_matrix, _box_limits, _epoch_kernel_gate, _feature_constraints, _link_offset, _max_sq_row_norm,
    _poisson_family, _standardize_design, as_torch_dtype, mesh_device,
)
from sgdnet_tpu_torch.core.sparse import BlockCOO, HybridCSR, as_head_dtype
from sgdnet_tpu_torch.families import get_family
from sgdnet_tpu_torch.penalties import select_penalty
from sgdnet_tpu_torch.solver.saga import SolverConfig, fit_path, init_state
from sgdnet_tpu_torch.solver.screening import _full_lp
from sgdnet_tpu_torch.solver.stepsize import power_iteration_sq_norm, saga_step_sizes


def fold_score(family_name: str, type_measure: str, lp: torch.Tensor, y: torch.Tensor, mask: torch.Tensor):
    """One lambda's score on the masked (test) rows; lp (n, k), y (n, ky),
    a 0-d tensor."""
    m = torch.clamp(torch.sum(mask), min=1e-12)
    if family_name in ("gaussian", "mgaussian"):
        r = lp - y
        if type_measure in ("deviance", "mse"):
            per = torch.sum(r * r, dim=1)
        elif type_measure == "mae":
            per = torch.sum(torch.abs(r), dim=1)
        else:
            raise ValueError(type_measure)
        return torch.sum(per * mask) / m
    if family_name == "binomial":
        prob = 1.0 / (1.0 + torch.exp(-lp[:, 0]))
        yb = y[:, 0]
        if type_measure == "auc":
            # the masked average-tie rank-sum AUC: excluded rows get the
            # sentinel 2.0 > any probability, so for an included p_i the
            # searchsorted positions count included rows only, and
            # (left + right + 1) / 2 is its average-tie rank
            pm = torch.where(mask > 0, prob, torch.full_like(prob, 2.0))
            sp_ = torch.sort(pm).values
            lo = torch.searchsorted(sp_, pm, side="left").to(prob.dtype)
            hi = torch.searchsorted(sp_, pm, side="right").to(prob.dtype)
            rank = 0.5 * (lo + hi + 1.0)
            n1 = torch.sum(mask * yb)
            n0 = torch.sum(mask) - n1
            u = torch.sum(rank * yb * mask) - n1 * (n1 + 1.0) / 2.0
            return torch.where(n1 * n0 > 0, u / torch.clamp(n1 * n0, min=1.0), torch.full_like(u, float("nan")))
        if type_measure == "deviance":
            p_ = torch.clamp(prob, 1e-5, 1 - 1e-5)
            per = -2.0 * ((1 - yb) * torch.log(1 - p_) + yb * torch.log(p_))
        elif type_measure == "mse":
            per = (prob + (1 - yb) - 1) ** 2 + (prob - yb) ** 2
        elif type_measure == "mae":
            per = torch.abs(prob + (1 - yb) - 1) + torch.abs(prob - yb)
        elif type_measure == "class":
            per = (1 - yb) * (prob > 0.5) + yb * (prob <= 0.5)
        else:
            raise ValueError(type_measure)
        return torch.sum(per * mask) / m
    if family_name == "poisson":
        lpv, yv = lp[:, 0], y[:, 0]
        mu = torch.exp(lpv)
        if type_measure == "deviance":
            ylogy = torch.where(yv > 0, yv * torch.log(torch.clamp(yv, min=1e-300)), torch.zeros_like(yv))
            per = 2.0 * (mu - yv * lpv + ylogy - yv)
        elif type_measure == "mse":
            per = (mu - yv) ** 2
        elif type_measure == "mae":
            per = torch.abs(mu - yv)
        else:
            raise ValueError(type_measure)
        return torch.sum(per * mask) / m
    if family_name == "multinomial":
        prob = torch.softmax(lp, dim=1)
        if type_measure == "deviance":
            p_ = torch.clamp(prob, 1e-5, 1 - 1e-5)
            per = -2.0 * torch.sum(y * torch.log(p_), dim=1)
        elif type_measure == "mse":
            per = torch.sum((y - prob) ** 2, dim=1)
        elif type_measure == "mae":
            per = torch.sum(torch.abs(y - prob), dim=1)
        elif type_measure == "class":
            per = (torch.argmax(prob, dim=1) != torch.argmax(y, dim=1)).to(prob.dtype)
        else:
            raise ValueError(type_measure)
        return torch.sum(per * mask) / m
    raise ValueError(family_name)


def _fold_fit_and_score(x, blk_tail, y_enc, train_w, test_mask, lambdas, mix, top_sq_hint, fam, penalty,
                        config: SolverConfig, type_measure: str, tol, seed: int, standardize: bool = True, pf=None,
                        box_lo=None, box_hi=None, offs=None, quantize_int8: bool = False):
    """One fold: weighted standardization -> the lambda path -> its scores
    (nl,) on the held-out rows, host numpy.  `blk_tail` is the design's
    packed tail (or None), scaled here to the fold's columns; under
    `quantize_int8` the solver fits the head quantized after the fold's
    standardization while step sizes and scores use the float form, as the
    serial path's fit and score do."""
    dtype, dev = y_enc.dtype, y_enc.device
    n_pad, p = y_enc.shape[0], x.shape[1]
    k = fam.n_classes

    if standardize:
        # fit's standardization with the fold's weights, never donated: the
        # next fold needs the head
        x_std, xc, _, sd = _standardize_design(x, train_w, dtype)
        x_scale = sd.to(dtype)
    else:
        x_std, xc, x_scale = x, None, torch.ones((p,), dtype=dtype, device=dev)
    x_fit = x_std
    if quantize_int8:
        if not isinstance(x_std, HybridCSR):
            raise ValueError("hybrid_head_dtype='int8' requires the hybrid layout")
        x_fit = x_std.quantize_head()
    if blk_tail is not None:
        x_fit = replace(x_fit, blk_tail=blk_tail.scale_columns(x_scale) if standardize else blk_tail)

    w64 = train_w.to(torch.float64)
    y_proc64, y_center, y_scale = fam.preprocess(y_enc.to(torch.float64), w64)
    max_scale = float(torch.max(y_scale))
    l2s = (1.0 - mix) * lambdas / max_scale
    l1s = mix * lambdas / max_scale

    W = float(torch.clamp(torch.sum(w64), min=1e-12))
    max_sq = _max_sq_row_norm(x_std, xc, (train_w > 0).to(torch.float64))
    gammas = saga_step_sizes(max_sq, top_sq_hint, l2s, W, config.batch_size, config.fit_intercept, fam.L_scaling)

    # box limits on this fold's standardized scale
    box = None
    if box_lo is not None:
        sc = x_scale[None, :] / y_scale.to(dtype)[:, None]  # (k, p)
        box = (box_lo[None, :] * sc, box_hi[None, :] * sc)

    state0 = init_state(n_pad, p, k, dtype, dev)
    if offs is not None:
        null_int = fam.null_intercept_offset(y_proc64, offs.to(torch.float64), config.fit_intercept, w64)
    else:
        null_int = fam.null_intercept(y_proc64, config.fit_intercept, w64)
    state0 = state0._replace(intercept=null_int.to(dtype))

    _, _, results = fit_path(x_fit, y_proc64.to(dtype), train_w, gammas, l1s, l2s, tol, state0, fam, penalty, config,
                             offs=offs, pf=pf, box=box, seed=seed, xc=xc)
    x_fit = None

    w_path = torch.as_tensor(results.w, device=dev).to(dtype)  # (nl, k, p), standardized scale
    nl = w_path.shape[0]
    lp = _full_lp(x_std, xc, w_path.reshape(nl * k, p), dtype).reshape(-1, nl, k)
    lp = lp + torch.as_tensor(results.intercept, device=dev).to(dtype)[None]
    if offs is not None:
        lp = lp + offs[:, None, :]
    # undo the response standardization for gaussian scoring
    lp = lp * y_scale.to(dtype) + y_center.to(dtype)
    return np.asarray([float(fold_score(fam.name, type_measure, lp[:, i], y_enc, test_mask))
                       for i in range(lp.shape[1])])


def parallel_fold_scores(
    x, y, foldid, nfolds, alpha, lambda_path, type_measure="deviance",
    mesh=None, batch_size: int = 32, dtype=torch.float32, maxit: int = 1000,
    thresh: float = 1e-3, intercept: bool = True, standardize: bool = True,
    seed: int = 0, family: str = "gaussian", sample_weight=None,
    penalty_factor=None, lower_limits=None, upper_limits=None, exclude=None,
    type_multinomial: str = "ungrouped", standardize_response: bool = False,
    poisson_smoothness=None, intercept_decay=None, sparse_mode=None,
    offset=None,
    # the layout and kernel options, so the folds fit the problem the
    # serial path would
    hybrid=None, hybrid_coverage: float = 0.9, hybrid_max_head=16384,
    hybrid_memory_budget: float = 2e9, hybrid_head_dtype=None,
    sampling=None, g_sum_refresh_every: int = 1, use_pallas=None,
    use_epoch_kernel=None, use_tail_kernel: bool = True, device=None,
    # inert here: the lambda path comes from the full-data fits
    nlambda: int = 100, lambda_min_ratio=None, feature_names=None,
    # rejected: no meaning in the fold program
    screen: bool = False, debug: bool = False, warm_state=None,
):
    """Scores (nfolds, n_lambda), the folds fitted one after another over
    one design on `device` (None: the card).  Takes dense, scipy sparse,
    PaddedCSR or HybridCSR designs, sample weights, penalty factors, box
    limits, exclusions, offsets, every score (AUC as a masked rank sum) and
    the layout and kernel options of `fit`; unknown keywords raise
    TypeError.  `screen`, `debug` and `warm_state` raise.  With a `mesh`
    (every rank calls with the same arguments; the device is the mesh's)
    each rank fits its share of the folds and every rank returns all the
    scores; a padded fold (past `nfolds`) is not fitted."""
    if screen:
        raise NotImplementedError(
            "screen=True is not supported inside the parallel CV fold program "
            "(same fixed point either way); use parallel=False for screened folds"
        )
    if debug or warm_state is not None:
        raise NotImplementedError("debug/warm_state are not supported with parallel CV")

    dtype = as_torch_dtype(dtype)
    dev = mesh_device(mesh, device)
    head_dtype = as_head_dtype(hybrid_head_dtype)
    quantize_int8 = head_dtype == torch.int8

    # every layout fit takes; an int8 head is built as f32 and quantized
    # after each fold's standardization, the order fit uses
    d = _as_design_matrix(x, dtype, dev, hybrid=hybrid, hybrid_coverage=hybrid_coverage,
                          hybrid_max_head=hybrid_max_head, hybrid_memory_budget=hybrid_memory_budget,
                          head_dtype=None if quantize_int8 else head_dtype, batch_size=batch_size,
                          g_sum_refresh_every=g_sum_refresh_every, plan_itemsize=1 if quantize_int8 else None)
    x, is_sparse = d.x, d.is_sparse
    n, p = x.shape

    fam = get_family(family, standardize_response=standardize_response)
    y_enc, _ = fam.encode(np.asarray(y))
    if family == "poisson":
        # the bound from the whole response: every fold's counts are a
        # subset, so it holds in every fold
        fam = _poisson_family(y_enc, poisson_smoothness)
    penalty = select_penalty(float(alpha), family, type_multinomial)
    _, offs_np, y_enc = _link_offset(offset, family, fam.n_classes, n, y_enc)

    excl_mask, pf_np, lo_np, hi_np = _feature_constraints(p, exclude, penalty_factor, lower_limits, upper_limits,
                                                          d.col_perm)
    lo_hi = _box_limits(p, lo_np, hi_np, excl_mask)
    box_lo, box_hi = (None, None) if lo_hi is None else (torch.as_tensor(v, device=dev).to(dtype) for v in lo_hi)
    pf_dev = None if pf_np is None else torch.as_tensor(pf_np, device=dev).to(dtype)

    sw = None
    if sample_weight is not None:
        sw = np.asarray(sample_weight, dtype=np.float64)
        if sw.shape != (n,):
            raise ValueError("sample_weight must have one entry per sample")

    n_pad = ((n + batch_size - 1) // batch_size) * batch_size
    ek_ok, sampling = _epoch_kernel_gate(
        use_epoch_kernel, sampling, dev, dtype, n, n_pad, p, fam.n_classes, batch_size, dense=not is_sparse,
        plain_only=lo_hi is not None, with_offs=offs_np is not None, warm=False)
    foldid = np.asarray(foldid)
    if sampling == "block":
        # the one seeded row shuffle fit makes, so fixed blocks are random
        # samples
        rperm_np = np.random.default_rng(seed + 0x5EED).permutation(n)
        rperm = torch.as_tensor(rperm_np, device=dev)
        x = x.take_rows(rperm) if is_sparse else x[rperm]
        y_enc = y_enc[rperm_np]
        foldid = foldid[rperm_np]
        if sw is not None:
            sw = sw[rperm_np]
        if offs_np is not None:
            offs_np = offs_np[rperm_np]

    tens = dict(dtype=dtype, device=dev)
    if is_sparse:
        x = x.pad_rows(n_pad)
    elif n_pad > n:
        x = torch.cat([x, torch.zeros((n_pad - n, p), **tens)])

    def padded(a):
        out = np.zeros((n_pad,) + a.shape[1:])
        out[:n] = a
        return torch.as_tensor(out, **tens)

    y_dev = padded(y_enc)
    offs_dev = None if offs_np is None else padded(offs_np)
    valid = padded(np.ones(n))

    # the top-eigenvalue hint from the full data on its standardized form,
    # with a 1.2 margin (a fold's top singular value can mildly exceed it)
    x_hint, xc_hint = _standardize_design(x, valid, dtype)[:2] if standardize else (x, None)
    top_sq = float(power_iteration_sq_norm(x_hint, x_center_scaled=xc_hint)) / max(n, 1) * 1.2
    x_hint = xc_hint = None

    if intercept_decay is None:
        intercept_decay = 0.01 if (is_sparse and family != "poisson") else 1.0
    if sparse_mode is None:
        sparse_mode = "densify" if p <= 8192 else "gather"
    config = SolverConfig(
        batch_size=batch_size, max_iter=maxit, fit_intercept=intercept, intercept_decay=float(intercept_decay),
        sparse_mode=sparse_mode, sampling=sampling, g_sum_refresh_every=g_sum_refresh_every,
        # no default-on: K2 runs on an explicit opt-in only, as in the JAX
        # package's fold program
        use_pallas=bool(use_pallas), use_epoch_kernel=ek_ok and sampling == "block",
        use_tail_kernel=use_tail_kernel,
    )
    # the tail packed once, after the shuffle and the padding
    blk_tail = BlockCOO.from_padded(x.tail, batch_size) if sampling == "block" and isinstance(x, HybridCSR) else None

    lambdas = np.asarray(lambda_path, dtype=np.float64)
    n_ranks, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    if mesh is not None:
        # every rank fits on rank 0's path (the paths were computed apart)
        lambdas = mesh.broadcast(torch.as_tensor(lambdas, dtype=torch.float64, device=dev)).cpu().numpy()
    per = -(-nfolds // n_ranks)  # folds a rank, the last ranks' padded
    scores = np.zeros((per, len(lambdas)))
    for i, j in enumerate(range(rank * per, min((rank + 1) * per, nfolds))):
        train = (foldid != j).astype(np.float64)  # train on k-1 folds
        # the test mask is the held-out fold itself, so zero-weight
        # training rows never leak into it
        train_w = padded(train if sw is None else train * sw)
        test_mask = padded(1.0 - train)
        scores[i] = _fold_fit_and_score(
            x, blk_tail, y_dev, train_w, test_mask, lambdas, float(alpha), top_sq, fam, penalty, config,
            type_measure, thresh, seed, standardize=standardize, pf=pf_dev, box_lo=box_lo, box_hi=box_hi,
            offs=offs_dev, quantize_int8=quantize_int8,
        )
    if mesh is not None:
        scores = mesh.all_gather(torch.as_tensor(scores, dtype=torch.float64, device=dev)).cpu().numpy()
    return scores.reshape(-1, len(lambdas))[:nfolds]
