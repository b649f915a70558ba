"""Model-fitting front end (twin of sgdnet_tpu/api/fit.py).

Input validation, sparse ingestion (scipy input into a PaddedCSR or a
HybridCSR with a BlockCOO tail), response encoding, feature
standardization, lambda-path construction, the K1/K2 kernel gates, solver
dispatch and output assembly into an `SgdnetFit`.  Every tensor is created
on the fit's `device`, which defaults to the card.
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field, replace
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from sgdnet_tpu_torch.core.layout import plan_layout
from sgdnet_tpu_torch.core.sparse import (
    BlockCOO, HeadNNZ, HybridCSR, PaddedCSR, as_head_dtype, canonical_csr, materialize_int8_head, scipy_column_stats,
    scipy_row_sq_norms,
)
from sgdnet_tpu_torch.families import get_family, lambda_max_offset
from sgdnet_tpu_torch.parallel.dist import pad_to_shards, shard_path_inputs
from sgdnet_tpu_torch.penalties import select_penalty
from sgdnet_tpu_torch.solver import epoch_kernel, saga
from sgdnet_tpu_torch.solver.saga import (
    PathCounts, PathResults, SagaState, SolverConfig, backoff_path, fit_path, init_state, order_count, uses_head_kernel,
)
from sgdnet_tpu_torch.solver.screening import screened_path
from sgdnet_tpu_torch.solver.stepsize import power_iteration_sq_norm, saga_step_sizes
from sgdnet_tpu_torch.utils.device import resolve_device

FAMILIES = ("gaussian", "binomial", "poisson", "multinomial", "mgaussian")


@dataclass
class SgdnetFit:
    """Fitted regularization path.  `beta` is (n_lambda, k, p) on the
    original data scale; `a0` is (n_lambda, k) ((n_lambda,) when k = 1)."""

    a0: np.ndarray
    beta: np.ndarray
    lambda_: np.ndarray
    dev_ratio: np.ndarray
    df: np.ndarray
    dfmat: np.ndarray | None
    nulldev: float
    npasses: int
    return_codes: np.ndarray
    alpha: float
    family: str
    classnames: list | None
    grouped: bool
    nobs: int
    offset: bool = False
    feature_names: list | None = None
    diagnostics: dict | None = None
    #: everything needed to refit (predict(..., exact=True))
    _refit_args: dict | None = field(default=None, repr=False)
    #: final solver state (SagaState on the fit's device) — pass as
    #: `warm_state=` to resume
    final_state: object = field(default=None, repr=False)
    #: wall_time_s, epochs, nnz, nnz_per_s, layout, device, which kernels
    #: ran (epoch_kernel = K1, head_kernel = K2, tail_kernel = the BlockCOO
    #: tail ops K3 / K4), epoch_chunks (K1's launches, a chunk of epochs and
    #: one host sync each; 0 off K1), layout_plan (the planner's LayoutPlan as a
    #: dict under hybrid_max_head="auto" on scipy input, else None), and
    #: under a mesh `mesh` (axis, size, rank, backend) and `allreduces` (the
    #: fit's all-reduces by what they reduce: step, refresh, loss, setup,
    #: and their total); epochs_by_attempt and host_syncs, the operator
    #: accounting `fit`'s docstring describes
    stats: dict | None = field(default=None, repr=False)

    @property
    def n_lambda(self) -> int:
        return len(self.lambda_)

    @property
    def n_classes(self) -> int:
        return self.beta.shape[1]

    @property
    def n_features(self) -> int:
        return self.beta.shape[2]

    def predict(self, newx=None, s=None, type="link", exact=False, **kwargs):
        from sgdnet_tpu_torch.api.predict import predict

        return predict(self, newx=newx, s=s, type=type, exact=exact, **kwargs)

    def coef(self, s=None, **kwargs):
        from sgdnet_tpu_torch.api.predict import predict

        return predict(self, s=s, type="coefficients", **kwargs)

    def deviance(self):
        """Deviance along the path: (1 - dev_ratio) * nulldev."""
        return (1.0 - self.dev_ratio) * self.nulldev

    def score(self, x, y, type_measure="deviance", s=None, offset=None):
        from sgdnet_tpu_torch.api.score import score

        return score(self, x, y, type_measure=type_measure, s=s, offset=offset)

    def plot(self, **kwargs):
        from sgdnet_tpu_torch.api.plot import plot_path

        return plot_path(self, **kwargs)

    def __repr__(self):
        return (
            f"SgdnetFit(family={self.family!r}, alpha={self.alpha}, "
            f"n_lambda={self.n_lambda}, nobs={self.nobs}, "
            f"n_features={self.n_features}, npasses={self.npasses})"
        )

    def print_path(self, max_rows: int = 100):
        """Path summary table."""
        lines = ["     Df   %Dev   Lambda"]
        for i in range(min(self.n_lambda, max_rows)):
            lines.append(f"{i:>3} {int(self.df[i]):>4} {self.dev_ratio[i]:6.2f} {self.lambda_[i]:>9.4g}")
        return "\n".join(lines)


def as_torch_dtype(dtype) -> torch.dtype:
    """torch.float32/float64 from a torch dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    if name not in ("float32", "float64"):
        raise ValueError(f"dtype must be float32 or float64; got {name}")
    return getattr(torch, name)


def _issparse(x) -> bool:
    try:
        import scipy.sparse as sp
    except ImportError:
        return False
    return sp.issparse(x)


def mesh_device(mesh, device) -> torch.device:
    """The device of a fit: the mesh's where there is one (a `device` given
    beside it must name the same), else `device` (None: the card)."""
    if mesh is None:
        return resolve_device(device)
    if device is not None:
        asked = torch.device(device)
        if asked.type != mesh.device.type or asked.index not in (None, mesh.device.index):
            raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
    return mesh.device


def _layout_stats(x) -> dict:
    if isinstance(x, HybridCSR):
        return {"kind": "hybrid", "head_width": x.n_head, "head_dtype": str(x.head.dtype),
                "blk_tail": x.blk_tail is not None}
    if isinstance(x, PaddedCSR):
        return {"kind": "padded_csr", "row_width": x.row_width}
    return {"kind": "dense"}


def _weighted_column_stats(x: torch.Tensor, weights: torch.Tensor):
    w = weights.reshape(-1, 1).to(torch.float64)
    W = torch.clamp(torch.sum(w), min=1e-12)
    xf = x.to(torch.float64)
    mean = torch.sum(xf * w, dim=0) / W
    var = torch.sum(w * (xf - mean) ** 2, dim=0) / W
    sd = torch.where(var == 0.0, torch.ones_like(var), torch.sqrt(var))
    return mean, sd


def _standardize_design(x, weights, dtype, donate: bool = False):
    """The solver's standardization of any layout with the row weights
    `weights` ((n,) tensor; None counts every row of a sparse layout once):
    (x_std, xc, center, scale), center and scale f64.  Dense x is centred
    and scaled (xc None); a PaddedCSR is scaled and a HybridCSR's head
    centred and scaled, its tail scaled, the centering carried as the term
    xc.  `donate=True` overwrites a HybridCSR's head in place (for callers
    that own it)."""
    if isinstance(x, (PaddedCSR, HybridCSR)):
        center, scale = x.column_stats(weights)
        if isinstance(x, HybridCSR):
            x_std, xc = x.standardize(center, scale, donate=donate)
        else:
            x_std, xc = x.scale_columns(scale), center / scale
        return x_std, xc.to(dtype), center, scale
    center, scale = _weighted_column_stats(x, weights)
    return ((x.to(torch.float64) - center) / scale).to(dtype), None, center, scale


def _max_sq_row_norm(x, xc, active) -> float:
    """max_i ||x_i - c||^2 over the rows where `active` is 1, any layout (a
    sparse layout's norms are those of its scaled, centered rows)."""
    if isinstance(x, (PaddedCSR, HybridCSR)):
        per_row = x.row_squared_norms(xc)
    else:
        per_row = torch.sum(x.to(torch.float64) ** 2, dim=1)
    return float(torch.max(per_row * active))


def _poisson_family(y_enc: np.ndarray, poisson_smoothness):
    """The poisson family with its data-dependent curvature bound for the
    exp link (from the whole response), rounded up to a power of two."""
    if poisson_smoothness is None:
        ym = y_enc[:, 0]
        bound = max(float(ym.max()) * 2.0, float(ym.mean()) * 4.0, 2.0)
    else:
        bound = float(poisson_smoothness)
    return get_family("poisson", smoothness=float(2.0 ** np.ceil(np.log2(bound))))


def _link_offset(offset, family: str, n_classes: int, n_samples: int, y_enc: np.ndarray):
    """(offset as given, (n, kk); the offset the solver carries, or None;
    the encoded response): identity-link families absorb the offset into
    the response, the others carry it through the fit."""
    if offset is None:
        return None, None, y_enc
    offset_arr = np.asarray(offset, dtype=np.float64)
    if offset_arr.ndim == 1:
        offset_arr = offset_arr.reshape(-1, 1)
    kk = n_classes if family in ("multinomial", "mgaussian") else 1
    if offset_arr.shape != (n_samples, kk):
        want = f"({n_samples},)" if kk == 1 else f"({n_samples}, {kk})"
        raise ValueError(f"offset must have shape {want} for family '{family}'")
    if np.isnan(offset_arr).any():
        raise ValueError("NA values are not allowed.")
    if family in ("gaussian", "mgaussian"):
        return offset_arr, None, y_enc - offset_arr  # identity link: absorb into the response
    return offset_arr, offset_arr, y_enc


def _feature_constraints(n_features: int, exclude, penalty_factor, lower_limits, upper_limits, col_perm):
    """(exclusion mask, penalty factors scaled to mean 1 over the features
    not excluded, lower and upper limits), numpy or None each, in the
    layout's column order (`col_perm`); an infinite penalty factor
    excludes its feature, as in glmnet."""
    excl_mask = None
    if exclude is not None:
        ex = np.atleast_1d(np.asarray(exclude, dtype=np.int64)).ravel()
        if ex.size and (ex.min() < 0 or ex.max() >= n_features):
            raise ValueError("exclude indices must be in [0, n_features)")
        excl_mask = np.zeros(n_features, dtype=bool)
        excl_mask[ex] = True

    pf_np = None
    if penalty_factor is not None:
        pf_np = np.asarray(penalty_factor, dtype=np.float64).ravel()
        if pf_np.shape != (n_features,):
            raise ValueError("penalty_factor must have one entry per feature")
        if (pf_np < 0).any() or np.isnan(pf_np).any():
            raise ValueError("penalty_factor entries must be nonnegative")
        inf_pf = np.isinf(pf_np)
        if inf_pf.any():  # glmnet: infinite penalty factor == exclude
            excl_mask = inf_pf if excl_mask is None else (excl_mask | inf_pf)
            pf_np = np.where(inf_pf, 1.0, pf_np)

    lower_np = upper_np = None
    if lower_limits is not None:
        lower_np = np.broadcast_to(np.asarray(lower_limits, dtype=np.float64), (n_features,)).copy()
        if (lower_np > 0).any():
            raise ValueError("lower_limits must be <= 0 (coefficients start at zero)")
    if upper_limits is not None:
        upper_np = np.broadcast_to(np.asarray(upper_limits, dtype=np.float64), (n_features,)).copy()
        if (upper_np < 0).any():
            raise ValueError("upper_limits must be >= 0 (coefficients start at zero)")

    if col_perm is not None:  # user vectors are in the original column order
        excl_mask, pf_np, lower_np, upper_np = (None if v is None else v[col_perm]
                                                for v in (excl_mask, pf_np, lower_np, upper_np))

    if pf_np is not None:
        # rescale: mean over non-excluded features = 1
        sel = ~excl_mask if excl_mask is not None else np.ones(n_features, bool)
        if sel.any():
            m = float(pf_np[sel].mean())
            if m > 0:
                pf_np = pf_np / m
    return excl_mask, pf_np, lower_np, upper_np


def _box_limits(n_features: int, lower_np, upper_np, excl_mask):
    """(lo, hi) coefficient bounds on the data scale, excluded features
    pinned at [0, 0]; None when there are none."""
    if lower_np is None and upper_np is None and excl_mask is None:
        return None
    lo = lower_np.copy() if lower_np is not None else np.full(n_features, -np.inf)
    hi = upper_np.copy() if upper_np is not None else np.full(n_features, np.inf)
    if excl_mask is not None:
        lo[excl_mask] = 0.0
        hi[excl_mask] = 0.0
    if (lo > hi).any():
        raise ValueError("lower_limits must be <= upper_limits")
    return lo, hi


def _epoch_kernel_gate(use_epoch_kernel, sampling, dev, dtype, n_samples: int, n_pad: int, n_features: int,
                       n_classes: int, batch_size: int, dense: bool, plain_only: bool, with_offs: bool,
                       warm: bool):
    """(K1 runs, the sampling): dense f32 problems within the Hopper gate
    run each λ attempt's epochs in launches of K1, by default on CUDA only
    (on the CPU its twin runs on explicit opt-in, as interpret mode does in
    the JAX package); debug, box limits and a mesh (`plain_only`) and a
    warm state stay on the step path.  Unset sampling is block under K1, else block
    from 32768 rows on; a warm state keeps permutation, as block mode
    pre-shuffles rows and would misalign a g_mem saved under another
    order."""
    ek_ok = (
        use_epoch_kernel is not False
        and dense
        and not plain_only
        and not warm
        and dtype == torch.float32
        and epoch_kernel.supported(n_pad, n_features, n_classes, batch_size, with_offs=with_offs)
        and (use_epoch_kernel is True or dev.type == "cuda")
    )
    if sampling is None:
        if warm:
            sampling = "permutation"
        elif ek_ok:
            sampling = "block"
        else:
            sampling = "block" if n_samples >= 32768 else "permutation"
    if sampling not in ("permutation", "block"):
        raise ValueError("sampling must be 'permutation' or 'block'")
    return ek_ok, sampling


class Design(NamedTuple):
    """The design matrix as `_as_design_matrix` builds it on the device."""

    x: object  # dense tensor, PaddedCSR or HybridCSR
    is_sparse: bool
    prebuilt: bool  # a layout the caller built (fit keeps its columns in its order)
    col_perm: np.ndarray | None  # hybrid column permutation: new column j is original col_perm[j]
    head_nnz: HeadNNZ | None  # an int8 head in nonzero form, rebuilt shuffled and padded by fit
    pre_std: tuple | None  # (mean, sd) in original column order, when standardized on the host
    pre_row_sq: np.ndarray | None  # host row norms of the standardized design (int8 ingestion)
    layout_plan: object  # the planner's LayoutPlan under hybrid_max_head="auto" on scipy input
    max_head: int  # hybrid_max_head, resolved
    coverage: float  # hybrid_coverage, 1.0 where the plan governs the split


def _as_design_matrix(x, dtype, dev, hybrid=None, hybrid_coverage=0.9, hybrid_max_head=16384,
                      hybrid_memory_budget=2e9, head_dtype=None, batch_size=32, g_sum_refresh_every=1,
                      standardize=True, sample_weight=None, plan_itemsize=None) -> Design:
    """Dense (numpy or torch), scipy sparse, PaddedCSR or HybridCSR input
    as the solver's layout on `dev`: scipy input with more than 512 columns
    (or `hybrid=True`) becomes a HybridCSR with a column permutation, else a
    PaddedCSR; a prebuilt layout is moved to `dev` and held to the checks a
    scipy input gets.  An int8 head (`head_dtype`) is built on the host,
    standardized there with `sample_weight` when `standardize`.  NaN in x
    raises.  The planner prices the head at `plan_itemsize` bytes an
    element (default: the head's type)."""
    layout_plan = None
    if hybrid_max_head == "auto":
        # the cost-model planner (core/layout.py): the head width where the
        # column-popularity curve crosses the dense-stream vs element-op
        # break-even, capped by the head memory budget
        hybrid_max_head = 16384  # for input that is not scipy-sparse
        if _issparse(x):
            itemsize = plan_itemsize or (head_dtype or dtype).itemsize
            layout_plan = plan_layout(x, batch_size=batch_size, head_itemsize=itemsize,
                                      g_sum_refresh_every=g_sum_refresh_every, hbm_budget=hybrid_memory_budget)
            hybrid_max_head = layout_plan.max_head
            hybrid_coverage = 1.0  # the planner's D governs the split

    col_perm = head_nnz = pre_std = pre_row_sq = None
    prebuilt = isinstance(x, (PaddedCSR, HybridCSR))
    is_sparse = prebuilt or _issparse(x)
    if prebuilt:
        # a layout built by the caller: moved to the device and held to the
        # checks a scipy input gets; its columns stay in its order
        x = x.ingest(dev, dtype) if isinstance(x, HybridCSR) else x.to(dev, dtype).canonical()
    elif is_sparse:
        xs = canonical_csr(x)
        if np.isnan(xs.data).any():
            raise ValueError("NA values are not allowed.")
        split_kw = dict(coverage=hybrid_coverage, max_head=hybrid_max_head, dtype=dtype,
                        memory_budget=hybrid_memory_budget, device=dev)
        use_hybrid = hybrid if hybrid is not None else xs.shape[1] > 512
        if use_hybrid and head_dtype == torch.int8:
            # int8 ingestion on the host: column stats, row norms and the
            # standardization fused into the quantization; the head crosses
            # to the device as its nonzeros
            if standardize:
                w_host = None if sample_weight is None else np.asarray(sample_weight, np.float64)
                pre_std = scipy_column_stats(xs, w_host)
                pre_row_sq = scipy_row_sq_norms(xs, *pre_std)
            else:
                pre_row_sq = scipy_row_sq_norms(xs)
            x, col_perm = HybridCSR.split_columns(xs, head_dtype=torch.int8, std_stats=pre_std, head_form="nnz",
                                                  **split_kw)
            head_nnz = x.head
            x = replace(x, head=materialize_int8_head(head_nnz, device=dev))
        elif use_hybrid:
            x, col_perm = HybridCSR.split_columns(xs, head_dtype=head_dtype, **split_kw)
        else:
            x = PaddedCSR.from_scipy(xs, dtype=dtype, device=dev)
    else:
        x_in = x.detach() if isinstance(x, torch.Tensor) else np.asarray(x)
        if x_in.ndim != 2:
            raise ValueError("x must be a 2-D matrix")
        if isinstance(x_in, torch.Tensor):
            nan = x_in.is_floating_point() and bool(torch.isnan(x_in).any())
        else:
            nan = x_in.dtype != object and np.issubdtype(x_in.dtype, np.floating) and np.isnan(x_in).any()
        if nan:
            raise ValueError("NA values are not allowed.")
        x = torch.as_tensor(x_in).to(dtype=dtype, device=dev)
    return Design(x, is_sparse, prebuilt, col_perm, head_nnz, pre_std, pre_row_sq, layout_plan, hybrid_max_head,
                  hybrid_coverage)


def _chunked_path(fit_chunk, state0, n_lambda: int, size: int, tol: float):
    """The path in warm-started chunks of `size` lambdas: `fit_chunk(lo,
    hi, state, gmul, try_)` fits lambdas lo..hi-1 from `state` at gammas
    times gmul (fit_path's returns), each chunk under the sticky step
    backoff of `backoff_path`.  Every attempt counts in the epochs and in
    the K1 launches.  Returns (final state, epochs, the chunks' PathResults
    concatenated, {"chunks", "refits": the starts of the chunks refit at
    half the step, "backoff": the halvings kept, "epoch_chunks"})."""
    state, n_iter, parts, bk = state0, 0, [], 0
    record = {"chunks": 0, "refits": [], "epoch_chunks": 0}

    def account(out):
        nonlocal n_iter
        n_iter += int(out[1])
        record["epoch_chunks"] += int(out[2].n_chunks.sum())

    for lo in range(0, n_lambda, size):
        hi = min(lo + size, n_lambda)

        def run_one(gmul, try_, lo=lo, hi=hi, state_in=state):
            if try_:
                record["refits"].append(lo)
            return fit_chunk(lo, hi, state_in, gmul, try_)

        (state, _, res), bk = backoff_path(run_one, bk, tol, account)
        parts.append(res)
        record["chunks"] += 1
    results = PathResults(*(np.concatenate([getattr(p, f) for p in parts]) for f in PathResults._fields))
    return state, n_iter, results, dict(record, backoff=bk)


def fit(
    x,
    y,
    family: str = "gaussian",
    alpha: float = 1.0,
    nlambda: int = 100,
    lambda_min_ratio: float | None = None,
    lambda_path=None,
    maxit: int = 1000,
    standardize: bool = True,
    intercept: bool = True,
    thresh: float = 0.001,
    standardize_response: bool = False,
    type_multinomial: str = "ungrouped",
    sample_weight=None,
    offset=None,
    penalty_factor=None,
    lower_limits=None,
    upper_limits=None,
    exclude=None,
    poisson_smoothness=None,
    batch_size: int = 32,
    dtype=torch.float32,
    seed: int = 0,
    debug: bool = False,
    warm_state: SagaState | None = None,
    intercept_decay: float | None = None,
    sparse_mode: str | None = None,
    sampling: str | None = None,
    feature_names=None,
    mesh=None,
    use_pallas: bool | None = None,
    use_epoch_kernel: bool | None = None,
    screen: bool | str = False,
    hybrid: bool | None = None,
    hybrid_coverage: float = 0.9,
    hybrid_max_head: int | str = 16384,
    hybrid_memory_budget: float = 2e9,
    hybrid_head_dtype=None,
    g_sum_refresh_every: int = 1,
    lambda_chunk: int | None = None,
    step_backoff: bool = True,
    device=None,
    use_tail_kernel: bool = True,
) -> SgdnetFit:
    """Fit an elastic-net regularized GLM path with batched SAGA.

    The keywords and their meaning are those of `sgdnet_tpu.fit` (see its
    docstring).  `x` is a dense matrix (numpy or torch) or a scipy sparse
    matrix: with more than 512 columns, or `hybrid=True`, the latter
    becomes a HybridCSR (a dense head of the most frequent columns, f32,
    bf16 or int8 by `hybrid_head_dtype`, and a sparse tail, packed per
    block as a BlockCOO under block sampling), else a PaddedCSR.  A
    prebuilt PaddedCSR or HybridCSR of this package is taken as it is,
    moved to `device` and checked as scipy input is (duplicate columns of
    a row summed); its coefficients come back in its column order, and
    `hybrid_head_dtype="int8"` quantizes a float head after standardizing
    it.  Addition:
    `device` (a torch device) on which every tensor of the fit is created;
    None means the CUDA card and raises RuntimeError when there is none.

    The kernel switches keep the JAX package's names:
    `use_epoch_kernel` selects K1, the hand-written CUDA whole-epoch kernel
    (None: on for dense f32 CUDA fits within its gate; True: on wherever
    the gate admits the problem, running its plain torch twin on the CPU);
    `use_pallas` selects K2, the hand-written CUDA fused head step, for
    block sampling (default: on for a bf16 HybridCSR head under block
    sampling on CUDA, else off; on the CPU the twin runs).  The BlockCOO
    tail ops run K3 / K4 (hand-written CUDA) whenever the tail is packed
    and the fit is on CUDA, their twins on the CPU; `use_tail_kernel=False`
    (a port-only switch, for comparisons) runs the twins on any device.

    `hybrid_max_head="auto"` sizes the head of a scipy input with the
    port's layout planner (core/layout.py, constants measured on the H100),
    which then governs the split alone (coverage 1.0); its plan is
    `stats["layout_plan"]`.  Other input falls back to 16384.  The model
    prices every head at the bf16 stream rate and has no host term, so its
    width is the model's optimum, not one found fastest on the card
    (chip_smoke.py phase 13 times the widths either side of it).

    `screen` selects strong-rule screening of the path (solver/
    screening.py): True runs the screened path (KKT-checked, so exact;
    groups in the dense regime fall back to the full layout), "auto"
    screens until the first group in the dense regime and then fits the
    rest of the path unscreened; ridge and debug fits run unscreened under
    "auto" and raise under True.  `stats["screening"]` holds its record,
    and `nnz` / `nnz_per_s` then count the elements the solver streamed
    (`coverage_nnz`: the full design's).

    With `mesh` (a parallel.dist.Mesh; every rank of its group calls fit
    with the same arguments) the fit runs data-parallel: each rank keeps
    its contiguous share of the shuffled, padded rows (and of g_mem) on the
    mesh's device, w and g_sum are replicated, and a step makes one
    all-reduce (parallel/dist.py).  `batch_size` is then the per-rank
    batch; the global batch is batch_size * mesh.size.  K1 does not run
    under a mesh, K2 only with `use_pallas=True`; `screen="auto"` runs
    unscreened and `screen=True` raises.  Every rank returns the same path.

    `lambda_chunk` fits the path in warm-started chunks of that many
    lambdas, one fit_path call each, as the JAX package does: a chunk draws
    its orders under the salt lo + 1000 * try (the JAX package's
    fold_in(key, lo + 1000 * try)), and a suspicious chunk is refit at half
    the step and kept only if better (`solver.saga.backoff_path`);
    `stats["lambda_chunk"]` records the chunks, the starts of those refit
    and the halvings kept.  Under `screen="auto"` it chunks the full-layout
    tail; a mesh fit ignores it, as the JAX package's does.

    Operator accounting, counted where the work happens (fit_path's epoch
    loops and host reads): `stats["epochs_by_attempt"]` maps (lambda
    index, attempt) to the epochs that attempt ran (attempt 0, then the
    halved-step retries; where several fit_path calls fitted one lambda,
    as a chunk's refits or a screened group's KKT rounds, their epochs
    add up), and `stats["host_syncs"]` counts fit_path's reads of device
    values into the host (the step total, each epoch's stop-rule
    statistics or K1 chunk's, each attempt's objective, each lambda's
    deviance, debug losses, the path's copy to the host), on the card
    each a wait for it.
    """
    # ---- keywords ----
    if screen not in (False, True, "auto"):
        raise ValueError(f"screen must be False, True, or 'auto'; got {screen!r}")
    if isinstance(hybrid_max_head, str) and hybrid_max_head != "auto":
        raise ValueError(f"hybrid_max_head must be an int or 'auto'; got {hybrid_max_head!r}")
    if lambda_chunk is not None and lambda_chunk < 1:
        raise ValueError(f"lambda_chunk must be a positive number of lambdas; got {lambda_chunk!r}")
    if sparse_mode not in (None, "densify", "gather"):
        raise ValueError("sparse_mode must be 'densify' or 'gather'")

    # ---- validation ----
    if family not in FAMILIES:
        raise ValueError(f"family must be one of {FAMILIES}")
    if not 0.0 <= alpha <= 1.0:
        raise ValueError("elastic net mixing parameter (alpha) must be in [0, 1].")
    if thresh < 0:
        raise ValueError("threshold for stopping criteria cannot be negative.")
    if maxit <= 0:
        raise ValueError("maximum number of iterations cannot be negative or zero.")

    dtype = as_torch_dtype(dtype)
    dev = mesh_device(mesh, device)
    tens = dict(dtype=dtype, device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    head_dtype = as_head_dtype(hybrid_head_dtype)

    d = _as_design_matrix(x, dtype, dev, hybrid=hybrid, hybrid_coverage=hybrid_coverage,
                          hybrid_max_head=hybrid_max_head, hybrid_memory_budget=hybrid_memory_budget,
                          head_dtype=head_dtype, batch_size=batch_size, g_sum_refresh_every=g_sum_refresh_every,
                          standardize=standardize, sample_weight=sample_weight)
    x, is_sparse, prebuilt, col_perm, layout_plan = d.x, d.is_sparse, d.prebuilt, d.col_perm, d.layout_plan
    head_nnz, pre_std, pre_row_sq = d.head_nnz, d.pre_std, d.pre_row_sq
    hybrid_max_head, hybrid_coverage = d.max_head, d.coverage
    d = None  # the design as ingested is not kept beside its standardized form
    n_samples, n_features = x.shape
    if n_samples == 0:
        raise ValueError("the predictor matrix (x) is empty.")

    y_arr = np.asarray(y)
    if y_arr.shape[0] != n_samples:
        raise ValueError("the number of samples in 'x' and 'y' must match")
    if y_arr.dtype != object and np.issubdtype(y_arr.dtype, np.number) and np.isnan(
        y_arr.astype(np.float64)
    ).any():
        raise ValueError("NA values are not allowed.")

    if lambda_path is not None:
        lambda_path = np.atleast_1d(np.asarray(lambda_path, dtype=np.float64))
        if (lambda_path < 0).any():
            raise ValueError("penalty strengths (lambdas) must be positive.")
        nlambda = len(lambda_path)
    if nlambda == 0:
        raise ValueError("lambda path cannot be of zero length.")

    # ---- penalty factors / exclusions / box constraints (glmnet style) ----
    excl_mask, pf_np, lower_np, upper_np = _feature_constraints(n_features, exclude, penalty_factor, lower_limits,
                                                                upper_limits, col_perm)

    lam_col_mult = None
    if pf_np is not None or excl_mask is not None:
        base = pf_np if pf_np is not None else np.ones(n_features)
        penalized = base > 0
        if excl_mask is not None:
            penalized &= ~excl_mask
        lam_col_mult = torch.as_tensor(np.where(penalized, 1.0 / np.maximum(base, 1e-300), 0.0), **f64)

    # ---- response encoding ----
    fam = get_family(family, standardize_response=standardize_response)
    y_enc, classnames = fam.encode(y_arr)
    n_classes = fam.n_classes

    if family == "poisson":
        fam = _poisson_family(y_enc, poisson_smoothness)

    # ---- linear-predictor offset ----
    offset_arr, offset_arr_internal, y_enc = _link_offset(offset, family, n_classes, n_samples, y_enc)

    y_dev = torch.as_tensor(y_enc).to(**tens)

    grouped = family == "mgaussian" or (family == "multinomial" and type_multinomial == "grouped")
    penalty = select_penalty(alpha, family, type_multinomial)

    if sample_weight is None:
        weights_np = np.ones((n_samples,), dtype=np.float64)
    else:
        weights_np = np.asarray(sample_weight, dtype=np.float64)
        if weights_np.shape != (n_samples,):
            raise ValueError("sample_weight must have one entry per sample")
        if (weights_np < 0).any():
            raise ValueError("sample_weight must be nonnegative")
    weights = torch.as_tensor(weights_np).to(**tens)
    w_total = float(weights_np.sum())
    if w_total <= 0:
        raise ValueError("sample weights sum to zero")
    weights64 = weights.to(torch.float64)

    # ---- feature standardization: dense x centered and scaled; sparse x
    # scale-only in its tail, the centering carried as the term xc ----
    xc = None
    w_stats = None if sample_weight is None else torch.as_tensor(weights_np, **f64)
    if standardize:
        if pre_std is not None:  # the int8 head was standardized on the host
            m_o, s_o = pre_std
            x_center = torch.as_tensor(m_o[col_perm], **f64)
            x_scale = torch.as_tensor(s_o[col_perm], **f64)
            xc_np = m_o[col_perm] / s_o[col_perm]
            xc_np[: x.n_head] = 0.0
            xc = torch.as_tensor(xc_np, **f64).to(dtype)
        else:
            # as the JAX package: a sparse layout's statistics take the f64
            # sample weights (or none), a dense one's the solver's; a head
            # fit built is overwritten
            x, xc, x_center, x_scale = _standardize_design(x, w_stats if is_sparse else weights, dtype,
                                                           donate=not prebuilt)
    else:
        x_center = torch.zeros((n_features,), **f64)
        x_scale = torch.ones((n_features,), **f64)

    # ---- null deviance on the original response ----
    offs_link64 = None
    b0_offs = None  # offset null intercept, solved once and reused below
    if offset_arr_internal is not None:
        offs_link64 = torch.as_tensor(offset_arr_internal, **f64)
        b0_offs = fam.null_intercept_offset(y_dev.to(torch.float64), offs_link64, intercept, weights64)
        nulldev = float(fam.null_deviance_offset(y_dev.to(torch.float64), offs_link64, intercept,
                                                 weights64, b0=b0_offs))
    else:
        nulldev = float(fam.null_deviance(y_dev.to(torch.float64), intercept, weights64))

    # ---- response preprocessing ----
    w64 = weights64 if sample_weight is not None else None
    y_proc64, y_center, y_scale = fam.preprocess(y_dev.to(torch.float64), w64)
    y_proc = y_proc64.to(dtype)
    offs64 = None if offs_link64 is None else offs_link64 / y_scale[None, :]

    # ---- coefficient bounds on the standardized solver scale; excluded
    # features are pinned at [0, 0] ----
    pf_dev = None if pf_np is None else torch.as_tensor(pf_np).to(**tens)
    box = None
    lo_hi = _box_limits(n_features, lower_np, upper_np, excl_mask)
    if lo_hi is not None:
        xs_np, ys_np = x_scale.cpu().numpy(), y_scale.cpu().numpy()
        box = tuple(torch.as_tensor(v[None, :] * xs_np[None, :] / ys_np[:, None]).to(**tens) for v in lo_hi)

    # ---- lambda path ----
    if lambda_path is None:
        if offs64 is not None:
            lam_max = float(lambda_max_offset(fam, x, y_proc64, offs64, y_scale, intercept, w64, b0=b0_offs,
                                              col_mult=lam_col_mult)) / max(alpha, 0.001)
        else:
            lam_max = float(fam.lambda_max(x, y_proc64, y_scale, w64, col_mult=lam_col_mult)) / max(alpha, 0.001)
        if lam_max > 0.0 and np.isfinite(lam_max):
            if lambda_min_ratio is None:
                lambda_min_ratio = 0.01 if n_samples < n_features else 1e-4
            lambdas = np.exp(np.linspace(np.log(lam_max), np.log(lam_max * lambda_min_ratio), nlambda))
        else:
            lambdas = np.zeros(nlambda)
    else:
        lambdas = lambda_path

    max_scale = float(torch.max(y_scale))
    l2s = (1.0 - alpha) * lambdas / max_scale
    l1s = alpha * lambdas / max_scale

    # ---- step sizes ----
    if pre_row_sq is not None:
        max_sq = float(np.max(pre_row_sq * (weights_np > 0)))
    else:
        max_sq = _max_sq_row_norm(x, xc, (weights > 0).to(torch.float64))
    top_sq = float(power_iteration_sq_norm(x, seed=seed, x_center_scaled=xc)) / w_total if batch_size > 1 else None
    gammas = saga_step_sizes(max_sq, top_sq, l2s, w_total, batch_size, intercept, fam.L_scaling)
    if head_dtype == torch.int8 and isinstance(x, HybridCSR):
        # a prebuilt float head is quantized on the device after its
        # standardization, as the JAX package does (a head fit built from
        # scipy input is int8 already)
        x = x.quantize_head()

    # ---- pad rows to a multiple of batch_size (of shards * batch_size under
    # a mesh: each rank's rows are a whole number of batches) ----
    if mesh is None:
        n_pad = ((n_samples + batch_size - 1) // batch_size) * batch_size
    else:
        n_pad = pad_to_shards(n_samples, mesh.size, batch_size)
    ek_ok, sampling = _epoch_kernel_gate(
        use_epoch_kernel, sampling, dev, dtype, n_samples, n_pad, n_features, n_classes, batch_size,
        dense=not is_sparse, plain_only=debug or box is not None or mesh is not None,
        with_offs=offs64 is not None, warm=warm_state is not None)
    if sampling == "block":
        # shuffle rows once (seed-deterministic, as in the JAX package) so
        # contiguous blocks are random samples even for ordered input
        rperm_np = np.random.default_rng(seed + 0x5EED).permutation(n_samples)
        rperm = torch.as_tensor(rperm_np, device=dev)
        if head_nnz is not None:  # the head is rebuilt from its shuffled nonzeros below
            x = replace(x, tail=x.tail.take_rows(rperm))
            head_nnz = head_nnz.take_rows(rperm_np)
        elif is_sparse:
            x = x.take_rows(rperm)
        else:
            x = x[rperm]
        y_proc = y_proc[rperm]
        weights = weights[rperm]
        if offs64 is not None:
            offs64 = offs64[rperm]

    offs_dev = None if offs64 is None else offs64.to(dtype)
    if head_nnz is not None and (sampling == "block" or n_pad > n_samples):
        # one scatter builds the int8 head shuffled and padded; the
        # unshuffled one is dropped first, so one head is resident at a time
        tail, scale = x.tail.pad_rows(n_pad), x.head_scale
        x = None
        x = HybridCSR(materialize_int8_head(head_nnz, n_pad, device=dev), tail, n_pad, n_features, head_scale=scale)
    elif is_sparse:
        x = x.pad_rows(n_pad)
    if n_pad > n_samples:
        extra = n_pad - n_samples
        if not is_sparse:
            x = torch.cat([x, torch.zeros((extra, n_features), **tens)])
        y_proc = torch.cat([y_proc, torch.zeros((extra, y_proc.shape[1]), **tens)])
        weights = torch.cat([weights, torch.zeros((extra,), **tens)])
        if offs_dev is not None:
            offs_dev = torch.cat([offs_dev, torch.zeros((extra, offs_dev.shape[1]), **tens)])

    # ---- solver state ----
    if warm_state is None:
        state0 = init_state(n_pad, n_features, n_classes, dtype, dev)
        # intercept warm-started at the null model
        if offs_dev is not None:
            null_int = b0_offs
        else:
            null_int = fam.null_intercept(y_proc.to(torch.float64), intercept, weights.to(torch.float64))
        state0 = state0._replace(intercept=null_int.to(dtype))
    else:
        state0 = SagaState(*(t.to(**tens) for t in warm_state))

    if offs_dev is not None:
        null_dev_scaled = float(fam.null_deviance_offset(
            y_proc.to(torch.float64), offs_dev.to(torch.float64), intercept, weights.to(torch.float64), b0=b0_offs
        ))
    else:
        null_dev_scaled = float(fam.null_deviance(y_proc.to(torch.float64), intercept, weights.to(torch.float64)))

    # block sampling + hybrid layout: the tail's true nonzeros packed per block
    if sampling == "block" and isinstance(x, HybridCSR):
        x = replace(x, blk_tail=BlockCOO.from_padded(x.tail, batch_size))

    if intercept_decay is None:
        # the reference's sparse damping, but not for poisson: its exp link
        # makes every rate exponentially sensitive to the intercept
        intercept_decay = 0.01 if (is_sparse and family != "poisson") else 1.0
    if sparse_mode is None:
        sparse_mode = "densify" if n_features <= 8192 else "gather"
    if use_pallas is None:
        # K2 by default where the JAX package runs its Pallas kernel: a bf16
        # hybrid head under block sampling, on the card, unmeshed
        use_pallas = (sampling == "block" and isinstance(x, HybridCSR) and x.head.dtype == torch.bfloat16
                      and dev.type == "cuda" and mesh is None)

    config = SolverConfig(
        batch_size=batch_size,
        max_iter=maxit,
        fit_intercept=intercept,
        intercept_decay=intercept_decay,
        g_sum_refresh=True,
        g_sum_refresh_every=g_sum_refresh_every,
        sparse_mode=sparse_mode,
        sampling=sampling,
        step_backoff=step_backoff,
        debug=debug,
        use_pallas=bool(use_pallas),
        use_epoch_kernel=ek_ok and sampling == "block",
        use_tail_kernel=use_tail_kernel,
    )

    if screen == "auto":
        # regime-aware screening; ineligible fits (mesh, ridge, debug) run
        # the unscreened schedule: "auto" chooses, it never errors
        screen = "auto" if (mesh is None and alpha > 0.0 and not debug) else False
    if screen and (mesh is not None or alpha == 0.0 or debug):
        raise ValueError("screen=True requires a single device, alpha > 0, and debug=False")

    nnz_per_epoch = x.total_nnz() if is_sparse else n_pad * n_features
    if mesh is not None:
        # every rank computed the path from the whole data; rank 0's values
        # are taken, so no rank can branch on a difference in the last bits
        # (a scatter on the card sums in no fixed order)
        nl = len(l1s)
        path = mesh.broadcast(torch.as_tensor(np.concatenate([gammas, l1s, l2s, lambdas]), **f64))
        gammas, l1s, l2s, lambdas = (a.numpy() for a in path.cpu().split(nl))
        mesh.broadcast(state0.intercept)
        if box is not None:
            box = tuple(mesh.broadcast(b.contiguous()) for b in box)
        # the rank's rows (as fit_path_sharded takes them); the full design
        # is dropped here
        x, y_proc, weights, offs_dev, state0 = shard_path_inputs(mesh, x, y_proc, weights, offs_dev, state0)
        config = replace(config, mesh=mesh)
        counts0 = dict(mesh.counts)

    t0 = time.perf_counter()
    scr_stats = chunk_stats = None
    counts = PathCounts()
    if screen:
        w_scr, b_scr, dev_scr, it_scr, codes_scr, n_iter, scr_stats = screened_path(
            x, y_proc, weights, gammas, l1s, l2s, thresh, fam, penalty, config, xc=xc, pf=pf_dev, box=box,
            always_inactive=excl_mask, offs=offs_dev,
            intercept0=None if offs_dev is None else b0_offs.cpu().numpy(), auto_full_tail=screen == "auto",
            full_tail_chunk=lambda_chunk, seed=seed, counts=counts,
        )
        state = None
        results = SimpleNamespace(w=w_scr, intercept=b_scr, deviance=dev_scr, return_codes=codes_scr,
                                  losses=np.zeros((len(l1s), 0)), clamp_gap=np.zeros(len(l1s)))
    elif mesh is None and lambda_chunk is not None and lambda_chunk < len(l1s):
        n_orders = order_count(config, n_pad)

        def fit_chunk(lo, hi, st, gmul, try_):
            return fit_path(x, y_proc, weights, gammas[lo:hi] * gmul, l1s[lo:hi], l2s[lo:hi], thresh, st, fam,
                            penalty, config, offs=offs_dev, pf=pf_dev, box=box, xc=xc,
                            order_fn=saga.default_order_fn(seed, n_orders, lo + 1000 * try_), counts=counts, lam0=lo)

        state, n_iter, results, chunk_stats = _chunked_path(fit_chunk, state0, len(l1s), lambda_chunk, thresh)
    else:
        state, n_iter, results = fit_path(
            x, y_proc, weights, gammas, l1s, l2s, thresh, state0, fam, penalty, config,
            offs=offs_dev, pf=pf_dev, box=box, seed=seed, xc=xc, counts=counts,
        )
    wall = time.perf_counter() - t0  # fit_path returns host arrays: synced

    # ---- rescale to original units ----
    w_path = np.asarray(results.w, dtype=np.float64)  # (nl, k, p)
    epochs = int(n_iter)
    stats = {
        "wall_time_s": wall,
        "epochs": epochs,
        "nnz": nnz_per_epoch * max(epochs, 1),
        "nnz_per_s": nnz_per_epoch * max(epochs, 1) / max(wall, 1e-9),
        "layout": _layout_stats(x),
        "device": str(dev),
        "epoch_kernel": config.use_epoch_kernel,
        # K1 launches over the path (each a chunk of epochs, with one sync)
        "epoch_chunks": (scr_stats["epoch_chunks"] if screen else chunk_stats["epoch_chunks"] if chunk_stats
                         else int(results.n_chunks.sum())),
        "head_kernel": scr_stats["head_kernel"] if screen else (not config.use_epoch_kernel
                                                                and uses_head_kernel(x, fam, config)),
        # K3 / K4 ran: on a screened path only where a group fitted the full layout
        "tail_kernel": scr_stats["tail_kernel"] if screen else (isinstance(x, HybridCSR) and x.blk_tail is not None
                                                                and use_tail_kernel),
        "layout_plan": None if layout_plan is None else asdict(layout_plan),
        "epochs_by_attempt": counts.epochs_by_attempt,
        "host_syncs": counts.host_syncs,
    }
    if chunk_stats is not None:
        stats["lambda_chunk"] = {k: v for k, v in chunk_stats.items() if k != "epoch_chunks"}
    if mesh is not None:
        stats["mesh"] = {"axis": mesh.axis, "size": mesh.size, "rank": mesh.rank, "backend": mesh.backend}
        stats["allreduces"] = {k: v - counts0.get(k, 0) for k, v in mesh.counts.items()}
        stats["allreduces"]["total"] = sum(stats["allreduces"].values())
    if screen:
        # the work basis: the elements the solver streamed on its active-set
        # subsets; the full design's figure stays as coverage
        stats["screening"] = scr_stats
        stats["coverage_nnz"] = stats["nnz"]
        stats["nnz"] = scr_stats["work_elems"]
        stats["nnz_per_s"] = scr_stats["work_elems"] / max(wall, 1e-9)
    b_path = np.asarray(results.intercept, dtype=np.float64)  # (nl, k)
    x_scale_np = x_scale.cpu().numpy()
    x_center_np = x_center.cpu().numpy()
    y_scale_np = y_scale.cpu().numpy()
    y_center_np = y_center.cpu().numpy()

    beta = w_path * y_scale_np[None, :, None] / x_scale_np[None, None, :]
    # snap numerical residue to exact zero so sparsity patterns match the
    # exact-prox zeros
    tiny = 10 * np.finfo(np.asarray(results.w).dtype).eps * max(1.0, np.abs(beta).max())
    beta[np.abs(beta) < tiny] = 0.0
    a0 = b_path * y_scale_np[None, :]
    if intercept:
        a0 = a0 + y_center_np[None, :] - np.einsum("j,lkj->lk", x_center_np, beta)
    if family == "multinomial":  # intercepts re-centered to sum 0
        a0 = a0 - a0.mean(axis=1, keepdims=True)
    if col_perm is not None:  # undo the hybrid column permutation
        unperm = np.empty_like(beta)
        unperm[:, :, col_perm] = beta
        beta = unperm

    dev_path = np.asarray(results.deviance, dtype=np.float64)
    if null_dev_scaled != 0.0:
        dev_ratio = 1.0 - dev_path / null_dev_scaled
    else:  # degenerate constant-response case
        dev_ratio = np.zeros_like(dev_path)

    clamp_gap = np.asarray(results.clamp_gap, dtype=np.float64)
    if family == "poisson" and (
        np.nanmax(np.abs(clamp_gap)) > 1e-6 * max(abs(null_dev_scaled), 1.0) or not np.isfinite(dev_path).all()
    ):
        import warnings

        warnings.warn(
            "the poisson smoothness clamp is active at the fitted solution "
            "for at least one lambda: the reported deviance is exact but the "
            "solver optimized the clamped objective — refit with a larger "
            "`poisson_smoothness` for a reliable fit.",
            RuntimeWarning,
            stacklevel=2,
        )

    nz = np.abs(beta) > 0
    df = nz.any(axis=1).sum(axis=1)  # features nonzero in any class
    dfmat = nz.sum(axis=2).T if n_classes > 1 else None  # (k, nl)

    fit_obj = SgdnetFit(
        a0=a0 if n_classes > 1 else a0[:, 0],
        beta=beta,
        lambda_=np.asarray(lambdas, dtype=np.float64),
        dev_ratio=dev_ratio,
        df=df,
        dfmat=dfmat,
        nulldev=nulldev,
        npasses=int(n_iter),
        return_codes=np.asarray(results.return_codes),
        alpha=alpha,
        family=family,
        classnames=classnames,
        grouped=grouped,
        nobs=n_samples,
        offset=offset_arr is not None,
        feature_names=list(feature_names) if feature_names is not None else None,
        diagnostics={"loss": np.asarray(results.losses, dtype=np.float64)} if debug else None,
        final_state=state,
        stats=stats,
    )
    fit_obj._refit_args = dict(
        family=family,
        alpha=alpha,
        maxit=maxit,
        standardize=standardize,
        intercept=intercept,
        thresh=thresh,
        standardize_response=standardize_response,
        type_multinomial=type_multinomial,
        batch_size=batch_size,
        dtype=dtype,
        seed=seed,
        sampling=sampling,
        sample_weight=weights_np if sample_weight is not None else None,
        offset=offset_arr,
        penalty_factor=penalty_factor,
        lower_limits=lower_limits,
        upper_limits=upper_limits,
        exclude=exclude,
        poisson_smoothness=poisson_smoothness,
        hybrid=hybrid,
        hybrid_coverage=hybrid_coverage,
        hybrid_max_head=hybrid_max_head,
        hybrid_memory_budget=hybrid_memory_budget,
        hybrid_head_dtype=hybrid_head_dtype,
        sparse_mode=sparse_mode,
        g_sum_refresh_every=g_sum_refresh_every,
        use_pallas=use_pallas,
        use_epoch_kernel=use_epoch_kernel,
        intercept_decay=intercept_decay,
        step_backoff=step_backoff,
        device=dev,
        use_tail_kernel=use_tail_kernel,
    )
    return fit_obj
