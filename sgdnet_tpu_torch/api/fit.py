"""Model-fitting front end (twin of sgdnet_tpu/api/fit.py, dense path).

Input validation, response encoding, feature standardization, lambda-path
construction, the K1/K2 kernel gates, solver dispatch and output assembly
into an `SgdnetFit`.  Every tensor is created on the fit's `device`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from sgdnet_tpu_torch.families import get_family, lambda_max_offset
from sgdnet_tpu_torch.penalties import select_penalty
from sgdnet_tpu_torch.solver import epoch_kernel
from sgdnet_tpu_torch.solver.saga import SagaState, SolverConfig, fit_path, init_state, uses_head_kernel
from sgdnet_tpu_torch.solver.stepsize import power_iteration_sq_norm, saga_step_sizes

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
    #: wall_time_s, epochs, nnz, nnz_per_s, layout, device, and which
    #: kernels ran (epoch_kernel = K1, head_kernel = K2)
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


def _resolve_device(device) -> torch.device:
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device)


def _not_in_slice(name: str, item: str):
    raise NotImplementedError(f"{name} is not ported to sgdnet_tpu_torch yet (ROADMAP Queue 1 item {item})")


def _weighted_column_stats(x: torch.Tensor, weights: torch.Tensor):
    w = weights.reshape(-1, 1).to(torch.float64)
    W = torch.clamp(torch.sum(w), min=1e-12)
    xf = x.to(torch.float64)
    mean = torch.sum(xf * w, dim=0) / W
    var = torch.sum(w * (xf - mean) ** 2, dim=0) / W
    sd = torch.where(var == 0.0, torch.ones_like(var), torch.sqrt(var))
    return mean, sd


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
    hybrid_max_head: int = 16384,
    hybrid_memory_budget: float = 2e9,
    hybrid_head_dtype=None,
    g_sum_refresh_every: int = 1,
    lambda_chunk: int | None = None,
    step_backoff: bool = True,
    device=None,
) -> SgdnetFit:
    """Fit an elastic-net regularized GLM path with batched SAGA.

    The keywords and their meaning are those of `sgdnet_tpu.fit` (see its
    docstring), on a dense design.  Additions: `device` (a torch device;
    None picks "cuda" when available, else "cpu") on which every tensor of
    the fit is created.

    The kernel switches keep the JAX package's names:
    `use_epoch_kernel` selects K1, the hand-written CUDA whole-epoch kernel
    (None: on for dense f32 CUDA fits within its gate; True: on wherever
    the gate admits the problem, running its plain torch twin on the CPU);
    `use_pallas` selects K2, the hand-written CUDA fused head step, for
    block sampling (default off; on the CPU the twin runs).

    Not ported yet, and raising NotImplementedError: `mesh`, `screen`
    other than False, the `hybrid*` layout options, `sparse_mode`,
    scipy-sparse `x`, and `lambda_chunk`.
    """
    # ---- keywords outside the dense slice ----
    if mesh is not None:
        _not_in_slice("mesh (data-parallel fits)", "9")
    if screen is not False:
        _not_in_slice("screen", "11")
    if (hybrid is not None or hybrid_coverage != 0.9 or hybrid_max_head != 16384
            or hybrid_memory_budget != 2e9 or hybrid_head_dtype is not None):
        _not_in_slice("the hybrid dense-head/sparse-tail layout", "6")
    if sparse_mode is not None:
        _not_in_slice("sparse_mode", "6")
    if lambda_chunk is not None:
        _not_in_slice("lambda_chunk", "5 (relay workaround, not ported)")
    try:
        import scipy.sparse as sp

        if sp.issparse(x):
            _not_in_slice("scipy-sparse x", "6")
    except ImportError:
        pass

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
    dev = _resolve_device(device)
    tens = dict(dtype=dtype, device=dev)
    f64 = dict(dtype=torch.float64, device=dev)

    if isinstance(x, torch.Tensor):
        x_in = x.detach()
        if x_in.ndim != 2:
            raise ValueError("x must be a 2-D matrix")
        if x_in.is_floating_point() and bool(torch.isnan(x_in).any()):
            raise ValueError("NA values are not allowed.")
    else:
        x_in = np.asarray(x)
        if x_in.ndim != 2:
            raise ValueError("x must be a 2-D matrix")
        if x_in.dtype != object and np.issubdtype(x_in.dtype, np.floating) and np.isnan(x_in).any():
            raise ValueError("NA values are not allowed.")
    x = torch.as_tensor(x_in).to(**tens)
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

    if pf_np is not None:
        # rescale: mean over non-excluded features = 1
        sel = ~excl_mask if excl_mask is not None else np.ones(n_features, bool)
        if sel.any():
            m = float(pf_np[sel].mean())
            if m > 0:
                pf_np = pf_np / m

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
        # data-dependent curvature bound for the exp link, rounded up to a
        # power of two
        if poisson_smoothness is None:
            ym = y_enc[:, 0]
            bound = max(float(ym.max()) * 2.0, float(ym.mean()) * 4.0, 2.0)
        else:
            bound = float(poisson_smoothness)
        fam = get_family("poisson", smoothness=float(2.0 ** np.ceil(np.log2(bound))))

    # ---- linear-predictor offset ----
    offset_arr = None
    offset_arr_internal = None
    if offset is not None:
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
            y_enc = y_enc - offset_arr  # identity link: absorb into the response
        else:
            offset_arr_internal = offset_arr

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

    # ---- feature standardization ----
    if standardize:
        x_center, x_scale = _weighted_column_stats(x, weights)
        x = ((x.to(torch.float64) - x_center) / x_scale).to(dtype)
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
    box = None
    pf_dev = None if pf_np is None else torch.as_tensor(pf_np).to(**tens)
    if lower_np is not None or upper_np is not None or excl_mask is not None:
        lo = lower_np if lower_np is not None else np.full(n_features, -np.inf)
        hi = upper_np if upper_np is not None else np.full(n_features, np.inf)
        if excl_mask is not None:
            lo, hi = lo.copy(), hi.copy()
            lo[excl_mask] = 0.0
            hi[excl_mask] = 0.0
        if (lo > hi).any():
            raise ValueError("lower_limits must be <= upper_limits")
        xs_np = x_scale.cpu().numpy()
        ys_np = y_scale.cpu().numpy()
        box = (
            torch.as_tensor(lo[None, :] * xs_np[None, :] / ys_np[:, None]).to(**tens),
            torch.as_tensor(hi[None, :] * xs_np[None, :] / ys_np[:, None]).to(**tens),
        )

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
    per_row = torch.sum(x.to(torch.float64) ** 2, dim=1)
    max_sq = float(torch.max(per_row * (weights > 0).to(torch.float64)))
    top_sq = float(power_iteration_sq_norm(x, seed=seed)) / w_total if batch_size > 1 else None
    gammas = saga_step_sizes(max_sq, top_sq, l2s, w_total, batch_size, intercept, fam.L_scaling)

    # ---- pad rows to a multiple of batch_size ----
    n_pad = ((n_samples + batch_size - 1) // batch_size) * batch_size
    # ---- K1 gate: dense f32 problems within the Hopper gate run each epoch
    # as one kernel launch; by default on CUDA only (on the CPU the twin
    # runs on explicit opt-in, as interpret mode does in the JAX package).
    # Box limits stay on the step path.
    ek_ok = (
        use_epoch_kernel is not False
        and not debug
        and warm_state is None
        and box is None
        and dtype == torch.float32
        and epoch_kernel.supported(n_pad, n_features, n_classes, batch_size, with_offs=offs64 is not None)
        and (use_epoch_kernel is True or dev.type == "cuda")
    )
    if sampling is None:
        # with a warm_state stay with permutation: block mode pre-shuffles
        # rows and would misalign a g_mem saved under another order
        if warm_state is not None:
            sampling = "permutation"
        elif ek_ok:
            sampling = "block"
        else:
            sampling = "block" if n_samples >= 32768 else "permutation"
    if sampling not in ("permutation", "block"):
        raise ValueError("sampling must be 'permutation' or 'block'")
    if sampling == "block":
        # shuffle rows once (seed-deterministic, as in the JAX package) so
        # contiguous blocks are random samples even for ordered input
        rperm = torch.as_tensor(np.random.default_rng(seed + 0x5EED).permutation(n_samples), device=dev)
        x = x[rperm]
        y_proc = y_proc[rperm]
        weights = weights[rperm]
        if offs64 is not None:
            offs64 = offs64[rperm]

    offs_dev = None if offs64 is None else offs64.to(dtype)
    if n_pad > n_samples:
        extra = n_pad - n_samples
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

    if intercept_decay is None:
        intercept_decay = 1.0  # the 0.01 damping is a sparse-layout default

    config = SolverConfig(
        batch_size=batch_size,
        max_iter=maxit,
        fit_intercept=intercept,
        intercept_decay=intercept_decay,
        g_sum_refresh=True,
        g_sum_refresh_every=g_sum_refresh_every,
        sampling=sampling,
        step_backoff=step_backoff,
        debug=debug,
        use_pallas=bool(use_pallas),
        use_epoch_kernel=ek_ok and sampling == "block",
    )

    t0 = time.perf_counter()
    state, n_iter, results = fit_path(
        x, y_proc, weights, gammas, l1s, l2s, thresh, state0, fam, penalty, config,
        offs=offs_dev, pf=pf_dev, box=box, seed=seed,
    )
    wall = time.perf_counter() - t0  # fit_path returns host arrays: synced

    # ---- rescale to original units ----
    w_path = np.asarray(results.w, dtype=np.float64)  # (nl, k, p)
    nnz_per_epoch = n_pad * n_features
    epochs = int(n_iter)
    stats = {
        "wall_time_s": wall,
        "epochs": epochs,
        "nnz": nnz_per_epoch * max(epochs, 1),
        "nnz_per_s": nnz_per_epoch * max(epochs, 1) / max(wall, 1e-9),
        "layout": {"kind": "dense"},
        "device": str(dev),
        "epoch_kernel": config.use_epoch_kernel,
        "head_kernel": not config.use_epoch_kernel and uses_head_kernel(x, fam, config),
    }
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
        g_sum_refresh_every=g_sum_refresh_every,
        use_pallas=use_pallas,
        use_epoch_kernel=use_epoch_kernel,
        intercept_decay=intercept_decay,
        step_backoff=step_backoff,
        device=dev,
    )
    return fit_obj
