"""The two-solver relative benchmark on the port (twin of
sgdnet_tpu/benchmarks/relative.py): the reference's `benchmarks` artifact.

The reference ships loss-against-time curves of itself against glmnet
(data/benchmarks.rda; protocol data-raw/benchmarks.R:35-112): each solver
fits at lambda = 1/n under a sweep of stopping strictness.  Here the
partner is scikit-learn: coordinate descent for the gaussian families,
SAGA logistic regression for the link families.  Both report the same
objective (the mean family loss at lambda = 1/n), and `normalize_curves`
applies the reference's per-run [0, 1] normalization
(data-raw/benchmarks.R:5-33).  sklearn is imported at first use: without
it `sklearn_curve` and `run_relative` raise ImportError.
"""

from __future__ import annotations

import time

import numpy as np

from sgdnet_tpu_torch.benchmarks.convergence import bundled_datasets, convergence_curve_trace


def _sklearn_fit(x, y, family: str, alpha: float, lam: float, max_iter: int, tol: float):
    """One sklearn fit at lambda = 1/n with bounded iterations; returns a
    predictor object exposing the final coefficients via a fit-like shim."""
    import warnings

    from sklearn.linear_model import (
        ElasticNet,
        Lasso,
        LogisticRegression,
        MultiTaskElasticNet,
        Ridge,
    )

    xt = np.asarray(x, dtype=np.float64)
    yt = np.asarray(y)
    n = len(yt)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if family == "gaussian":
            if alpha == 0.0:
                m = Ridge(alpha=n * lam, fit_intercept=True, max_iter=max_iter, tol=tol,
                          solver="sag")
            elif alpha == 1.0:
                m = Lasso(alpha=lam, fit_intercept=True, max_iter=max_iter, tol=tol)
            else:
                m = ElasticNet(alpha=lam, l1_ratio=alpha, fit_intercept=True,
                               max_iter=max_iter, tol=tol)
            m.fit(xt, yt.ravel())
        elif family in ("binomial", "multinomial"):
            if alpha == 0.0:
                penalty, l1_ratio = "l2", None
            elif alpha == 1.0:
                penalty, l1_ratio = "l1", None
            else:
                penalty, l1_ratio = "elasticnet", alpha
            m = LogisticRegression(
                penalty=penalty, l1_ratio=l1_ratio, C=1.0 / (n * lam), solver="saga",
                fit_intercept=True, max_iter=max_iter, tol=tol,
            )
            m.fit(xt, yt.ravel())
        else:  # mgaussian
            m = MultiTaskElasticNet(alpha=lam, l1_ratio=max(alpha, 1e-6),
                                    fit_intercept=True, max_iter=max_iter, tol=tol)
            m.fit(xt, yt)
    return m


def _sklearn_loss(m, x, y, family: str):
    """Mean family loss of the sklearn model (same objective as ours)."""
    xt = np.asarray(x, dtype=np.float64)
    if family == "gaussian":
        pred = m.predict(xt)
        return float(0.5 * np.mean((pred - np.asarray(y).ravel()) ** 2))
    if family == "binomial":
        lp = xt @ m.coef_[0] + m.intercept_[0]
        # labels may be strings (e.g. heart's 'presence'/'absence'):
        # encode against the sorted class set, matching sklearn's classes_
        yv = np.asarray(y).ravel()
        classes = np.unique(yv)
        y01 = (yv == classes[-1]).astype(float)
        return float(np.mean(np.logaddexp(0, lp) - y01 * lp))
    if family == "multinomial":
        lp = xt @ m.coef_.T + m.intercept_  # (n, k)
        yv = np.asarray(y).ravel()
        classes = list(m.classes_)
        onehot = np.zeros_like(lp)
        for i, c in enumerate(yv):
            onehot[i, classes.index(c)] = 1.0
        mx = lp.max(axis=1, keepdims=True)
        lse = np.log(np.exp(lp - mx).sum(axis=1)) + mx[:, 0]
        return float(np.mean(lse - (lp * onehot).sum(axis=1)))
    # mgaussian
    pred = m.predict(xt)
    return float(0.5 * np.mean(np.sum((pred - np.asarray(y)) ** 2, axis=1)))


def sklearn_curve(x, y, family="gaussian", alpha=1.0, iter_grid=None):
    """Loss-vs-time curve for the sklearn reference solver at lambda = 1/n:
    iteration-budget sweep (the analog of the reference's glmnet tolerance
    sweep, data-raw/benchmarks.R:41-45)."""
    n = np.asarray(y).shape[0]
    lam = 1.0 / n
    if iter_grid is None:
        iter_grid = np.unique(np.logspace(0, np.log10(2000), 12).astype(int))
    times, losses = [], []
    for it in iter_grid:
        t0 = time.perf_counter()
        m = _sklearn_fit(x, y, family, alpha, lam, int(it), tol=0.0)
        times.append(time.perf_counter() - t0)
        losses.append(_sklearn_loss(m, x, y, family))
    return {
        "times": np.asarray(times),
        "losses": np.asarray(losses),
        "iters": np.asarray(iter_grid),
        "alpha": alpha,
        "family": family,
        "solver": "sklearn",
    }


def normalize_curves(*curves, bins: int = 20):
    """Reference normalization (data-raw/benchmarks.R:5-33): times scaled to
    [0, 1] by the slowest run across solvers, losses to [0, 1] by the shared
    loss range; median loss per time bin per solver."""
    t_max = max(float(c["times"].max()) for c in curves)
    lo = min(float(c["losses"].min()) for c in curves)
    hi = max(float(c["losses"].max()) for c in curves)
    span = max(hi - lo, 1e-300)
    out = []
    edges = np.linspace(0.0, 1.0, bins + 1)
    for c in curves:
        t = c["times"] / t_max
        l_ = (c["losses"] - lo) / span
        mids, meds = [], []
        for b in range(bins):
            sel = (t >= edges[b]) & (t < edges[b + 1] + (1e-12 if b == bins - 1 else 0))
            if sel.any():
                mids.append((edges[b] + edges[b + 1]) / 2)
                meds.append(float(np.median(l_[sel])))
        out.append({"time": np.asarray(mids), "loss": np.asarray(meds), **{
            k: c[k] for k in ("alpha", "family") if k in c}})
    return out


def run_relative(datasets=None, alphas=(1.0, 0.0), device=None, **fit_kwargs):
    """Both solvers' loss-against-time curves on the bundled datasets (or
    `datasets`), the port's from `convergence_curve_trace` on `device`:
    {"name/lasso" | ...: {"sgdnet_tpu_torch": curve, "sklearn": curve}}."""
    out = {}
    for name, ((x, y), family) in (datasets or bundled_datasets()).items():
        # both solvers get the same standardized matrix: sklearn does not
        # standardize, and an L1 penalty on raw-scale coefficients is
        # another problem (glmnet and sgdnet standardize by default)
        xs = np.asarray(x, dtype=np.float64)
        sd = xs.std(axis=0)
        xs = (xs - xs.mean(axis=0)) / np.where(sd == 0.0, 1.0, sd)
        for alpha in alphas:
            pen = {1.0: "lasso", 0.0: "ridge"}.get(alpha, f"enet{alpha}")
            ours = convergence_curve_trace(xs, y, family=family, alpha=alpha, device=device, **fit_kwargs)
            ref = sklearn_curve(xs, y, family=family, alpha=alpha)
            out[f"{name}/{pen}"] = {"sgdnet_tpu_torch": ours, "sklearn": ref}
    return out
