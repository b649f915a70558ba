"""Plotting: coefficient paths and cross-validation curves (twin of
sgdnet_tpu/api/plot.py).

matplotlib versions of the reference's lattice plots (R/plot.sgdnet.R:55-124
and R/plot.cv_sgdnet.R:46-131): `plot_path` draws each coefficient against
the L1 norm, log lambda or the deviance ratio; `plot_cv` the CV error curve
with a +-1 SD band and the lambda_min / lambda_1se lines, a panel an alpha.
matplotlib is imported at first use, under the Agg backend.
"""

from __future__ import annotations

import numpy as np


def _xvar_values(fit, xvar: str):
    beta = fit.beta  # (nl, k, p)
    if xvar == "norm":
        return np.abs(beta).sum(axis=(1, 2)), "L1 norm"
    if xvar == "lambda":
        return np.log(fit.lambda_), r"log $\lambda$"
    if xvar == "dev":
        return fit.dev_ratio, "fraction deviance explained"
    raise ValueError("xvar must be one of 'norm', 'lambda', 'dev'")


def plot_path(fit, xvar: str = "norm", ax=None, **kwargs):
    """Coefficient profile plot; a panel a class / response for the
    multivariate families.  Returns the matplotlib Figure."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    x, xlabel = _xvar_values(fit, xvar)
    k = fit.beta.shape[1]

    if ax is not None:
        axes = [ax]
        fig = ax.figure
        if k != 1:
            raise ValueError("pass ax only for single-response fits")
    else:
        ncol = min(k, 3)
        nrow = (k + ncol - 1) // ncol
        fig, axs = plt.subplots(nrow, ncol, figsize=(4 * ncol, 3.2 * nrow), squeeze=False)
        axes = axs.ravel()

    for c in range(k):
        a = axes[c]
        for j in range(fit.beta.shape[2]):
            a.plot(x, fit.beta[:, c, j], lw=1, **kwargs)
        a.set_xlabel(xlabel)
        a.set_ylabel(r"$\hat\beta$")
        if k > 1:
            name = fit.classnames[c] if fit.classnames else str(c)
            a.set_title(str(name))
    for a in axes[k:]:
        a.set_visible(False)
    fig.tight_layout()
    return fig


def plot_cv(cv, ax=None):
    """CV error curves with a +-1 SD band and the lambda_min / lambda_1se
    lines, a panel an alpha.  Returns the matplotlib Figure."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    alphas = np.asarray(cv.alpha)
    n_alpha = len(alphas)
    if ax is not None:
        if n_alpha != 1:
            raise ValueError("pass ax only for a CV over one alpha")
        axes = [ax]
        fig = ax.figure
    else:
        fig, axs = plt.subplots(1, n_alpha, figsize=(4.5 * n_alpha, 3.5), squeeze=False)
        axes = axs.ravel()

    s = cv.cv_summary
    for i, a_val in enumerate(alphas):
        a = axes[i]
        sel = s["alpha"] == a_val
        lam = np.log(s["lambda"][sel])
        mean, lo, up = s["mean"][sel], s["ci_lo"][sel], s["ci_up"][sel]
        a.fill_between(lam, lo, up, alpha=0.25, lw=0)
        a.plot(lam, mean, marker="o", ms=3)
        a.axvline(np.log(cv.lambda_min), ls="--", lw=0.8)
        a.axvline(np.log(cv.lambda_1se), ls=":", lw=0.8)
        a.set_xlabel(r"log $\lambda$")
        a.set_ylabel(cv.name)
        if n_alpha > 1:
            a.set_title(rf"$\alpha$ = {a_val}")
    fig.tight_layout()
    return fig
