"""k-fold cross-validation over an (alpha grid x lambda path) (twin of
sgdnet_tpu/api/cv.py).

Classic k-fold: train on k-1 folds, test on the held-out fold.  With
`parallel=False` each fold is refitted with the port's `fit` on its
training rows and scored with `score`; with `parallel=True` the folds are
0/1 sample-weight masks over one padded design on the device
(parallel/cv.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sgdnet_tpu_torch.api.fit import SgdnetFit, fit as fit_fn, mesh_device
from sgdnet_tpu_torch.api.score import score as score_fn


@dataclass
class CvFit:
    """Cross-validation result (the reference's cv_sgdnet object)."""

    alpha: np.ndarray  # alpha grid
    lambda_: list  # per-alpha lambda paths
    cv_summary: dict  # columns: alpha, lambda, mean, sd, ci_lo, ci_up
    cv_raw: list  # per-alpha (nfolds, nlambda) score matrices
    name: str
    fit: SgdnetFit  # full-data fit at the winning alpha
    fits: list  # full-data fits for every alpha
    alpha_min: float
    lambda_min: float
    lambda_1se: float
    type_measure: str

    def predict(self, newx=None, s="lambda_min", type="link", **kwargs):
        if isinstance(s, str):
            if s not in ("lambda_min", "lambda_1se"):
                raise ValueError("s must be 'lambda_min', 'lambda_1se', or numeric")
            s = getattr(self, s)
        from sgdnet_tpu_torch.api.predict import predict

        return predict(self.fit, newx=newx, s=s, type=type, **kwargs)

    def coef(self, s="lambda_min", **kwargs):
        return self.predict(s=s, type="coefficients", **kwargs)

    def score(self, x, y, type_measure=None, s="lambda_1se", offset=None):
        if isinstance(s, str):
            s = getattr(self, s)
        return score_fn(self.fit, x, y, type_measure or self.type_measure, s=s, offset=offset)

    def deviance(self):
        """Deviance along the winning fit's path."""
        return self.fit.deviance()

    def plot(self, **kwargs):
        from sgdnet_tpu_torch.api.plot import plot_cv

        return plot_cv(self, **kwargs)

    def summary(self) -> str:
        """Text summary."""
        lines = [
            f"Cross-validation ({self.name})",
            f"  alpha_min:  {self.alpha_min:g}",
            f"  lambda_min: {self.lambda_min:.6g}",
            f"  lambda_1se: {self.lambda_1se:.6g}",
            "",
            "  alpha    lambda      mean        sd",
        ]
        s = self.cv_summary
        for i in range(len(s["lambda"])):
            lines.append(
                f"  {s['alpha'][i]:<6g} {s['lambda'][i]:<10.4g} "
                f"{s['mean'][i]:<10.5g} {s['sd'][i]:<10.5g}"
            )
        return "\n".join(lines)

    def __repr__(self):
        return (
            f"CvFit(name={self.name!r}, alpha_min={self.alpha_min}, "
            f"lambda_min={self.lambda_min:.6g}, lambda_1se={self.lambda_1se:.6g})"
        )


_MEASURE_NAMES = {
    "deviance": {
        "gaussian": "Mean-Squared Error",
        "mgaussian": "Mean-Squared Error",
        "binomial": "Binomial Deviance",
        "poisson": "Poisson Deviance",
        "multinomial": "Multinomial Deviance",
    },
    "mse": "Mean-Squared Error",
    "mae": "Mean Absolute Error",
    "class": "Misclassification Error",
    "auc": "AUC",
}


def _find_optimum(lambdas, means, sds, maximize=False):
    """lambda_min / lambda_1se selection: the best mean, and the largest
    lambda within one standard deviation of it."""
    means = np.asarray(means)
    if maximize:
        means = -means
    ind = int(np.nanargmin(means))
    within = means <= means[ind] + np.asarray(sds)[ind]
    lambda_1se = float(np.max(np.asarray(lambdas)[within]))
    return ind, float(lambdas[ind]), lambda_1se, float(means[ind])


def _rows(x, mask: np.ndarray):
    """The rows of x where `mask` holds: numpy, torch (on its device) or scipy."""
    if isinstance(x, torch.Tensor):
        return x[torch.as_tensor(mask, device=x.device)]
    if hasattr(x, "tocsr"):
        return x[np.flatnonzero(mask)]
    return np.asarray(x)[mask]


def cv_fit(
    x,
    y,
    alpha=1.0,
    lambda_path=None,
    nfolds: int = 10,
    foldid=None,
    type_measure: str = "deviance",
    seed: int = 0,
    parallel: bool = False,
    cv_mesh=None,
    offset=None,
    **fit_kwargs,
) -> CvFit:
    """Cross-validate elastic-net GLM fits over alpha x lambda.

    `alpha` may be a scalar or a grid; `lambda_path` None (per alpha, from
    the full-data fit), one array (one alpha), or a list of arrays matching
    `alpha`.  `fit_kwargs` reach every fit (`device` among them: None is
    the card).  `parallel=True` fits each alpha's folds as weight masks
    over one design on the device (parallel/cv.py), one after another, or
    over a fold mesh `cv_mesh` (parallel/dist.py `make_mesh(axis="folds")`,
    every rank calling cv_fit with the same arguments), each rank its share
    of the folds; a `mesh` among `fit_kwargs` makes every fit data-parallel
    instead (serial CV).
    """
    if parallel and cv_mesh is not None:
        mesh_device(cv_mesh, fit_kwargs.get("device"))  # a device beside the mesh must be its own
    alphas = np.atleast_1d(np.asarray(alpha, dtype=np.float64))
    n_alpha = len(alphas)
    if nfolds <= 2:
        raise ValueError("nfolds must be greater than 2")

    n_samples = np.asarray(y).shape[0]
    if nfolds > n_samples:
        raise ValueError("you cannot have more folds than samples.")

    if isinstance(lambda_path, (list, tuple)) and len(lambda_path) and not np.isscalar(lambda_path[0]):
        if n_alpha != len(lambda_path):
            raise ValueError("the length of the lambda list needs to match the number of alpha.")
        lambda_list = [np.asarray(lam) if lam is not None else None for lam in lambda_path]
    elif lambda_path is None:
        lambda_list = [None] * n_alpha
    else:
        if n_alpha > 1:
            raise ValueError(
                "you need a list of lambdas (or None) when you have multiple alphas."
            )
        lambda_list = [np.asarray(lambda_path, dtype=np.float64)]

    offset_arr = None if offset is None else np.asarray(offset, dtype=np.float64)

    # observation weights: the full-data fits take the whole vector, the
    # fold fits their training rows' (scores stay unweighted)
    sw_arr = fit_kwargs.pop("sample_weight", None)
    if sw_arr is not None:
        sw_arr = np.asarray(sw_arr, dtype=np.float64)
        if sw_arr.shape != (n_samples,):
            raise ValueError("sample_weight must have one entry per sample")
    # the full-data fit of each alpha
    fits = [
        fit_fn(
            x, y, alpha=float(alphas[i]), lambda_path=lambda_list[i], offset=offset_arr,
            sample_weight=sw_arr, **fit_kwargs,
        )
        for i in range(n_alpha)
    ]
    lambda_list = [f.lambda_ for f in fits]

    # fold assignment
    if foldid is None:
        rng = np.random.default_rng(seed)
        perm = rng.permutation(n_samples)
        foldid = np.zeros(n_samples, dtype=int)
        for j, chunk in enumerate(np.array_split(perm, nfolds)):
            foldid[chunk] = j
    else:
        foldid = np.asarray(foldid)
        if len(foldid) != n_samples:
            raise ValueError("the length of `foldid` must match the number of samples")
        nfolds = len(np.unique(foldid))

    cv_raw = []
    y_arr = np.asarray(y)
    for i in range(n_alpha):
        scores = np.full((nfolds, len(lambda_list[i])), np.nan)
        if parallel:
            from sgdnet_tpu_torch.parallel.cv import parallel_fold_scores

            scores = parallel_fold_scores(
                x, y, foldid, nfolds, alpha=float(alphas[i]), lambda_path=lambda_list[i],
                type_measure=type_measure, mesh=cv_mesh, seed=seed, sample_weight=sw_arr, offset=offset_arr,
                **fit_kwargs,
            )
        else:
            for j in range(nfolds):
                test = foldid == j
                train = ~test
                o_tr = o_te = None
                if offset_arr is not None:
                    o_tr, o_te = offset_arr[train], offset_arr[test]
                sw_tr = sw_arr[train] if sw_arr is not None else None
                f = fit_fn(
                    _rows(x, train), y_arr[train], alpha=float(alphas[i]), lambda_path=lambda_list[i],
                    offset=o_tr, sample_weight=sw_tr, **fit_kwargs,
                )
                x_te = _rows(x, test)
                if isinstance(x_te, torch.Tensor):
                    x_te = x_te.cpu().numpy()
                scores[j] = score_fn(f, x_te, y_arr[test], type_measure, s=lambda_list[i], offset=o_te)
        cv_raw.append(scores)

    # the summary
    rows = {"alpha": [], "lambda": [], "mean": [], "sd": [], "ci_lo": [], "ci_up": []}
    optima = []
    maximize = type_measure == "auc"
    for i in range(n_alpha):
        means = np.nanmean(cv_raw[i], axis=0)
        sds = np.nanstd(cv_raw[i], axis=0, ddof=1)
        rows["alpha"].extend([alphas[i]] * len(means))
        rows["lambda"].extend(lambda_list[i])
        rows["mean"].extend(means)
        rows["sd"].extend(sds)
        rows["ci_lo"].extend(means - sds)
        rows["ci_up"].extend(means + sds)
        ind, lam_min, lam_1se, err = _find_optimum(lambda_list[i], means, sds, maximize)
        optima.append((err, float(alphas[i]), lam_min, lam_1se, i))

    _, alpha_min, lambda_min, lambda_1se, best_i = min(optima)

    name = _MEASURE_NAMES[type_measure]
    if isinstance(name, dict):
        name = name[fits[best_i].family]

    return CvFit(
        alpha=alphas,
        lambda_=lambda_list,
        cv_summary={k: np.asarray(v) for k, v in rows.items()},
        cv_raw=cv_raw,
        name=name,
        fit=fits[best_i],
        fits=fits,
        alpha_min=alpha_min,
        lambda_min=lambda_min,
        lambda_1se=lambda_1se,
        type_measure=type_measure,
    )
