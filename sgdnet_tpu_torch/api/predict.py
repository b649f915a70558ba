"""Prediction along a fitted path (twin of sgdnet_tpu/api/predict.py).

link/response/class/coefficients/nonzero prediction types, linear
interpolation between path points for off-path lambda values, and exact
refits through the port's `fit`.  Host numpy throughout, except for a
PaddedCSR / HybridCSR `newx`, whose product runs on the layout's device.

Shapes: for single-response families (gaussian, binomial) predictions are
(n_new, n_s); for multivariate families (multinomial, mgaussian) they are
(n_new, k, n_s) — matching the reference's (sample, class, lambda) arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from sgdnet_tpu_torch.core.sparse import HybridCSR, PaddedCSR


def _sparse_product(newx, b: np.ndarray) -> np.ndarray:
    """newx @ b for a scipy matrix, or through a PaddedCSR / HybridCSR's
    `matmul_dense` on its device, (n_new, n_s) host numpy."""
    if isinstance(newx, (PaddedCSR, HybridCSR)):
        vals = newx.values if isinstance(newx, PaddedCSR) else newx.tail.values
        bt = torch.as_tensor(np.ascontiguousarray(b), dtype=vals.dtype, device=vals.device)
        return newx.matmul_dense(bt).cpu().numpy()
    return np.asarray(newx @ b)


def lambda_interpolate(lambda_path: np.ndarray, s: np.ndarray):
    """Linear interpolation weights between adjacent path points
    (reference R/predict.sgdnet.R:144-169)."""
    lam = np.asarray(lambda_path, dtype=np.float64)
    s = np.atleast_1d(np.asarray(s, dtype=np.float64)).copy()
    if len(lam) == 1:
        n = len(s)
        return np.zeros(n, int), np.zeros(n, int), np.ones(n)
    s = np.clip(s, lam.min(), lam.max())
    k = len(lam)
    sfrac = (lam[0] - s) / (lam[0] - lam[k - 1])
    lam_norm = (lam[0] - lam) / (lam[0] - lam[k - 1])
    coord = np.interp(sfrac, lam_norm, np.arange(k, dtype=np.float64))
    left = np.floor(coord).astype(int)
    right = np.ceil(coord).astype(int)
    denom = lam_norm[left] - lam_norm[right]
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = (sfrac - lam_norm[right]) / denom
    frac[left == right] = 1.0
    frac[np.abs(denom) < np.finfo(float).eps] = 1.0
    return left, right, frac


def _interp_coefs(beta: np.ndarray, a0: np.ndarray, lambda_path, s):
    """Interpolated (beta (n_s, k, p), a0 (n_s, k))."""
    left, right, frac = lambda_interpolate(lambda_path, s)
    f = frac.reshape(-1, *([1] * (beta.ndim - 1)))
    beta_i = beta[left] * f + beta[right] * (1.0 - f)
    a0_2d = a0 if a0.ndim == 2 else a0[:, None]
    f2 = frac.reshape(-1, 1)
    a0_i = a0_2d[left] * f2 + a0_2d[right] * (1.0 - f2)
    return beta_i, a0_i


def _nonzero_bystep(beta_k: np.ndarray):
    """Per-path-step nonzero feature indices for one class
    (reference R/predict.sgdnet.R:49-93)."""
    return [np.flatnonzero(np.abs(beta_k[l]) > 0) for l in range(beta_k.shape[0])]


def predict(
    fit,
    newx=None,
    s=None,
    type: str = "link",
    exact: bool = False,
    x=None,
    y=None,
    newoffset=None,
    **refit_kwargs,
):
    """Predict from an `SgdnetFit`.

    `type` one of 'link', 'response', 'class', 'coefficients', 'nonzero'.
    With `s` given, coefficients are linearly interpolated between path
    points unless `exact=True`, in which case the model is refit on a path
    augmented with `s` (requires passing the original `x`, `y`).

    A fit made with an `offset` requires `newoffset` here (one value per row
    of `newx`, same shape rules as `offset` in `fit`) — glmnet behaves the
    same way.
    """
    family = fit.family
    valid = {"link", "response", "coefficients", "nonzero"}
    if family in ("binomial", "multinomial"):
        valid.add("class")
    if type not in valid:
        raise ValueError(f"type must be one of {sorted(valid)} for family '{family}'")

    if s is not None and np.any(np.atleast_1d(s) < 0):
        raise ValueError("s (lambda penalty) cannot be negative")

    if exact and s is not None:
        s_arr = np.atleast_1d(np.asarray(s, dtype=np.float64))
        if not np.all(np.isin(s_arr, fit.lambda_)):
            if x is None or y is None:
                raise ValueError("exact=True requires passing the original x and y for the refit")
            from sgdnet_tpu_torch.api.fit import fit as fit_fn

            new_lams = np.unique(np.concatenate([s_arr, fit.lambda_]))[::-1]
            args = dict(fit._refit_args or {})
            args.update(refit_kwargs)
            fit = fit_fn(x, y, lambda_path=new_lams, **args)

    beta = np.asarray(fit.beta)  # (nl, k, p)
    a0 = np.asarray(fit.a0)
    a0_2d = a0 if a0.ndim == 2 else a0[:, None]

    if s is not None:
        beta, a0_2d = _interp_coefs(beta, a0_2d, fit.lambda_, s)

    n_s, k, p = beta.shape

    if type == "coefficients":
        out = np.concatenate([a0_2d[:, :, None], beta], axis=2)  # (n_s, k, p+1)
        return out[:, 0, :] if k == 1 else out

    if type == "nonzero":
        if k == 1:
            return _nonzero_bystep(beta[:, 0, :])
        if fit.grouped:
            return _nonzero_bystep(beta[:, 0, :])
        return {c: _nonzero_bystep(beta[:, i, :]) for i, c in enumerate(fit.classnames or range(k))}

    if newx is None:
        raise ValueError(f"you need to supply a value for 'newx' for type = '{type}'")
    if getattr(fit, "offset", False) and newoffset is None:
        raise ValueError(
            "the model was fit with an offset; supply 'newoffset' to predict"
        )

    sparse_newx = False
    layout_newx = isinstance(newx, (PaddedCSR, HybridCSR))
    if not layout_newx:
        try:
            import scipy.sparse as sp

            sparse_newx = sp.issparse(newx)
        except ImportError:
            pass
    if not (sparse_newx or layout_newx):
        if hasattr(newx, "detach"):  # torch tensor
            newx = newx.detach().cpu().numpy()
        newx = np.asarray(newx, dtype=np.float64)
        if newx.ndim == 1:
            newx = newx.reshape(1, -1)
        # NaN rows are allowed and propagate to NaN predictions

    # (n_new, k, n_s)
    if sparse_newx or layout_newx:
        n_new = newx.shape[0]
        lp = np.empty((n_new, k, n_s))
        for kk in range(k):  # per class, no densify
            lp[:, kk, :] = _sparse_product(newx, beta[:, kk, :].T)
        lp = lp + a0_2d.T[None, :, :]
    else:
        lp = np.einsum("nj,lkj->nkl", newx, beta) + a0_2d.T[None, :, :]

    if newoffset is not None:
        # same shape contract as fit's offset: per-class for multi-response
        no = np.asarray(newoffset, dtype=np.float64)
        if no.ndim == 1:
            no = no.reshape(-1, 1)
        kk = k if family in ("multinomial", "mgaussian") else 1
        if no.shape != (lp.shape[0], kk):
            want = f"({lp.shape[0]},)" if kk == 1 else f"({lp.shape[0]}, {kk})"
            raise ValueError(f"newoffset must have shape {want} for family '{family}'")
        lp = lp + no[:, :, None]

    if family == "gaussian":
        out = lp[:, 0, :]
        return out  # link == response

    if family == "poisson":
        out = lp[:, 0, :]
        if type == "link":
            return out
        if type == "response":
            return np.exp(out)  # expected counts

    if family == "binomial":
        out = lp[:, 0, :]
        if type in ("link",):
            return out
        if type == "response":
            return 1.0 / (1.0 + np.exp(-out))
        if type == "class":
            names = fit.classnames or ["0", "1"]
            cls = np.asarray(names, dtype=object)[(out > 0).astype(int)]
            cls[np.isnan(out)] = np.nan  # NA rows -> NA class (reference
            # test-predictions.R:109-125 NA propagation)
            return cls

    if family == "multinomial":
        if type == "link":
            return lp
        if type == "response":
            m = lp.max(axis=1, keepdims=True)
            e = np.exp(lp - m)
            return e / e.sum(axis=1, keepdims=True)
        if type == "class":
            names = np.asarray(fit.classnames or [str(i) for i in range(k)], dtype=object)
            cls = names[np.argmax(lp, axis=1)]
            cls[np.isnan(lp).any(axis=1)] = np.nan  # NA propagation
            return cls

    if family == "mgaussian":
        return lp  # link == response

    raise AssertionError("unreachable")
