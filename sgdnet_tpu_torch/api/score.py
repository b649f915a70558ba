"""Model scoring along the path (twin of sgdnet_tpu/api/score.py).

Per-family deviance / mse / mae / class / auc measures, evaluated at every
requested lambda.  Host numpy throughout.
"""

from __future__ import annotations

import numpy as np

from sgdnet_tpu_torch.api.predict import predict

PROB_MIN = 1e-5  # clamp used by the reference's deviance measures (R/score.R:86)


def auc(y: np.ndarray, prob: np.ndarray, weights=None) -> float:
    """Area under the ROC curve (reference R/score.R:203-232)."""
    y = np.asarray(y)
    if y.ndim == 2:
        ny = y.shape[0]
        return auc(
            np.repeat([0.0, 1.0], ny),
            np.concatenate([prob, prob]),
            (np.ones(ny) if weights is None else np.asarray(weights)).repeat(2).reshape(2, -1).T.ravel() * y.T.ravel(),
        )
    if weights is None:
        rprob = np.argsort(np.argsort(prob, kind="mergesort"), kind="mergesort") + 1.0
        # average ranks for ties
        order = np.argsort(prob, kind="mergesort")
        sorted_p = prob[order]
        ranks = np.empty(len(prob))
        i = 0
        r = 1
        while i < len(sorted_p):
            j = i
            while j + 1 < len(sorted_p) and sorted_p[j + 1] == sorted_p[i]:
                j += 1
            ranks[order[i : j + 1]] = 0.5 * (r + r + (j - i))
            r += j - i + 1
            i = j + 1
        n1 = y.sum()
        n0 = len(y) - n1
        if n1 == 0 or n0 == 0:
            return np.nan
        u = ranks[y == 1].sum() - n1 * (n1 + 1) / 2
        return float(u / (n1 * n0))
    w = np.asarray(weights, dtype=np.float64)
    order = np.lexsort((np.random.default_rng(0).random(len(prob)), prob))
    y_s, w_s = y[order], w[order]
    cw = np.cumsum(w_s)
    mask1 = y_s == 1
    w1 = w_s[mask1]
    cw1 = np.cumsum(w1)
    num = np.sum(w1 * (cw[mask1] - cw1))
    sumw1 = cw1[-1] if len(cw1) else 0.0
    sumw2 = cw[-1] - sumw1
    if sumw1 == 0 or sumw2 == 0:
        return np.nan
    return float(num / (sumw1 * sumw2))


def _onehot_from_labels(y, classnames):
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] == 1:
        y = y[:, 0]
    names = list(classnames) if classnames else sorted({str(v) for v in y})
    lookup = {str(c): i for i, c in enumerate(names)}
    codes = np.asarray([lookup[str(v)] for v in y])
    return np.eye(len(names))[codes]


def score(fit, x, y, type_measure: str = "deviance", s=None, offset=None):
    """Score a fit on held-out data; returns one value per lambda in `s`
    (default: the fit's whole path).  `offset` is passed to predict as
    `newoffset` (required when the fit used one)."""
    if s is None:
        s = fit.lambda_
    s = np.atleast_1d(np.asarray(s, dtype=np.float64))
    family = fit.family

    if family == "gaussian":
        if type_measure not in ("deviance", "mse", "mae"):
            raise ValueError(f"type_measure '{type_measure}' not available for gaussian")
        y = np.asarray(y, dtype=np.float64).reshape(-1)
        y_hat = predict(fit, x, s=s, newoffset=offset)  # (n, n_s)
        r = y_hat - y[:, None]
        if type_measure in ("deviance", "mse"):
            return (r**2).mean(axis=0)
        return np.abs(r).mean(axis=0)

    if family == "poisson":
        if type_measure not in ("deviance", "mse", "mae"):
            raise ValueError(f"type_measure '{type_measure}' not available for poisson")
        y = np.asarray(y, dtype=np.float64).reshape(-1)
        mu = np.exp(predict(fit, x, s=s, newoffset=offset))  # (n, n_s)
        if type_measure == "mse":
            return ((mu - y[:, None]) ** 2).mean(axis=0)
        if type_measure == "mae":
            return np.abs(mu - y[:, None]).mean(axis=0)
        # mean unit deviance 2*(y log(y/mu) - (y - mu)), xlogy(0, .) == 0
        with np.errstate(divide="ignore", invalid="ignore"):
            ylog = np.where(y[:, None] > 0, y[:, None] * np.log(y[:, None] / mu), 0.0)
        return (2.0 * (ylog - (y[:, None] - mu))).mean(axis=0)

    if family == "binomial":
        if type_measure not in ("deviance", "mse", "mae", "class", "auc"):
            raise ValueError(f"type_measure '{type_measure}' not available for binomial")
        yb = _onehot_from_labels(y, fit.classnames)  # (n, 2)
        y_hat = predict(fit, x, s=s, type="response", newoffset=offset)  # (n, n_s) P(class 2)
        if type_measure == "auc":
            return np.asarray([auc(yb, y_hat[:, i]) for i in range(y_hat.shape[1])])
        if type_measure == "mse":
            return ((y_hat + yb[:, [0]] - 1) ** 2 + (y_hat - yb[:, [1]]) ** 2).mean(axis=0)
        if type_measure == "mae":
            return (np.abs(y_hat + yb[:, [0]] - 1) + np.abs(y_hat - yb[:, [1]])).mean(axis=0)
        if type_measure == "deviance":
            p = np.clip(y_hat, PROB_MIN, 1 - PROB_MIN)
            lp = yb[:, [0]] * np.log(1 - p) + yb[:, [1]] * np.log(p)
            return (-2.0 * lp).mean(axis=0)
        return (yb[:, [0]] * (y_hat > 0.5) + yb[:, [1]] * (y_hat <= 0.5)).mean(axis=0)

    if family == "multinomial":
        if type_measure not in ("deviance", "mse", "mae", "class"):
            raise ValueError(f"type_measure '{type_measure}' not available for multinomial")
        yk = _onehot_from_labels(y, fit.classnames)  # (n, k)
        y_hat = predict(fit, x, s=s, type="response", newoffset=offset)  # (n, k, n_s)
        yk3 = yk[:, :, None]
        if type_measure == "mse":
            return ((yk3 - y_hat) ** 2).sum(axis=1).mean(axis=0)
        if type_measure == "mae":
            return np.abs(yk3 - y_hat).sum(axis=1).mean(axis=0)
        if type_measure == "deviance":
            p = np.clip(y_hat, PROB_MIN, 1 - PROB_MIN)
            return (-2.0 * (yk3 * np.log(p)).sum(axis=1)).mean(axis=0)
        pred = np.argmax(y_hat, axis=1)  # (n, n_s)
        truth = np.argmax(yk, axis=1)[:, None]
        return (pred != truth).mean(axis=0)

    if family == "mgaussian":
        if type_measure not in ("deviance", "mse", "mae"):
            raise ValueError(f"type_measure '{type_measure}' not available for mgaussian")
        y = np.asarray(y, dtype=np.float64)
        y_hat = predict(fit, x, s=s, newoffset=offset)  # (n, k, n_s)
        r = y_hat - y[:, :, None]
        if type_measure in ("deviance", "mse"):
            return (r**2).sum(axis=1).mean(axis=0)
        return np.abs(r).sum(axis=1).mean(axis=0)

    raise ValueError(f"unknown family {family}")
