"""GLM response families on torch tensors (twin of
sgdnet_tpu/families/families.py).

Each family exposes batched loss/gradient functions on (B, k) blocks of
linear predictors.  Internal response encoding (host-side `encode`, numpy):

    gaussian    y -> (n, 1) float
    binomial    y -> (n, 1) float in {0, 1}
    poisson     y -> (n, 1) counts
    multinomial y -> (n, K) one-hot
    mgaussian   y -> (n, m) float

Deviance = 2 * sum(loss) throughout.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sgdnet_tpu_torch.core.linalg import clamp, column_mean, column_sd, logsumexp


def _xty(x, y: torch.Tensor) -> torch.Tensor:
    """x.T @ y in float64 for dense, PaddedCSR or HybridCSR x; returns (p, m)."""
    from sgdnet_tpu_torch.core.sparse import HybridCSR, PaddedCSR

    if isinstance(x, (PaddedCSR, HybridCSR)):
        # a bf16 or int8 head must not truncate y: matvec_T multiplies the
        # head in its own type and sums in at least f32
        dtype = x.values.dtype if isinstance(x, PaddedCSR) else x.head.dtype
        return x.matvec_T(y.to(torch.promote_types(dtype, torch.float32))).to(torch.float64)
    return x.T.to(torch.float64) @ y.to(torch.float64)


def _wmean(y: torch.Tensor, weights: torch.Tensor | None) -> torch.Tensor:
    if weights is None:
        return torch.mean(y, dim=0)
    w = weights.reshape(-1, 1)
    return torch.sum(y * w, dim=0) / torch.sum(w)


def _wstats(y: torch.Tensor, weights: torch.Tensor):
    """Weighted per-column (mean, population SD) with zero-variance guard."""
    w = weights.reshape(-1, 1)
    W = torch.clamp(torch.sum(w), min=1e-12)
    mean = torch.sum(y * w, dim=0) / W
    var = torch.sum(w * (y - mean) ** 2, dim=0) / W
    sd = torch.where(var == 0.0, torch.ones_like(var), torch.sqrt(var))
    return mean, sd


def _ones_col(y: torch.Tensor, weights):
    if weights is None:
        return torch.ones((y.shape[0], 1), dtype=y.dtype, device=y.device)
    return weights.reshape(-1, 1)


class Family:
    """Base family protocol."""

    name: str = "base"
    L_scaling: float = 1.0
    is_classification: bool = False

    def __init__(self, n_classes: int = 1):
        self.n_classes = n_classes

    # ----- host-side -----
    def encode(self, y_raw):
        """Validate + encode raw response -> (y (n, ky) float64, class_names)."""
        raise NotImplementedError

    # ----- tensor functions -----
    def preprocess(self, y: torch.Tensor, weights: torch.Tensor | None = None):
        """Response standardization; returns (y_t, y_center (k,), y_scale (k,))."""
        z = torch.zeros((self.n_classes,), dtype=y.dtype, device=y.device)
        return y, z, z + 1.0

    def loss(self, lp: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Per-sample loss; lp (B, k), y (B, ky) -> (B,)."""
        raise NotImplementedError

    def gradient(self, lp: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Per-sample gradient dloss/dlp; (B, k)."""
        raise NotImplementedError

    def loss_report(self, lp: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Loss used for reported statistics; families whose solver loss
        carries a numerical safeguard override this with the exact loss."""
        return self.loss(lp, y)

    def null_intercept(self, y: torch.Tensor, fit_intercept: bool, weights=None) -> torch.Tensor:
        """Intercept of the null (intercept-only) model; (k,)."""
        raise NotImplementedError

    def null_deviance(self, y: torch.Tensor, fit_intercept: bool, weights=None) -> torch.Tensor:
        """2 * sum(loss) under the null model."""
        lp0 = self.null_intercept(y, fit_intercept, weights).expand(y.shape[0], self.n_classes)
        losses = self.loss_report(lp0, y)
        if weights is not None:
            losses = losses * weights
        return 2.0 * torch.sum(losses)

    def lambda_max(self, x, y, y_scale, weights=None, col_mult=None) -> torch.Tensor:
        """Largest lambda on the auto path; `col_mult` is an optional (p,)
        multiplier on the null-gradient statistic (1/penalty_factor, 0 for
        excluded or unpenalized features)."""
        raise NotImplementedError

    def null_intercept_offset(self, y, offs, fit_intercept: bool, weights=None) -> torch.Tensor:
        """Intercept of the intercept-plus-offset null model; (k,)."""
        return self.null_intercept(y, fit_intercept, weights)

    def null_deviance_offset(self, y, offs, fit_intercept: bool, weights=None, b0=None) -> torch.Tensor:
        """2 * sum(loss) under the intercept-plus-offset null model."""
        if b0 is None:
            b0 = self.null_intercept_offset(y, offs, fit_intercept, weights)
        lp0 = b0[None, :] + offs
        losses = self.loss_report(lp0, y)
        if weights is not None:
            losses = losses * weights
        return 2.0 * torch.sum(losses)


def _apply_col_mult(inner, col_mult):
    if col_mult is None:
        return inner
    return inner * col_mult.to(inner.dtype)[:, None]


def lambda_max_offset(fam: Family, x, y, offs, y_scale, fit_intercept: bool, weights=None, b0=None, col_mult=None):
    """lambda_max = max-norm of the gradient at the intercept-plus-offset
    null model (link families only; identity links fold the offset into
    the response)."""
    if b0 is None:
        b0 = fam.null_intercept_offset(y, offs, fit_intercept, weights)
    g = fam.gradient(b0[None, :] + offs, y)
    if weights is not None:
        g = g * weights.reshape(-1, 1)
        W = torch.clamp(torch.sum(weights), min=1e-12)
    else:
        W = y.shape[0]
    inner = _xty(x, g) * y_scale[None, :].to(torch.float64)
    return torch.max(torch.abs(_apply_col_mult(inner, col_mult))) / W


class Gaussian(Family):
    """Least squares.  L = 1.0."""

    name = "gaussian"
    L_scaling = 1.0

    def __init__(self, n_classes: int = 1):
        super().__init__(1)

    def encode(self, y_raw):
        y = np.asarray(y_raw, dtype=np.float64)
        if y.ndim == 1:
            y = y.reshape(-1, 1)
        if y.shape[1] != 1:
            raise ValueError("response for Gaussian regression must be one-dimensional.")
        return y, None

    def preprocess(self, y, weights=None):
        if weights is None:
            center = column_mean(y)
            scale = column_sd(y, center)
        else:
            center, scale = _wstats(y, weights)
        return (y - center) / scale, center, scale

    def loss(self, lp, y):
        r = lp[:, 0] - y[:, 0]
        return 0.5 * r * r

    def gradient(self, lp, y):
        return lp - y

    def null_intercept(self, y, fit_intercept, weights=None):
        return _wmean(y, weights)

    def lambda_max(self, x, y, y_scale, weights=None, col_mult=None):
        if weights is None:
            W = y.shape[0]
            inner = _xty(x, y)
        else:
            W = torch.clamp(torch.sum(weights), min=1e-12)
            inner = _xty(x, y * weights.reshape(-1, 1))
        return y_scale[0] * torch.max(torch.abs(_apply_col_mult(inner, col_mult))) / W


class Binomial(Family):
    """Logistic regression, responses in {0, 1}.  L = 0.25."""

    name = "binomial"
    L_scaling = 0.25
    is_classification = True
    #: clamp for the logit link
    P_MIN = 1e-9

    def __init__(self, n_classes: int = 1):
        super().__init__(1)

    def encode(self, y_raw):
        y = np.asarray(y_raw)
        if y.ndim == 2 and y.shape[1] == 1:
            y = y[:, 0]
        classes, codes = np.unique(y, return_inverse=True)
        if len(classes) > 2:
            raise ValueError("more than two classes in response. Are you looking for family = 'multinomial'?")
        if len(classes) == 1:
            raise ValueError("only one class in response.")
        counts = np.bincount(codes)
        if counts.min() <= 1:
            raise ValueError(f"one class only has {counts.min()} observations.")
        return codes.astype(np.float64).reshape(-1, 1), [str(c) for c in classes]

    def link(self, p):
        z = clamp(p, self.P_MIN, 1.0 - self.P_MIN)
        return torch.log(z / (1.0 - z))

    def loss(self, lp, y):
        z = lp[:, 0]
        return torch.logaddexp(torch.zeros_like(z), z) - y[:, 0] * z

    def gradient(self, lp, y):
        return 1.0 / (1.0 + torch.exp(-lp)) - y

    def null_intercept(self, y, fit_intercept, weights=None):
        if not fit_intercept:
            return torch.zeros((1,), dtype=y.dtype, device=y.device)
        return self.link(_wmean(y, weights))

    def null_intercept_offset(self, y, offs, fit_intercept, weights=None):
        # bisection on the increasing f(b) = sum w*(sigma(b + o) - y):
        # divergence-proof for any offset magnitude; 80 halvings
        if not fit_intercept:
            return torch.zeros((1,), dtype=y.dtype, device=y.device)
        w = _ones_col(y, weights)
        span = torch.max(torch.abs(offs)) + 35.0
        lo = (-span).reshape(1).to(y.dtype)
        hi = span.reshape(1).to(y.dtype)
        for _ in range(80):
            mid = 0.5 * (lo + hi)
            p = 1.0 / (1.0 + torch.exp(-(mid[None, :] + offs)))
            go_right = torch.sum(w * (p - y)) < 0.0
            lo = torch.where(go_right, mid, lo)
            hi = torch.where(go_right, hi, mid)
        return 0.5 * (lo + hi)

    def lambda_max(self, x, y, y_scale, weights=None, col_mult=None):
        if weights is None:
            W = y.shape[0]
            y_bar = column_mean(y)
            y_std = column_sd(y, y_bar)
            y_map = (y - y_bar) / y_std
        else:
            W = torch.clamp(torch.sum(weights), min=1e-12)
            y_bar, y_std = _wstats(y, weights)
            y_map = (y - y_bar) / y_std * weights.reshape(-1, 1)
        inner = _apply_col_mult(_xty(x, y_map), col_mult)
        return y_std[0] * torch.max(torch.abs(inner)) / W


class Poisson(Family):
    """Log-link Poisson regression for counts.  `smoothness` caps the
    per-sample rate inside the exp, which makes the gradient Lipschitz with
    that constant so SAGA's fixed step is valid; `loss_report` is the exact
    unclamped deviance term."""

    name = "poisson"
    L_scaling = 1.0

    def __init__(self, n_classes: int = 1, smoothness: float = 1.0):
        super().__init__(1)
        self.smoothness = float(smoothness)
        self.L_scaling = self.smoothness

    def encode(self, y_raw):
        y = np.asarray(y_raw, dtype=np.float64)
        if y.ndim == 2 and y.shape[1] == 1:
            y = y[:, 0]
        if y.ndim != 1:
            raise ValueError("poisson response must be a vector")
        if (y < 0).any():
            raise ValueError("negative values not allowed for the 'poisson' family")
        return y.reshape(-1, 1), None

    def _mu(self, lp):
        return torch.exp(torch.clamp(lp, max=math.log(self.smoothness)))

    @staticmethod
    def _ylogy(yv):
        return torch.where(yv > 0, yv * torch.log(torch.clamp(yv, min=1e-300)), torch.zeros_like(yv))

    def loss(self, lp, y):
        mu_log = torch.clamp(lp[:, 0], max=math.log(self.smoothness))
        yv = y[:, 0]
        return torch.exp(mu_log) - yv * mu_log + self._ylogy(yv) - yv

    def loss_report(self, lp, y):
        mu_log = lp[:, 0]
        yv = y[:, 0]
        return torch.exp(mu_log) - yv * mu_log + self._ylogy(yv) - yv

    def gradient(self, lp, y):
        return self._mu(lp) - y

    def null_intercept(self, y, fit_intercept, weights=None):
        if not fit_intercept:
            return torch.zeros((1,), dtype=y.dtype, device=y.device)
        return torch.log(torch.clamp(_wmean(y, weights), min=1e-10))

    def null_intercept_offset(self, y, offs, fit_intercept, weights=None):
        # closed form: sum w*(exp(b + o) - y) = 0  =>  b = log(swy / swe)
        if not fit_intercept:
            return torch.zeros((1,), dtype=y.dtype, device=y.device)
        w = _ones_col(y, weights)
        swy = torch.sum(w * y)
        swe = torch.sum(w * torch.exp(offs))
        return torch.log(torch.clamp(swy, min=1e-10) / torch.clamp(swe, min=1e-300)).reshape(1)

    def lambda_max(self, x, y, y_scale, weights=None, col_mult=None):
        if weights is None:
            W = y.shape[0]
            resid = _wmean(y, None)[None, :] - y
        else:
            W = torch.clamp(torch.sum(weights), min=1e-12)
            resid = (_wmean(y, weights)[None, :] - y) * weights.reshape(-1, 1)
        inner = _apply_col_mult(_xty(x, resid), col_mult)
        return torch.max(torch.abs(inner)) / W


class Multinomial(Family):
    """Softmax regression over K classes, one-hot response.  L = 0.25."""

    name = "multinomial"
    L_scaling = 0.25
    is_classification = True

    def encode(self, y_raw):
        y = np.asarray(y_raw)
        if y.ndim == 2 and y.shape[1] == 1:
            y = y[:, 0]
        classes, codes = np.unique(y, return_inverse=True)
        k = len(classes)
        if k == 2:
            raise ValueError("only two classes in response. Are you looking for family = 'binomial'?")
        if k == 1:
            raise ValueError("only one class in response.")
        counts = np.bincount(codes)
        if counts.min() <= 1:
            raise ValueError(f"one class only has {counts.min()} observations.")
        if self.n_classes not in (1, k):
            raise ValueError(f"expected {self.n_classes} classes, found {k}")
        self.n_classes = k
        onehot = np.eye(k, dtype=np.float64)[codes]
        return onehot, [str(c) for c in classes]

    def loss(self, lp, y):
        return logsumexp(lp, axis=1) - torch.sum(lp * y, dim=1)

    def gradient(self, lp, y):
        return torch.exp(lp - logsumexp(lp, axis=1, keepdims=True)) - y

    def null_intercept(self, y, fit_intercept, weights=None):
        if fit_intercept:
            prop = _wmean(y, weights)
        else:
            prop = torch.full((self.n_classes,), 1.0 / self.n_classes, dtype=y.dtype, device=y.device)
        log_prop = torch.log(prop)
        return log_prop - torch.mean(log_prop)

    def null_intercept_offset(self, y, offs, fit_intercept, weights=None):
        # IPF-style fixed point matching weighted class proportions under
        # softmax(b + o); 100 sweeps, then re-centered to sum 0
        if not fit_intercept:
            return torch.zeros((self.n_classes,), dtype=y.dtype, device=y.device)
        target = torch.clamp(_wmean(y, weights), min=1e-12)
        w = _ones_col(y, weights)
        W = torch.clamp(torch.sum(w), min=1e-12)
        b = self.null_intercept(y, fit_intercept, weights)
        for _ in range(100):
            lp = b[None, :] + offs
            p = torch.exp(lp - logsumexp(lp, axis=1, keepdims=True))
            pw = torch.clamp(torch.sum(p * w, dim=0) / W, min=1e-12)
            b = b + torch.log(target) - torch.log(pw)
        return b - torch.mean(b)

    def lambda_max(self, x, y, y_scale, weights=None, col_mult=None):
        if weights is None:
            W = y.shape[0]
            y_bar = column_mean(y)
            y_std = column_sd(y, y_bar)
            y_map = (y - y_bar) / y_std
        else:
            W = torch.clamp(torch.sum(weights), min=1e-12)
            y_bar, y_std = _wstats(y, weights)
            y_map = (y - y_bar) / y_std * weights.reshape(-1, 1)
        inner = _apply_col_mult(_xty(x, y_map) * y_std, col_mult)
        return torch.max(torch.abs(inner)) / W


class MultivariateGaussian(Family):
    """Multi-response least squares.  L = 1.0."""

    name = "mgaussian"
    L_scaling = 1.0

    def __init__(self, n_classes: int = 1, standardize_response: bool = False):
        super().__init__(n_classes)
        self.standardize_response = standardize_response

    def encode(self, y_raw):
        y = np.asarray(y_raw, dtype=np.float64)
        if y.ndim != 2 or y.shape[1] == 1:
            raise ValueError(
                "response for multivariate Gaussian regression must not be "
                "one-dimensional; try family = 'gaussian'."
            )
        self.n_classes = y.shape[1]
        return y, None

    def preprocess(self, y, weights=None):
        # standardizes y (when asked) but reports coefficients on the
        # standardized-y scale: y_center/y_scale stay 0/1
        if self.standardize_response:
            if weights is None:
                center = column_mean(y)
                scale = column_sd(y, center)
            else:
                center, scale = _wstats(y, weights)
            y = (y - center) / scale
        z = torch.zeros((self.n_classes,), dtype=y.dtype, device=y.device)
        return y, z, z + 1.0

    def loss(self, lp, y):
        return 0.5 * torch.sum((lp - y) ** 2, dim=1)

    def gradient(self, lp, y):
        return lp - y

    def null_intercept(self, y, fit_intercept, weights=None):
        return _wmean(y, weights)

    def lambda_max(self, x, y, y_scale, weights=None, col_mult=None):
        if weights is None:
            W = y.shape[0]
            y_bar = column_mean(y)
            y_std = column_sd(y, y_bar)
            y_map = (y - y_bar) / y_std
        else:
            W = torch.clamp(torch.sum(weights), min=1e-12)
            y_bar, y_std = _wstats(y, weights)
            y_map = (y - y_bar) / y_std * weights.reshape(-1, 1)
        inner = _apply_col_mult(_xty(x, y_map) * (y_scale * y_std), col_mult)
        return torch.max(torch.sqrt(torch.sum(inner**2, dim=1))) / W


_FAMILIES = {
    "gaussian": Gaussian,
    "binomial": Binomial,
    "poisson": Poisson,
    "multinomial": Multinomial,
    "mgaussian": MultivariateGaussian,
}


def get_family(name: str, n_classes: int = 1, standardize_response: bool = False, smoothness: float = 1.0) -> Family:
    """Family factory (`smoothness` is poisson's per-sample curvature bound)."""
    if name not in _FAMILIES:
        raise ValueError(f"unknown family '{name}'; choose from {sorted(_FAMILIES)}")
    if name == "mgaussian":
        return MultivariateGaussian(n_classes, standardize_response)
    if name == "poisson":
        return Poisson(1, smoothness)
    return _FAMILIES[name](n_classes)
