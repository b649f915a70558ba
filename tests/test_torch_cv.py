"""The port's serial cross-validation against the JAX package's.

Twins of tests/test_cv.py: the same seeded data through `sgdnet_tpu.cv_fit`
and `sgdnet_tpu_torch.cv_fit` (float64, on the CPU), at one shape for the
gaussian cases (160 x 5, 4 folds of 120 rows: the JAX package compiles its
programs once for them).  The `jax_sampling` fixture gives the port the
JAX fits' batch orders (the port's `default_order_fn` replaced by
`ReferenceOrders`, salted as the JAX package folds its key) and the JAX
power iteration's start vector, so both packages walk the same
trajectories: `cv_raw` agrees within 1e-6 relative (measured 2e-15), and
lambda_min, lambda_1se and alpha_min are the same path points (the two
lambda paths agree to 1e-12; they differ in the last bits of
lambda_max).  The JAX results are made once a module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgdnet_tpu as jst
import sgdnet_tpu_torch as tst
from helpers import random_data
from sgdnet_tpu.api.cv import _find_optimum as j_find_optimum
from sgdnet_tpu_torch.api.cv import _find_optimum as t_find_optimum

torch.set_num_threads(1)

CV_TOL = 1e-6


_PERMS = {}


def _perms(n: int, count: int):
    """permutation(fold_in(akey, e0 + i), n) for i < count, jitted once a
    shape."""
    if (n, count) not in _PERMS:
        _PERMS[n, count] = jax.jit(lambda akey, e0: jax.vmap(
            lambda e: jax.random.permutation(jax.random.fold_in(akey, e), n))(e0 + jnp.arange(count)))
    return _PERMS[n, count]


class SaltedOrders:
    """test_torch_solver.ReferenceOrders' orders (the JAX path's:
    permutation(fold_in(akey, epoch), n), akey = fold_in(key, lambda),
    folded with the attempt on a retry), drawn CHUNK epochs at a time from
    one compiled program a shape, under the key fold_in(PRNGKey(seed),
    salt) where a salt is given, as the JAX package's screening draws a λ
    group's orders."""

    CHUNK = 64

    def __init__(self, seed: int, n: int, salt=None):
        self.key = jax.random.PRNGKey(seed)
        if salt is not None:
            self.key = jax.random.fold_in(self.key, salt)
        self.n, self.cache = n, {}

    def __call__(self, lam_idx, attempt, epoch):
        c = (lam_idx, attempt, epoch // self.CHUNK)
        if c not in self.cache:
            lam_key = jax.random.fold_in(self.key, lam_idx)
            akey = lam_key if attempt == 0 else jax.random.fold_in(lam_key, attempt)
            self.cache[c] = np.asarray(_perms(self.n, self.CHUNK)(akey, c[2] * self.CHUNK))
        return torch.tensor(self.cache[c][epoch % self.CHUNK])


@pytest.fixture
def jax_sampling(monkeypatch):
    """The port's fits draw the JAX fits' batch orders and start their
    power iterations from the JAX package's vector."""
    from sgdnet_tpu_torch.api import fit as tfit
    from sgdnet_tpu_torch.parallel import cv as tpcv
    from sgdnet_tpu_torch.solver import saga as tsaga
    from sgdnet_tpu_torch.solver import stepsize as tss

    monkeypatch.setattr(tsaga, "default_order_fn", lambda seed, n, salt=None: SaltedOrders(seed, n, salt))

    def power_iteration(x, seed=0, x_center_scaled=None, **kw):
        v0 = torch.tensor(np.asarray(jax.random.normal(jax.random.PRNGKey(0), (x.shape[1],), jnp.float64)))
        return tss.power_iteration_sq_norm(x, v0=v0, x_center_scaled=x_center_scaled)

    monkeypatch.setattr(tfit, "power_iteration_sq_norm", power_iteration)
    monkeypatch.setattr(tpcv, "power_iteration_sq_norm", power_iteration)


def assert_cv_lockstep(ct, cj):
    """cv_raw within CV_TOL relative, and the same optimum."""
    assert len(ct.cv_raw) == len(cj.cv_raw)
    for rt, rj in zip(ct.cv_raw, cj.cv_raw):
        np.testing.assert_allclose(rt, np.asarray(rj), rtol=CV_TOL, atol=0)
    for lt, lj in zip(ct.lambda_, cj.lambda_):
        np.testing.assert_allclose(lt, lj, rtol=1e-12)
    assert ct.alpha_min == cj.alpha_min
    best = list(np.atleast_1d(ct.alpha)).index(ct.alpha_min)
    for s in ("lambda_min", "lambda_1se"):
        assert list(ct.lambda_[best]).index(getattr(ct, s)) == list(cj.lambda_[best]).index(getattr(cj, s))
    assert ct.name == cj.name and ct.type_measure == cj.type_measure
    for key in ("alpha", "lambda", "mean", "sd"):
        np.testing.assert_allclose(ct.cv_summary[key], cj.cv_summary[key], rtol=CV_TOL)


_JAX = {}


def _jax_cv(name, x, y, **kw):
    """The JAX package's cv_fit of one case, made once a module."""
    if name not in _JAX:
        _JAX[name] = jst.cv_fit(x, y, **kw)
    return _JAX[name]


def test_cv_gaussian_basic(jax_sampling):
    x, y = random_data(n=160, p=5, seed=1)
    kw = dict(nfolds=4, nlambda=6, dtype=np.float64)
    cv = tst.cv_fit(x, y, device="cpu", **kw)
    assert cv.lambda_min > 0
    assert cv.lambda_1se >= cv.lambda_min
    assert cv.fit.family == "gaussian"
    assert cv.cv_raw[0].shape == (4, 6)
    assert np.isfinite(cv.cv_summary["mean"]).all()
    assert_cv_lockstep(cv, _jax_cv("gaussian", x, y, **kw))
    assert "lambda_min" in cv.summary() and repr(cv).startswith("CvFit(")
    np.testing.assert_allclose(cv.deviance(), cv.fit.deviance())


def test_cv_alpha_grid(jax_sampling):
    """Multiple alphas; the optimum is selected across the grid."""
    x, y = random_data(n=160, p=5, seed=2)
    kw = dict(alpha=[0.0, 1.0], nfolds=4, nlambda=6, dtype=np.float64)
    cv = tst.cv_fit(x, y, device="cpu", **kw)
    assert cv.alpha_min in (0.0, 1.0)
    assert len(cv.fits) == 2
    assert cv.fit is cv.fits[[0.0, 1.0].index(cv.alpha_min)]
    assert_cv_lockstep(cv, _jax_cv("alpha_grid", x, y, **kw))


@pytest.mark.parametrize("measure", ["deviance", "mse", "mae", "class", "auc"])
def test_cv_binomial_measures(measure, jax_sampling):
    """Every score type works for binomial."""
    x, y = random_data(n=150, p=4, family="binomial", seed=3)
    kw = dict(family="binomial", nfolds=4, nlambda=6, type_measure=measure, dtype=np.float64)
    cv = tst.cv_fit(x, y, device="cpu", **kw)
    assert np.isfinite(cv.lambda_min)
    if measure == "auc":
        assert cv.name == "AUC"
    assert_cv_lockstep(cv, _jax_cv(f"binomial_{measure}", x, y, **kw))


def test_cv_predict_at_selected_lambda(jax_sampling):
    x, y = random_data(n=160, p=5, seed=4)
    kw = dict(nfolds=4, nlambda=6, dtype=np.float64)
    cv = tst.cv_fit(x, y, device="cpu", **kw)
    p_min = cv.predict(x, s="lambda_min")
    p_1se = cv.predict(x, s="lambda_1se")
    assert p_min.shape == (160, 1)
    assert p_1se.shape == (160, 1)
    c = cv.coef()
    assert c.shape == (1, 6)
    cj = _jax_cv("predict", x, y, **kw)
    assert_cv_lockstep(cv, cj)
    scale = max(1.0, np.abs(np.asarray(cj.predict(x, s="lambda_min"))).max())
    np.testing.assert_allclose(p_min, cj.predict(x, s="lambda_min"), rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(cv.score(x, y), cj.score(x, y), rtol=1e-6)
    with pytest.raises(ValueError, match="lambda_min"):
        cv.predict(x, s="lambda_max")


def test_cv_fold_errors():
    x, y = random_data(n=30, p=3, seed=5)
    for kw, msg in ((dict(nfolds=31), "folds than samples"), (dict(nfolds=2), "greater than 2"),
                    (dict(alpha=[0.1, 0.9], lambda_path=[0.1, 0.01]), "list of lambdas"),
                    (dict(alpha=[0.1, 0.9], lambda_path=[[0.1, 0.01]]), "number of alpha"),
                    (dict(foldid=np.arange(29) % 3), "length of `foldid`"),
                    (dict(sample_weight=np.ones(29)), "one entry per sample")):
        with pytest.raises(ValueError, match=msg) as rt:
            tst.cv_fit(x, y, dtype=np.float64, device="cpu", **kw)
        with pytest.raises(ValueError, match=msg) as rj:
            jst.cv_fit(x, y, dtype=np.float64, **kw)
        assert str(rt.value) == str(rj.value)


def test_cv_explicit_foldid(jax_sampling):
    x, y = random_data(n=160, p=5, seed=6)
    foldid = np.arange(160) % 4
    kw = dict(foldid=foldid, nlambda=6, dtype=np.float64)
    cv = tst.cv_fit(x, y, device="cpu", **kw)
    assert cv.cv_raw[0].shape[0] == 4
    assert_cv_lockstep(cv, _jax_cv("foldid", x, y, **kw))


def test_find_optimum_matches():
    """_find_optimum on seeded arrays (NaN included, both directions): the
    same index, lambda_min, lambda_1se and best mean."""
    rng = np.random.default_rng(7)
    for trial in range(20):
        lam = np.sort(rng.uniform(0.01, 1.0, 12))[::-1]
        means = rng.normal(size=12)
        sds = rng.uniform(0.0, 0.5, 12)
        if trial % 3 == 0:
            means[rng.integers(0, 12)] = np.nan
        for maximize in (False, True):
            assert t_find_optimum(lam, means, sds, maximize) == j_find_optimum(lam, means, sds, maximize)
