"""The port's fit / predict / score against the JAX package's.

Same data in, same lambda path out: the port's `fit` is held against
`sgdnet_tpu.fit` on the four bundled datasets, a poisson synthetic set and
a binomial fit with every option (weights, offsets, penalty factors, box
limits, exclusions), all at float64 and thresh=1e-6.  The two packages
draw different batch orders, so they meet at the solution: coefficients
and intercepts within 1e-3 x scale, dev_ratio within 1e-3, and the lambda
path and null deviance to 1e-10.

`predict` and `score` run on a JAX fit converted with
utils/convert.fit_from_numpy, against the JAX package's on the same fit
(rtol 1e-12; exact=True refits at 1e-3 x scale), and a JAX final_state
resumes as the port's warm_state (utils/convert.state_from_numpy).
"""

import numpy as np
import pytest
import torch

import sgdnet_tpu as jst
import sgdnet_tpu_torch as tst
from sgdnet_tpu.utils.checkpoint import save_state
from sgdnet_tpu_torch.utils.convert import fit_from_numpy, state_from_numpy

torch.set_num_threads(1)

COMMON = dict(thresh=1e-6, maxit=5000, dtype=np.float64)


def _poisson_data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 6))
    return x, rng.poisson(np.exp(0.3 + x @ (rng.normal(size=6) * 0.3))).astype(np.float64)


def _heart_options():
    x, y = tst.load_heart()
    rng = np.random.default_rng(1)
    pf = np.ones(x.shape[1])
    pf[0], pf[2] = 0.0, 2.5
    return dict(sample_weight=rng.uniform(0.3, 2.0, len(y)), offset=0.3 * rng.normal(size=len(y)),
                penalty_factor=pf, lower_limits=-0.4, upper_limits=0.5, exclude=[5])


CASES = {
    "abalone": ("gaussian", dict(alpha=0.8, batch_size=128, nlambda=5, lambda_min_ratio=0.01)),
    "heart": ("binomial", dict(alpha=0.8, nlambda=8)),
    "wine": ("multinomial", dict(alpha=0.8, nlambda=6, lambda_min_ratio=0.05)),
    "student": ("mgaussian", dict(alpha=0.8, nlambda=8)),
    "poisson": ("poisson", dict(alpha=0.5, nlambda=6)),
    "heart_options": ("binomial", dict(alpha=0.7, nlambda=6)),
}

_JAX_FITS = {}


def _data(name):
    if name == "poisson":
        return _poisson_data()
    d = tst.load_dataset(name.split("_")[0])
    return d["x"], d["y"]


def _jax_fit(name):
    """(x, y, keyword args, the JAX package's fit), fitted once per module."""
    if name not in _JAX_FITS:
        family, kw = CASES[name]
        x, y = _data(name)
        kw = dict(family=family, **kw, **COMMON)
        if name == "heart_options":
            kw.update(_heart_options())
        _JAX_FITS[name] = (x, y, kw, jst.fit(x, y, **kw))
    return _JAX_FITS[name]


@pytest.mark.parametrize("name", list(CASES))
def test_fit_matches_jax(name):
    x, y, kw, fj = _jax_fit(name)
    ft = tst.fit(x, y, device="cpu", **kw)
    np.testing.assert_allclose(ft.lambda_, fj.lambda_, rtol=1e-10)
    np.testing.assert_allclose(ft.nulldev, fj.nulldev, rtol=1e-10)
    assert (fj.return_codes == 0).all() and (ft.return_codes == 0).all()
    scale = max(1.0, np.abs(fj.beta).max())
    np.testing.assert_allclose(ft.beta, fj.beta, atol=1e-3 * scale)
    a0j = np.asarray(fj.a0)
    np.testing.assert_allclose(ft.a0, a0j, atol=1e-3 * max(1.0, np.abs(a0j).max()))
    np.testing.assert_allclose(ft.dev_ratio, fj.dev_ratio, atol=1e-3)
    assert ft.classnames == fj.classnames and ft.grouped == fj.grouped and ft.nobs == fj.nobs
    assert ft.stats["device"] == "cpu" and ft.stats["epoch_kernel"] is False


def _converted(fj):
    return fit_from_numpy(
        a0=fj.a0, beta=fj.beta, lambda_=fj.lambda_, dev_ratio=fj.dev_ratio, df=fj.df, dfmat=fj.dfmat,
        nulldev=fj.nulldev, npasses=fj.npasses, return_codes=fj.return_codes, alpha=fj.alpha,
        family=fj.family, classnames=fj.classnames, grouped=fj.grouped, nobs=fj.nobs, offset=fj.offset,
    )


PREDICT_CASES = ["abalone", "heart", "wine", "student", "poisson"]


@pytest.mark.parametrize("name", PREDICT_CASES)
def test_predict_on_converted_fit(name):
    x, y, kw, fj = _jax_fit(name)
    ft = _converted(fj)
    s = [fj.lambda_[1], 0.5 * (fj.lambda_[2] + fj.lambda_[3])]  # on and between path points
    types = ["link", "response", "coefficients"] + (["class"] if fj.family in ("binomial", "multinomial") else [])
    for typ in types:
        for s_ in (None, s):
            a = ft.predict(x[:20], s=s_, type=typ)
            b = fj.predict(x[:20], s=s_, type=typ)
            if typ == "class":
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    a, b = ft.predict(type="nonzero"), fj.predict(type="nonzero")
    flat = lambda v: v if isinstance(v, list) else [u for c in sorted(v) for u in v[c]]  # noqa: E731
    for u, v in zip(flat(a), flat(b)):
        np.testing.assert_array_equal(u, v)
    np.testing.assert_allclose(ft.coef(s=s), fj.coef(s=s), rtol=1e-12)
    np.testing.assert_allclose(ft.deviance(), fj.deviance(), rtol=1e-12)


@pytest.mark.parametrize("name", PREDICT_CASES)
def test_score_on_converted_fit(name):
    x, y, kw, fj = _jax_fit(name)
    ft = _converted(fj)
    measures = {"binomial": ["deviance", "mse", "mae", "class", "auc"],
                "multinomial": ["deviance", "mse", "mae", "class"]}.get(fj.family, ["deviance", "mse", "mae"])
    for m in measures:
        np.testing.assert_allclose(ft.score(x, y, type_measure=m), fj.score(x, y, type_measure=m),
                                   rtol=1e-12, atol=1e-14, err_msg=m)


@pytest.mark.parametrize("name", ["heart", "wine"])
def test_exact_refit_matches_jax(name):
    """predict(exact=True) refits on a path augmented with s: the port's
    refit and the JAX package's meet at the solution."""
    x, y, kw, fj = _jax_fit(name)
    s = 0.5 * (fj.lambda_[2] + fj.lambda_[3])
    b = np.asarray(fj.predict(x[:10], s=s, type="link", exact=True, x=x, y=y))
    refit_kw = {k: v for k, v in kw.items() if k not in ("nlambda", "lambda_min_ratio")}
    a = _converted(fj).predict(x[:10], s=s, type="link", exact=True, x=x, y=y, **refit_kw)
    np.testing.assert_allclose(a, b, atol=1e-3 * max(1.0, np.abs(b).max()))


def test_warm_state_roundtrip(tmp_path):
    """A JAX final_state, written by sgdnet_tpu.utils.checkpoint.save_state,
    resumes in the port: the port continuing the path agrees with the JAX
    package continuing it."""
    x, y = tst.load_heart()
    kw = dict(family="binomial", alpha=0.9, **COMMON)
    lams = jst.fit(x, y, nlambda=8, **kw).lambda_
    fj1 = jst.fit(x, y, lambda_path=lams[:4], **kw)
    save_state(str(tmp_path / "state.npz"), fj1.final_state)
    with np.load(tmp_path / "state.npz") as z:
        warm = state_from_numpy(z)
    fj2 = jst.fit(x, y, lambda_path=lams[4:], warm_state=fj1.final_state, **kw)
    ft2 = tst.fit(x, y, lambda_path=lams[4:], warm_state=warm, **kw)
    assert ft2.stats["epoch_kernel"] is False  # a warm start runs the step path
    scale = max(1.0, np.abs(fj2.beta).max())
    np.testing.assert_allclose(ft2.beta, fj2.beta, atol=1e-3 * scale)
    np.testing.assert_allclose(ft2.a0, fj2.a0, atol=1e-3 * max(1.0, np.abs(fj2.a0).max()))
