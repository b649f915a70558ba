"""Kernel-free math of the PyTorch port against the JAX package.

The same float64 inputs, made with numpy from a seed, go through each JAX
function (CPU, x64 as tests/conftest.py sets it) and its twin in
sgdnet_tpu_torch: core/linalg, the three penalties, and every family
function for all five families.  Tolerance: elementwise rtol 1e-12, with
an absolute floor of 1e-12 x the largest magnitude for entries that cancel
to near zero (the two libraries' exp/log differ in the last ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdnet_tpu.core import linalg as jlin
from sgdnet_tpu.families import families as jfam
from sgdnet_tpu.penalties import penalties as jpen
from sgdnet_tpu_torch.core import linalg as tlin
from sgdnet_tpu_torch.families import families as tfam
from sgdnet_tpu_torch.penalties import penalties as tpen

torch.set_num_threads(1)

FAMILIES = ["gaussian", "binomial", "poisson", "multinomial", "mgaussian"]


def T(a):
    return torch.tensor(np.array(a, dtype=np.float64))


def close(t, j, rtol=1e-12):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    scale = max(1.0, float(np.nanmax(np.abs(j))) if j.size else 1.0)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=1e-12 * scale)


# ---------------------------------------------------------------------------
# core/linalg
# ---------------------------------------------------------------------------


def test_linalg_functions():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(30, 5)) * 3.0
    x[:, 2] = 1.5  # zero-variance column -> SD 1
    close(tlin.column_mean(T(x)), jlin.column_mean(jnp.asarray(x)))
    close(tlin.column_sd(T(x)), jlin.column_sd(jnp.asarray(x)))
    for a, b in zip(tlin.standardize(T(x)), jlin.standardize(jnp.asarray(x))):
        close(a, b)
    close(tlin.clamp(T(x), -1.0, 2.0), jlin.clamp(jnp.asarray(x), -1.0, 2.0))
    close(tlin.soft_threshold(T(x), 0.7), jlin.soft_threshold(jnp.asarray(x), 0.7))
    close(tlin.logspace(10.0, 0.01, 7), jlin.logspace(10.0, 0.01, 7))
    codes = rng.integers(0, 4, 50)
    close(tlin.proportions(torch.as_tensor(codes), 4), jlin.proportions(jnp.asarray(codes), 4))


@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
def test_logsumexp(axis, keepdims):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(12, 4)) * 20.0
    x[3, :] = -np.inf  # an all -inf row exercises the non-finite-max guard
    close(tlin.logsumexp(T(x), axis=axis, keepdims=keepdims),
          jlin.logsumexp(jnp.asarray(x), axis=axis, keepdims=keepdims))


# ---------------------------------------------------------------------------
# penalties
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_pf", [False, True])
@pytest.mark.parametrize("name", ["ridge", "elastic_net", "group_lasso"])
def test_penalty_prox_and_value(name, with_pf):
    cls = {"ridge": "Ridge", "elastic_net": "ElasticNet", "group_lasso": "GroupLasso"}[name]
    tp, jp = getattr(tpen, cls)(), getattr(jpen, cls)()
    rng = np.random.default_rng(2)
    w = rng.normal(size=(3, 7))
    w[:, 4] = 0.0  # a zero column for the group prox
    pf = rng.uniform(0.0, 2.0, size=7) if with_pf else None
    thr = 0.3 * pf if with_pf else 0.3
    close(tp.prox(T(w), T(thr) if with_pf else thr), jp.prox(jnp.asarray(w), jnp.asarray(thr)))
    close(tp.value(T(w), None if pf is None else T(pf)),
          jp.value(jnp.asarray(w), None if pf is None else jnp.asarray(pf)))


@pytest.mark.parametrize("family", FAMILIES + ["multinomial_grouped"])
@pytest.mark.parametrize("mix", [0.0, 0.5])
def test_select_penalty(family, mix):
    fam, tm = (family, "ungrouped") if family != "multinomial_grouped" else ("multinomial", "grouped")
    assert tpen.select_penalty(mix, fam, tm).name == jpen.select_penalty(mix, fam, tm).name


# ---------------------------------------------------------------------------
# families
# ---------------------------------------------------------------------------


def _raw_response(family, n, rng):
    if family == "gaussian":
        return rng.normal(size=n) * 2.0 + 1.0
    if family == "binomial":
        return rng.integers(0, 2, n)
    if family == "poisson":
        return rng.poisson(2.0, n).astype(np.float64)
    if family == "multinomial":
        return rng.integers(0, 3, n)
    return rng.normal(size=(n, 3))


def _pair(family, y_raw, **kw):
    jf, tf = jfam.get_family(family, **kw), tfam.get_family(family, **kw)
    yj, cj = jf.encode(y_raw)
    yt, ct = tf.encode(y_raw)
    np.testing.assert_array_equal(yt, yj)
    assert ct == cj and tf.n_classes == jf.n_classes
    return jf, tf, yj


@pytest.fixture(params=FAMILIES)
def family_case(request):
    family = request.param
    rng = np.random.default_rng(FAMILIES.index(family))
    n, p = 40, 5
    kw = {"smoothness": 8.0} if family == "poisson" else {}
    if family == "mgaussian":
        kw = {"standardize_response": True}
    jf, tf, y = _pair(family, _raw_response(family, n, rng), **kw)
    k = jf.n_classes
    return dict(
        family=family, jf=jf, tf=tf, y=y, x=rng.normal(size=(n, p)), lp=rng.normal(size=(n, k)) * 2.0,
        weights=rng.uniform(0.2, 2.0, size=n), offs=rng.normal(size=(n, k)) * 0.5,
        col_mult=np.where(rng.random(p) < 0.3, 0.0, rng.uniform(0.5, 2.0, p)),
    )


def test_family_loss_gradient(family_case):
    c = family_case
    jf, tf, y, lp = c["jf"], c["tf"], c["y"], c["lp"]
    if c["family"] == "poisson":
        lp = lp + 1.5  # some rates beyond the smoothness clamp
    close(tf.loss(T(lp), T(y)), jf.loss(jnp.asarray(lp), jnp.asarray(y)))
    close(tf.gradient(T(lp), T(y)), jf.gradient(jnp.asarray(lp), jnp.asarray(y)))
    close(tf.loss_report(T(lp), T(y)), jf.loss_report(jnp.asarray(lp), jnp.asarray(y)))


@pytest.mark.parametrize("weighted", [False, True])
def test_family_preprocess(family_case, weighted):
    c = family_case
    w = c["weights"] if weighted else None
    out_t = c["tf"].preprocess(T(c["y"]), None if w is None else T(w))
    out_j = c["jf"].preprocess(jnp.asarray(c["y"]), None if w is None else jnp.asarray(w))
    for a, b in zip(out_t, out_j):
        close(a, b)


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_family_null_model(family_case, weighted, fit_intercept):
    c = family_case
    jf, tf, y = c["jf"], c["tf"], c["y"]
    w = c["weights"] if weighted else None
    wt, wj = (None, None) if w is None else (T(w), jnp.asarray(w))
    close(tf.null_intercept(T(y), fit_intercept, wt), jf.null_intercept(jnp.asarray(y), fit_intercept, wj))
    close(tf.null_deviance(T(y), fit_intercept, wt), jf.null_deviance(jnp.asarray(y), fit_intercept, wj))
    if c["family"] in ("gaussian", "mgaussian"):
        return  # identity links fold offsets into the response
    offs = c["offs"][:, : jf.n_classes]
    b_t = tf.null_intercept_offset(T(y), T(offs), fit_intercept, wt)
    b_j = jf.null_intercept_offset(jnp.asarray(y), jnp.asarray(offs), fit_intercept, wj)
    close(b_t, b_j, rtol=1e-10)  # iterative solves (bisection / IPF)
    close(tf.null_deviance_offset(T(y), T(offs), fit_intercept, wt),
          jf.null_deviance_offset(jnp.asarray(y), jnp.asarray(offs), fit_intercept, wj), rtol=1e-10)


@pytest.mark.parametrize("with_col_mult", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_family_lambda_max(family_case, weighted, with_col_mult):
    c = family_case
    jf, tf, x = c["jf"], c["tf"], c["x"]
    y_proc_j, _, y_scale_j = jf.preprocess(jnp.asarray(c["y"]))
    y_proc, y_scale = np.asarray(y_proc_j), np.asarray(y_scale_j)
    w = c["weights"] if weighted else None
    cm = c["col_mult"] if with_col_mult else None
    lm_t = tf.lambda_max(T(x), T(y_proc), T(y_scale), None if w is None else T(w), None if cm is None else T(cm))
    lm_j = jf.lambda_max(jnp.asarray(x), jnp.asarray(y_proc), jnp.asarray(y_scale),
                         None if w is None else jnp.asarray(w), None if cm is None else jnp.asarray(cm))
    close(lm_t, lm_j)
    if c["family"] in ("binomial", "poisson", "multinomial"):
        offs = c["offs"][:, : jf.n_classes]
        lo_t = tfam.lambda_max_offset(tf, T(x), T(y_proc), T(offs), T(y_scale), True,
                                      None if w is None else T(w), col_mult=None if cm is None else T(cm))
        lo_j = jfam.lambda_max_offset(jf, jnp.asarray(x), jnp.asarray(y_proc), jnp.asarray(offs),
                                      jnp.asarray(y_scale), True, None if w is None else jnp.asarray(w),
                                      col_mult=None if cm is None else jnp.asarray(cm))
        close(lo_t, lo_j, rtol=1e-10)


@pytest.mark.parametrize("bad", [
    ("binomial", np.array([0, 1, 2, 1, 0])),
    ("binomial", np.array([1, 1, 1])),
    ("multinomial", np.array([0, 1, 0, 1])),
    ("poisson", np.array([1.0, -1.0, 2.0])),
    ("gaussian", np.ones((4, 2))),
    ("mgaussian", np.ones(4)),
])
def test_family_encode_errors_match(bad):
    family, y = bad
    with pytest.raises(ValueError) as ej:
        jfam.get_family(family).encode(y)
    with pytest.raises(ValueError) as et:
        tfam.get_family(family).encode(y)
    assert str(et.value) == str(ej.value)
