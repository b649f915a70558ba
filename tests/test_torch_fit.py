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
    refit_kw["device"] = "cpu"
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
        warm = state_from_numpy(z, device="cpu")
    fj2 = jst.fit(x, y, lambda_path=lams[4:], warm_state=fj1.final_state, **kw)
    ft2 = tst.fit(x, y, lambda_path=lams[4:], warm_state=warm, device="cpu", **kw)
    assert ft2.stats["epoch_kernel"] is False  # a warm start runs the step path
    scale = max(1.0, np.abs(fj2.beta).max())
    np.testing.assert_allclose(ft2.beta, fj2.beta, atol=1e-3 * scale)
    np.testing.assert_allclose(ft2.a0, fj2.a0, atol=1e-3 * max(1.0, np.abs(fj2.a0).max()))


# ---------------------------------------------------------------------------
# prebuilt layouts: fit(x=PaddedCSR | HybridCSR) and predict(newx=...)
# ---------------------------------------------------------------------------
#
# Both packages take a layout their user built.  The port's is carried over
# from the JAX package's with utils/convert.layout_from_jax, so the two fits
# start from the same arrays.


def _padded_problem():
    import scipy.sparse as sp
    from sgdnet_tpu.core.sparse import PaddedCSR as JPaddedCSR

    from helpers import random_data

    x, y = random_data(n=100, p=6, density=0.4, seed=1)
    return sp.csr_matrix(x), y, JPaddedCSR.from_scipy(sp.csr_matrix(x), dtype=np.float64)


def test_fit_accepts_padded_csr_directly(monkeypatch):
    """Twin of tests/test_edge_cases.py::test_fit_accepts_padded_csr_directly:
    the port's fit on a prebuilt PaddedCSR is its fit on the same scipy
    matrix (the reference test's 1e-10).  Against the JAX package's fit of
    the same layout, with the JAX fit's batch orders, the two differ by
    their power iterations' step sizes and the order of their sums: 1e-6 x
    scale (measured 1.4e-7)."""
    from sgdnet_tpu_torch.solver import saga as tsaga
    from sgdnet_tpu_torch.utils.convert import layout_from_jax

    xs, y, jcsr = _padded_problem()
    kw = dict(nlambda=5, dtype=np.float64)
    tcsr = layout_from_jax(jcsr, device="cpu")
    ft = tst.fit(tcsr, y, device="cpu", **kw)
    f_scipy = tst.fit(xs, y, hybrid=False, device="cpu", **kw)
    np.testing.assert_allclose(ft.beta, f_scipy.beta, atol=1e-10)
    assert ft.stats["layout"] == {"kind": "padded_csr", "row_width": tcsr.row_width}
    fj = jst.fit(jcsr, y, **kw)
    from test_torch_solver import ReferenceOrders

    # the port's default sampler replaced by the JAX fit's orders
    monkeypatch.setattr(tsaga, "default_order_fn", lambda seed, n: ReferenceOrders(seed, n, 1000))
    fl = tst.fit(tcsr, y, device="cpu", **kw)
    assert fl.npasses == fj.npasses and (fl.return_codes == fj.return_codes).all()
    scale = max(1.0, np.abs(fj.beta).max())
    np.testing.assert_allclose(fl.beta, fj.beta, atol=1e-6 * scale)
    np.testing.assert_allclose(fl.a0, np.asarray(fj.a0), atol=1e-6 * max(1.0, np.abs(fj.a0).max()))


def test_prebuilt_hybrid_keeps_its_column_order():
    """A prebuilt f64 HybridCSR: the port's fit returns coefficients in the
    layout's column order, as the JAX package's does (the port's fit of the
    scipy matrix, permuted, to 1e-10: the same layout), and meets the JAX
    fit of the same layout at the solution (1e-3 x scale, at thresh 1e-5;
    measured 1.8e-4)."""
    import scipy.sparse as sp
    from sgdnet_tpu.core.sparse import HybridCSR as JHybridCSR

    from helpers import random_data
    from sgdnet_tpu_torch.utils.convert import layout_from_jax

    x, y = random_data(n=300, p=40, family="binomial", density=0.3, seed=11)
    jh, perm = JHybridCSR.split_columns(sp.csr_matrix(x), coverage=0.8, max_head=16, dtype=np.float64)
    kw = dict(family="binomial", alpha=0.5, nlambda=4, lambda_min_ratio=0.1, batch_size=32, thresh=1e-5,
              maxit=5000, dtype=np.float64)
    fj = jst.fit(jh, y, **kw)
    ft = tst.fit(layout_from_jax(jh, device="cpu"), y, device="cpu", **kw)
    assert ft.stats["layout"]["kind"] == "hybrid" and ft.stats["layout"]["head_width"] == jh.n_head
    scale = max(1.0, np.abs(fj.beta).max())
    np.testing.assert_allclose(ft.beta, fj.beta, atol=1e-3 * scale)
    # and it is the scipy fit's, permuted
    fs = tst.fit(sp.csr_matrix(x), y, hybrid=True, hybrid_coverage=0.8, hybrid_max_head=16, device="cpu", **kw)
    np.testing.assert_allclose(ft.beta[:, :, np.argsort(perm)], fs.beta, atol=1e-10)


def _binomial_objective(f, x, y, alpha, sd):
    """Per-lambda penalized objective of a binomial fit on the original
    data: mean log-loss + lambda (alpha |b sd|_1 + (1 - alpha) / 2 |b sd|^2)."""
    b = f.beta[:, 0, :] * sd[None, :]
    lp = np.asarray(x @ f.beta[:, 0, :].T) + np.asarray(f.a0)[None, :]
    loss = np.mean(np.logaddexp(0.0, lp) - y[:, None] * lp, axis=0)
    return loss + f.lambda_ * (alpha * np.abs(b).sum(axis=1) + 0.5 * (1 - alpha) * (b * b).sum(axis=1))


def test_prebuilt_f32_hybrid_quantized_on_the_device():
    """Twin of tests/test_perf_modes.py::test_int8_host_vs_device_path_fit_agrees:
    a prebuilt f32 HybridCSR with hybrid_head_dtype="int8" is standardized,
    then quantized on the device.  Against the host int8 ingestion of the
    same scipy matrix at the reference test's 1e-2 x scale; against the JAX
    package's device path on the same layout at the trajectory-insensitive
    contract (ROADMAP Queue 3), the penalized objective per lambda: within
    5e-3 relative, as each fit stops within thresh (1e-3) of its own
    trajectory's solution (measured 1.8e-3)."""
    import jax.numpy as jnp
    import scipy.sparse as sp
    from sgdnet_tpu.core.sparse import HybridCSR as JHybridCSR

    from helpers import pop_sd, random_data
    from sgdnet_tpu_torch.utils.convert import layout_from_jax

    x, y = random_data(n=400, p=64, family="binomial", density=0.3, seed=29)
    xs = sp.csr_matrix(x)
    kw = dict(family="binomial", alpha=0.5, batch_size=32, seed=7, dtype=np.float32, hybrid_head_dtype="int8")
    host = tst.fit(xs, y, nlambda=6, hybrid=True, hybrid_max_head=32, hybrid_coverage=0.8, device="cpu", **kw)
    assert host.stats["layout"]["head_dtype"] == "torch.int8"
    jh, perm = JHybridCSR.split_columns(xs, coverage=0.8, max_head=32, dtype=jnp.float32)
    th = layout_from_jax(jh, device="cpu")
    dev = tst.fit(th, y, lambda_path=host.lambda_, device="cpu", **kw)
    assert dev.stats["layout"]["head_dtype"] == "torch.int8" and th.head.dtype == torch.float32  # not in place
    beta_dev = np.empty_like(dev.beta)
    beta_dev[:, :, perm] = dev.beta  # prebuilt layouts return permuted columns
    np.testing.assert_allclose(host.beta, beta_dev, atol=1e-2 * max(np.abs(host.beta).max(), 1.0))
    fj = jst.fit(jh, y, lambda_path=host.lambda_, **kw)
    xp = x[:, perm]
    sd = pop_sd(xp)
    oj, ot = _binomial_objective(fj, xp, y, 0.5, sd), _binomial_objective(dev, xp, y, 0.5, sd)
    np.testing.assert_allclose(ot, oj, rtol=5e-3)


def test_malformed_layout_raises_as_scipy_input():
    """A NaN in a prebuilt layout raises the error a NaN in scipy input
    raises; rows that do not match y raise as scipy input does; a row with
    a repeated column is summed as canonical_csr sums scipy duplicates, and
    a layout whose parts disagree raises."""
    import scipy.sparse as sp

    from sgdnet_tpu_torch.core.sparse import HybridCSR, PaddedCSR

    xs, y, _ = _padded_problem()
    kw = dict(nlambda=3, dtype=np.float64, device="cpu")
    bad = xs.copy()
    bad.data[3] = np.nan
    for arg in (bad, PaddedCSR.from_scipy(bad, dtype=torch.float64, device="cpu")):
        with pytest.raises(ValueError, match="NA values are not allowed"):
            tst.fit(arg, y, **kw)
    for arg in (xs, PaddedCSR.from_scipy(xs, dtype=torch.float64, device="cpu")):
        with pytest.raises(ValueError, match="the number of samples in 'x' and 'y' must match"):
            tst.fit(arg, y[:-1], **kw)
    hb, _ = HybridCSR.split_columns(bad, coverage=0.5, max_head=2, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="NA values are not allowed"):
        tst.fit(hb, y, **kw)
    # duplicates: the same (row, column) twice, summed by scipy and by the fit
    coo = xs.tocoo()
    dup = sp.csr_matrix((np.r_[coo.data, 0.5], (np.r_[coo.row, coo.row[0]], np.r_[coo.col, coo.col[0]])),
                        shape=xs.shape)
    dup.has_canonical_format = False
    raw = PaddedCSR.from_scipy(sp.csr_matrix(xs), dtype=torch.float64, device="cpu")
    r0, L = int(coo.row[0]), raw.row_width
    nnz0 = int(raw.nnz[r0])
    if nnz0 == L:  # room for one more entry in row r0
        raw = PaddedCSR(torch.cat([raw.indices, torch.zeros((raw.n_rows, 8), dtype=raw.indices.dtype)], 1),
                        torch.cat([raw.values, torch.zeros((raw.n_rows, 8), dtype=raw.values.dtype)], 1),
                        raw.nnz, raw.n_rows, raw.n_cols)
    raw.indices[r0, nnz0], raw.values[r0, nnz0] = int(coo.col[0]), 0.5
    raw.nnz[r0] += 1
    fd, fs = tst.fit(raw, y, **kw), tst.fit(dup, y, hybrid=False, **kw)
    np.testing.assert_allclose(fd.beta, fs.beta, atol=1e-10)
    with pytest.raises(ValueError, match="pad entries"):
        broken = PaddedCSR(raw.indices.clone(), raw.values.clone(), raw.nnz, raw.n_rows, raw.n_cols)
        broken.values[0, -1] = 1.0
        tst.fit(broken, y, **kw)
    with pytest.raises(ValueError, match="do not match its shape"):
        h, _ = HybridCSR.split_columns(xs, coverage=0.5, max_head=2, dtype=torch.float64, device="cpu")
        tst.fit(HybridCSR(h.head[:-1], h.tail, h.n_rows, h.n_cols), y, **kw)


def test_padded_csr_newx_no_densify():
    """Twin of tests/test_predictions.py::test_padded_csr_newx_no_densify:
    predict takes a PaddedCSR / HybridCSR newx (the layout's product, class
    by class, never densified) and gives the dense prediction, on a JAX fit
    converted to the port, as the JAX package predicts it (1e-8, the
    reference test's bound)."""
    import scipy.sparse as sp
    from sgdnet_tpu.core.sparse import HybridCSR as JHybridCSR
    from sgdnet_tpu.core.sparse import PaddedCSR as JPaddedCSR

    from helpers import random_data
    from sgdnet_tpu_torch.utils.convert import layout_from_jax

    x, y = random_data(n=150, p=12, family="gaussian", density=0.3, seed=34)
    fj = jst.fit(x, y, nlambda=6, dtype=np.float64)
    ft = _converted(fj)
    dense = ft.predict(x)
    jcsr = JPaddedCSR.from_scipy(sp.csr_matrix(x), dtype=np.float64)
    np.testing.assert_allclose(ft.predict(layout_from_jax(jcsr, device="cpu")), dense, rtol=1e-8)
    np.testing.assert_allclose(ft.predict(layout_from_jax(jcsr, device="cpu")), fj.predict(jcsr), rtol=1e-8)
    # a HybridCSR newx predicts in its own column order
    jh, perm = JHybridCSR.split_columns(sp.csr_matrix(x), coverage=0.6, max_head=4, dtype=np.float64)
    fp = _converted(fj)
    fp.beta = fj.beta[:, :, perm]
    np.testing.assert_allclose(fp.predict(layout_from_jax(jh, device="cpu")), dense, rtol=1e-8)
    # multinomial: class by class
    xw, yw = tst.load_wine()
    fjw = _jax_fit("wine")[3]
    jw = JPaddedCSR.from_scipy(sp.csr_matrix(xw[:30]), dtype=np.float64)
    np.testing.assert_allclose(_converted(fjw).predict(layout_from_jax(jw, device="cpu"), type="response"),
                               fjw.predict(xw[:30], type="response"), rtol=1e-8)
