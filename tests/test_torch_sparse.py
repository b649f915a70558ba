"""The port's sparse slice against the JAX package: layouts, batch ops,
the solver in lockstep, the hybrid K2 step, and whole fits on scipy input.

  * layouts (PaddedCSR, HybridCSR.split_columns with f64 / bf16 / int8
    heads, with and without std_stats, HeadNNZ, materialize_int8_head,
    BlockCOO, quantize_head) built by both packages from the same canonical
    CSR are exactly equal, and `layout_from_jax` carries a JAX layout over
    bit for bit;
  * the layouts' linear algebra and the solver's batch ops (dense,
    PaddedCSR densify / gather, HybridCSR with f64 / bf16 / int8 heads, the
    BlockCOO tail, the centering term xc) agree with the JAX package's at
    f64 to 1e-12 x scale (bf16 / int8 operands are rounded identically;
    only summation order differs);
  * fit_path on a layout, given the same layout, step sizes and batch
    orders (tests/test_torch_solver.py ReferenceOrders), agrees with the
    JAX fit_path at 1e-8 x scale, under block and permutation sampling;
  * one hybrid step through the K2 twin agrees with the JAX step_pallas
    (Pallas K2 in interpret mode) on a bf16 head at 1e-5 x scale in f32:
    the bf16 roundings of w and gc are the same, and the f32 sums differ
    only in order (tiles vs one product);
  * whole fits on scipy input meet `sgdnet_tpu.fit` at the solution:
    PaddedCSR (gather / densify) and f64-head hybrids at 1e-3 x scale in
    the coefficients; bf16 heads at 2e-2 x scale (the bound of the JAX
    package's own bf16 test) and by penalized objective; int8 heads by
    penalized objective only (trajectory-insensitive: the reference's own
    int8 test is red).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sgdnet_tpu as jst
import sgdnet_tpu_torch as tst
from sgdnet_tpu.core import sparse as js
from sgdnet_tpu.families import get_family as jget_family
from sgdnet_tpu.penalties import select_penalty as jselect_penalty
from sgdnet_tpu.solver import saga as jsaga
from sgdnet_tpu.solver.stepsize import power_iteration_sq_norm as j_power, saga_step_sizes
from sgdnet_tpu_torch.core import sparse as ts
from sgdnet_tpu_torch.families import get_family
from sgdnet_tpu_torch.penalties import select_penalty
from sgdnet_tpu_torch.solver import saga as tsaga
from sgdnet_tpu_torch.solver import stepsize as tss
from sgdnet_tpu_torch.utils.convert import layout_from_jax
from test_torch_solver import ReferenceOrders, _assert_lockstep

torch.set_num_threads(1)

CPU = dict(device="cpu")


def _zipf_csr(n=320, p=600, per_row=10, seed=0):
    """Bag-of-words-like canonical CSR (Zipf column use, as bench.py's
    make_sparse_binomial at a small size) and a binomial response."""
    rng = np.random.default_rng(seed)
    wz = (np.arange(p) + 10.0) ** -1.15
    cols = np.searchsorted(np.cumsum(wz) / wz.sum(), rng.random((n, per_row))).clip(0, p - 1)
    vals = rng.normal(size=(n, per_row))
    x = sp.csr_matrix((vals.ravel(), cols.ravel(), np.arange(0, n * per_row + 1, per_row)), shape=(n, p))
    x.sum_duplicates()
    beta = rng.normal(size=p) * (rng.random(p) < 0.08) * 2.0
    beta[:6] = [1.5, -1.2, 1.0, -0.8, 0.9, 1.1]
    eta = x @ beta
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-eta))).astype(float)
    return x, y, eta


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a


def _same(t, j, name=""):
    tv = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    jv = _t(j)
    assert tv.shape == jv.shape, name
    np.testing.assert_array_equal(tv, jv, err_msg=name)


JH = {"f64": None, "bf16": jnp.bfloat16, "int8": jnp.int8}


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_padded_csr_matches_jax(dtype):
    x, _, _ = _zipf_csr()
    j = js.PaddedCSR.from_scipy(x, dtype=getattr(jnp, dtype))
    t = ts.PaddedCSR.from_scipy(x, dtype=getattr(torch, dtype), **CPU)
    for f in ("indices", "values", "nnz"):
        _same(getattr(t, f), getattr(j, f), f)
    c = layout_from_jax(j, device="cpu")
    for f in ("indices", "values", "nnz"):
        _same(getattr(c, f), getattr(j, f), f)


SPLITS = {
    "f64": dict(head_dtype=None),
    "f32": dict(head_dtype=None, dtype="float32"),
    "bf16": dict(head_dtype="bfloat16"),
    "int8": dict(head_dtype="int8"),
    "int8_std": dict(head_dtype="int8", std=True),
    "int8_nnz_std": dict(head_dtype="int8", std=True, head_form="nnz"),
    "f64_budget": dict(head_dtype=None, memory_budget=320 * 8 * 130),
}


@pytest.mark.parametrize("case", list(SPLITS))
def test_split_columns_matches_jax(case):
    kw = dict(SPLITS[case])
    x, _, _ = _zipf_csr()
    std = js.scipy_column_stats(x) if kw.pop("std", False) else None
    hd = kw.pop("head_dtype")
    form = kw.pop("head_form", "dense")
    dt = kw.pop("dtype", "float64")
    common = dict(coverage=0.8, max_head=256, std_stats=std, head_form=form, **kw)
    jh, jperm = js.HybridCSR.split_columns(x, dtype=getattr(jnp, dt), head_dtype=None if hd is None else getattr(jnp, hd),
                                           as_host=form == "nnz", **common)
    th, tperm = ts.HybridCSR.split_columns(x, dtype=getattr(torch, dt), head_dtype=hd, device="cpu", **common)
    np.testing.assert_array_equal(tperm, jperm)
    for f in ("indices", "values", "nnz"):
        _same(getattr(th.tail, f), getattr(jh.tail, f), f)
    if form == "nnz":
        for f in ("rows", "cols", "vals", "q0"):
            np.testing.assert_array_equal(getattr(th.head, f), getattr(jh.head, f), err_msg=f)
        # the nonzero form rebuilds the dense head bit for bit, padded or not
        for n_pad in (None, 384):
            _same(ts.materialize_int8_head(th.head, n_pad, device="cpu"),
                  js.materialize_int8_head(jh.head, n_pad), "materialized head")
        with pytest.raises(ValueError, match="n_pad"):
            ts.materialize_int8_head(th.head, 100, device="cpu")
    else:
        assert th.head.dtype == {None: getattr(torch, dt), "bfloat16": torch.bfloat16, "int8": torch.int8}[hd]
        _same(th.head, jh.head, "head")
        c = layout_from_jax(jh, device="cpu")
        _same(c.head, jh.head, "carried head")
    if hd == "int8":
        _same(th.head_scale, jh.head_scale, "head_scale")


def test_block_coo_and_quantize_match_jax():
    x, _, _ = _zipf_csr()
    jh, _ = js.HybridCSR.split_columns(x, coverage=0.8, max_head=128, dtype=jnp.float64)
    th, _ = ts.HybridCSR.split_columns(x, coverage=0.8, max_head=128, dtype=torch.float64, **CPU)
    jb = js.BlockCOO.from_padded(jh.tail.pad_rows(384), 64)
    tb = ts.BlockCOO.from_padded(th.tail.pad_rows(384), 64)
    for f in ("rows", "cols", "vals"):
        _same(getattr(tb, f), getattr(jb, f), f)
    assert (tb.batch, tb.n_cols) == (jb.batch, jb.n_cols)
    jq, tq = jh.quantize_head(), th.quantize_head()
    _same(tq.head, jq.head, "int8 head")
    _same(tq.head_scale, jq.head_scale, "scale")


# ---------------------------------------------------------------------------
# the layouts' linear algebra and the solver's batch ops
# ---------------------------------------------------------------------------


def _layouts(head="f64", std=True, n_pad=384, B=64):
    """The same standardized layout in both packages (JAX built, carried
    over), with its xc and a BlockCOO tail."""
    x, y, eta = _zipf_csr()
    jh, perm = js.HybridCSR.split_columns(x, coverage=0.8, max_head=128, dtype=jnp.float64)
    xc = None
    if std:
        mean, sd = jh.column_stats()
        jh, xc = jh.standardize(mean, sd)
    if head == "bf16":
        jh = js.HybridCSR(jh.head.astype(jnp.bfloat16), jh.tail, jh.n_rows, jh.n_cols)
    elif head == "int8":
        jh = jh.quantize_head()
    jh = jh.pad_rows(n_pad)
    jh = js.HybridCSR(jh.head, jh.tail, jh.n_rows, jh.n_cols, blk_tail=js.BlockCOO.from_padded(jh.tail, B),
                      head_scale=jh.head_scale)
    return jh, layout_from_jax(jh, device="cpu"), xc, x, y


def _close(a, b, tol=1e-12, name=""):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(1.0, float(np.abs(b).max())), err_msg=name)


@pytest.mark.parametrize("head", ["f64", "bf16", "int8"])
def test_hybrid_linear_algebra_matches_jax(head):
    jh, th, xc, _, _ = _layouts(head)
    rng = np.random.default_rng(2)
    n, p = jh.shape
    v = rng.normal(size=(n, 2))
    wt = rng.normal(size=(p, 2))
    _close(th.matvec_T(torch.tensor(v)), jh.matvec_T(jnp.asarray(v)), name="matvec_T")
    _close(th.matvec_T(torch.tensor(v[:, 0])), jh.matvec_T(jnp.asarray(v[:, 0])), name="matvec_T 1-d")
    _close(th.matmul_dense(torch.tensor(wt)), jh.matmul_dense(jnp.asarray(wt)), name="matmul_dense")
    xct = None if xc is None else torch.tensor(np.asarray(xc))
    _close(th.row_squared_norms(xct), jh.row_squared_norms(xc), name="row norms")
    assert th.total_nnz() == jh.total_nnz()
    c0 = np.asarray(xc)
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (p,), dtype=jnp.promote_types(jh.head.dtype,
                                                                                           jnp.float32)))
    a = tss.power_iteration_sq_norm(th, v0=torch.tensor(v0), x_center_scaled=torch.tensor(c0))
    b = j_power(jh, xc)
    np.testing.assert_allclose(float(a), float(b), rtol=1e-5 if head != "f64" else 1e-10)


def test_padded_csr_linear_algebra_matches_jax():
    x, _, _ = _zipf_csr()
    j = js.PaddedCSR.from_scipy(x, dtype=jnp.float64)
    t = layout_from_jax(j, device="cpu")
    rng = np.random.default_rng(3)
    w = rng.uniform(0.5, 2.0, x.shape[0])
    for jw, tw in ((None, None), (jnp.asarray(w), torch.tensor(w))):
        for a, b in zip(t.column_stats(tw), j.column_stats(jw)):
            _close(a, b, name="column_stats")
    jm, jsd = j.column_stats()
    _close(t.scale_columns(torch.tensor(np.asarray(jsd))).values, j.scale_columns(jsd).values, name="scale")
    _close(t.to_dense(), j.to_dense(), name="to_dense")
    c = rng.normal(size=x.shape[1])
    _close(t.max_squared_row_norm(torch.tensor(c)), j.max_squared_row_norm(jnp.asarray(c)), name="row norm")
    _close(t.pad_rows(400).matvec_T(torch.tensor(rng.normal(size=(400, 1)))).shape, (x.shape[1], 1))
    m_t, s_t = ts.scipy_column_stats(x, w)
    m_j, s_j = js.scipy_column_stats(x, w)
    _close(m_t, m_j)
    _close(s_t, s_j)
    _close(ts.scipy_row_sq_norms(x, m_t, s_t), js.scipy_row_sq_norms(x, m_j, s_j))


@pytest.mark.parametrize("head", ["f64", "bf16", "int8"])
def test_hybrid_column_stats_and_standardize_match_jax(head):
    x, _, _ = _zipf_csr()
    hd = JH[head] if head != "int8" else None
    jh, _ = js.HybridCSR.split_columns(x, coverage=0.8, max_head=128, dtype=jnp.float64, head_dtype=hd)
    th = layout_from_jax(jh, device="cpu")
    w = np.random.default_rng(4).uniform(0.5, 2.0, x.shape[0])
    for jw, tw in ((None, None), (jnp.asarray(w), torch.tensor(w))):
        jm, jsd = jh.column_stats(jw)
        tm, tsd = th.column_stats(tw)
        _close(tm, jm, name="mean")
        _close(tsd, jsd, name="sd")
    js_, jxc = jh.standardize(jm, jsd)
    ts_, txc = th.standardize(torch.tensor(np.asarray(jm)), torch.tensor(np.asarray(jsd)))
    _same(ts_.head, js_.head, "standardized head")
    _close(txc, jxc, name="xc")
    _close(ts_.tail.values, js_.tail.values, name="tail")


OPS = ["dense", "csr_densify", "csr_gather", "hybrid_f64", "hybrid_bf16", "hybrid_int8"]


@pytest.mark.parametrize("kind", OPS)
@pytest.mark.parametrize("sel_kind", ["block", "rows"])
def test_batch_ops_match_jax(kind, sel_kind):
    B = 64
    rng = np.random.default_rng(5)
    if kind.startswith("hybrid"):
        jx, tx, xc, _, _ = _layouts(kind.split("_")[1], B=B)
    else:
        x, _, _ = _zipf_csr()
        x = sp.vstack([x, sp.csr_matrix((64, x.shape[1]))]).tocsr()
        jx = js.PaddedCSR.from_scipy(x, dtype=jnp.float64)
        if kind == "dense":
            jx = jnp.asarray(x.toarray())
            tx = torch.tensor(x.toarray())
        else:
            tx = layout_from_jax(jx, device="cpu")
        xc = jnp.asarray(rng.normal(size=x.shape[1]) * 0.1)
    mode = "gather" if kind == "csr_gather" else "densify"
    p = jx.shape[1]
    w = rng.normal(size=(2, p)) * 0.3
    gc = rng.normal(size=(B, 2))
    txc = torch.tensor(np.asarray(xc))
    for start in (0, 128, 320):
        if sel_kind == "block":
            jsel, tsel = jnp.int32(start), start
        else:
            idx = rng.permutation(jx.shape[0])[:B]
            jsel, tsel = jnp.asarray(idx), torch.tensor(idx)
        _close(tsaga._batch_predict(tx, txc, torch.tensor(w), tsel, B),
               jsaga._batch_predict(jx, xc, jnp.asarray(w), jsel, B), name="predict")
        _close(tsaga._batch_outer(tx, txc, torch.tensor(gc), tsel, B, mode),
               jsaga._batch_outer(jx, xc, jnp.asarray(gc), jsel, B, mode), name="outer")


# ---------------------------------------------------------------------------
# the solver on a layout, in lockstep
# ---------------------------------------------------------------------------


def _lockstep_sparse(layout, sampling, family="binomial", alpha=0.9, B=64, nlambda=4, max_iter=150,
                     tol=1e-4, mode="densify", refresh_every=2, seed=0):
    jx, tx, xc, _, y = layout
    n = jx.shape[0]
    n_real = len(y)
    jfam = jget_family(family)
    y_enc, _ = jfam.encode(y)
    y_proc = np.asarray(jfam.preprocess(jnp.asarray(y_enc))[0])
    y_proc = np.concatenate([y_proc, np.zeros((n - n_real, 1))])
    w = np.concatenate([np.ones(n_real), np.zeros(n - n_real)])
    k = jfam.n_classes
    tfam = get_family(family)
    jpen, tpen = jselect_penalty(alpha, family, "ungrouped"), select_penalty(alpha, family, "ungrouped")
    null = np.asarray(jfam.null_intercept(jnp.asarray(y_proc[:n_real]), True, None))
    lmax = float(jfam.lambda_max(jx, jnp.asarray(y_proc), jnp.ones(1), jnp.asarray(w))) / alpha
    lams = np.geomspace(lmax * 0.6, lmax * 0.1, nlambda)
    l1s, l2s = alpha * lams, (1.0 - alpha) * lams
    top = float(j_power(jx, xc)) / n_real
    max_sq = float(np.max(np.asarray(jx.row_squared_norms(xc)) if isinstance(jx, js.HybridCSR)
                          else np.asarray(jx.to_dense() ** 2).sum(1)))
    gammas = np.asarray(saga_step_sizes(max_sq, top, jnp.asarray(l2s), float(n_real), B, True, jfam.L_scaling))
    cfg = dict(batch_size=B, max_iter=max_iter, sampling=sampling, intercept_decay=0.01, sparse_mode=mode,
               g_sum_refresh_every=refresh_every)
    j0 = jsaga.init_state(n, jx.shape[1], k, jnp.float64)._replace(intercept=jnp.asarray(null))
    jout = jax.device_get(jsaga.fit_path(
        jx, jnp.asarray(y_proc), jnp.asarray(w), xc, jnp.asarray(gammas), jnp.asarray(l1s), jnp.asarray(l2s),
        jnp.asarray(tol), jax.random.PRNGKey(seed), j0, jfam, jpen, jsaga.SolverConfig(**cfg)))
    t0 = tsaga.init_state(n, jx.shape[1], k, torch.float64)._replace(intercept=torch.tensor(null))
    tout = tsaga.fit_path(
        tx, torch.tensor(y_proc), torch.tensor(w), gammas, l1s, l2s, tol, t0, tfam, tpen,
        tsaga.SolverConfig(**cfg), order_fn=ReferenceOrders(seed, n // B if sampling == "block" else n, max_iter),
        xc=None if xc is None else torch.tensor(np.asarray(xc)))
    return jout, tout


@pytest.mark.parametrize("head,sampling", [("f64", "block"), ("f64", "permutation"), ("bf16", "block"),
                                           ("int8", "block")])
def test_fit_path_lockstep_hybrid(head, sampling):
    jout, tout = _lockstep_sparse(_layouts(head), sampling)
    _assert_lockstep(jout, tout)


@pytest.mark.parametrize("mode,sampling", [("gather", "permutation"), ("densify", "block")])
def test_fit_path_lockstep_padded_csr(mode, sampling):
    x, y, _ = _zipf_csr()
    x = sp.vstack([x, sp.csr_matrix((64, x.shape[1]))]).tocsr()
    jx = js.PaddedCSR.from_scipy(x, dtype=jnp.float64)
    mean, sd = jx.column_stats()
    jx = jx.scale_columns(sd)
    xc = mean / sd
    jout, tout = _lockstep_sparse((jx, layout_from_jax(jx, device="cpu"), xc, x, y), sampling, mode=mode)
    _assert_lockstep(jout, tout)


def test_hybrid_k2_step_matches_jax_step_pallas():
    jh, th, xc, _, y = _layouts("bf16")
    B = 64
    n, p = jh.shape
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    jx = js.HybridCSR(jh.head, js.PaddedCSR(jh.tail.indices, jh.tail.values.astype(jnp.float32), jh.tail.nnz,
                                            n, p), n, p, blk_tail=js.BlockCOO.from_padded(
                      js.PaddedCSR(jh.tail.indices, jh.tail.values.astype(jnp.float32), jh.tail.nnz, n, p), B))
    tx = layout_from_jax(jx, device="cpu")
    rng = np.random.default_rng(6)
    yb = np.concatenate([y, np.zeros(n - len(y))])[:, None]
    wts = np.concatenate([np.ones(len(y)), np.zeros(n - len(y))])
    st = [rng.normal(size=(1, p)) * 0.2, np.array([0.1]), rng.normal(size=(n, 1)) * 0.1,
          rng.normal(size=(1, p)) * 0.01, np.array([0.01])]
    jfam, tfam = jget_family("binomial"), get_family("binomial")
    pen_j, pen_t = jselect_penalty(0.9, "binomial", "ungrouped"), select_penalty(0.9, "binomial", "ungrouped")
    cfg = dict(batch_size=B, sampling="block", use_pallas=True, intercept_decay=0.01)
    jstep = jsaga._make_step(jx, f32(yb), f32(wts), f32(xc), float(len(y)), jfam, pen_j, jsaga.SolverConfig(**cfg))
    tstep = tsaga._make_step(tx, torch.tensor(yb, dtype=torch.float32), torch.tensor(wts, dtype=torch.float32),
                             float(len(y)), tfam, pen_t, tsaga.SolverConfig(**cfg),
                             xc=torch.tensor(np.asarray(xc), dtype=torch.float32))
    assert tstep.__name__ == "step_pallas"
    gamma, l1, l2 = np.float32(0.05), np.float32(0.01), np.float32(0.001)
    for start in (0, 192):
        js_ = jstep(jsaga.SagaState(*(f32(a) for a in st)), (gamma, l1, l2), jnp.int32(start))
        ts_ = tstep(tsaga.SagaState(*(torch.tensor(a, dtype=torch.float32) for a in st)),
                    tsaga._scalars(gamma, l1, l2, 0.01, np.float32), start)
        for name, a, b in zip(tsaga.SagaState._fields, ts_, js_):
            _close(a, b, tol=1e-5, name=name)


# ---------------------------------------------------------------------------
# whole fits on scipy input
# ---------------------------------------------------------------------------


def _objective(fit, x, y, sd):
    """Per-lambda penalized objective of a binomial fit on the original
    data: mean log-loss + lambda (alpha |w|_1 + (1 - alpha)/2 |w|^2), w the
    standardized coefficients beta * sd."""
    lp = np.asarray(x @ fit.beta[:, 0, :].T) + np.asarray(fit.a0)[None, :]
    loss = np.mean(np.logaddexp(0.0, lp) - y[:, None] * lp, axis=0)
    w = fit.beta[:, 0, :] * sd[None, :]
    a = fit.alpha
    return loss + fit.lambda_ * (a * np.abs(w).sum(1) + 0.5 * (1 - a) * (w**2).sum(1))


FITS = {
    "csr_gather": dict(family="binomial", hybrid=False, sparse_mode="gather"),
    "csr_densify_gaussian": dict(family="gaussian", hybrid=False, sparse_mode="densify", standardize=False),
    "hybrid_binomial": dict(family="binomial"),
    "hybrid_gaussian_nostd": dict(family="gaussian", standardize=False),
    "hybrid_bf16": dict(family="binomial", hybrid_head_dtype="bfloat16"),
    "hybrid_int8": dict(family="binomial", hybrid_head_dtype="int8"),
    "hybrid_int8_nostd_perm": dict(family="binomial", hybrid_head_dtype="int8", standardize=False,
                                   sampling="permutation"),
}


@pytest.mark.parametrize("case", list(FITS))
def test_fit_on_scipy_matches_jax(case):
    kw = dict(FITS[case])
    x, y, eta = _zipf_csr()
    if kw["family"] == "gaussian":
        y = eta + 0.3 * np.random.default_rng(7).normal(size=len(eta))
    kw = dict(dict(alpha=0.9, nlambda=4, lambda_min_ratio=0.1, thresh=1e-5, maxit=400, batch_size=64,
                   dtype=np.float64, hybrid_coverage=0.8, hybrid_max_head=128, seed=1), **kw)
    if "sampling" not in kw:
        kw["sampling"] = "block"
    hd = kw.get("hybrid_head_dtype")
    fj = jst.fit(x, y, **kw)
    ft = tst.fit(x, y, device="cpu", **kw)
    # lambda_max of a bf16 head is a product summed in f32 by both packages,
    # in different orders
    np.testing.assert_allclose(ft.lambda_, fj.lambda_, rtol=1e-5 if hd == "bfloat16" else 1e-10)
    np.testing.assert_allclose(ft.nulldev, fj.nulldev, rtol=1e-10)
    kind = "padded_csr" if kw.get("hybrid") is False else "hybrid"
    assert ft.stats["layout"]["kind"] == kind == fj.stats["layout"]["kind"]
    if kind == "hybrid":
        assert ft.stats["layout"]["head_width"] == fj.stats["layout"]["head_width"]
        assert ft.stats["tail_kernel"] is (kw["sampling"] == "block")
    assert ft.stats["nnz"] // max(ft.npasses, 1) == fj.stats["nnz"] // max(fj.npasses, 1)
    scale = max(1.0, np.abs(fj.beta).max())
    if hd is None:
        np.testing.assert_allclose(ft.beta, fj.beta, atol=1e-3 * scale)
        np.testing.assert_allclose(ft.a0, fj.a0, atol=1e-3 * max(1.0, np.abs(fj.a0).max()))
        np.testing.assert_allclose(ft.dev_ratio, fj.dev_ratio, atol=1e-3)
        return
    sd = ts.scipy_column_stats(x)[1] if kw.get("standardize", True) else np.ones(x.shape[1])
    oj, ot = _objective(fj, x, y, sd), _objective(ft, x, y, sd)
    np.testing.assert_allclose(ot, oj, rtol=1e-3)
    if hd == "bfloat16":
        np.testing.assert_allclose(ft.beta, fj.beta, atol=2e-2 * scale)


def test_predict_and_score_on_scipy_newx():
    """A hybrid fit's coefficients come back in the original column order:
    predictions on scipy newx equal those on its dense form and the
    direct product."""
    x, y, _ = _zipf_csr()
    f = tst.fit(x, y, family="binomial", nlambda=3, batch_size=64, sampling="block", hybrid_max_head=128,
                hybrid_coverage=0.8, maxit=50, **CPU)
    a = f.predict(x[:30], type="link")
    np.testing.assert_allclose(a, f.predict(x[:30].toarray(), type="link"), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(a, np.asarray(x[:30] @ f.beta[:, 0, :].T) + f.a0[None, :], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(f.score(x, y), f.score(x.toarray(), y), rtol=1e-10)


# ---------------------------------------------------------------------------
# the kernel gates on layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head,want", [("float32", True), ("bfloat16", True), ("int8", False)])
def test_head_kernel_gate_reads_the_head(head, want):
    x, y, _ = _zipf_csr()
    kw = dict(family="binomial", nlambda=2, maxit=20, batch_size=64, sampling="block", hybrid_max_head=128,
              hybrid_coverage=0.8, dtype="float32", hybrid_head_dtype=head, **CPU)
    f = tst.fit(x, y, use_pallas=True, **kw)
    assert f.stats["head_kernel"] is want and f.stats["tail_kernel"] is True
    assert f.stats["layout"]["head_width"] == 128
    # on the CPU use_pallas defaults off, as off the TPU in the JAX package
    assert tst.fit(x, y, **kw).stats["head_kernel"] is False
    th, _ = ts.HybridCSR.split_columns(x, coverage=0.8, max_head=128, head_dtype=head, **CPU)
    cfg = tsaga.SolverConfig(batch_size=64, sampling="block", use_pallas=True)
    assert tsaga.uses_head_kernel(th, get_family("binomial"), cfg) is want
    # the gate reads the head's width, not the full column count
    assert th.shape[1] == 600 and th.n_head == 128


def test_padded_csr_never_takes_the_head_kernel():
    x, y, _ = _zipf_csr()
    f = tst.fit(x, y, family="binomial", nlambda=2, maxit=20, batch_size=64, sampling="block", hybrid=False,
                use_pallas=True, dtype="float32", **CPU)
    assert f.stats["head_kernel"] is False and f.stats["layout"]["kind"] == "padded_csr"
    assert f.stats["tail_kernel"] is False


def test_hybrid_max_head_auto_is_not_ported():
    """hybrid_max_head="auto" runs the port's planner (core/layout.py): the
    head is the plan's width, the split is the plan's alone (coverage 1.0),
    and the plan is recorded (tests/test_torch_layout.py holds it against
    the JAX package's)."""
    from sgdnet_tpu_torch.core.layout import plan_layout

    x, y, _ = _zipf_csr()
    f = tst.fit(x, y, family="binomial", hybrid_max_head="auto", nlambda=2, maxit=20, batch_size=64, **CPU)
    plan = plan_layout(x, batch_size=64, head_itemsize=4, g_sum_refresh_every=1, hbm_budget=2e9)
    assert f.stats["layout_plan"]["max_head"] == plan.max_head == f.stats["layout"]["head_width"]
    assert np.isfinite(f.beta).all()
