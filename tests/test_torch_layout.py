"""The port's hybrid-layout planner (sgdnet_tpu_torch/core/layout.py) and
fit(hybrid_max_head="auto") on the CPU.

  * `plan_layout` against `sgdnet_tpu.core.layout.plan_layout` with the
    constants passed explicitly and equal, on the Zipf matrices of
    tests/test_layout.py: head width and bytes equal, the floats within
    1e-12 relative (the same numpy arithmetic);
  * fit(hybrid_max_head="auto") against `sgdnet_tpu.fit` given the port's
    planned D and coverage 1.0, at f64 within 1e-3 x scale: the two
    packages' default constants differ on purpose (the TPU's and the
    H100's), so each is held to the split the port chose;
  * the twin of tests/test_layout.py::test_fit_auto_max_head;
  * an int8 "auto" fit equals, bit for bit, the same fit with the plan's D
    passed explicitly.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sgdnet_tpu as jst
import sgdnet_tpu_torch as tst
from sgdnet_tpu.core import layout as jlayout
from sgdnet_tpu_torch.core import layout as tlayout

torch.set_num_threads(1)


def _zipf_sparse(n=5000, p=2000, nnz_row=20, seed=0):
    """tests/test_layout.py's matrix."""
    rng = np.random.default_rng(seed)
    weights = (np.arange(p) + 10.0) ** -1.15
    cdf = np.cumsum(weights) / weights.sum()
    cols = np.searchsorted(cdf, rng.random((n, nnz_row))).clip(0, p - 1)
    rows = np.repeat(np.arange(n), nnz_row)
    vals = rng.normal(size=n * nnz_row)
    return sp.csr_matrix((vals, (rows, cols.ravel())), shape=(n, p))


@pytest.fixture(scope="module")
def zipf():
    return {0: _zipf_sparse(), 1: _zipf_sparse(n=3000, p=900, nnz_row=12, seed=1)}


@pytest.mark.parametrize("cap", [None, 256])
@pytest.mark.parametrize("budget", [2e6, 12e9])
@pytest.mark.parametrize("refresh", [1, 4, 8])
@pytest.mark.parametrize("itemsize", [1, 2, 4])
def test_plan_matches_jax(zipf, itemsize, refresh, budget, cap):
    for m, (stream, elem) in enumerate([(tlayout.STREAM_BYTES_PER_S, tlayout.ELEM_OP_S),
                                        (jlayout.STREAM_BYTES_PER_S, jlayout.ELEM_OP_S)]):
        kw = dict(batch_size=512, head_itemsize=itemsize, g_sum_refresh_every=refresh, hbm_budget=budget,
                  stream_bytes_per_s=stream, elem_op_s=elem, max_head_cap=cap)
        x = zipf[m]
        t, j = tlayout.plan_layout(x, **kw), jlayout.plan_layout(x, **kw)
        assert (t.max_head, t.head_bytes) == (j.max_head, j.head_bytes)
        for f in ("head_ms", "tail_ms", "coverage", "break_even_nnz"):
            np.testing.assert_allclose(getattr(t, f), getattr(j, f), rtol=1e-12, atol=0, err_msg=f)
    assert tlayout.TAIL_OPS_PER_ENTRY == jlayout.TAIL_OPS_PER_ENTRY == 4


def test_the_h100_constants_are_the_ports_own():
    """The port's constants are measurements on the card, not the JAX
    package's TPU ones; the planner's defaults are the JAX package's."""
    assert tlayout.STREAM_BYTES_PER_S != jlayout.STREAM_BYTES_PER_S
    assert tlayout.ELEM_OP_S != jlayout.ELEM_OP_S
    x = _zipf_sparse(n=600, p=300, nnz_row=10, seed=3)
    d = tlayout.plan_layout(x)
    e = tlayout.plan_layout(x, batch_size=8192, head_itemsize=1, g_sum_refresh_every=8, hbm_budget=12e9)
    assert d == e


def _auto_data():
    """tests/test_layout.py::test_fit_auto_max_head's data."""
    x = _zipf_sparse(n=600, p=300, nnz_row=10, seed=3)
    rng = np.random.default_rng(0)
    wt = np.zeros(300)
    wt[:4] = [1.0, -0.8, 0.5, -0.3]
    y = np.asarray(x @ wt).ravel() + 0.1 * rng.normal(size=600)
    return x, y


AUTO = dict(family="gaussian", alpha=0.5, batch_size=64, hybrid=True, thresh=1e-5, dtype=np.float64, seed=2)


def test_fit_auto_matches_jax_at_the_ports_plan():
    x, y = _auto_data()
    ft = tst.fit(x, y, nlambda=6, hybrid_max_head="auto", device="cpu", **AUTO)
    plan = tlayout.plan_layout(x, batch_size=64, head_itemsize=8, g_sum_refresh_every=1, hbm_budget=2e9)
    assert ft.stats["layout_plan"] == plan.__dict__
    assert ft.stats["layout"]["head_width"] == plan.max_head
    fj = jst.fit(x, y, lambda_path=ft.lambda_, hybrid_max_head=plan.max_head, hybrid_coverage=1.0, **AUTO)
    assert fj.stats["layout"]["head_width"] == plan.max_head
    scale = max(np.abs(fj.beta).max(), 1.0)
    np.testing.assert_allclose(ft.beta, fj.beta, atol=1e-3 * scale)
    np.testing.assert_allclose(ft.a0, fj.a0, atol=1e-3 * max(np.abs(fj.a0).max(), 1.0))


def test_fit_auto_max_head():
    """hybrid_max_head='auto' plans the split and fits correctly (the twin
    of tests/test_layout.py's test)."""
    x, y = _auto_data()
    f_auto = tst.fit(x, y, nlambda=6, hybrid_max_head="auto", device="cpu",
                     **{k: v for k, v in AUTO.items() if k != "seed"})
    f_ref = tst.fit(x, y, lambda_path=f_auto.lambda_, device="cpu",
                    **{k: v for k, v in AUTO.items() if k not in ("seed", "hybrid")}, hybrid=False)
    assert f_auto.stats["layout"]["kind"] == "hybrid" and f_ref.stats["layout"]["kind"] == "padded_csr"
    scale = max(np.abs(f_ref.beta).max(), 1.0)
    np.testing.assert_allclose(f_auto.beta, f_ref.beta, atol=2e-3 * scale)


def test_int8_auto_equals_the_explicit_plan():
    rng = np.random.default_rng(6)
    x = _zipf_sparse(n=2048, p=1500, nnz_row=16, seed=4)
    y = (rng.random(2048) < 0.4).astype(float)
    kw = dict(family="binomial", nlambda=3, lambda_min_ratio=0.2, maxit=40, batch_size=256, sampling="block",
              hybrid_head_dtype="int8", g_sum_refresh_every=8, hybrid_memory_budget=8e9, device="cpu")
    f_auto = tst.fit(x, y, hybrid_max_head="auto", **kw)
    plan = f_auto.stats["layout_plan"]
    assert plan["max_head"] == tlayout.plan_layout(x, batch_size=256, head_itemsize=1, g_sum_refresh_every=8,
                                                    hbm_budget=8e9).max_head
    assert 128 <= plan["max_head"] < 1500 and f_auto.stats["layout"]["head_width"] == plan["max_head"]
    f_explicit = tst.fit(x, y, hybrid_max_head=plan["max_head"], hybrid_coverage=1.0, **kw)
    assert f_explicit.stats["layout_plan"] is None
    for name in ("beta", "a0", "lambda_", "dev_ratio", "return_codes"):
        np.testing.assert_array_equal(getattr(f_auto, name), getattr(f_explicit, name), err_msg=name)
    assert f_auto.npasses == f_explicit.npasses


def test_auto_on_dense_input_keeps_the_default_width():
    x, y = tst.load_heart()
    f = tst.fit(x, y, family="binomial", nlambda=2, hybrid_max_head="auto", device="cpu")
    assert f.stats["layout_plan"] is None and f.stats["layout"]["kind"] == "dense"
    with pytest.raises(ValueError, match="auto"):
        tst.fit(sp.csr_matrix(x), y, family="binomial", hybrid_max_head="widest", device="cpu")
