"""The many-class head path and the sparse heart loader, against the JAX package.

  * `load_heart(sparse=True)`: the same CSR matrix as the JAX package's,
    and a fit on it agrees with the fit on the dense matrix;
  * a small many-class hybrid multinomial fit (n 2048, p 600 Zipf
    columns, a bf16 head 256 wide, k 20, B 256, block sampling,
    use_pallas=True: K2's twin and K3 / K4's at 20 classes) against the
    JAX package's fit in lockstep (the same batch orders and power
    iteration start, `jax_sampling`), its Pallas head kernel in interpret
    mode;
  * slice M's label generator (`make_sparse_multiclass_labels`): seeded,
    every class drawn, a softmax model whose true coefficients lie on head
    and tail columns.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sgdnet_tpu as jst
import sgdnet_tpu_torch as tst
from sgdnet_tpu.data.datasets import load_heart as j_load_heart
from sgdnet_tpu_torch.tools.profile_sparse_slices import SLICE_C, SLICE_M, make_sparse_multiclass_labels
from test_torch_cv import jax_sampling  # noqa: F401  (a fixture)

torch.set_num_threads(1)


def test_load_heart_sparse_matches_jax():
    xt, yt = tst.load_heart(sparse=True)
    xj, yj = j_load_heart(sparse=True)
    assert sp.isspmatrix_csr(xt) and xt.shape == xj.shape == (270, 18)
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(xt, name), getattr(xj, name))
    np.testing.assert_array_equal(yt, yj)
    xd, yd = tst.load_heart()
    assert isinstance(xd, np.ndarray) and np.array_equal(xt.toarray(), xd)


def test_fit_on_sparse_heart_matches_dense():
    """The sparse heart (a PaddedCSR on the sparse path) fits the path the
    dense one does: the same lambdas, coefficients within 1e-3 x scale
    (the two layouts sum a row's products in different orders, and each
    lambda stops at thresh 1e-7)."""
    kw = dict(family="binomial", nlambda=20, thresh=1e-7, maxit=2000, seed=3, device="cpu", dtype=np.float64)
    fs = tst.fit(tst.load_heart(sparse=True)[0], tst.load_heart()[1], **kw)
    fd = tst.fit(*tst.load_heart(), **kw)
    assert fs.stats["layout"]["kind"] == "padded_csr"
    np.testing.assert_allclose(fs.lambda_, fd.lambda_, rtol=1e-10)
    scale = max(1.0, np.abs(fd.beta).max())
    np.testing.assert_allclose(fs.beta, fd.beta, atol=1e-3 * scale)
    np.testing.assert_allclose(fs.a0, fd.a0, atol=1e-3 * max(1.0, np.abs(fd.a0).max()))
    np.testing.assert_allclose(fs.dev_ratio, fd.dev_ratio, atol=1e-4)


def _many_class_problem(n=2048, p=600, per_row=12, k=20, seed=0):
    """A Zipf-column CSR (the north star's design at a small size) and k
    classes drawn by slice M's generator, its head the 256 most used
    columns."""
    rng = np.random.default_rng(seed)
    wz = (np.arange(p) + 10.0) ** -1.15
    cols = np.searchsorted(np.cumsum(wz) / wz.sum(), rng.random((n, per_row))).clip(0, p - 1)
    x = sp.csr_matrix((rng.normal(size=n * per_row), cols.ravel(), np.arange(0, n * per_row + 1, per_row)),
                      shape=(n, p))
    x.sum_duplicates()
    return x, make_sparse_multiclass_labels(x, k=k, per_class=40, head=256, seed=seed)


MANY_CLASS = dict(family="multinomial", alpha=1.0, nlambda=3, lambda_min_ratio=0.3, maxit=30, thresh=1e-4,
                  batch_size=256, sampling="block", hybrid=True, hybrid_max_head=256, hybrid_coverage=0.98,
                  hybrid_head_dtype="bfloat16", g_sum_refresh_every=4, use_pallas=True, seed=2, dtype=np.float32)


def test_many_class_hybrid_fit_matches_jax(jax_sampling):  # noqa: F811
    """Both packages walk the same batch orders through K2 (the port's
    twin, the JAX package's Pallas kernel in interpret mode) on a bf16
    head at 20 classes and K3 / K4 on the tail, in f32 (the JAX package's
    Pallas step takes an f32 state).  The f32 paths part by the lambdas'
    last bits (3e-6 relative: the JAX package computes lambda_max in f64)
    and f32 rounding, not by K2: the same fits on the plain step part by
    as much (7.0e-4 x scale in the coefficients, 4.7e-5 in the
    intercepts, 2.9e-5 in dev_ratio, with and without K2).  Bounds:
    lambdas 1e-5 relative, the same epochs, coefficients 2e-3 x scale,
    intercepts and dev_ratio 2e-4."""
    x, y = _many_class_problem()
    fj = jst.fit(x, y, **MANY_CLASS)
    ft = tst.fit(x, y, device="cpu", **MANY_CLASS)
    lay = ft.stats["layout"]
    assert (lay["kind"], lay["head_width"], lay["head_dtype"]) == ("hybrid", 256, "torch.bfloat16")
    assert lay["head_width"] == fj.stats["layout"]["head_width"]
    assert ft.stats["head_kernel"] is True and ft.stats["tail_kernel"] is True
    assert ft.beta.shape == fj.beta.shape and ft.beta.shape[1] == 20
    np.testing.assert_allclose(ft.lambda_, fj.lambda_, rtol=1e-5)
    np.testing.assert_array_equal(ft.npasses, fj.npasses)
    scale = max(1.0, np.abs(fj.beta).max())
    np.testing.assert_allclose(ft.beta, fj.beta, atol=2e-3 * scale)
    np.testing.assert_allclose(ft.a0, fj.a0, atol=2e-4 * max(1.0, np.abs(fj.a0).max()))
    np.testing.assert_allclose(ft.dev_ratio, fj.dev_ratio, atol=2e-4)
    assert ft.dev_ratio[-1] > ft.dev_ratio[0] > 0.0


def test_many_class_labels_are_seeded_and_cover_every_class():
    x, y = _many_class_problem(k=20)
    assert y.shape == (x.shape[0],) and y.dtype.kind == "i"
    counts = np.bincount(y, minlength=20)
    assert counts.min() > 0 and counts.max() < x.shape[0] // 2  # every class drawn, none dominant
    np.testing.assert_array_equal(y, _many_class_problem(k=20)[1])
    assert not np.array_equal(y, _many_class_problem(k=20, seed=1)[1])
    with pytest.raises(RuntimeError, match="drew no row"):  # more classes than rows
        make_sparse_multiclass_labels(x[:30], k=53, per_class=4, head=64)


def test_slice_m_is_slice_c_on_53_classes():
    assert {k: v for k, v in SLICE_M.items() if k != "family"} == {k: v for k, v in SLICE_C.items() if k != "family"}
    assert SLICE_M["family"] == "multinomial" and SLICE_M["hybrid_head_dtype"] == "bfloat16"
