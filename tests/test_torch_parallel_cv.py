"""The port's fold-parallel cross-validation against the JAX package's.

Twins of every CV test of tests/test_parallel.py, run with mesh=None (one
device; the fold mesh is tests/test_torch_multihost.py's): the port's
`cv_fit(parallel=True)` is held to its serial `cv_fit` at the reference
tests' own tolerances (rtol 0.05, atol 1e-3 or 2e-3; lambda_min equal),
and its fold scores to the JAX package's `parallel_fold_scores` on the
same lambda path in lockstep (the `jax_sampling` fixture of
test_torch_cv.py: the JAX fits' batch orders and power-iteration start
vector) within 1e-6 relative.  Also: the fold score against the JAX
package's `_traced_score` for every family and measure at 1e-12 in
float64, the packed tail a fold scales against the tail re-packed from the
scaled layout (bit for bit), and the raising options.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sgdnet_tpu as jst
import sgdnet_tpu_torch as tst
from helpers import random_data
from sgdnet_tpu.families import get_family as jget_family
from sgdnet_tpu.parallel.cv import _traced_score, parallel_fold_scores as j_fold_scores
from sgdnet_tpu_torch.parallel.cv import fold_score, parallel_fold_scores as t_fold_scores
from test_torch_cv import jax_sampling  # noqa: F401

torch.set_num_threads(1)

LOCKSTEP = 1e-6


def _twin(x, y, foldid, rtol=0.05, atol=2e-3, **kw):
    """Port parallel vs port serial at the reference test's tolerance, and
    the port's fold scores vs the JAX package's in lockstep."""
    cs = tst.cv_fit(x, y, foldid=foldid, device="cpu", **kw)
    cp = tst.cv_fit(x, y, foldid=foldid, device="cpu", parallel=True, **kw)
    np.testing.assert_allclose(cp.cv_raw[0], cs.cv_raw[0], rtol=rtol, atol=atol)
    assert abs(np.log(cp.lambda_min) - np.log(cs.lambda_min)) < 1e-9
    sj = j_fold_scores(x, y, foldid, len(np.unique(foldid)), 1.0, cp.lambda_[0], **kw)
    np.testing.assert_allclose(cp.cv_raw[0], sj, rtol=LOCKSTEP, atol=0)


def test_parallel_cv_matches_serial(jax_sampling):
    """Fold-parallel CV (masked fits over one design) matches the serial
    per-fold refit path."""
    x, y = random_data(n=240, p=6, seed=10)
    _twin(x, y, np.arange(240) % 4, rtol=0.05, atol=1e-3, nlambda=6, thresh=1e-5, dtype=np.float64)


def test_parallel_cv_binomial_class(jax_sampling):
    x, y = random_data(n=160, p=5, family="binomial", seed=11)
    foldid = np.arange(160) % 4
    cv = tst.cv_fit(x, y, family="binomial", foldid=foldid, nlambda=5, type_measure="class", dtype=np.float64,
                    parallel=True, device="cpu")
    assert np.isfinite(cv.cv_summary["mean"]).all()
    sj = j_fold_scores(x, y, foldid, 4, 1.0, cv.lambda_[0], family="binomial", type_measure="class",
                       dtype=np.float64)
    np.testing.assert_allclose(cv.cv_raw[0], sj, rtol=LOCKSTEP, atol=0)


def test_parallel_cv_unstandardized(jax_sampling):
    """standardize=False in the fold-parallel path."""
    x, y = random_data(n=240, p=6, seed=12)
    _twin(x, y, np.arange(240) % 4, rtol=0.05, atol=1e-3, nlambda=6, thresh=1e-5, dtype=np.float64,
          standardize=False)


@pytest.mark.parametrize("layout", ["dense", "csr", "hybrid"])
@pytest.mark.parametrize("extra", ["weights", "pf"])
def test_parallel_cv_generalized(layout, extra, jax_sampling):
    """{dense, sparse, hybrid} x {sample_weight, penalty_factor + lower
    limits}: fold-parallel matches the serial per-fold refit path."""
    rng = np.random.default_rng(40)
    n, p = 200, 8
    x, y = random_data(n=n, p=p, density=0.4, seed=41)
    kw = dict(nlambda=5, thresh=1e-5, dtype=np.float64)
    if extra == "weights":
        kw["sample_weight"] = rng.uniform(0.2, 2.0, size=n)
    else:
        pf = np.ones(p)
        pf[0] = 0.0  # unpenalized
        pf[3] = 3.0
        kw["penalty_factor"] = pf
        kw["lower_limits"] = -2.0
    xx = x
    if layout != "dense":
        xx = sp.csr_matrix(x)
        kw["hybrid"] = layout == "hybrid"
    _twin(xx, y, np.arange(n) % 4, **kw)


def test_parallel_cv_poisson(jax_sampling):
    """Poisson fold-parallel CV (the full data's smoothness bound in every
    fold)."""
    rng = np.random.default_rng(42)
    n, p = 240, 6
    x = rng.normal(size=(n, p)) * 0.4
    y = rng.poisson(np.exp(0.4 + x @ np.r_[0.6, -0.3, 0.2, 0, 0, 0])).astype(float)
    _twin(x, y, np.arange(n) % 4, family="poisson", nlambda=5, thresh=1e-5, dtype=np.float64)


def test_parallel_cv_clear_errors():
    """Options with no meaning in the fold program raise, as do unknown
    keywords, with the JAX package's messages."""
    x, y = random_data(n=120, p=5, family="binomial", seed=43)
    kw = dict(family="binomial", nfolds=3, nlambda=4, parallel=True)
    with pytest.raises(NotImplementedError, match="screen") as rt:
        tst.cv_fit(x, y, screen=True, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="screen") as rj:
        jst.cv_fit(x, y, screen=True, **kw)
    assert str(rt.value) == str(rj.value)
    with pytest.raises(TypeError):
        tst.cv_fit(x, y, not_an_option=1, device="cpu", **kw)
    foldid = np.arange(120) % 3
    for bad in (dict(debug=True), dict(warm_state=object())):
        with pytest.raises(NotImplementedError, match="debug/warm_state") as rt:
            t_fold_scores(x, y, foldid, 3, 1.0, [0.1], family="binomial", device="cpu", **bad)
        with pytest.raises(NotImplementedError, match="debug/warm_state") as rj:
            j_fold_scores(x, y, foldid, 3, 1.0, [0.1], family="binomial", **bad)
        assert str(rt.value) == str(rj.value)


def test_parallel_cv_auc(jax_sampling):
    """The masked rank-sum AUC in the fold program: against the serial
    numpy AUC (past the first path point, as the reference test compares)
    and, in lockstep, the JAX package's at every point."""
    x, y = random_data(n=240, p=6, family="binomial", seed=44)
    foldid = np.arange(240) % 4
    kw = dict(family="binomial", nlambda=6, thresh=1e-5, dtype=np.float64, type_measure="auc")
    cv_serial = tst.cv_fit(x, y, foldid=foldid, device="cpu", **kw)
    cv_par = tst.cv_fit(x, y, foldid=foldid, parallel=True, device="cpu", **kw)
    np.testing.assert_allclose(cv_par.cv_raw[0][:, 1:], cv_serial.cv_raw[0][:, 1:], atol=0.02)
    assert np.isfinite(cv_par.cv_raw[0]).all()
    assert abs(np.log(cv_par.lambda_min) - np.log(cv_serial.lambda_min)) < 1e-9
    sj = j_fold_scores(x, y, foldid, 4, 1.0, cv_par.lambda_[0], **kw)
    np.testing.assert_allclose(cv_par.cv_raw[0], sj, rtol=LOCKSTEP, atol=0)


@pytest.mark.parametrize("family", ["binomial", "gaussian"])
def test_parallel_cv_offset(family, jax_sampling):
    """Offsets: link families carry them through fit and score, identity
    links absorb them into y."""
    rng = np.random.default_rng(45)
    n = 240
    x, y = random_data(n=n, p=6, family=family, seed=46)
    offs = rng.normal(size=n) * 0.4
    _twin(x, y, np.arange(n) % 4, family=family, nlambda=5, thresh=1e-5, dtype=np.float64, offset=offs)


@pytest.mark.parametrize("head_dtype", ["bfloat16", "int8"])
def test_parallel_cv_head_dtype(head_dtype, jax_sampling):
    """Reduced-precision hybrid heads: the folds fit the design the serial
    path would (int8 quantized after each fold's standardization).  At the
    default thresh (1e-3; the reference test's 1e-5 takes a bf16 head
    ~7700 epochs a fit on the port's CPU step).  The head's products and
    its standardization round differently in XLA and in torch, so the fold
    scores meet the JAX package's at the reference test's tolerance, not in
    lockstep (measured 5.8e-3 relative at thresh 1e-5)."""
    rng = np.random.default_rng(47)
    n, p = 256, 600
    x = (rng.random((n, p)) < 0.08) * rng.normal(size=(n, p))
    beta = np.zeros(p)
    beta[:5] = rng.normal(size=5) * 2
    y = x @ beta + 0.3 * rng.normal(size=n)
    xx, foldid = sp.csr_matrix(x), np.arange(n) % 4
    kw = dict(nlambda=5, dtype=np.float64, hybrid=True, hybrid_head_dtype=head_dtype, hybrid_max_head=256)
    cv_serial = tst.cv_fit(xx, y, foldid=foldid, device="cpu", **kw)
    cv_par = tst.cv_fit(xx, y, foldid=foldid, parallel=True, device="cpu", **kw)
    np.testing.assert_allclose(cv_par.cv_raw[0], cv_serial.cv_raw[0], rtol=0.05, atol=2e-3)
    assert abs(np.log(cv_par.lambda_min) - np.log(cv_serial.lambda_min)) < 1e-9
    sj = j_fold_scores(xx, y, foldid, 4, 1.0, cv_par.lambda_[0], **kw)
    np.testing.assert_allclose(cv_par.cv_raw[0], sj, rtol=0.05, atol=2e-3)


def test_parallel_cv_block_sampling(jax_sampling):
    """sampling='block' with the one seeded row shuffle."""
    x, y = random_data(n=256, p=6, seed=48)
    _twin(x, y, np.arange(256) % 4, nlambda=5, thresh=1e-5, dtype=np.float64, sampling="block", batch_size=64)


# ---------------------------------------------------------------------------
# the fold score, the scaled tail, and what raises
# ---------------------------------------------------------------------------


MEASURES = {"gaussian": ("deviance", "mse", "mae"), "mgaussian": ("deviance", "mse", "mae"),
            "binomial": ("deviance", "mse", "mae", "class", "auc"), "poisson": ("deviance", "mse", "mae"),
            "multinomial": ("deviance", "mse", "mae", "class")}


@pytest.mark.parametrize("family", list(MEASURES))
def test_fold_score_matches_traced_score(family):
    """Every measure of every family on seeded predictors, responses and a
    held-out mask (ties in the binomial probabilities included): the port's
    fold score against the JAX package's at 1e-12 relative in float64."""
    rng = np.random.default_rng(50)
    n = 97
    k = {"multinomial": 3, "mgaussian": 2}.get(family, 1)
    lp = rng.normal(size=(n, k))
    if family == "binomial":
        lp[::7] = lp[3]  # tied probabilities
        y = (rng.random((n, 1)) < 0.4).astype(float)
    elif family == "poisson":
        y = rng.poisson(2.0, size=(n, 1)).astype(float)
    elif family == "multinomial":
        y = np.eye(k)[rng.integers(0, k, n)]
    else:
        y = rng.normal(size=(n, k))
    mask = (rng.random(n) < 0.3).astype(float)
    jfam = jget_family(family, n_classes=k) if family == "multinomial" else jget_family(family)
    for measure in MEASURES[family]:
        want = float(_traced_score(jfam, measure, jnp.asarray(lp), jnp.asarray(y), jnp.asarray(mask)))
        got = float(fold_score(family, measure, torch.tensor(lp), torch.tensor(y), torch.tensor(mask)))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, err_msg=measure)
    with pytest.raises(ValueError):
        fold_score(family, "not_a_measure", torch.tensor(lp), torch.tensor(y), torch.tensor(mask))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fold_tail_scaled_equals_repacked(dtype):
    """A fold's BlockCOO: the tail packed once and scaled by the fold's
    column scales gives, bit for bit, every view of the tail re-packed from
    the fold's scaled layout (heavy columns, empty blocks and pad entries
    included)."""
    from sgdnet_tpu_torch.core.sparse import BlockCOO, HybridCSR

    rng = np.random.default_rng(51)
    n, p, B = 200, 700, 32
    cols = (p * rng.random((n, 14)) ** 3).astype(int) % p
    x = np.zeros((n, p))
    for i in range(n):
        x[i, cols[i]] = rng.normal(size=14)
    x[:, :160] = rng.normal(size=(n, 160))  # 160 dense columns: 32 stay in the tail, heavy in every block
    h, _ = HybridCSR.split_columns(sp.csr_matrix(x), coverage=0.9, max_head=128, dtype=dtype, device="cpu")
    h = h.take_rows(torch.as_tensor(rng.permutation(n))).pad_rows(256)  # the last block is pad rows only
    packed = BlockCOO.from_padded(h.tail, B)
    assert packed.max_heavy > 0 and int(packed.counts.min()) == 0
    for fold in range(3):
        w = torch.as_tensor((np.arange(256) % 3 != fold) * (np.arange(256) < n), dtype=torch.float64)
        _, sd = h.column_stats(w)
        scaled, repacked = packed.scale_columns(sd), BlockCOO.from_padded(h.tail.scale_columns(sd), B)
        for view in ("rows", "cols", "vals", "counts", "row_ptr", "rows_by_col", "vals_by_col", "col_seg",
                     "heavy_cols"):
            a, b = getattr(scaled, view), getattr(repacked, view)
            assert a.dtype == b.dtype and torch.equal(a, b), view
        assert scaled.lanes == repacked.lanes and scaled.max_heavy == repacked.max_heavy


def test_cv_mesh_raises():
    """The fold mesh's errors, raised before any fit: a mesh asked for with
    no process group, and a `device` beside the mesh that is not its own
    (the fold mesh's scores are tests/test_torch_multihost.py's)."""
    import torch.distributed as dist

    from sgdnet_tpu_torch.parallel.dist import make_mesh
    from sgdnet_tpu_torch.parallel.multihost import free_port, init_multihost

    x, y = random_data(n=60, p=3, seed=52)
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        make_mesh(axis="folds", device="cpu")
    init_multihost(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        mesh = make_mesh(axis="folds", device="cpu")
        with pytest.raises(ValueError, match="not the mesh's device"):
            tst.cv_fit(x, y, nfolds=3, parallel=True, cv_mesh=mesh, device="meta")
        with pytest.raises(ValueError, match="not the mesh's device"):
            t_fold_scores(x, y, np.arange(60) % 3, 3, 1.0, [0.1], mesh=mesh, device="meta")
    finally:
        dist.destroy_process_group()
