"""The port's strong-rule screening against the JAX package's.

Twins of tests/test_screening.py at the sizes of the port's CPU step (n <=
300; 6 lambdas, past lambda_max of a 7-lambda path: at lambda_max w stays
0 and the epoch count follows rounding noise, which no two summation
orders share; where the reference test screens a sparse path, to 0.3
lambda_max, which keeps its spacing of 0.66-0.76 a step, at which the
strong rule of a 4-lambda group still discards most features).  Each
screened fit of the port is held to the JAX package's unscreened fit at
the reference test's tolerance (2e-3 x scale in the coefficients), and to
the JAX package's screened fit in lockstep (the `jax_sampling` fixture of
test_torch_cv.py: the JAX batch orders, salted per lambda group, KKT round
and retry as the JAX package folds its key, and its power-iteration start
vector) within 1e-6 x scale, with the same active sets, KKT rounds and
fallbacks.  Also: `screened_path` itself in lockstep with the JAX one,
and `_column_subset` exactly equal to the JAX one on the three layouts.
"""

import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sgdnet_tpu as jst
import sgdnet_tpu_torch as tst
from helpers import random_data
from test_torch_cv import jax_sampling  # noqa: F401

torch.set_num_threads(1)

LOCKSTEP = 1e-6
STAT_KEYS = ("active_per_group", "kkt_rounds_per_group", "full_fallback_groups", "full_tail_from", "kkt_clean")


def _twin(x, y, nlambda=7, lambda_min_ratio=0.3, screen=True, **kw):
    """The JAX package's unscreened path; the port's screened fit on it
    past lambda_max, held to it at the reference test's
    tolerance (2e-3 x scale) and to the JAX package's screened fit in
    lockstep.  Returns (the port's fit, the JAX unscreened fit past
    lambda_max)."""
    full = jst.fit(x, y, nlambda=nlambda, lambda_min_ratio=lambda_min_ratio, **kw)
    lams = full.lambda_[1:]
    scr = tst.fit(x, y, lambda_path=lams, screen=screen, device="cpu", **kw)
    scale = max(1.0, np.abs(full.beta).max())
    np.testing.assert_allclose(scr.beta, full.beta[1:], atol=2e-3 * scale)
    _lockstep(scr, x, y, lambda_path=lams, screen=screen, **kw)
    return scr, SimpleNamespace(beta=full.beta[1:], a0=np.asarray(full.a0)[1:], dev_ratio=full.dev_ratio[1:],
                                return_codes=np.asarray(full.return_codes)[1:], scale=scale)


def _lockstep(scr, x, y, **kw):
    """The port's screened fit against the JAX package's on the same
    inputs: coefficients and intercepts within 1e-6 x scale, the same
    return codes and screening record (active sets, KKT rounds,
    fallbacks), and the epochs within 1% (a lambda whose last epoch's
    change sits at thresh can stop an epoch apart under another summation
    order: the sparse layouts' scatters)."""
    j = jst.fit(x, y, **kw)
    scale = max(1.0, np.abs(j.beta).max())
    np.testing.assert_allclose(scr.beta, j.beta, rtol=0, atol=LOCKSTEP * scale)
    np.testing.assert_allclose(scr.a0, np.asarray(j.a0), rtol=0, atol=LOCKSTEP * max(1.0, np.abs(j.a0).max()))
    np.testing.assert_allclose(scr.dev_ratio, j.dev_ratio, rtol=0, atol=LOCKSTEP)
    assert abs(scr.npasses - j.npasses) <= 0.01 * j.npasses
    assert (scr.return_codes == np.asarray(j.return_codes)).all()
    if "screening" in j.stats:
        for key in STAT_KEYS:
            assert scr.stats["screening"][key] == j.stats["screening"][key], key
    else:
        assert "screening" not in scr.stats
    return j


def _wide(seed, n=200, p=400, k=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p))
    beta = np.zeros(p)
    beta[:k] = rng.normal(size=k) * 2
    return x, x @ beta + 0.5 * rng.normal(size=n)


def test_screened_matches_unscreened(jax_sampling):
    """Screening is exact (KKT-checked): the full fit's coefficients."""
    x, y = _wide(0)
    scr, full = _twin(x, y, thresh=1e-6, maxit=2000, dtype=np.float64)
    np.testing.assert_allclose(scr.a0, full.a0, atol=5e-3 * full.scale)
    np.testing.assert_allclose(scr.dev_ratio, full.dev_ratio, atol=1e-3)
    assert scr.stats["screening"]["mean_active"] < 0.35 * x.shape[1]


def test_screened_binomial(jax_sampling):
    x, y = random_data(n=150, p=120, family="binomial", seed=1)
    _twin(x, y, family="binomial", thresh=1e-6, maxit=2000, dtype=np.float64)


def test_screen_rejects_unsupported():
    x, y = random_data(n=50, p=10, seed=2)
    with pytest.raises(ValueError, match="screen=True") as rt:
        tst.fit(x, y, alpha=0.0, screen=True, dtype=np.float64, device="cpu")
    with pytest.raises(ValueError, match="screen=True") as rj:
        jst.fit(x, y, alpha=0.0, screen=True, dtype=np.float64)
    assert str(rt.value) == str(rj.value)
    with pytest.raises(ValueError, match="screen=True"):
        tst.fit(x, y, screen=True, debug=True, dtype=np.float64, device="cpu")


@pytest.mark.parametrize("layout", ["csr", "hybrid"])
def test_screened_sparse_layouts(layout, jax_sampling):
    """Screening on PaddedCSR / HybridCSR designs matches the unscreened
    fit, and the active set shrinks."""
    rng = np.random.default_rng(5)
    n, p = 250, 800
    x = (rng.random((n, p)) < 0.05) * rng.normal(size=(n, p))
    beta = np.zeros(p)
    beta[:6] = rng.normal(size=6) * 3
    y = x @ beta + 0.3 * rng.normal(size=n)
    scr, full = _twin(sp.csr_matrix(x), y, thresh=1e-6, maxit=2000, dtype=np.float64, hybrid=layout == "hybrid")
    np.testing.assert_allclose(scr.a0, full.a0, atol=5e-3 * full.scale)
    assert scr.stats["screening"]["mean_active"] < 0.6 * p
    assert scr.stats["layout"]["kind"] == ("hybrid" if layout == "hybrid" else "padded_csr")


def test_screened_offset_binomial(jax_sampling):
    """Offsets under screening (they shift the full-data linear
    predictors): screened is unscreened."""
    x, y = random_data(n=180, p=150, family="binomial", seed=11)
    offs = np.random.default_rng(12).normal(size=len(y)) * 0.5
    scr, full = _twin(x, y, family="binomial", thresh=1e-6, maxit=2000, dtype=np.float64, offset=offs)
    np.testing.assert_allclose(scr.a0, full.a0, atol=5e-3 * full.scale)
    assert scr.stats["screening"]["kkt_clean"] is True


def _kkt_problem():
    """The reference test's standardized gaussian problem, as numpy."""
    rng = np.random.default_rng(13)
    n, p = 128, 60
    x = rng.normal(size=(n, p))
    beta = np.zeros(p)
    beta[:4] = [3.0, -2.0, 1.5, -1.0]
    y = x @ beta + 0.1 * rng.normal(size=n)
    xs = x.std(0)
    xs[xs == 0] = 1.0
    x_std = (x - x.mean(0)) / xs
    y_proc = ((y - y.mean()) / y.std()).reshape(-1, 1)
    lmax = float(np.abs(x_std.T @ y_proc[:, 0]).max()) / n
    l1s = np.geomspace(lmax, lmax * 1e-3, 6)
    return x_std, y_proc, l1s


def _jax_screened(x_std, y_proc, l1s, config_kw, **kw):
    """The JAX package's screened_path and inputs of the KKT problem."""
    from sgdnet_tpu.families import get_family
    from sgdnet_tpu.penalties import select_penalty
    from sgdnet_tpu.solver.saga import SolverConfig
    from sgdnet_tpu.solver.screening import screened_path
    from sgdnet_tpu.solver.stepsize import power_iteration_sq_norm, saga_step_sizes

    n = x_std.shape[0]
    xj = jnp.asarray(x_std)
    l2s = np.zeros_like(l1s)
    top_sq = power_iteration_sq_norm(xj, None) / n * 1.2
    gammas = np.asarray(saga_step_sizes(float(np.max(np.sum(x_std ** 2, axis=1))), top_sq, jnp.asarray(l2s),
                                        float(n), 32, True, 1.0))
    out = screened_path(xj, jnp.asarray(y_proc), jnp.ones((n,)), jnp.asarray(gammas), jnp.asarray(l1s),
                        jnp.asarray(l2s), 1e-7, jax.random.PRNGKey(0), get_family("gaussian"),
                        select_penalty(1.0, "gaussian"), SolverConfig(**config_kw), **kw)
    return gammas, l2s, out


def _torch_screened(x_std, y_proc, l1s, l2s, gammas, config_kw, **kw):
    from sgdnet_tpu_torch.families import get_family
    from sgdnet_tpu_torch.penalties import select_penalty
    from sgdnet_tpu_torch.solver.saga import SolverConfig
    from sgdnet_tpu_torch.solver.screening import screened_path

    n = x_std.shape[0]
    return screened_path(
        torch.tensor(x_std), torch.tensor(y_proc), torch.ones((n,), dtype=torch.float64), gammas, l1s, l2s, 1e-7,
        get_family("gaussian"), select_penalty(1.0, "gaussian"), SolverConfig(**config_kw), seed=0, **kw)


def _assert_screened_lockstep(t_out, j_out):
    w, b, dev, iters, codes, tot, stats = t_out
    jw, jb, jdev, jiters, jcodes, jtot, jstats = j_out
    scale = max(1.0, float(np.abs(np.asarray(jw)).max()))
    np.testing.assert_allclose(w, np.asarray(jw), rtol=0, atol=LOCKSTEP * scale)
    np.testing.assert_allclose(b, np.asarray(jb), rtol=0, atol=LOCKSTEP * scale)
    np.testing.assert_allclose(dev, np.asarray(jdev), rtol=LOCKSTEP)
    assert (iters == np.asarray(jiters)).all() and (codes == np.asarray(jcodes)).all() and tot == jtot
    for key in STAT_KEYS:
        assert stats[key] == jstats[key], key


def test_screening_kkt_expands_until_clean(jax_sampling):
    """The KKT loop keeps expanding past max_kkt_rounds (with a
    RuntimeWarning) instead of returning an inexact solution: screened_path
    with max_kkt_rounds=0 matches the unscreened path of the same engine,
    and the JAX package's screened_path in lockstep (every warning it
    gives, the port gives)."""
    from sgdnet_tpu_torch.families import get_family
    from sgdnet_tpu_torch.penalties import select_penalty
    from sgdnet_tpu_torch.solver.saga import SolverConfig, fit_path, init_state

    x_std, y_proc, l1s = _kkt_problem()
    n, p = x_std.shape
    cfg = dict(batch_size=32, max_iter=3000, fit_intercept=True)
    with warnings.catch_warnings(record=True) as jrec:
        warnings.simplefilter("always")
        gammas, l2s, j_out = _jax_screened(x_std, y_proc, l1s, cfg, max_kkt_rounds=0)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        t_out = _torch_screened(x_std, y_proc, l1s, l2s, gammas, cfg, max_kkt_rounds=0)
    stats = t_out[6]
    assert stats["kkt_clean"] is True
    kkt_warnings = [str(r.message) for r in rec if "KKT expansion rounds" in str(r.message)]
    if max(stats["kkt_rounds_per_group"]) > 0:
        assert kkt_warnings
    assert kkt_warnings == [str(r.message) for r in jrec if "KKT expansion rounds" in str(r.message)]
    _assert_screened_lockstep(t_out, j_out)

    # the same engine, full width, same inputs
    fam = get_family("gaussian")
    y_t = torch.tensor(y_proc)
    w_t = torch.ones((n,), dtype=torch.float64)
    state0 = init_state(n, p, 1, torch.float64)._replace(intercept=fam.null_intercept(y_t, True, w_t))
    _, _, full = fit_path(torch.tensor(x_std), y_t, w_t, gammas, l1s, l2s, 1e-7, state0, fam,
                          select_penalty(1.0, "gaussian"), SolverConfig(**cfg))
    scale = max(1.0, float(np.abs(full.w).max()))
    np.testing.assert_allclose(t_out[0], full.w, atol=2e-3 * scale)


@pytest.mark.parametrize("config_kw", [dict(sampling="permutation"), dict(sampling="block", step_backoff=False)],
                         ids=["permutation", "block"])
def test_screened_path_lockstep(config_kw, jax_sampling):
    """screened_path against the JAX one on the same standardized problem
    and step sizes, with the salted sampler replaying the JAX orders: the
    same groups, active sets, KKT rounds and epochs, and coefficients
    within 1e-6 x scale; under permutation and block sampling, with the
    default KKT rounds and small groups."""
    x_std, y_proc, l1s = _kkt_problem()
    cfg = dict(batch_size=32, max_iter=3000, fit_intercept=True, **config_kw)
    gammas, l2s, j_out = _jax_screened(x_std, y_proc, l1s, cfg, group_size=2)
    t_out = _torch_screened(x_std, y_proc, l1s, l2s, gammas, cfg, group_size=2)
    _assert_screened_lockstep(t_out, j_out)


def test_screened_penalty_factors_and_box(jax_sampling):
    """Screening honours penalty factors (pf 0 always active; thresholds
    scale per feature), box limits and exclusions."""
    rng = np.random.default_rng(6)
    n, p = 200, 300
    x = rng.normal(size=(n, p))
    beta = np.zeros(p)
    beta[:5] = [2.0, -1.5, 1.0, -0.8, 0.6]
    y = x @ beta + 0.4 * rng.normal(size=n)
    pf = np.ones(p)
    pf[0] = 0.0  # unpenalized: must always be active
    pf[5] = 4.0
    scr, _ = _twin(x, y, thresh=1e-6, maxit=2000, dtype=np.float64, penalty_factor=pf, lower_limits=-1.2,
                   upper_limits=1.2, exclude=[7])
    assert np.all(scr.beta[:, :, 7] == 0.0)
    assert np.abs(scr.beta).max() <= 1.2 + 1e-9


def test_screened_throughput_counts_work_not_coverage(jax_sampling):
    """A screened fit's nnz / nnz_per_s count the elements the solver
    streamed on its active-set subsets (work_elems = the sum over its
    fit_path calls of epochs x n_pad x K), the full design's figure kept
    as coverage_nnz."""
    x, y = _wide(0)
    scr, _ = _twin(x, y, thresh=1e-6, maxit=2000, dtype=np.float64)
    s = scr.stats
    work = s["screening"]["work_elems"]
    assert work > 0
    assert s["nnz"] == work
    assert s["nnz_per_s"] == pytest.approx(work / s["wall_time_s"], rel=1e-6)
    n_pad = -(-x.shape[0] // 32) * 32
    assert s["coverage_nnz"] == n_pad * x.shape[1] * s["epochs"]
    assert s["screening"]["mean_active"] < x.shape[1]
    assert work < s["coverage_nnz"]


def test_screening_full_fallback_dense_tail(jax_sampling):
    """Deep paths activate most features: groups past full_fallback_frac
    run on the full native layout (recorded) and stay exact."""
    rng = np.random.default_rng(3)
    n, p = 150, 200
    x = rng.normal(size=(n, p))
    y = x @ rng.normal(size=p) + 0.1 * rng.normal(size=n)  # dense truth
    scr, _ = _twin(x, y, lambda_min_ratio=1e-2, thresh=1e-6, maxit=3000, dtype=np.float64)
    assert scr.stats["screening"]["full_fallback_groups"] >= 1
    assert scr.stats["screening"]["work_elems"] > 0


def test_screen_auto_sparse_regime(jax_sampling):
    """screen='auto' on a wide sparse-regime problem stays screened (no
    full-tail switch) and matches the unscreened fit."""
    x, y = _wide(21)
    auto, _ = _twin(x, y, screen="auto", thresh=1e-6, maxit=2000, dtype=np.float64)
    assert auto.stats["screening"]["full_tail_from"] is None
    assert auto.stats["screening"]["mean_active"] < 0.35 * x.shape[1]


def test_screen_auto_dense_regime_switches_to_full_tail(jax_sampling):
    """screen='auto' on a path that densifies: the first group past the
    break-even runs the rest of the path as one full-layout fit (one
    fallback group), and the result matches unscreened."""
    rng = np.random.default_rng(22)
    n, p = 300, 60  # narrow: the active set soon becomes most of p
    x = rng.normal(size=(n, p))
    y = x @ rng.normal(size=p) + 0.2 * rng.normal(size=n)  # every feature matters
    auto, full = _twin(x, y, lambda_min_ratio=1e-4, screen="auto", thresh=1e-6, maxit=2000, dtype=np.float64)
    scr = auto.stats["screening"]
    assert scr["full_tail_from"] is not None
    assert scr["full_fallback_groups"] == 1
    assert auto.return_codes.shape == full.return_codes.shape


def test_screened_tail_kernel_stat():
    """stats["tail_kernel"] under screening says whether the BlockCOO tail
    ops ran: never on the dense column subsets, so not on a path that
    stayed screened, and on a group fitted on the full hybrid layout."""
    rng = np.random.default_rng(24)
    n, p = 256, 60
    x = sp.csr_matrix((rng.random((n, p)) < 0.5) * rng.normal(size=(n, p)))
    y = x @ rng.normal(size=p) + 0.2 * rng.normal(size=n)
    kw = dict(hybrid=True, hybrid_max_head=16, sampling="block", thresh=1e-4, maxit=300, dtype=np.float64,
              device="cpu")
    assert tst.fit(x, y, nlambda=3, lambda_min_ratio=0.5, **kw).stats["tail_kernel"] is True
    shallow = tst.fit(x, y, nlambda=3, lambda_min_ratio=0.5, screen=True, **kw)
    assert shallow.stats["screening"]["full_fallback_groups"] == 0
    assert shallow.stats["tail_kernel"] is False
    deep = tst.fit(x, y, nlambda=8, lambda_min_ratio=1e-3, screen="auto", **kw)
    assert deep.stats["screening"]["full_tail_from"] is not None
    assert deep.stats["tail_kernel"] is True


def test_screen_auto_ineligible_runs_unscreened():
    """'auto' never errors: ridge (alpha 0) and debug fits run the
    unscreened schedule, with no screening record."""
    x, y = random_data(n=60, p=12, seed=23)
    fit = tst.fit(x, y, alpha=0.0, screen="auto", nlambda=5, dtype=np.float64, device="cpu")
    assert "screening" not in fit.stats
    fit_dbg = tst.fit(x, y, screen="auto", debug=True, nlambda=5, dtype=np.float64, device="cpu")
    assert "screening" not in fit_dbg.stats
    plain = tst.fit(x, y, alpha=0.0, nlambda=5, dtype=np.float64, device="cpu")
    np.testing.assert_array_equal(fit.beta, plain.beta)


def test_screen_rejects_bad_value():
    x, y = random_data(n=50, p=10, seed=2)
    with pytest.raises(ValueError, match="screen must be") as rt:
        tst.fit(x, y, screen="always", dtype=np.float64, device="cpu")
    with pytest.raises(ValueError, match="screen must be") as rj:
        jst.fit(x, y, screen="always", dtype=np.float64)
    assert str(rt.value) == str(rj.value)


@pytest.mark.parametrize("layout", ["dense", "csr", "hybrid"])
def test_column_subset_matches(layout):
    """_column_subset against the JAX one on the same standardized layout,
    the dummy column and the sparse centering term included: exactly
    equal (f64; a hybrid int8 head with its scales, too)."""
    from sgdnet_tpu.core.sparse import HybridCSR as JHybrid, PaddedCSR as JPadded
    from sgdnet_tpu.solver.screening import _column_subset as j_subset
    from sgdnet_tpu_torch.solver.screening import _column_subset as t_subset
    from sgdnet_tpu_torch.utils.convert import layout_from_jax

    rng = np.random.default_rng(60)
    n, p = 96, 300
    x = (rng.random((n, p)) < 0.1) * rng.normal(size=(n, p))
    xc = rng.normal(size=p)
    cols = np.full(32, p)
    cols[:20] = np.sort(rng.choice(p, 20, replace=False))
    cases = []
    if layout == "dense":
        cases.append((jnp.asarray(x), torch.tensor(x), None))
    elif layout == "csr":
        jx = JPadded.from_scipy(sp.csr_matrix(x), dtype=np.float64)
        cases.append((jx, layout_from_jax(jx, device="cpu"), xc))
    else:
        for hd in (None, jnp.int8):
            jx, _ = JHybrid.split_columns(sp.csr_matrix(x), coverage=0.5, max_head=128, dtype=np.float64,
                                          head_dtype=hd)
            c = xc.copy()
            c[: jx.n_head] = 0.0
            cases.append((jx, layout_from_jax(jx, device="cpu"), c))
    for jx, tx, c in cases:
        want = np.asarray(j_subset(jx, None if c is None else jnp.asarray(c), cols, p, jnp.float64))[:, :32]
        got = t_subset(tx, None if c is None else torch.tensor(c), cols, p, torch.float64)
        assert got.shape == (n, 32) and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
