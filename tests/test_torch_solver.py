"""The port's fit_path in lockstep with the JAX package's fit_path.

Both solvers get the same float64 problem (made with numpy from a seed),
the same step sizes, and the same batch orders: the port's pluggable
`order_fn` replays the JAX path's orders, permutation(fold_in(akey,
epoch), n) with akey = fold_in(key, lambda) on attempt 0 and
fold_in(that, attempt) on a step-backoff retry (sgdnet_tpu/solver/saga.py
fit_one / fit_one_robust / scan_body).  With identical orders the two
trajectories differ only by summation order, so coefficients, intercepts
and deviances agree at 1e-8 x scale, and epoch counts, return codes and
the total epoch count exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdnet_tpu.families import get_family as jget_family
from sgdnet_tpu.penalties import select_penalty as jselect_penalty
from sgdnet_tpu.solver import saga as jsaga
from sgdnet_tpu.solver.stepsize import power_iteration_sq_norm, saga_step_sizes
from sgdnet_tpu_torch.families import get_family
from sgdnet_tpu_torch.penalties import select_penalty
from sgdnet_tpu_torch.solver import saga as tsaga

torch.set_num_threads(1)


class ReferenceOrders:
    """order_fn replaying the JAX path's batch orders."""

    def __init__(self, seed: int, n: int, max_iter: int):
        self.key = jax.random.PRNGKey(seed)
        self.cache = {}
        self._perms = jax.jit(lambda akey: jax.vmap(
            lambda e: jax.random.permutation(jax.random.fold_in(akey, e), n))(jnp.arange(max_iter)))

    def __call__(self, lam_idx, attempt, epoch):
        if (lam_idx, attempt) not in self.cache:
            lam_key = jax.random.fold_in(self.key, lam_idx)
            akey = lam_key if attempt == 0 else jax.random.fold_in(lam_key, attempt)
            self.cache[(lam_idx, attempt)] = np.asarray(self._perms(akey))
        return torch.tensor(self.cache[(lam_idx, attempt)][epoch])


def _problem(family, seed, n=96, p=6, weighted=False, with_offs=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p)) @ rng.normal(size=(p, p)) * 0.5 + rng.normal(size=(n, p))
    x = (x - x.mean(0)) / x.std(0)
    eta = x[:, :3] @ np.array([1.0, -0.8, 0.5])
    if family == "gaussian":
        y = eta + 0.3 * rng.normal(size=n)
    elif family == "binomial":
        y = (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(float)
    elif family == "poisson":
        y = rng.poisson(np.exp(0.3 + 0.4 * eta)).astype(float)
    elif family == "multinomial":
        y = np.argmax(np.stack([eta, -eta, 0.5 * eta], 1) + rng.gumbel(size=(n, 3)), axis=1)
    else:
        y = np.stack([eta, -0.5 * eta], 1) + 0.3 * rng.normal(size=(n, 2))
    fam = jget_family(family, smoothness=16.0) if family == "poisson" else jget_family(family)
    y_enc, _ = fam.encode(y)
    w = rng.uniform(0.3, 2.0, n) if weighted else np.ones(n)
    y_proc, _, _ = fam.preprocess(jnp.asarray(y_enc), jnp.asarray(w) if weighted else None)
    offs = 0.3 * rng.normal(size=(n, fam.n_classes)) if with_offs else None
    return x, np.asarray(y_proc), w, offs, fam


def _lockstep(family, alpha=0.8, type_multinomial="ungrouped", sampling="permutation", B=16, nlambda=5,
              max_iter=200, tol=1e-4, weighted=False, with_offs=False, with_pf=False, with_box=False,
              gmul=1.0, seed=0, problem=None, **cfg):
    if problem is None:
        x, y, w, offs, jfam = _problem(family, seed, weighted=weighted, with_offs=with_offs)
    else:
        x, y, w, offs, jfam = problem
    n, p = x.shape
    k = jfam.n_classes
    tfam = get_family(family, n_classes=k, smoothness=getattr(jfam, "smoothness", 1.0))
    tfam.n_classes = k
    jpen, tpen = jselect_penalty(alpha, family, type_multinomial), select_penalty(alpha, family, type_multinomial)
    pf = np.linspace(0.2, 1.8, p) if with_pf else None
    box = (np.full((k, p), -0.3), np.full((k, p), 0.4)) if with_box else None

    null = np.asarray(jfam.null_intercept(jnp.asarray(y), True, jnp.asarray(w)))
    lmax = float(np.abs(x.T @ ((y - y.mean(0)) * w[:, None])).max()) / w.sum()
    # start below lambda_max: at lambda_max w ~ 0 and the relative-change
    # test compares rounding noise, which no two summation orders share
    lams = np.geomspace(lmax * 0.5, lmax * 0.02, nlambda)
    l1s, l2s = alpha * lams, (1.0 - alpha) * lams
    top = float(power_iteration_sq_norm(jnp.asarray(x))) / n
    gammas = np.asarray(saga_step_sizes(float((x**2).sum(1).max()), top, jnp.asarray(l2s), float(n), B, True,
                                        jfam.L_scaling)) * gmul

    jcfg = jsaga.SolverConfig(batch_size=B, max_iter=max_iter, sampling=sampling, **cfg)
    tcfg = tsaga.SolverConfig(batch_size=B, max_iter=max_iter, sampling=sampling, **cfg)
    j0 = jsaga.init_state(n, p, k, jnp.float64)._replace(intercept=jnp.asarray(null))
    jx = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    j_state, j_iter, j_res = jax.device_get(jsaga.fit_path(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), None, jnp.asarray(gammas), jnp.asarray(l1s),
        jnp.asarray(l2s), jnp.asarray(tol), jax.random.PRNGKey(seed), j0, jfam, jpen, jcfg,
        offs=jx(offs), pf=jx(pf), box=None if box is None else (jx(box[0]), jx(box[1])),
    ))
    t0 = tsaga.init_state(n, p, k, torch.float64)._replace(intercept=torch.tensor(null))
    tx = lambda a: None if a is None else torch.tensor(a)  # noqa: E731
    n_orders = n // B if sampling == "block" else n
    t_state, t_iter, t_res = tsaga.fit_path(
        torch.tensor(x), torch.tensor(y), torch.tensor(w), gammas, l1s, l2s, tol, t0, tfam, tpen, tcfg,
        offs=tx(offs), pf=tx(pf), box=None if box is None else (tx(box[0]), tx(box[1])),
        order_fn=ReferenceOrders(seed, n_orders, max_iter),
    )
    return (j_state, j_iter, j_res), (t_state, t_iter, t_res)


def _assert_lockstep(jout, tout, check_w=None):
    (j_state, j_iter, j_res), (t_state, t_iter, t_res) = jout, tout
    np.testing.assert_array_equal(t_res.return_codes, np.asarray(j_res.return_codes))
    np.testing.assert_array_equal(t_res.n_epochs, np.asarray(j_res.n_epochs))
    assert int(t_iter) == int(j_iter)
    sel = slice(None) if check_w is None else check_w
    for name in ("w", "intercept"):
        a, b = getattr(t_res, name)[sel], np.asarray(getattr(j_res, name))[sel]
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8 * max(1.0, float(np.abs(b).max())), err_msg=name)
    b = np.asarray(j_res.deviance)[sel]
    np.testing.assert_allclose(t_res.deviance[sel], b, rtol=1e-8, atol=1e-8 * max(1.0, float(np.abs(b).max())))
    np.testing.assert_allclose(t_res.clamp_gap[sel], np.asarray(j_res.clamp_gap)[sel], rtol=0,
                               atol=1e-8 * max(1.0, float(np.abs(b).max())))
    np.testing.assert_allclose(t_res.final_change[sel], np.asarray(j_res.final_change)[sel], rtol=1e-6,
                               atol=1e-12)
    if check_w is None:
        for name in jsaga.SagaState._fields:
            b = np.asarray(getattr(j_state, name))
            np.testing.assert_allclose(getattr(t_state, name).numpy(), b, rtol=0,
                                       atol=1e-8 * max(1.0, float(np.abs(b).max())), err_msg=name)


CASES = {
    "gaussian_permutation": dict(family="gaussian"),
    "gaussian_no_backoff_debug": dict(family="gaussian", step_backoff=False, debug=True, alpha=1.0),
    "binomial_block_offs_pf_box": dict(family="binomial", sampling="block", with_offs=True, with_pf=True,
                                       with_box=True),
    "multinomial_grouped_weights_refresh2": dict(family="multinomial", type_multinomial="grouped",
                                                 weighted=True, g_sum_refresh_every=2, intercept_decay=0.5),
    "poisson_block_offs": dict(family="poisson", sampling="block", with_offs=True, alpha=0.5),
    "mgaussian_ridge_no_intercept": dict(family="mgaussian", sampling="block", alpha=0.0, fit_intercept=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fit_path_lockstep(case):
    jout, tout = _lockstep(**CASES[case])
    _assert_lockstep(jout, tout)
    if CASES[case].get("debug"):
        np.testing.assert_allclose(tout[2].losses, np.asarray(jout[2].losses), rtol=1e-8)


@pytest.fixture(scope="module")
def osc_problem():
    """The tests/test_backoff.py repro: a correlated (effectively rank-8)
    design whose inflated step oscillates or diverges mid-path."""
    rng = np.random.default_rng(3)
    n, p = 256, 120
    x = rng.normal(size=(n, 8)) @ rng.normal(size=(8, p)) + 0.05 * rng.normal(size=(n, p))
    beta = np.zeros(p)
    beta[:6] = [3, -2, 1.5, -1, 2, -1.5]
    y = x @ beta + 0.1 * rng.normal(size=n)
    x = (x - x.mean(0)) / x.std(0)
    y = ((y - y.mean()) / y.std()).reshape(-1, 1)
    return x, y, np.ones(n), None, jget_family("gaussian")


def test_step_backoff_lockstep(osc_problem):
    """Inflated step with backoff: retries at gamma/2 and gamma/4 replay
    the reference's folded attempt keys, and the kept attempt matches."""
    jout, tout = _lockstep("gaussian", alpha=1.0, B=32, nlambda=6, max_iter=120, gmul=16.0,
                           problem=osc_problem)
    _assert_lockstep(jout, tout)
    t_res = tout[2]
    assert int(tout[1]) > int(t_res.n_epochs.sum()), "no retry happened: the repro lost its oscillation"


def test_divergence_guard_lockstep(osc_problem):
    """No backoff: a diverging lambda lands as code 1 with final_change =
    inf in both packages, never as converged."""
    jout, tout = _lockstep("gaussian", alpha=1.0, B=32, nlambda=6, max_iter=120, gmul=16.0,
                           problem=osc_problem, step_backoff=False)
    t_res, j_res = tout[2], jout[2]
    codes = np.asarray(j_res.return_codes)
    np.testing.assert_array_equal(t_res.return_codes, codes)
    np.testing.assert_array_equal(np.isinf(t_res.final_change), np.isinf(np.asarray(j_res.final_change)))
    assert (codes == 1).any()
    # every lambda up to the first failure is in lockstep
    first_bad = int(np.argmax(codes == 1))
    if first_bad:
        _assert_lockstep(jout, tout, check_w=slice(0, first_bad))
    ok = t_res.return_codes == 0
    assert np.isfinite(t_res.w[ok]).all()


def test_default_orders_are_keyed_not_sequential():
    """The default sampler gives an epoch the same order whatever ran
    before it (as the JAX package's folded keys do)."""
    f = tsaga.default_order_fn(7, 50)
    a = f(3, 1, 4)
    f(0, 0, 0), f(5, 2, 9)
    assert torch.equal(a, f(3, 1, 4))
    assert not torch.equal(a, f(3, 1, 5)) and not torch.equal(a, f(3, 0, 4))
    assert torch.equal(torch.sort(a).values, torch.arange(50))
