"""K1's chunks of epochs (epoch_kernel.saga_epochs) on the CPU.

  * `epochs_reference`, the twin of the kernel's multi-epoch launch, gives
    identical bits in f64 to the per-epoch host loop of solver/saga.py
    `fit_one` (one `epoch_reference` and one statistics sync an epoch):
    a stop inside a chunk and at its boundary, a refresh cadence of 2 and
    3 across chunk boundaries, a block that ends one epoch and starts the
    next, a diverging (NaN) epoch and the all-zero case;
  * fit_path's K1 branch through the twin (use_epoch_kernel=True) in
    lockstep with the JAX package's fit_path with use_epoch_kernel=True,
    whose Pallas epoch kernel runs in interpret mode: the same
    ReferenceOrders, f32 (the JAX kernel's type) at 1e-4 x scale as
    tests/test_epoch_kernel.py, and equal epoch counts and return codes;
  * chunking is invisible: fit_path gives the same bits with one epoch a
    chunk as with growing chunks, in fewer chunks;
  * the launch plan: one shared-memory formula in solver/epoch_kernel.py
    and csrc/epoch_kernel.cu (the .cu expression evaluated here), every
    shape the gate admits planned within a CTA's shared memory, and the
    ctypes signature against the C entry point.

The kernel itself runs only on the card: tests/test_torch_cuda.py holds
it against these twins there.
"""

import os
import re

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
from sgdnet_tpu_torch.solver import epoch_kernel as ek
from sgdnet_tpu_torch.solver import saga as tsaga
from sgdnet_tpu_torch.solver.saga import SagaState
from sgdnet_tpu_torch.utils import build

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "sgdnet_tpu_torch", "csrc", "epoch_kernel.cu")


# ---------------------------------------------------------------------------
# the twin against the per-epoch host loop, f64
# ---------------------------------------------------------------------------


def _problem(family="gaussian", n=90, p=7, B=16, seed=0, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p))
    x = (x - x.mean(0)) / x.std(0)
    eta = x[:, :3] @ np.array([1.0, -0.7, 0.4])
    if family == "binomial":
        y = (rng.random((n, 1)) < 1 / (1 + np.exp(-eta[:, None]))).astype(float)
    elif family == "multinomial":
        y = np.eye(3)[np.argmax(np.stack([eta, -eta, 0.5 * eta], 1) + rng.gumbel(size=(n, 3)), axis=1)]
    else:
        y = (eta + 0.3 * rng.normal(size=n))[:, None]
    k = y.shape[1]
    n_pad = -(-n // B) * B
    pad = lambda a: torch.tensor(np.concatenate([a, np.zeros((n_pad - n,) + a.shape[1:])]), dtype=dtype)  # noqa: E731
    data = ek.pad_data(pad(x), pad(y), pad(rng.uniform(0.5, 1.5, n)), pad(0.2 * rng.normal(size=(n, k))),
                       torch.tensor(rng.uniform(0.5, 1.5, p), dtype=dtype), dtype=dtype)
    st0 = SagaState(torch.zeros((k, p), dtype=dtype), torch.zeros((k,), dtype=dtype),
                    torch.zeros((n_pad, k), dtype=dtype), torch.zeros((k, p), dtype=dtype),
                    torch.zeros((k,), dtype=dtype))
    fam = get_family(family, n_classes=k)
    fam.n_classes = k
    return data, ek.pad_state(st0, p, dtype=dtype), fam, n, n_pad // B


def _orders(T, E, seed=1, B=16):
    rng = np.random.default_rng(seed)
    return torch.tensor(np.stack([rng.permutation(T) for _ in range(E)]) * B)


def _host_loop(data, ps, orders, B, fam, pen, gamma, l1, l2, w_total, it0=0, t_conv=0.0, every=1):
    """solver/saga.py fit_one's per-epoch loop as it ran before K1 took
    chunks: one epoch_reference, one statistics sync and the rule an epoch."""
    dt = np.float64 if ps.w.dtype == torch.float64 else np.float32
    stats = None
    for e in range(orders.shape[0]):
        refresh = every > 0 and (it0 + e + 1) % every == 0
        new = ek.epoch_reference(data, ps, orders[e], B, fam, pen, gamma, l1, l2, w_total, 0.5, True, refresh)
        stats = torch.stack([
            torch.max(torch.abs(new.w - ps.w)),
            torch.max(torch.abs(new.w)),
            torch.all(torch.isfinite(new.ivec[0])).to(new.w.dtype),
        ]).tolist()
        ps = new
        max_change, max_size = dt(stats[0]), dt(stats[1])
        finite = bool(np.isfinite(max_size) and np.isfinite(max_change) and stats[2] == 1.0)
        all_zero = max_size == 0.0 and max_change == 0.0
        no_change = finite and max_size != 0.0 and max_change <= dt(t_conv) * max_size
        if all_zero or no_change or not finite:
            return ps, e + 1, stats, finite
    return ps, orders.shape[0], stats, finite


def _chunks(data, ps, orders, sizes, B, fam, pen, gamma, l1, l2, w_total, t_conv=0.0, every=1):
    """epochs_reference over consecutive chunks of `orders`, stopping as the
    host does; returns the state, the epochs run and the last stats."""
    it = 0
    for n in sizes:
        ps, stats = ek.epochs_reference(data, ps, orders[it:it + n], B, fam, pen, gamma, l1, l2, w_total, 0.5, True,
                                        it, t_conv, every)
        ran, mc, ms, fin = stats.tolist()
        it += int(ran)
        if ek.stop_rule(mc, ms, fin == 1.0, t_conv, np.float64)[0]:
            break
    return ps, it, stats


def _same_bits(a, b):
    for name, u, v in zip(ek.PadState._fields, a, b):
        as_int = torch.int64 if u.dtype == torch.float64 else torch.int32
        assert u.dtype == v.dtype and torch.equal(u.view(as_int), v.view(as_int)), name


RUN = dict(gamma=0.02, l1=0.01, l2=0.02)


@pytest.mark.parametrize("sizes", [[12], [3, 9], [5, 7], [1] * 12])
def test_epochs_reference_is_the_host_loop(sizes):
    """A stop inside a chunk (and the epochs after it never run) and at a
    chunk's boundary give the per-epoch loop's bits, epoch count and
    statistics."""
    data, ps, fam, n, T = _problem()
    pen = select_penalty(0.6, "gaussian", "ungrouped")
    orders = _orders(T, 12)
    t_conv = 0.1  # stops mid-way: after epoch 7 here
    ref, n_ref, st_ref, _ = _host_loop(data, ps, orders, 16, fam, pen, **RUN, w_total=float(n), t_conv=t_conv)
    assert 1 < n_ref < 12
    out, n_out, stats = _chunks(data, ps, orders, sizes, 16, fam, pen, **RUN, w_total=float(n), t_conv=t_conv)
    assert n_out == n_ref
    _same_bits(out, ref)
    assert stats.tolist()[1:3] == st_ref[:2]


def test_stop_at_a_chunk_boundary():
    data, ps, fam, n, T = _problem(seed=4)
    pen = select_penalty(0.6, "gaussian", "ungrouped")
    orders = _orders(T, 12, seed=5)
    t_conv = 0.1  # after epoch 6
    ref, n_ref, _, _ = _host_loop(data, ps, orders, 16, fam, pen, **RUN, w_total=float(n), t_conv=t_conv)
    # a first chunk that ends exactly at the stopping epoch, then one that never runs
    out, n_out, stats = _chunks(data, ps, orders, [n_ref, 12 - n_ref], 16, fam, pen, **RUN, w_total=float(n),
                                t_conv=t_conv)
    assert n_out == n_ref and stats[0] == n_ref
    _same_bits(out, ref)


@pytest.mark.parametrize("every", [2, 3])
@pytest.mark.parametrize("sizes", [[7], [2, 5], [4, 1, 2]])
def test_refresh_cadence_across_chunks(every, sizes):
    """The refresh lands on epochs it0 + e + 1 divisible by the cadence,
    whichever chunk holds them."""
    data, ps, fam, n, T = _problem("binomial", seed=2)
    pen = select_penalty(0.5, "binomial", "ungrouped")
    orders = _orders(T, 7, seed=3)
    ref, n_ref, _, _ = _host_loop(data, ps, orders, 16, fam, pen, **RUN, w_total=float(n), every=every)
    assert n_ref == 7
    out, n_out, _ = _chunks(data, ps, orders, sizes, 16, fam, pen, **RUN, w_total=float(n), every=every)
    assert n_out == 7
    _same_bits(out, ref)


def test_block_that_ends_an_epoch_starts_the_next():
    """Epoch e's last block is epoch e + 1's first: its g_mem from the end
    of epoch e is what epoch e + 1's first step reads."""
    data, ps, fam, n, T = _problem("multinomial", seed=6)
    pen = select_penalty(0.9, "multinomial", "grouped")
    orders = _orders(T, 4, seed=7)
    for e in range(3):
        first = orders[e + 1].tolist().index(int(orders[e, -1]))
        orders[e + 1, [0, first]] = orders[e + 1, [first, 0]]
        assert orders[e + 1, 0] == orders[e, -1]
    ref, n_ref, _, _ = _host_loop(data, ps, orders, 16, fam, pen, **RUN, w_total=float(n))
    out, stats = ek.saga_epochs(data, ps, orders, 16, fam, pen, **RUN, w_total=float(n), decay=0.5)
    assert n_ref == 4 and stats[0] == 4
    _same_bits(out, ref)


def test_diverging_epoch_stops_the_chunk():
    """A step far too large: the first epoch whose w or intercept is not
    finite ends the chunk, reads as not finite and gives rel = inf (f32,
    where the overflow comes within a few epochs; NaN at the larger step)."""
    for gamma, bad in ((40.0, np.isinf), (200.0, np.isnan)):
        data, ps, fam, n, T = _problem(seed=8, dtype=torch.float32)
        pen = select_penalty(1.0, "gaussian", "ungrouped")
        orders = _orders(T, 10, seed=9)
        ref, n_ref, st_ref, fin_ref = _host_loop(data, ps, orders, 16, fam, pen, gamma, 1e-3, 0.0, float(n))
        assert not fin_ref and n_ref < 10 and bad(st_ref[0])
        out, stats = ek.epochs_reference(data, ps, orders, 16, fam, pen, gamma, 1e-3, 0.0, float(n), 0.5)
        ran, mc, ms, fin = stats.tolist()
        assert ran == n_ref and fin == 0.0
        done, rel = ek.stop_rule(mc, ms, False, 0.0, np.float32)
        assert done and np.isinf(rel)
        _same_bits(out, ref)


def test_all_zero_stops_after_one_epoch():
    """A penalty that keeps w at zero: max |w| = max |dw| = 0 stops at once."""
    data, ps, fam, n, T = _problem(seed=10)
    pen = select_penalty(1.0, "gaussian", "ungrouped")
    orders = _orders(T, 5, seed=11)
    out, stats = ek.epochs_reference(data, ps, orders, 16, fam, pen, 0.02, 1e3, 0.0, float(n), 0.5)
    assert stats.tolist() == [1.0, 0.0, 0.0, 1.0]
    assert float(out.w.abs().max()) == 0.0
    ref, n_ref, _, _ = _host_loop(data, ps, orders, 16, fam, pen, 0.02, 1e3, 0.0, float(n))
    assert n_ref == 1
    _same_bits(out, ref)


@pytest.mark.parametrize("p, k, px, kc", [(7, 1, 8, 1), (9, 3, 12, 4), (12, 8, 12, 8)])
def test_pad_data_is_the_kernel_layout(p, k, px, kc):
    """One layout for the kernel and its twin: rows of p rounded up to 4
    columns, classes to 1, 2, 4 or 8 lanes, penalty factors to px; pads zero."""
    rng = np.random.default_rng(p + k)
    n = 24
    x, y, offs = (torch.tensor(rng.normal(size=s), dtype=torch.float32) for s in [(n, p), (n, k), (n, k)])
    pf = torch.tensor(rng.uniform(0.5, 1.5, p), dtype=torch.float32)
    data = ek.pad_data(x, y, torch.ones(n), offs, pf)
    assert data.x.shape == (n, px) and data.y.shape == (n, kc) and data.offs.shape == (n, kc)
    assert data.pf.shape == (px,) and (data.p, data.k) == (p, k)
    assert torch.equal(data.x[:, :p], x) and torch.equal(data.y[:, :k], y) and torch.equal(data.pf[:p], pf)
    assert float(data.x[:, p:].abs().sum() + data.y[:, k:].abs().sum() + data.offs[:, k:].abs().sum()
                 + data.pf[p:].abs().sum()) == 0.0
    pl = ek.plan(p, k, 8, True)
    assert (pl.px, pl.kc) == (px, kc)


def test_saga_epochs_leaves_the_callers_state():
    """A chunk returns a new state: fit_one_robust retries from the same
    warm start."""
    data, ps, fam, n, T = _problem(seed=12)
    pen = select_penalty(0.5, "gaussian", "ungrouped")
    orders = _orders(T, 3, seed=13)
    before = ek.PadState(*(t.clone() for t in ps))
    out, _ = ek.saga_epochs(data, ps, orders, 16, fam, pen, **RUN, w_total=float(n), decay=0.5)
    ref, _ = ek.epochs_reference(data, before, orders, 16, fam, pen, **RUN, w_total=float(n), decay=0.5)
    _same_bits(out, ref)
    _same_bits(ps, before)
    assert float(out.w.abs().max()) > 0.0 and all(u is not v for u, v in zip(out, ps))


# ---------------------------------------------------------------------------
# fit_path's K1 branch in lockstep with the JAX package's
# ---------------------------------------------------------------------------


class ReferenceOrders:
    """order_fn replaying the JAX path's batch orders (tests/test_torch_solver.py)."""

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


def _k1_paths(family, alpha=0.8, type_multinomial="ungrouped", B=16, nlambda=4, max_iter=150, tol=1e-4,
              with_offs=False, with_pf=False, seed=0, n=96, p=6, gmul=1.0, **cfg):
    """The same f32 problem through the JAX fit_path (Pallas epoch kernel,
    interpret mode) and the port's (the epochs twin), both with
    use_epoch_kernel=True and the same orders."""
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
    jfam = jget_family(family, smoothness=16.0) if family == "poisson" else jget_family(family)
    y_enc, _ = jfam.encode(y)
    w = np.ones(n)
    y_proc = np.asarray(jfam.preprocess(jnp.asarray(y_enc), None)[0])
    k = jfam.n_classes
    offs = (0.3 * rng.normal(size=(n, k))).astype(np.float32) if with_offs else None
    pf = np.linspace(0.2, 1.8, p).astype(np.float32) if with_pf else None
    tfam = get_family(family, n_classes=k, smoothness=getattr(jfam, "smoothness", 1.0))
    tfam.n_classes = k
    jpen, tpen = jselect_penalty(alpha, family, type_multinomial), select_penalty(alpha, family, type_multinomial)
    null = np.asarray(jfam.null_intercept(jnp.asarray(y_proc), True, jnp.asarray(w)), np.float32)
    lmax = float(np.abs(x.T @ ((y_proc - y_proc.mean(0)) * w[:, None])).max()) / w.sum()
    lams = np.geomspace(lmax * 0.5, lmax * 0.02, nlambda)
    l1s, l2s = (alpha * lams).astype(np.float32), ((1.0 - alpha) * lams).astype(np.float32)
    top = float(power_iteration_sq_norm(jnp.asarray(x))) / n
    gammas = np.asarray(saga_step_sizes(float((x**2).sum(1).max()), top, jnp.asarray(l2s), float(n), B, True,
                                        jfam.L_scaling) * gmul, np.float32)
    x32, y32, w32 = x.astype(np.float32), y_proc.astype(np.float32), w.astype(np.float32)
    tol32 = np.float32(tol)

    jcfg = jsaga.SolverConfig(batch_size=B, max_iter=max_iter, sampling="block", use_epoch_kernel=True, **cfg)
    j0 = jsaga.init_state(n, p, k, jnp.float32)._replace(intercept=jnp.asarray(null))
    jx = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    j_state, j_iter, j_res = jax.device_get(jsaga.fit_path(
        jnp.asarray(x32), jnp.asarray(y32), jnp.asarray(w32), None, jnp.asarray(gammas), jnp.asarray(l1s),
        jnp.asarray(l2s), jnp.asarray(tol32), jax.random.PRNGKey(seed), j0, jfam, jpen, jcfg,
        offs=jx(offs), pf=jx(pf),
    ))
    tcfg = tsaga.SolverConfig(batch_size=B, max_iter=max_iter, sampling="block", use_epoch_kernel=True, **cfg)
    t0 = tsaga.init_state(n, p, k, torch.float32)._replace(intercept=torch.tensor(null))
    tx = lambda a: None if a is None else torch.tensor(a)  # noqa: E731
    t_state, t_iter, t_res = tsaga.fit_path(
        torch.tensor(x32), torch.tensor(y32), torch.tensor(w32), gammas, l1s, l2s, tol32, t0, tfam, tpen, tcfg,
        offs=tx(offs), pf=tx(pf), order_fn=ReferenceOrders(seed, n // B, max_iter),
    )
    return (j_state, j_iter, j_res), (t_state, t_iter, t_res)


K1_CASES = {
    "gaussian": dict(family="gaussian"),
    "binomial_offs_pf": dict(family="binomial", with_offs=True, with_pf=True),
    "multinomial_grouped_refresh2": dict(family="multinomial", type_multinomial="grouped", g_sum_refresh_every=2,
                                         alpha=0.9),
    "poisson_refresh3": dict(family="poisson", alpha=0.5, g_sum_refresh_every=3),
    "mgaussian_ridge_no_intercept": dict(family="mgaussian", alpha=0.0, fit_intercept=False),
}


@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_fit_path_lockstep_with_jax(case):
    (_, j_iter, j_res), (_, t_iter, t_res) = _k1_paths(**K1_CASES[case])
    np.testing.assert_array_equal(t_res.n_epochs, np.asarray(j_res.n_epochs))
    np.testing.assert_array_equal(t_res.return_codes, np.asarray(j_res.return_codes))
    assert int(t_iter) == int(j_iter)
    for name in ("w", "intercept"):
        b = np.asarray(getattr(j_res, name))
        np.testing.assert_allclose(getattr(t_res, name), b, rtol=0, atol=1e-4 * max(1.0, float(np.abs(b).max())),
                                   err_msg=name)
    # K1 ran its epochs in fewer launches than epochs
    assert 0 < int(t_res.n_chunks.sum()) < int(t_iter)


def test_chunking_is_invisible(monkeypatch):
    """One epoch a chunk and the growing chunks give the same bits: the
    chunk only decides how many epochs a launch runs."""
    def run():
        return _k1_paths("binomial", with_offs=True, nlambda=3)[1]

    s_grow, it_grow, r_grow = run()
    monkeypatch.setattr(ek, "CHUNK_FIRST", 1)
    monkeypatch.setattr(ek, "CHUNK_CAP", 1)
    s_one, it_one, r_one = run()
    assert it_one == it_grow and np.array_equal(r_one.n_epochs, r_grow.n_epochs)
    for name in ("w", "intercept", "deviance", "final_change"):
        assert np.array_equal(getattr(r_one, name), getattr(r_grow, name)), name
    for u, v in zip(s_one, s_grow):
        assert torch.equal(u, v)
    assert int(r_one.n_chunks.sum()) == it_one > int(r_grow.n_chunks.sum())


def test_k1_divergence_reads_as_not_converged():
    """An inflated step through the K1 branch with no backoff: a lambda
    that diverges lands as code 1 with final_change = inf in both packages."""
    (_, _, j_res), (_, _, t_res) = _k1_paths("gaussian", alpha=1.0, nlambda=3, max_iter=60, gmul=40.0,
                                             step_backoff=False)
    np.testing.assert_array_equal(t_res.return_codes, np.asarray(j_res.return_codes))
    np.testing.assert_array_equal(np.isinf(t_res.final_change), np.isinf(np.asarray(j_res.final_change)))
    assert np.isinf(t_res.final_change).any()


def test_a_kernel_stop_the_host_rule_would_not_make_raises(monkeypatch):
    """The next chunk's orders are drawn for the epochs after a whole chunk:
    a launch that stops early where the host's rule goes on must fail, not
    shift the sampler."""
    real = ek.saga_epochs
    monkeypatch.setattr(ek, "saga_epochs", lambda data, ps, orders, *a, **kw: real(data, ps, orders[:1], *a, **kw))
    rng = np.random.default_rng(14)
    n, p, B = 64, 5, 16
    x = rng.normal(size=(n, p)).astype(np.float32)
    y = (x[:, :1] + 0.1 * rng.normal(size=(n, 1))).astype(np.float32)
    fam = get_family("gaussian")
    fam.n_classes = 1
    cfg = tsaga.SolverConfig(batch_size=B, max_iter=40, sampling="block", use_epoch_kernel=True)
    with pytest.raises(RuntimeError, match="stopped after 1 of 4 epochs"):
        tsaga.fit_path(torch.tensor(x), torch.tensor(y), torch.ones(n), [0.05], [1e-3], [1e-3], 1e-7,
                       tsaga.init_state(n, p, 1, torch.float32), fam, select_penalty(0.5, "gaussian", "ungrouped"),
                       cfg)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------


def _cu_formula():
    src = open(CSRC).read()
    m = re.search(r"/\* SMEM-FORMULA \*/(.*?)/\* END-FORMULA \*/", src, re.S)
    return " ".join(m.group(1).split())


def test_smem_formula_is_the_launchers():
    """The .cu launcher's expression, evaluated here, is the Python one."""
    expr = _cu_formula()
    names = ("KC", "B", "px", "has_offs", "stages", "groups", "rgroups", "nq")
    rng = np.random.default_rng(0)
    for _ in range(300):
        v = dict(KC=int(rng.choice([1, 2, 4, 8])), B=8 * int(rng.integers(1, 300)), px=4 * int(rng.integers(1, 900)),
                 has_offs=int(rng.integers(0, 2)), stages=int(rng.choice([0, 2, 3])),
                 groups=int(rng.integers(1, 20)), rgroups=int(rng.integers(1, 17)), nq=int(rng.integers(2, 900)))
        assert eval(expr, {}, dict(v)) == ek.smem_floats(*(v[n] for n in names))
    # and the launcher derives rgroups and nq from px as plan does
    src = open(CSRC).read()
    assert "const int nq = px / 4 + 1, rg = NWC / nq > 1 ? NWC / nq : 1;" in src


def _admitted():
    for n_pad_blocks in (1, 3, 40):
        for B in (8, 16, 32, 72, 256, 1024, 4096):
            for p in (1, 5, 9, 31, 32, 33, 100, 128, 129, 500, 1000, 2000, 3000, 3584):
                for k in (1, 2, 3, 5, 8):
                    for offs in (False, True):
                        n_pad = n_pad_blocks * B
                        if ek.supported(n_pad, p, k, B, with_offs=offs):
                            yield n_pad, p, k, B, offs


def test_every_admitted_shape_has_a_launch():
    """The gate is unchanged; every shape it admits plans within a CTA's
    shared memory, a ring only where its rows fit the registers."""
    seen = {"ring": 0, "l2": 0}
    for n_pad, p, k, B, offs in _admitted():
        pl = ek.plan(p, k, B, offs)
        seen[pl.variant] += 1
        assert pl.smem <= ek.SMEM_LIMIT
        assert pl.kc >= k and pl.kc in (1, 2, 4, 8) and pl.px >= p and pl.px % 4 == 0
        assert pl.threads % 32 == 0 and 32 <= pl.threads <= ek.THREADS and pl.threads % pl.lanes == 0
        assert pl.rows == -(-B // (pl.threads // pl.lanes))
        assert (pl.variant == "ring") == (pl.stages in (2, 3)) and (pl.variant == "l2" or pl.rows <= ek.RMAX)
    assert seen["ring"] > 0 and seen["l2"] > 0


def test_plan_at_the_paths_shapes():
    """Slice A (abalone: p 9, k 1, B 32): one warp, a row a lane, three
    stages; wider and larger shapes take more threads, lanes, column groups
    or the l2 variant."""
    assert ek.plan(9, 1, 32) == ek.Plan("ring", 1, 12, 32, 1, 1, 1, 3, ek.plan(9, 1, 32).smem)
    wide = ek.plan(200, 3, 32)
    assert wide.variant == "ring" and wide.lanes == 16 and wide.kc == 4 and wide.threads == 512
    many = ek.plan(9, 1, 256)
    assert many.threads == 256 and many.groups == 16 and many.variant == "ring"
    assert ek.plan(9, 1, 4096).variant == "l2"


def test_ctypes_signature_is_the_c_entry():
    src = open(CSRC).read()
    params = [q.strip() for q in re.search(r"int sgd_epochs\((.*?)\)\s*\{", src, re.S).group(1).split(",")]
    sig = build._SIGNATURES["sgd_epochs"][0]
    kinds = {"P": build._P, "I": build._I, "F": build._F}
    assert len(params) == len(sig)
    for q, t in zip(params, sig):
        want = "P" if "*" in q else ("F" if q.startswith("float") else "I")
        assert t is kinds[want], q


def test_profile_slice_a_on_the_cpu():
    """tools/profile_slice_a.py's run at three lambdas on the CPU: the plain
    path (no K1 launch, no chunks) and no device numbers."""
    from sgdnet_tpu_torch.tools import profile_slice_a

    out = profile_slice_a.run("cpu", reps=1, nlambda=3)
    assert out["lambdas"] == 3 and out["epochs"] > 0 and out["epoch_kernel"] is False
    assert out["k1_launches"] == 0 and out["k1_chunks"] == 0 and len(out["walls_s"]) == 1
    assert out["busy_share"] is None and out["device_s"] is None and out["host_syncs"] is None
