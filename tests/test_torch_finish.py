"""K6, the step's finish (solver/finish_kernel.py, csrc/step_finish.cu), on
the CPU.

  * the kernel's walk replayed in numpy (float64): bw by BW_THREADS
    threads, each adding rows t, t + BW_THREADS, ... in order, then a
    pairwise tree; each class's sum_gc the same over ICPT_THREADS threads;
    each element's merge, estimate, prox, box and g_sum update in the
    chain's order, the head's corr merged at D 0 and D > 0: within 1e-12
    of `finish_step_reference` at k 1 / 3 / 53, Ridge and elastic net,
    pf, box and the intercept each on and off; the thread counts are the
    .cu file's;
  * the route: K6 on CUDA f32 / f64 for Ridge and elastic net, the chain
    for CPU tensors, group lasso, a mesh, `xc`, other dtypes and
    `use_tail_kernel=False`; on the CPU an epoch runs the twin a step and
    counts no launch;
  * the move: `_make_epoch` on the CPU gives the same bits as the step as
    it stood before the finish moved into `finish_step_reference` (kept
    here verbatim), on dense, PaddedCSR and hybrid designs, through the
    plain step and K2's twin, with pf, a box, xc, no intercept and a
    one-rank mesh.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sgdnet_tpu_torch.core.sparse import BlockCOO, HybridCSR, PaddedCSR
from sgdnet_tpu_torch.families import get_family
from sgdnet_tpu_torch.penalties.penalties import ElasticNet, GroupLasso, Ridge
from sgdnet_tpu_torch.solver import finish_kernel as fk
from sgdnet_tpu_torch.solver import saga

torch.set_num_threads(1)

CU = os.path.join(os.path.dirname(__file__), os.pardir, "sgdnet_tpu_torch", "csrc", "step_finish.cu")


# ---------------------------------------------------------------------------
# the kernel's walk, replayed
# ---------------------------------------------------------------------------


def _fixed_sum(v: np.ndarray, threads: int) -> float:
    """Thread t adds v[t], v[t + threads], ... in order from 0; then
    red[t] += red[t + h] for h = threads / 2, ..., 1."""
    red = np.zeros(threads)
    for t in range(threads):
        s = 0.0
        for r in range(t, len(v), threads):
            s = s + v[r]
        red[t] = s
    h = threads // 2
    while h > 0:
        red[:h] = red[:h] + red[h : 2 * h]
        h //= 2
    return red[0]


def _replay(state, scal, wb, gc, corr, head, prox, w_total, fit_intercept, pf, box):
    """K6 on float64 numpy operands, as finish_bw and finish_columns walk them."""
    w, g = state.w.numpy(), state.g_sum.numpy()
    icpt, gsi = state.intercept.numpy(), state.g_sum_intercept.numpy()
    s = _fixed_sum(wb.numpy(), fk.BW_THREADS)
    bw = 1e-12 if s < 1e-12 else s
    inv_wt = 1.0 / w_total
    cj = corr.numpy().copy()
    if head is not None:
        D = head.shape[1]
        cj[:, :D] = cj[:, :D] + head.numpy()
    if pf is None:
        decay, thr = scal.shrink, scal.gl1
    else:
        f = pf.numpy()[None, :]
        decay, thr = 1.0 - scal.gl2 * f, scal.gl1 * f
    w_half = w * decay - scal.gamma * (cj / bw + g)
    v = w_half
    if prox == "elastic_net":
        m = np.abs(w_half) - thr
        m = np.where(m < 0.0, 0.0, m)
        v = np.sign(w_half) * m
    if box is not None:
        v = np.minimum(np.maximum(v, box[0].numpy()), box[1].numpy())
    g_new = g + cj * inv_wt
    if fit_intercept:
        sum_gc = np.array([_fixed_sum(gc.numpy()[:, c], fk.ICPT_THREADS) for c in range(gc.shape[1])])
        icpt = icpt - scal.gdecay * (sum_gc / bw + gsi)
        gsi = gsi + sum_gc * inv_wt
    return v, g_new, icpt, gsi


def _operands(k, p, D, B, seed, pf_on, box_on):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float64))  # noqa: E731
    state = saga.SagaState(w=t(rng.normal(size=(k, p))), intercept=t(rng.normal(size=k)),
                           g_mem=torch.zeros((B, k), dtype=torch.float64), g_sum=t(0.1 * rng.normal(size=(k, p))),
                           g_sum_intercept=t(0.1 * rng.normal(size=k)))
    wb = t(rng.random(B) < 0.8)
    gc = t(rng.normal(size=(B, k)))
    corr = t(5.0 * rng.normal(size=(k, p)))
    head = t(5.0 * rng.normal(size=(k, D))) if D else None
    pf = t(rng.uniform(0.0, 2.0, p)) if pf_on else None
    box = (t(-np.abs(rng.normal(size=(k, p)))), t(0.3 * np.abs(rng.normal(size=(k, p))))) if box_on else None
    return state, wb, gc, corr, head, pf, box


def test_replay_thread_counts_are_the_kernels():
    """BW_THREADS / ICPT_THREADS are the .cu file's RT / CT, which the
    replay walks with."""
    src = open(CU).read()
    assert int(re.search(r"constexpr int RT = (\d+);", src).group(1)) == fk.BW_THREADS
    assert int(re.search(r"constexpr int CT = (\d+);", src).group(1)) == fk.ICPT_THREADS


@pytest.mark.parametrize("fit_intercept", [True, False], ids=["icpt", "no-icpt"])
@pytest.mark.parametrize("box_on", [False, True], ids=["", "box"])
@pytest.mark.parametrize("pf_on", [False, True], ids=["", "pf"])
@pytest.mark.parametrize("prox", ["ridge", "elastic_net"])
@pytest.mark.parametrize("k,D", [(1, 0), (1, 16), (3, 0), (3, 24), (53, 0), (53, 8)])
def test_replay_matches_reference(k, D, prox, pf_on, box_on, fit_intercept):
    """The replayed walk against the chain (float64, 1e-12 x the largest
    magnitude): they differ only in the order of the two sums and in the
    chain's w_total reciprocal."""
    p, B = 40, 1500  # B above BW_THREADS: threads walk more than one row
    state, wb, gc, corr, head, pf, box = _operands(k, p, D, B, seed=k + D, pf_on=pf_on, box_on=box_on)
    scal = saga._scalars(0.03, 20.0, 0.2, 0.9, np.float64)
    penalty = ElasticNet() if prox == "elastic_net" else Ridge()
    w_total = 1234.0
    ref = fk.finish_step_reference(state, scal, wb, gc, corr, penalty, w_total, fit_intercept, pf=pf, box=box,
                                   corr_head=head)
    got = _replay(state, scal, wb, gc, corr, head, prox, w_total, fit_intercept, pf, box)
    for a, b in zip(got, (ref.w, ref.g_sum, ref.intercept, ref.g_sum_intercept)):
        b = b.numpy()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * max(1.0, np.abs(b).max()))
    if prox == "elastic_net":
        assert (ref.w == 0).any()  # the prox zeroes some coefficients
    assert ref.g_mem is state.g_mem
    if not fit_intercept:
        assert ref.intercept is state.intercept and ref.g_sum_intercept is state.g_sum_intercept


def test_reference_merges_the_head_out_of_place():
    """The twin adds the head's corr to a copy: the caller's corr stays."""
    state, wb, gc, corr, head, _, _ = _operands(3, 40, 24, 100, 0, False, False)
    before = corr.clone()
    scal = saga._scalars(0.03, 0.5, 0.2, 1.0, np.float64)
    merged = corr.clone()
    merged[:, :24] += head
    a = fk.finish_step_reference(state, scal, wb, gc, corr, ElasticNet(), 100.0, True, corr_head=head)
    b = fk.finish_step_reference(state, scal, wb, gc, merged, ElasticNet(), 100.0, True)
    assert torch.equal(corr, before)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

CUDA = torch.device("cuda")


@pytest.mark.parametrize("case,expect", [
    (dict(), True),
    (dict(dtype=torch.float64, penalty=Ridge()), True),
    (dict(device=torch.device("cuda", 1)), True),
    (dict(device=torch.device("cpu")), False),
    (dict(penalty=GroupLasso()), False),
    (dict(mesh=object()), False),
    (dict(xc=torch.zeros(4)), False),
    (dict(dtype=torch.bfloat16), False),
    (dict(dtype=torch.float16), False),
    (dict(use_tail_kernel=False), False),
], ids=["en-f32", "ridge-f64", "cuda1", "cpu", "group-lasso", "mesh", "xc", "bf16", "f16", "plain-ops"])
def test_route(case, expect):
    """K6 exactly where its route holds; the chain elsewhere."""
    config = saga.SolverConfig(mesh=case.get("mesh"), use_tail_kernel=case.get("use_tail_kernel", True))
    got = fk.uses_finish_kernel(case.get("device", CUDA), case.get("dtype", torch.float32),
                                case.get("penalty", ElasticNet()), config, case.get("xc"))
    assert got is expect


def test_launcher_refuses_what_it_does_not_take():
    """Binding K6 to CPU tensors, a penalty it has no prox for, or shapes
    out of range raises before any library is loaded."""
    with pytest.raises(ValueError, match="on the card"):
        fk.FinishLauncher(8, 1, 10, 0, torch.float32, "cpu", ElasticNet(), 8.0, True)
    with pytest.raises(ValueError, match="on the card"):
        fk.FinishLauncher(8, 1, 10, 0, torch.bfloat16, "cuda", ElasticNet(), 8.0, True)
    with pytest.raises(ValueError, match="Ridge or elastic-net"):
        fk.FinishLauncher(8, 1, 10, 0, torch.float32, "cuda", GroupLasso(), 8.0, True)
    with pytest.raises(ValueError, match="0 <= D <= p"):
        fk.FinishLauncher(8, 1, 10, 11, torch.float32, "cuda", ElasticNet(), 8.0, True)


def _hybrid(n=256, p=300, B=32, seed=0, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    wz = (np.arange(p) + 5.0) ** -1.1
    cols = np.searchsorted(np.cumsum(wz) / wz.sum(), rng.random((n, 9))).clip(0, p - 1)
    x = sp.csr_matrix((rng.normal(size=n * 9), cols.ravel(), np.arange(0, n * 9 + 1, 9)), shape=(n, p))
    x.sum_duplicates()
    h, _ = HybridCSR.split_columns(x, coverage=0.6, max_head=128, dtype=dtype, device="cpu")
    return dataclasses.replace(h, blk_tail=BlockCOO.from_padded(h.tail, B)), x


def test_cpu_epoch_runs_the_twin_and_counts_no_launch(monkeypatch):
    """On CPU tensors the step binds no K6 launcher: every step of an epoch
    runs `finish_step_reference`, and K6's counter does not move."""
    h, _ = _hybrid()
    n, k, B = h.n_rows, 2, 32
    calls = []
    real = fk.finish_step_reference

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(fk, "finish_step_reference", counted)
    y = torch.tensor(np.random.default_rng(1).normal(size=(n, k)))
    config = saga.SolverConfig(batch_size=B, sampling="block")
    epoch = saga._make_epoch(h, y, torch.ones(n, dtype=torch.float64), float(n), get_family("mgaussian", n_classes=k),
                             ElasticNet(), config)
    before = fk.finish_step.launches
    state = saga.init_state(n, h.n_cols, k, torch.float64, "cpu")
    for it in range(2):
        state = epoch(state, torch.randperm(n // B), 0.01, 1e-3, 0.0, it=it)
    assert len(calls) == 2 * (n // B) and fk.finish_step.launches == before
    assert saga._make_step(h, y, torch.ones(n, dtype=torch.float64), float(n), get_family("mgaussian", n_classes=k),
                           ElasticNet(), config).finish is None
    out = fk.finish_step(state, saga._scalars(0.01, 1e-3, 0.0, 1.0, np.float64), torch.ones(B, dtype=torch.float64),
                         torch.zeros((B, k), dtype=torch.float64), torch.zeros((k, h.n_cols), dtype=torch.float64),
                         ElasticNet(), float(n))
    assert len(calls) == 2 * (n // B) + 1 and fk.finish_step.launches == before and out.w.shape == state.w.shape


# ---------------------------------------------------------------------------
# the move: the step as it stood before, its finish inline
# ---------------------------------------------------------------------------


def _step_before(x, y, weights, w_total, family, penalty, config, offs=None, pf=None, box=None, xc=None):
    """solver/saga.py `_make_step` before the finish moved out (on the CPU,
    where it binds no K3 launcher), verbatim but for the launcher."""
    _rows, _set_rows, SagaState = saga._rows, saga._set_rows, saga.SagaState
    B = config.batch_size
    hybrid = isinstance(x, HybridCSR)
    kernels = config.use_tail_kernel
    mesh = config.mesh
    if mesh is not None:
        k, p = family.n_classes, x.shape[1]
        red = torch.empty((1 + k + k * p,), dtype=y.dtype, device=y.device)
        red_bw, red_gc, red_corr = red[0], red[1 : 1 + k], red[1 + k :].view(k, p)
    fwd = None

    def step_pallas(state, scal, sel):
        offs_b = None if offs is None else _rows(offs, sel, B)
        if hybrid:
            lp_extra = saga._tail_predict(x, state.w, sel, B, kernels, fwd, intercept=state.intercept, offs=offs_b)
        else:
            lp_extra = state.intercept.expand(B, family.n_classes)
            if offs_b is not None:
                lp_extra = lp_extra + offs_b
        if xc is not None:
            lp_extra = lp_extra - state.w @ xc.to(state.w.dtype)
        yb = _rows(y, sel, B)
        wb = _rows(weights, sel, B)
        g_mem_b = _rows(state.g_mem, sel, B)
        head, w_head = (x.head, state.w[:, : x.n_head]) if hybrid else (x, state.w)
        g, corr_head = saga.head_kernel.fused_head_step_at(head, sel, w_head, lp_extra, yb, g_mem_b, wb,
                                                           family.name)
        g = g.to(state.w.dtype)
        g_change = g - g_mem_b
        _set_rows(state.g_mem, sel, g, B)
        if hybrid:
            corr = saga._tail_outer(x, g_change, sel, B, kernels)
            corr[:, : x.n_head] += corr_head.to(corr.dtype)
            if xc is not None:
                corr = corr - torch.outer(torch.sum(g_change, dim=0), xc.to(corr.dtype))
        else:
            corr = corr_head.to(state.w.dtype)
        return _finish_step(state, scal, wb, g_change, corr)

    def step_xla(state, scal, sel):
        yb = _rows(y, sel, B)
        wb = _rows(weights, sel, B)
        lp = saga._linear_predictor(x, xc, state.w, state.intercept, None if offs is None else _rows(offs, sel, B),
                                    sel, B, kernels, fwd)
        g = family.gradient(lp, yb) * wb[:, None]
        g_change = g - _rows(state.g_mem, sel, B)
        _set_rows(state.g_mem, sel, g, B)
        corr = saga._batch_outer(x, xc, g_change, sel, B, config.sparse_mode, kernels)
        return _finish_step(state, scal, wb, g_change, corr)

    def _finish_step(state, scal, wb, g_change, corr):
        if mesh is None:
            bw = torch.clamp(torch.sum(wb), min=1e-12)
            sum_gc = torch.sum(g_change, dim=0)  # (k,)
        else:
            torch.sum(wb, dim=0, out=red_bw)
            torch.sum(g_change, dim=0, out=red_gc)
            red_corr.copy_(corr)
            mesh.all_reduce(red, "step")
            bw, sum_gc, corr = torch.clamp(red_bw, min=1e-12), red_gc, red_corr
        grad_est = corr / bw + state.g_sum
        if pf is None:
            w_half = state.w * scal.shrink - scal.gamma * grad_est
            w_new = penalty.prox(w_half, scal.gl1)
        else:
            w_half = state.w * (1.0 - scal.gl2 * pf) - scal.gamma * grad_est
            w_new = penalty.prox(w_half, scal.gl1 * pf)
        if box is not None:
            w_new = torch.minimum(torch.maximum(w_new, box[0]), box[1])
        g_sum = state.g_sum + corr / w_total
        if config.fit_intercept:
            grad_est_b = sum_gc / bw + state.g_sum_intercept
            intercept = state.intercept - scal.gdecay * grad_est_b
            g_sum_i = state.g_sum_intercept + sum_gc / w_total
        else:
            intercept = state.intercept
            g_sum_i = state.g_sum_intercept
        return SagaState(w_new, intercept, state.g_mem, g_sum, g_sum_i)

    return step_pallas if saga.uses_head_kernel(x, family, config) else step_xla


def _epochs_before(step, x, w_total, config, state, orders, xc):
    """`_make_epoch`'s epoch over `orders`, driving `_step_before`'s step."""
    B, dt = config.batch_size, saga.np_dtype(state.w.dtype)
    for it, order in enumerate(orders):
        scal = saga._scalars(0.02, 3e-3, 1e-3, config.intercept_decay, dt)
        state = state._replace(g_mem=state.g_mem.clone())
        if config.sampling == "block":
            sels = [int(s) * B for s in order.tolist()]
        else:
            sels = list(order.reshape(-1, B))
        for sel in sels:
            state = step(state, scal, sel)
        if config.g_sum_refresh and (it + 1) % config.g_sum_refresh_every == 0:
            state = saga._refresh_g_sum(x, w_total, state, xc, config.mesh, kernels=config.use_tail_kernel)
    return state


class _OneRank:
    """A mesh of one rank: every all-reduce leaves its buffer as it is."""

    def __init__(self):
        self.counts = {}

    def all_reduce(self, t, what):
        self.counts[what] = self.counts.get(what, 0) + 1
        return t


MOVE_CASES = {
    "dense-en": dict(layout="dense", family="gaussian", k=1, alpha=1.0),
    "dense-k2-pallas": dict(layout="dense", family="multinomial", k=3, alpha=1.0, use_pallas=True),
    "dense-ridge-no-icpt": dict(layout="dense", family="binomial", k=1, alpha=0.0, fit_intercept=False),
    "dense-pf-box": dict(layout="dense", family="gaussian", k=1, alpha=1.0, pf=True, box=True),
    "dense-mesh": dict(layout="dense", family="binomial", k=1, alpha=1.0, mesh=True),
    "csr-gather-xc": dict(layout="csr", family="gaussian", k=1, alpha=1.0, xc=True, sampling="permutation"),
    "csr-densify-group": dict(layout="csr", family="mgaussian", k=2, alpha=1.0, sparse_mode="densify"),
    "hybrid-k2": dict(layout="hybrid", family="binomial", k=1, alpha=1.0, use_pallas=True),
    "hybrid-k2-multinomial-pf": dict(layout="hybrid", family="multinomial", k=3, alpha=0.5, use_pallas=True,
                                     pf=True),
    "hybrid-k2-xc": dict(layout="hybrid", family="gaussian", k=1, alpha=1.0, use_pallas=True, xc=True),
    "hybrid-plain-box": dict(layout="hybrid", family="binomial", k=1, alpha=1.0, box=True),
    "hybrid-plain-ops-mesh": dict(layout="hybrid", family="gaussian", k=1, alpha=1.0, use_tail_kernel=False,
                                  mesh=True),
}


@pytest.mark.parametrize("name", list(MOVE_CASES))
def test_make_epoch_bits_unchanged_by_the_move(name):
    """Three epochs (a refresh every second) of `_make_epoch` against the
    step as it stood before the finish moved: every leaf of the state the
    same bits (CPU; float64, and float32 where K2's twin runs, which takes
    f32 / bf16 heads)."""
    from sgdnet_tpu_torch.penalties import select_penalty

    c = MOVE_CASES[name]
    dt = torch.float32 if c.get("use_pallas") else torch.float64
    h, xs = _hybrid(n=256, p=300, B=32, seed=len(name), dtype=dt)
    rng = np.random.default_rng(len(name))
    n, p, k, B = h.n_rows, h.n_cols, c["k"], 32
    t = lambda a: torch.tensor(np.asarray(a), dtype=dt)  # noqa: E731
    if c["layout"] == "hybrid":
        x = h
    elif c["layout"] == "csr":
        x = PaddedCSR.from_scipy(xs, dtype=dt, device="cpu")
    else:
        x = t(rng.normal(size=(n, p)))
    family = get_family(c["family"], n_classes=k)
    if c["family"] == "multinomial":
        y = t(np.eye(k)[rng.integers(0, k, n)])
    elif c["family"] == "binomial":
        y = t((rng.random((n, 1)) < 0.5).astype(float))
    else:
        y = t(rng.normal(size=(n, k)))
    weights = t(rng.uniform(0.5, 1.5, n))
    weights[-5:] = 0.0
    w_total = float(weights.sum())
    penalty = select_penalty(c["alpha"], c["family"])
    assert (type(penalty) is GroupLasso) is (name == "csr-densify-group")
    config = saga.SolverConfig(batch_size=B, sampling=c.get("sampling", "block"), use_pallas=c.get("use_pallas", False),
                               fit_intercept=c.get("fit_intercept", True), sparse_mode=c.get("sparse_mode", "gather"),
                               use_tail_kernel=c.get("use_tail_kernel", True), g_sum_refresh_every=2,
                               mesh=_OneRank() if c.get("mesh") else None)
    pf = t(rng.uniform(0.2, 2.0, p)) if c.get("pf") else None
    box = (torch.full((k, p), -0.05, dtype=dt), torch.full((k, p), 0.04, dtype=dt)) if c.get("box") else None
    xc = None
    if c.get("xc"):
        xc = t(rng.normal(size=p))
        if c["layout"] == "hybrid":
            xc[: h.n_head] = 0.0
    assert saga.uses_head_kernel(x, family, config) is c.get("use_pallas", False)
    n_orders = n // B if config.sampling == "block" else n
    orders = [torch.randperm(n_orders, generator=torch.Generator().manual_seed(e)) for e in range(3)]
    state0 = saga.init_state(n, p, k, dt, "cpu")._replace(w=t(0.01 * rng.normal(size=(k, p))))
    kw = dict(pf=pf, box=box, xc=xc)
    before = _epochs_before(_step_before(x, y, weights, w_total, family, penalty, config, **kw), x, w_total, config,
                            state0, orders, xc)
    epoch = saga._make_epoch(x, y, weights, w_total, family, penalty, config, **kw)
    state = state0
    for it, order in enumerate(orders):
        state = epoch(state, order, 0.02, 3e-3, 1e-3, it=it)
    for name_, a, b in zip(saga.SagaState._fields, state, before):
        assert torch.equal(a, b), name_
    assert float(state.w.abs().max()) > 0
