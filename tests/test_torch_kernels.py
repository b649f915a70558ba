"""The port's kernel twins against the JAX package's Pallas kernels.

On the CPU the port's wrappers run the plain torch twin of each Hopper
kernel; here each twin is held against the Pallas kernel it replaces, run
in interpret mode as the JAX package's own tests run it:

  * K2 (head_kernel.fused_head_step_reference) vs
    pallas_kernels.fused_head_step_at(interpret=True) at the
    tests/test_pallas.py cases, with its bounds (f32: g atol 1e-5, corr
    atol 2e-3; bf16: g atol 3e-2, corr atol 2e-2 * max|corr|);
  * K1 (epoch_kernel.saga_epoch's twin) vs epoch_kernel.build(interpret=
    True) for one f32 epoch from the same state and block starts, across
    5 families x 3 penalties with offsets / penalty factors / refresh on
    and off, at 1e-5 relative;
  * the Hopper gates.

The kernels themselves run only on the card: tests/test_torch_cuda.py
holds them against these twins there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdnet_tpu.families import get_family as jget_family
from sgdnet_tpu.penalties import select_penalty as jselect_penalty
from sgdnet_tpu.solver import epoch_kernel as jek
from sgdnet_tpu.solver.pallas_kernels import fused_head_step_at as j_head_step
from sgdnet_tpu.solver.saga import SagaState as JState
from sgdnet_tpu.solver.saga import SolverConfig as JConfig
from sgdnet_tpu_torch.families import get_family
from sgdnet_tpu_torch.penalties import select_penalty
from sgdnet_tpu_torch.solver import epoch_kernel as ek
from sgdnet_tpu_torch.solver import head_kernel as hk
from sgdnet_tpu_torch.solver.saga import SagaState, SolverConfig, uses_head_kernel

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# K2: fused head step
# ---------------------------------------------------------------------------


def _head_case(family, k, seed, n_pad=256, B=128, D=256):
    rng = np.random.default_rng(seed)
    head = rng.normal(size=(n_pad, D)).astype(np.float32)
    # w scaled so |lp| = O(1) as on a fitted path: at the unscaled |lp| ~ 16
    # of tests/test_pallas.py, torch's and XLA's f32 summation orders alone
    # differ by ~1e-5 in g
    w = (rng.normal(size=(k, D)) / np.sqrt(D)).astype(np.float32)
    lpe = rng.normal(size=(B, k)).astype(np.float32)
    if family == "binomial":
        y = (rng.random((n_pad, k)) < 0.5).astype(np.float32)
    elif family == "multinomial":
        y = np.eye(k, dtype=np.float32)[rng.integers(0, k, n_pad)]
    else:
        y = rng.normal(size=(n_pad, k)).astype(np.float32)
    gm = rng.normal(size=(n_pad, k)).astype(np.float32)
    wb = (rng.random(B) < 0.9).astype(np.float32)
    return head, w, lpe, y, gm, wb


@pytest.mark.parametrize("kp_lanes", [8, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("start", [0, 128])
@pytest.mark.parametrize("family,k", [("gaussian", 1), ("binomial", 1), ("multinomial", 3), ("mgaussian", 2)])
def test_head_twin_matches_pallas(family, k, start, dtype, kp_lanes):
    B = 128
    head, w, lpe, y, gm, wb = _head_case(family, k, seed=k)
    yb, gmb = y[start:start + B], gm[start:start + B]
    jhead = jnp.asarray(head).astype(getattr(jnp, dtype))
    g_j, corr_j = j_head_step(jhead, jnp.int32(start), jnp.asarray(w), jnp.asarray(lpe), jnp.asarray(yb),
                              jnp.asarray(gmb), jnp.asarray(wb), B, family, interpret=True, kp_lanes=kp_lanes)
    thead = torch.tensor(head).to(getattr(torch, dtype))
    g_t, corr_t = hk.fused_head_step_at(thead, start, torch.tensor(w), torch.tensor(lpe), torch.tensor(yb),
                                        torch.tensor(gmb), torch.tensor(wb), family)
    assert g_t.dtype == torch.float32 and corr_t.shape == (k, head.shape[1])
    g_j, corr_j = np.asarray(g_j), np.asarray(corr_j)
    if dtype == "float32":
        np.testing.assert_allclose(g_t.numpy(), g_j, atol=1e-5)
        np.testing.assert_allclose(corr_t.numpy(), corr_j, atol=2e-3)
    else:
        np.testing.assert_allclose(g_t.numpy(), g_j, atol=3e-2)
        np.testing.assert_allclose(corr_t.numpy(), corr_j, atol=2e-2 * max(np.abs(corr_j).max(), 1.0))


def test_head_wrapper_on_cpu_is_the_twin():
    head, w, lpe, y, gm, wb = (torch.tensor(a) for a in _head_case("multinomial", 3, seed=9))
    before = hk.fused_head_step_at.launches
    a = hk.fused_head_step_at(head, 128, w, lpe, y[128:], gm[128:], wb, "multinomial")
    b = hk.fused_head_step_reference(head, 128, w, lpe, y[128:], gm[128:], wb, "multinomial")
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert hk.fused_head_step_at.launches == before  # the twin never counts as a launch


# ---------------------------------------------------------------------------
# K1: whole-epoch kernel
# ---------------------------------------------------------------------------

FAMILIES = ["gaussian", "binomial", "poisson", "multinomial", "mgaussian"]
PENALTIES = [(0.0, "ungrouped"), (0.7, "ungrouped"), (0.7, "grouped")]  # ridge, elastic net, group lasso


def _epoch_problem(family, seed, n=60, p=7, B=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p))
    x = (x - x.mean(0)) / x.std(0)
    if family == "gaussian":
        y = rng.normal(size=(n, 1))
    elif family == "binomial":
        y = (rng.random((n, 1)) < 0.4).astype(float)
    elif family == "poisson":
        y = rng.poisson(1.5, size=(n, 1)).astype(float)
    elif family == "multinomial":
        y = np.eye(3)[rng.integers(0, 3, n)]
    else:
        y = rng.normal(size=(n, 2))
    k = y.shape[1]
    n_pad = -(-n // B) * B
    pad = lambda a: np.concatenate([a, np.zeros((n_pad - n,) + a.shape[1:])]).astype(np.float32)  # noqa: E731
    weights = pad(rng.uniform(0.5, 1.5, n))
    state = dict(
        w=0.2 * rng.normal(size=(k, p)), intercept=0.1 * rng.normal(size=k),
        g_mem=pad(0.1 * rng.normal(size=(n, k))), g_sum=0.05 * rng.normal(size=(k, p)),
        g_sum_intercept=0.05 * rng.normal(size=k),
    )
    state = {f: np.asarray(v, np.float32) for f, v in state.items()}
    offs = pad(0.3 * rng.normal(size=(n, k)))
    pf = rng.uniform(0.0, 2.0, p).astype(np.float32)
    return pad(x), pad(y), weights, state, offs, pf


@pytest.mark.parametrize("pen", range(len(PENALTIES)))
@pytest.mark.parametrize("family", FAMILIES)
def test_epoch_twin_matches_pallas(family, pen):
    alpha, tm = PENALTIES[pen]
    case = FAMILIES.index(family) * 3 + pen
    # options rotate over the 15 cases: offsets, penalty factors, in-kernel
    # refresh on/off, intercept on/off
    with_offs, with_pf = case % 3 == 1, case % 3 == 2
    refresh_every = 1 if case % 2 == 0 else 2
    fit_intercept = case % 4 != 3
    B = 16
    x, y, weights, state, offs, pf = _epoch_problem(family, seed=case)
    n_pad, p = x.shape
    k = y.shape[1]
    smooth = {"smoothness": 4.0} if family == "poisson" else {}
    jfam, tfam = jget_family(family, **smooth), get_family(family, **smooth)
    jfam.n_classes = tfam.n_classes = k
    jpen, tpen = jselect_penalty(alpha, family, tm), select_penalty(alpha, family, tm)
    assert jpen.name == tpen.name
    gamma, l1, l2, w_total = 0.05, 0.02, 0.03, float(weights.sum())
    jcfg = JConfig(batch_size=B, fit_intercept=fit_intercept, intercept_decay=0.5,
                   g_sum_refresh_every=refresh_every, use_epoch_kernel=True, sampling="block")
    tcfg = SolverConfig(batch_size=B, fit_intercept=fit_intercept, intercept_decay=0.5,
                        g_sum_refresh_every=refresh_every, use_epoch_kernel=True, sampling="block")
    key = jax.random.PRNGKey(case)
    order = np.asarray(jax.random.permutation(key, n_pad // B))  # the JAX epoch's block order

    jx = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    epoch_j = jek.build(jx(x), jx(y), jx(weights), jnp.float32(w_total), jfam, jpen, jcfg, interpret=True,
                        offs=jx(offs) if with_offs else None, pf=jx(pf) if with_pf else None)
    ps_j = jek.pad_state(JState(**{f: jnp.asarray(v) for f, v in state.items()}), p)
    out_j = epoch_j(ps_j, key, jnp.float32(gamma), jnp.float32(l1), jnp.float32(l2), it=0)

    tt = lambda a: None if a is None else torch.tensor(a)  # noqa: E731
    epoch_t = ek.build_epoch(tt(x), tt(y), tt(weights), w_total, tfam, tpen, tcfg,
                             offs=tt(offs) if with_offs else None, pf=tt(pf) if with_pf else None)
    ps_t = ek.pad_state(SagaState(**{f: torch.tensor(v) for f, v in state.items()}), p)
    out_t = epoch_t(ps_t, torch.tensor(order), gamma, l1, l2, it=0)

    for name, a, b in zip(ek.PadState._fields, out_t, out_j):
        b = np.asarray(b)
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5 * scale, err_msg=name)
    # pad lanes stay exactly zero
    assert float(out_t.w[k:].abs().max() if k < ek.KP else 0.0) == 0.0
    assert float(out_t.w[:, p:].abs().max()) == 0.0
    assert float(out_t.g_mem[:, k:].abs().max() if k < ek.KP else 0.0) == 0.0
    # and the epoch is functional: the input state is untouched
    assert torch.equal(ps_t.w, ek.pad_state(SagaState(**{f: torch.tensor(v) for f, v in state.items()}), p).w)


def test_pad_state_roundtrip():
    rng = np.random.default_rng(0)
    st = SagaState(*(torch.tensor(rng.normal(size=s)) for s in [(3, 5), (3,), (32, 3), (3, 5), (3,)]))
    ps = ek.pad_state(st, 5)
    assert ps.w.shape == (ek.KP, 128) and ps.g_mem.shape == (32, ek.KP) and ps.ivec.shape == (2, ek.KP)
    back = ek.unpad_state(ps, 3, 5)
    for a, b in zip(back, st):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args,ok", [
    ((4192, 9, 1, 32, torch.float64), False),  # f32 only
    ((4192, 9, 9, 32), False),  # k > 8
    ((4190, 9, 1, 10), False),  # B not 8-aligned
    ((4192, 9, 1, 48), False),  # B does not tile n_pad
    ((3_000_000, 512, 1, 8192), False),  # beyond the L2 budget
    ((65536, 784, 10, 4096), False),  # the dense multinomial shape: K2's, not K1's
    ((1024, 3600, 1, 8), False),  # the (KP, P) state exceeds shared memory
    ((4192, 9, 1, 32), True),
    ((4192, 9, 8, 32), True),
])
def test_epoch_gate(args, ok):
    assert ek.supported(*args) is ok


def test_epoch_gate_counts_offsets():
    n_pad, p = 26112, 384  # just inside the L2 budget without offsets
    assert ek.supported(n_pad, p, 1, 32)
    assert not ek.supported(n_pad, p, 1, 32, with_offs=True)


@pytest.mark.parametrize("args,ok", [
    ((4096, 784, 10, torch.float32, "multinomial"), True),
    ((4096, 784, 10, torch.bfloat16, "mgaussian"), True),
    ((128, 256, 1, torch.float32, "binomial"), True),
    ((128, 256, 1, torch.float32, "poisson"), False),  # no poisson gradient in K2
    ((128, 256, 1, torch.float64, "gaussian"), False),
    ((128, 256, 129, torch.float32, "multinomial"), False),
    ((100, 256, 1, torch.float32, "gaussian"), False),  # B not 8-aligned
])
def test_head_gate(args, ok):
    assert hk.supported(*args) is ok


def test_head_gate_in_the_step():
    x = torch.zeros((256, 16))
    block = SolverConfig(batch_size=64, use_pallas=True, sampling="block")
    assert uses_head_kernel(x, get_family("binomial"), block)
    # a poisson fit never selects K2 (the JAX gate would let it through and
    # fail at trace time)
    assert not uses_head_kernel(x, get_family("poisson"), block)
    assert not uses_head_kernel(x, get_family("binomial"), SolverConfig(batch_size=64, use_pallas=True))
    assert not uses_head_kernel(x.double(), get_family("binomial"), block)
