"""K1: the whole-SAGA-epoch kernel (twin of sgdnet_tpu/solver/epoch_kernel.py).

Small dense fits are latency-bound: every epoch is T = n_pad / B strictly
sequential batched steps, and a step is a dozen tiny ops.  On the card one
launch of csrc/epoch_kernel.cu runs a lambda attempt's epochs: each step
from operands already in shared memory (a ring of prefetched blocks), the
exact g_sum refresh at the epochs the cadence names, and the convergence
test of solver/saga.py `fit_one` after each epoch, stopping where the host
would stop.  `plan` sizes the launch (threads, lanes a row, column groups,
ring stages) and its shared memory from one formula that the .cu launcher
shares.

Semantics are those of the plain step path (solver/saga.py step_xla /
_finish_step with block sampling): same batch sequence, same update
order, same epoch-end refresh.  State rides in the padded layout of the
JAX kernel (classes padded to KP = 8 lanes, features to a 128 multiple)
across the whole lambda path; pad lanes stay exactly zero, so the
convergence check over the padded tile equals the check over the real one.
The data (EpochData) is padded only to the kernel's own, narrower layout:
rows of p rounded up to 4 columns, classes to 1, 2, 4 or 8 lanes.

`saga_epochs` launches the kernel for CUDA tensors and runs
`epochs_reference`, the plain torch version (a loop of `epoch_reference`
under the same stopping rule), for CPU tensors; `saga_epoch` is a chunk of
one epoch.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from sgdnet_tpu_torch.utils import build

#: class-lane padding: k classes ride the first k of KP lanes
KP = 8
#: shared memory one Hopper CTA may use (227 KB)
SMEM_LIMIT = 232448
#: resident bytes of x, y, weights, g_mem (and offsets) the gate admits:
#: sized to stay inside the H100's 50 MB L2 with room for the state
L2_BUDGET = 40 * 1024 * 1024
#: the size formula of the admission gate (the earlier CTA: 16 warps, the
#: (KP, P) state, one batch of gc)
_GATE_WARPS = 16
#: threads of the epoch CTA, and the rows a row slot of the ring variant
#: keeps in registers (csrc/epoch_kernel.cu NTC, RMAX)
THREADS = 512
RMAX = 4
#: first and largest chunk of epochs a launch runs (fit_path)
CHUNK_FIRST, CHUNK_CAP = 4, 64

_FAMILY_CODE = {"gaussian": 0, "binomial": 1, "poisson": 2, "multinomial": 3, "mgaussian": 4}
_PENALTY_CODE = {"ridge": 0, "elastic_net": 1, "group_lasso": 2}


def _ceil_mult(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def _pow2_at_least(v: int) -> int:
    return 1 << max(v - 1, 0).bit_length()


def smem_bytes(P: int, B: int) -> int:
    """Shared memory of the earlier epoch CTA: the gate's size formula, kept so
    the admitted set does not change."""
    return 4 * (2 * KP * P + B * KP + _GATE_WARPS * (KP + 1) + 2 * KP + KP + 1)


def supported(n_pad: int, p: int, k: int, B: int, dtype=torch.float32, with_offs: bool = False) -> bool:
    """Shapes and types the Hopper epoch kernel takes: f32, at most 8
    classes, 8-aligned batches that tile n_pad, the (KP, P) state plus one
    batch of gc in one CTA's shared memory, and the dataset within the L2
    budget."""
    if dtype != torch.float32:
        return False
    if k > KP or B % 8 != 0 or B < 8 or n_pad % B != 0:
        return False
    P = _ceil_mult(max(p, 1), 128)
    if smem_bytes(P, B) > SMEM_LIMIT:
        return False
    resident = n_pad * P * 4 + 2 * n_pad * KP * 4 + n_pad * 4
    if with_offs:
        resident += n_pad * KP * 4
    return resident <= L2_BUDGET


def smem_floats(KC, B, px, has_offs, stages, groups, rgroups, nq):
    """The launch's shared memory in floats: csrc/epoch_kernel.cu
    `smem_floats`, the same expression."""
    return (stages * (B * px + B * KC + B + has_offs * B * KC) + 2 * KC * px + B * KC
            + (groups > 1) * groups * KC * px + (rgroups > 1) * rgroups * nq * KC * 4 + 16 * (KC + 2) + 2 * KC + 4
            + 8)


class Plan(NamedTuple):
    """A launch of csrc/epoch_kernel.cu."""

    variant: str  # "ring": blocks prefetched into shared memory; "l2": read from global memory
    kc: int  # classes rounded up to 1, 2, 4 or 8 (the template)
    px: int  # the kernel's row width: p rounded up to 4
    threads: int  # threads of the step (a multiple of 32)
    lanes: int  # lanes a row of the row phase takes (a power of two)
    rows: int  # rows a row slot takes a step
    groups: int  # row groups of the column phase
    stages: int  # ring stages (0: the l2 variant)
    smem: int  # bytes of dynamic shared memory


@functools.lru_cache(maxsize=None)
def plan(p: int, k: int, B: int, with_offs: bool = False) -> Plan:
    """The launch for a (B-row block, p columns, k classes) problem: one
    warp at B = 32, p <= 32; a row takes more lanes only past 32 columns
    (at most 16 columns a lane); as many threads as the rows' lanes or the
    columns need, up to 512; the deepest ring (3, else 2 stages) that fits
    beside the state, else the l2 variant."""
    kc = _pow2_at_least(max(k, 1))
    px = _ceil_mult(max(p, 1), 4)
    lanes = 1 if p <= 32 else min(32, _pow2_at_least(-(-p // 16)))
    threads = min(THREADS, max(32, _ceil_mult(max(B * lanes, p), 32)))
    rows = -(-B // (threads // lanes))
    groups = 1 if threads == 32 else max(1, min(threads // max(p, 1), B // 16))
    nq = px // 4 + 1
    rgroups = max(1, (THREADS // 32) // nq)
    for stages in (3, 2, 0):
        if stages and rows > RMAX:
            continue
        smem = 4 * smem_floats(kc, B, px, int(with_offs), stages, groups, rgroups, nq)
        if smem <= SMEM_LIMIT:
            return Plan("ring" if stages else "l2", kc, px, threads, lanes, rows, groups, stages, smem)
    raise ValueError(f"epoch kernel: no launch fits p={p}, k={k}, B={B}")


class PadState(NamedTuple):
    """SagaState in kernel layout (all f32, lane-padded)."""

    w: torch.Tensor  # (KP, P)
    ivec: torch.Tensor  # (2, KP): row 0 intercept, row 1 g_sum_intercept
    g_mem: torch.Tensor  # (n_pad, KP)
    g_sum: torch.Tensor  # (KP, P)


class EpochData(NamedTuple):
    """The padded, contiguous inputs (built once per fit) in the kernel's
    layout: rows of p rounded up to px = a multiple of 4 columns, k classes
    rounded up to kc = 1, 2, 4 or 8 lanes, pads zero."""

    x: torch.Tensor  # (n_pad, px)
    y: torch.Tensor  # (n_pad, kc)
    wt: torch.Tensor  # (n_pad,)
    offs: torch.Tensor | None  # (n_pad, kc)
    pf: torch.Tensor | None  # (px,)
    p: int
    k: int


def pad_data(x, y, weights, offs=None, pf=None, dtype=torch.float32) -> EpochData:
    n_pad, p = x.shape
    k = y.shape[1]
    px, kc = _ceil_mult(max(p, 1), 4), _pow2_at_least(k)

    def padded(a, shape):
        out = torch.zeros(shape, dtype=dtype, device=x.device)
        out[..., : a.shape[-1]] = a
        return out

    return EpochData(
        padded(x, (n_pad, px)), padded(y, (n_pad, kc)), weights.to(dtype=dtype, copy=True),
        None if offs is None else padded(offs, (n_pad, kc)), None if pf is None else padded(pf, (px,)), p, k,
    )


def pad_state(state, p: int, dtype=torch.float32) -> PadState:
    """SagaState (k-, p-sized) -> kernel layout; pads are zero."""
    k = state.w.shape[0]
    P = _ceil_mult(max(p, 1), 128)
    z = dict(dtype=dtype, device=state.w.device)
    w = torch.zeros((KP, P), **z)
    w[:k, :p] = state.w
    ivec = torch.zeros((2, KP), **z)
    ivec[0, :k] = state.intercept
    ivec[1, :k] = state.g_sum_intercept
    g_mem = torch.zeros((state.g_mem.shape[0], KP), **z)
    g_mem[:, :k] = state.g_mem
    g_sum = torch.zeros((KP, P), **z)
    g_sum[:k, :p] = state.g_sum
    return PadState(w, ivec, g_mem, g_sum)


def unpad_state(ps: PadState, k: int, p: int):
    from sgdnet_tpu_torch.solver.saga import SagaState

    return SagaState(
        w=ps.w[:k, :p],
        intercept=ps.ivec[0, :k],
        g_mem=ps.g_mem[:, :k],
        g_sum=ps.g_sum[:k, :p],
        g_sum_intercept=ps.ivec[1, :k],
    )


def _gradient(family, lp, yb, k: int):
    """Family gradient on (B, kc) with only the first k lanes real."""
    name = family.name
    if name in ("gaussian", "mgaussian"):
        return lp - yb
    if name == "binomial":
        return 1.0 / (1.0 + torch.exp(-lp)) - yb
    if name == "poisson":
        return torch.exp(torch.clamp(lp, max=math.log(family.smoothness))) - yb
    if name == "multinomial":
        mask = torch.arange(lp.shape[1], device=lp.device)[None, :] < k
        lpm = torch.where(mask, lp, torch.full_like(lp, -1e30))
        m = torch.amax(lpm, dim=1, keepdim=True)
        e = torch.exp(lpm - m)
        return e / torch.sum(e, dim=1, keepdim=True) - yb
    raise ValueError(f"epoch kernel: unsupported family {name}")


def _prox(penalty, w_half, threshold):
    """Whole-tile prox; pad rows/cols are zero and stay zero."""
    name = penalty.name
    if name == "ridge":
        return w_half
    if name == "elastic_net":
        return torch.sign(w_half) * torch.clamp(torch.abs(w_half) - threshold, min=0.0)
    if name == "group_lasso":
        norms = torch.sqrt(torch.sum(w_half * w_half, dim=0, keepdim=True))
        factor = torch.clamp(1.0 - threshold / torch.clamp(norms, min=1e-30), min=0.0)
        return w_half * factor
    raise ValueError(f"epoch kernel: unsupported penalty {name}")


def epoch_reference(data: EpochData, ps: PadState, starts, B: int, family, penalty,
                    gamma: float, l1: float, l2: float, w_total: float,
                    decay: float = 1.0, fit_intercept: bool = True, refresh: bool = True) -> PadState:
    """Plain torch version of one kernel epoch: the work on the kernel's
    (kc, px) part of the state, written into a copy of the padded state
    (the input is left untouched)."""
    x, y, wt = data.x, data.y, data.wt
    kc, px = y.shape[1], x.shape[1]
    w, g_sum = ps.w[:kc, :px].clone(), ps.g_sum[:kc, :px].clone()
    ivec, g_mem = ps.ivec[:, :kc].clone(), ps.g_mem[:, :kc].clone()
    kmask = (torch.arange(kc, device=x.device) < data.k).to(torch.float32)
    for start in torch.as_tensor(starts).tolist():
        rows = slice(start, start + B)
        xb = x[rows]
        wtb = wt[rows][:, None]
        lp = xb @ w.T + ivec[0:1, :]
        if data.offs is not None:
            lp = lp + data.offs[rows]
        g = _gradient(family, lp, y[rows], data.k) * wtb * kmask
        gc = g - g_mem[rows]
        g_mem[rows] = g
        corr = gc.T @ xb  # (kc, px)
        bw = torch.clamp(torch.sum(wtb), min=1e-12)
        grad_est = corr / bw + g_sum
        if data.pf is not None:
            w_half = w * (1.0 - gamma * l2 * data.pf) - gamma * grad_est
            w = _prox(penalty, w_half, gamma * l1 * data.pf)
        else:
            w_half = w * (1.0 - gamma * l2) - gamma * grad_est
            w = _prox(penalty, w_half, gamma * l1)
        g_sum = g_sum + corr / w_total
        if fit_intercept:
            sum_gc = torch.sum(gc, dim=0)
            ivec[0] = ivec[0] - gamma * decay * (sum_gc / bw + ivec[1])
            ivec[1] = ivec[1] + sum_gc / w_total
    if refresh:
        g_sum = (g_mem.T @ x) / w_total
        ivec[1] = torch.sum(g_mem, dim=0) / w_total
    out = PadState(*(t.clone() for t in ps))
    out.w[:kc, :px], out.g_sum[:kc, :px] = w, g_sum
    out.ivec[:, :kc], out.g_mem[:, :kc] = ivec, g_mem
    return out


def epoch_stats(w, w_prev, intercept):
    """The convergence statistics of an epoch, on the host: max |w -
    w_prev|, max |w| (torch.max: a NaN propagates) and whether the
    intercept is all finite (1.0 / 0.0).  One device sync."""
    return torch.stack([
        torch.max(torch.abs(w - w_prev)),
        torch.max(torch.abs(w)),
        torch.all(torch.isfinite(intercept)).to(w.dtype),
    ]).tolist()


def stop_rule(max_change, max_size, intercept_finite, t_conv, dt):
    """solver/saga.py fit_one's rule on an epoch's statistics, in the fit's
    dtype `dt`: (done, rel).  Done when w is all zero and did not move,
    when the relative change is within t_conv, or when anything is not
    finite (rel = inf then: a divergence reads as not converged)."""
    max_change, max_size = dt(max_change), dt(max_size)
    finite = bool(np.isfinite(max_size) and np.isfinite(max_change) and intercept_finite)
    all_zero = max_size == 0.0 and max_change == 0.0
    no_change = finite and max_size != 0.0 and max_change <= dt(t_conv) * max_size
    if finite and max_size > 0.0:
        rel = max_change / max(max_size, dt(1e-30))
    else:
        rel = dt(0.0) if finite else dt(np.inf)
    return bool(all_zero or no_change or not finite), rel


def epochs_reference(data: EpochData, ps: PadState, orders, B: int, family, penalty,
                     gamma: float, l1: float, l2: float, w_total: float, decay: float = 1.0,
                     fit_intercept: bool = True, it0: int = 0, t_conv: float = 0.0, refresh_every: int = 1):
    """Plain torch version of `saga_epochs`: `epoch_reference` over the rows
    of `orders` (E, T block starts), the refresh at epochs whose index it0 +
    e + 1 the cadence divides (never for refresh_every = 0), stopping after
    the first epoch at which `stop_rule` does.  Returns (state, stats): a
    new PadState and a (4,) tensor [epochs run, max change, max size,
    finite] of that epoch, in the state's dtype."""
    dt = np.float64 if ps.w.dtype == torch.float64 else np.float32
    orders = torch.as_tensor(orders)
    stats = [0, 0.0, 0.0, 1.0]
    for e in range(orders.shape[0]):
        refresh = refresh_every > 0 and (it0 + e + 1) % refresh_every == 0
        new = epoch_reference(data, ps, orders[e], B, family, penalty, gamma, l1, l2, w_total, decay,
                              fit_intercept, refresh)
        mc, ms, fin = epoch_stats(new.w, ps.w, new.ivec[0])
        ps = new
        done, _ = stop_rule(mc, ms, fin == 1.0, t_conv, dt)
        finite = bool(np.isfinite(mc) and np.isfinite(ms) and fin == 1.0)
        stats = [e + 1, mc, ms, float(finite)]
        if done:
            break
    return ps, torch.tensor(stats, dtype=ps.w.dtype)


def saga_epochs(data: EpochData, ps: PadState, orders, B: int, family, penalty,
                gamma: float, l1: float, l2: float, w_total: float, decay: float = 1.0,
                fit_intercept: bool = True, it0: int = 0, t_conv: float = 0.0, refresh_every: int = 1):
    """Up to E = orders.shape[0] SAGA epochs over the (E, T) block starts
    `orders` in one launch, with the refresh cadence and stopping rule of
    `epochs_reference`; returns (state, stats) as it does: a new PadState
    (`ps` is left untouched) and stats on the state's device.  CUDA tensors
    launch the Hopper kernel (or raise); CPU tensors run
    `epochs_reference`."""
    if not data.x.is_cuda:
        return epochs_reference(data, ps, orders, B, family, penalty, gamma, l1, l2, w_total, decay,
                                fit_intercept, it0, t_conv, refresh_every)
    n_pad, P = data.x.shape[0], _ceil_mult(max(data.p, 1), 128)
    T = n_pad // B
    if not supported(n_pad, data.p, data.k, B, data.x.dtype, data.offs is not None):
        raise ValueError(f"epoch kernel: unsupported problem n_pad={n_pad}, p={data.p}, k={data.k}, B={B}")
    if family.name not in _FAMILY_CODE or penalty.name not in _PENALTY_CODE:
        raise ValueError(f"epoch kernel: unsupported family/penalty {family.name}/{penalty.name}")
    dev = data.x.device
    orders = torch.as_tensor(orders)
    if orders.dim() != 2 or orders.shape[1] != T or orders.shape[0] < 1:
        raise ValueError(f"epoch kernel: expected (E, {T}) block starts, got {tuple(orders.shape)}")
    # host orders (fit_path's, from its order_fn) are checked before upload:
    # the kernel reads and writes B rows from each start
    if not orders.is_cuda and (int(orders.min()) < 0 or int(orders.max()) > n_pad - B or bool((orders % B).any())):
        raise ValueError(f"epoch kernel: block starts must be multiples of {B} in [0, {n_pad - B}]")
    orders = orders.to(device=dev, dtype=torch.int32).contiguous()
    if any(t.device != dev or t.dtype != torch.float32 or not t.is_contiguous() for t in ps):
        raise ValueError("epoch kernel: the state must be contiguous f32 tensors on the data's device")
    if ps.w.shape != (KP, P) or ps.g_sum.shape != (KP, P) or ps.ivec.shape != (2, KP) \
            or ps.g_mem.shape != (n_pad, KP):
        raise ValueError("epoch kernel: state does not match the padded layout")
    if any(t is not None and t.data_ptr() % 16 for t in (data.x, data.y, data.wt, data.offs)):
        raise ValueError("epoch kernel: the data's tensors must start on 16 bytes (pad_data makes them)")
    pl = plan(data.p, data.k, B, data.offs is not None)
    if data.x.shape[1] != pl.px or data.y.shape[1] != pl.kc:
        raise ValueError("epoch kernel: the data does not match the kernel layout (pad_data makes it)")
    out = PadState(*(t.clone() for t in ps))
    wprev = torch.empty((pl.kc * pl.px,), dtype=torch.float32, device=dev)
    stats = torch.empty((4,), dtype=torch.float32, device=dev)
    log_smooth = math.log(family.smoothness) if family.name == "poisson" else 0.0
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    code = build.load_library().sgd_epochs(
        orders.data_ptr(), orders.shape[0], T, B, n_pad, data.x.data_ptr(), pl.px, data.p,
        data.y.data_ptr(), data.wt.data_ptr(), ptr(data.offs), ptr(data.pf),
        out.w.data_ptr(), out.ivec.data_ptr(), out.g_mem.data_ptr(), out.g_sum.data_ptr(), P,
        wprev.data_ptr(), stats.data_ptr(),
        data.k, pl.kc, _FAMILY_CODE[family.name], _PENALTY_CODE[penalty.name], log_smooth,
        gamma, l1, l2, w_total, decay, int(fit_intercept), it0, refresh_every, t_conv,
        pl.threads, pl.lanes, pl.groups, pl.stages, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(code, "epoch kernel")
    saga_epochs.launches += 1
    saga_epochs.launches_by_variant[pl.variant] += 1
    return out, stats


#: kernel launches since the last reset, in all and by variant (the twin
#: never counts)
saga_epochs.launches = 0
saga_epochs.launches_by_variant = {"ring": 0, "l2": 0}


def saga_epoch(data: EpochData, ps: PadState, starts, B: int, family, penalty,
               gamma: float, l1: float, l2: float, w_total: float,
               decay: float = 1.0, fit_intercept: bool = True, refresh: bool = True) -> PadState:
    """One SAGA epoch over the block starts `starts` (int tensor): a chunk
    of one `saga_epochs`; returns a new PadState (the input is left
    untouched)."""
    out, _ = saga_epochs(data, ps, torch.as_tensor(starts).reshape(1, -1), B, family, penalty, gamma, l1, l2,
                         w_total, decay, fit_intercept, 0, 0.0, 1 if refresh else 0)
    return out


def build_epochs(x, y, weights, w_total, family, penalty, config, offs=None, pf=None):
    """Return `epochs_fn(ps, orders, gamma, l1, l2, it0, t_conv) ->
    (ps, stats)` running the epochs of `orders` (E, T block indices) in one
    call, with the refresh cadence of `config`."""
    data = pad_data(x, y, weights, offs, pf)
    B = config.batch_size
    every = max(config.g_sum_refresh_every, 1) if config.g_sum_refresh else 0

    def epochs_fn(ps, orders, gamma, l1, l2, it0=0, t_conv=0.0):
        return saga_epochs(data, ps, torch.as_tensor(orders) * B, B, family, penalty, gamma, l1, l2, w_total,
                           config.intercept_decay, config.fit_intercept, it0, t_conv, every)

    return epochs_fn
