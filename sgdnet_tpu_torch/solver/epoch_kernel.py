"""K1: the whole-SAGA-epoch kernel (twin of sgdnet_tpu/solver/epoch_kernel.py).

Small dense fits are latency-bound: every epoch is T = n_pad / B strictly
sequential batched steps, and a step is a dozen tiny ops.  On the card one
launch of csrc/epoch_kernel.cu runs the whole epoch in one persistent CTA,
with the (KP, P) state in shared memory and the dataset L2-resident; a
second launch inside the same op recomputes g_sum exactly.

Semantics are those of the plain step path (solver/saga.py step_xla /
_finish_step with block sampling): same batch sequence, same update
order, same epoch-end refresh.  State rides in the padded layout of the
JAX kernel (classes padded to KP = 8 lanes, features to a 128 multiple)
across the whole lambda path; pad lanes stay exactly zero, so the
convergence check over the padded tile equals the check over the real one.

`saga_epoch` launches the kernel for CUDA tensors and runs
`epoch_reference`, the plain torch version, for CPU tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sgdnet_tpu_torch.utils import build

#: class-lane padding: k classes ride the first k of KP lanes
KP = 8
#: shared memory one Hopper CTA may use (227 KB)
SMEM_LIMIT = 232448
#: resident bytes of x, y, weights, g_mem (and offsets) the gate admits:
#: sized to stay inside the H100's 50 MB L2 with room for the state
L2_BUDGET = 40 * 1024 * 1024
#: warps of the epoch CTA (csrc/epoch_kernel.cu NW)
_NW = 16

_FAMILY_CODE = {"gaussian": 0, "binomial": 1, "poisson": 2, "multinomial": 3, "mgaussian": 4}
_PENALTY_CODE = {"ridge": 0, "elastic_net": 1, "group_lasso": 2}


def _ceil_mult(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def smem_bytes(P: int, B: int) -> int:
    """Dynamic shared memory of the epoch CTA (csrc epoch_smem_bytes)."""
    return 4 * (2 * KP * P + B * KP + _NW * (KP + 1) + 2 * KP + KP + 1)


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


class PadState(NamedTuple):
    """SagaState in kernel layout (all f32, lane-padded)."""

    w: torch.Tensor  # (KP, P)
    ivec: torch.Tensor  # (2, KP): row 0 intercept, row 1 g_sum_intercept
    g_mem: torch.Tensor  # (n_pad, KP)
    g_sum: torch.Tensor  # (KP, P)


class EpochData(NamedTuple):
    """The kernel's padded, f32, contiguous inputs (built once per fit)."""

    x: torch.Tensor  # (n_pad, P)
    y: torch.Tensor  # (n_pad, KP)
    wt: torch.Tensor  # (n_pad,)
    offs: torch.Tensor | None  # (n_pad, KP)
    pf: torch.Tensor | None  # (P,), pad columns 0
    p: int
    k: int


def pad_data(x, y, weights, offs=None, pf=None) -> EpochData:
    n_pad, p = x.shape
    k = y.shape[1]
    P = _ceil_mult(max(p, 1), 128)
    f32 = dict(dtype=torch.float32, device=x.device)
    x_pad = torch.zeros((n_pad, P), **f32)
    x_pad[:, :p] = x
    y_pad = torch.zeros((n_pad, KP), **f32)
    y_pad[:, :k] = y
    offs_pad = pf_pad = None
    if offs is not None:
        offs_pad = torch.zeros((n_pad, KP), **f32)
        offs_pad[:, : offs.shape[1]] = offs
    if pf is not None:
        pf_pad = torch.zeros((P,), **f32)
        pf_pad[:p] = pf
    return EpochData(x_pad, y_pad, weights.to(torch.float32).contiguous(), offs_pad, pf_pad, p, k)


def pad_state(state, p: int) -> PadState:
    """SagaState (k-, p-sized) -> kernel layout; pads are zero."""
    k = state.w.shape[0]
    P = _ceil_mult(max(p, 1), 128)
    f32 = dict(dtype=torch.float32, device=state.w.device)
    w = torch.zeros((KP, P), **f32)
    w[:k, :p] = state.w
    ivec = torch.zeros((2, KP), **f32)
    ivec[0, :k] = state.intercept
    ivec[1, :k] = state.g_sum_intercept
    g_mem = torch.zeros((state.g_mem.shape[0], KP), **f32)
    g_mem[:, :k] = state.g_mem
    g_sum = torch.zeros((KP, P), **f32)
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
    """Family gradient on (B, KP) with only the first k lanes real."""
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
    """Plain torch version of one kernel epoch on the padded layout."""
    x, y, wt = data.x, data.y, data.wt
    w, ivec, g_mem, g_sum = (t.clone() for t in ps)
    kmask = (torch.arange(KP, device=x.device) < data.k).to(torch.float32)
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
        corr = gc.T @ xb  # (KP, P)
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
    return PadState(w, ivec, g_mem, g_sum)


def saga_epoch(data: EpochData, ps: PadState, starts, B: int, family, penalty,
               gamma: float, l1: float, l2: float, w_total: float,
               decay: float = 1.0, fit_intercept: bool = True, refresh: bool = True) -> PadState:
    """One SAGA epoch over the block starts `starts` (int tensor); returns
    a new PadState (the input is left untouched).  CUDA tensors launch the
    Hopper kernel; CPU tensors run `epoch_reference`."""
    if not data.x.is_cuda:
        return epoch_reference(data, ps, starts, B, family, penalty, gamma, l1, l2, w_total,
                               decay, fit_intercept, refresh)
    n_pad, P = data.x.shape
    T = n_pad // B
    if not supported(n_pad, data.p, data.k, B, data.x.dtype, data.offs is not None):
        raise ValueError(f"epoch kernel: unsupported problem n_pad={n_pad}, p={data.p}, k={data.k}, B={B}")
    if family.name not in _FAMILY_CODE or penalty.name not in _PENALTY_CODE:
        raise ValueError(f"epoch kernel: unsupported family/penalty {family.name}/{penalty.name}")
    dev = data.x.device
    starts = torch.as_tensor(starts).to(device=dev, dtype=torch.int32).contiguous()
    if starts.shape != (T,):
        raise ValueError(f"epoch kernel: expected {T} block starts, got {tuple(starts.shape)}")
    out = PadState(*(t.to(device=dev, dtype=torch.float32).contiguous().clone() for t in ps))
    if out.w.shape != (KP, P) or out.g_sum.shape != (KP, P) or out.ivec.shape != (2, KP) \
            or out.g_mem.shape != (n_pad, KP):
        raise ValueError("epoch kernel: state does not match the padded layout")
    log_smooth = math.log(family.smoothness) if family.name == "poisson" else 0.0
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    lib = build.load_library()
    code = lib.sgd_epoch(
        starts.data_ptr(), T, B, data.x.data_ptr(), P, data.p, n_pad,
        data.y.data_ptr(), data.wt.data_ptr(), ptr(data.offs), ptr(data.pf),
        out.w.data_ptr(), out.ivec.data_ptr(), out.g_mem.data_ptr(), out.g_sum.data_ptr(),
        data.k, _FAMILY_CODE[family.name], _PENALTY_CODE[penalty.name], log_smooth,
        gamma, l1, l2, w_total, decay, int(fit_intercept), int(refresh),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(code, "epoch kernel")
    saga_epoch.launches += 1
    return out


#: kernel launches since the last reset (the twin never counts)
saga_epoch.launches = 0


def build_epoch(x, y, weights, w_total, family, penalty, config, offs=None, pf=None):
    """Return `epoch_fn(ps, order, gamma, l1, l2, it) -> ps` running one
    whole epoch per call, with `order` a permutation of the T blocks."""
    data = pad_data(x, y, weights, offs, pf)
    B = config.batch_size
    every = config.g_sum_refresh_every

    def epoch_fn(ps, order, gamma, l1, l2, it=None):
        refresh = config.g_sum_refresh and (every <= 1 or it is None or (it + 1) % every == 0)
        return saga_epoch(data, ps, order * B, B, family, penalty, gamma, l1, l2, w_total,
                          config.intercept_decay, config.fit_intercept, refresh)

    return epoch_fn
