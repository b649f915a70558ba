"""K6: the SAGA step's finish in one launcher call (csrc/step_finish.cu),
and its plain torch twin, the chain of ops it replaces.

After a step's products, the finish forms the SAGA estimate, the prox
step and the g_sum and intercept updates (solver/saga.py `_make_step`):

    bw = max(sum wb, 1e-12),  sum_gc = sum_b g_change[b]
    corr_jc = corr[c, j] (+ corr_head[c, j] where j < D: the head's part)
    w_new = box(prox(w * shrink - gamma * (corr / bw + g_sum)))    (pf scales the decay and the threshold)
    g_sum_new = g_sum + corr / w_total
    intercept_new = intercept - gdecay * (sum_gc / bw + g_sum_intercept),  g_sum_intercept += sum_gc / w_total

`finish_step_reference` is that chain, as the step has always run it: the
route for the CPU, group lasso (its prox takes a norm over the classes),
the meshed step (its all-reduce sits between the sums and the update) and
a centering term `xc` (applied after the head/tail merge).
`uses_finish_kernel` is the route; it takes K6 on the card for Ridge and
elastic net, with or without `pf`, a box and the intercept, where
`use_tail_kernel` holds (the switch of the port's plain-op comparison
path, as for K3-K5).

`FinishLauncher` is K6 bound once by the step to its shapes, dtype,
penalty, `pf` and box, which it checks then; `prepare` makes an epoch's
input state contiguous (once an epoch), and a call is one allocation (the
new w, g_sum, intercept and g_sum_intercept are views of it) and one
ctypes call that launches two kernels.  The new state never shares the
input's storage.  `finish_step` is the checked one-shot form: its twin on
the CPU, a launcher bound for the call on the card.
"""

from __future__ import annotations

import torch

from sgdnet_tpu_torch.penalties.penalties import ElasticNet, Ridge
from sgdnet_tpu_torch.utils import build

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
#: the kernel's prox codes (csrc/common.h `Penalty`)
_PROX = {Ridge: 0, ElasticNet: 1}
#: threads of the bw sum and of an intercept's sum (csrc/step_finish.cu RT, CT):
#: thread t adds rows t, t + threads, ... in order, then the partials meet in
#: a pairwise tree (tests/test_torch_finish.py replays it)
BW_THREADS, ICPT_THREADS = 1024, 128


def uses_finish_kernel(device, dtype, penalty, config, xc=None) -> bool:
    """The K6 route: CUDA tensors of f32 or f64, a Ridge or elastic-net
    penalty, no mesh, no centering term, and `use_tail_kernel`."""
    return (
        config.use_tail_kernel
        and torch.device(device).type == "cuda"
        and dtype in _DTYPE_CODE
        and type(penalty) in _PROX
        and config.mesh is None
        and xc is None
    )


def finish_step_reference(state, scal, wb, g_change, corr, penalty, w_total: float, fit_intercept: bool, pf=None,
                          box=None, corr_head=None, reduce=None):
    """The finish as a chain of torch ops: K6's twin, and the finish of
    every step off K6's route.  `corr_head` (k, D) is added to corr's first
    D columns first (out of place); `reduce(wb, g_change, corr)`, where
    given (the meshed step), returns (bw, sum_gc, corr) summed over the
    ranks.  Returns the new state (the input's g_mem)."""
    if corr_head is not None:
        corr = corr.clone()
        corr[:, : corr_head.shape[1]] += corr_head.to(corr.dtype)
    if reduce is None:
        bw = torch.clamp(torch.sum(wb), min=1e-12)
        sum_gc = torch.sum(g_change, dim=0)  # (k,)
    else:
        bw, sum_gc, corr = reduce(wb, g_change, corr)
    grad_est = corr / bw + state.g_sum
    # per-feature penalty factors scale both the L2 decay and the prox
    # threshold (glmnet `penalty.factor`); pf is (p,), broadcast over k
    if pf is None:
        w_half = state.w * scal.shrink - scal.gamma * grad_est
        w_new = penalty.prox(w_half, scal.gl1)
    else:
        w_half = state.w * (1.0 - scal.gl2 * pf) - scal.gamma * grad_est
        w_new = penalty.prox(w_half, scal.gl1 * pf)
    if box is not None:
        # box constraints: project onto [lo, hi] after the prox
        w_new = torch.minimum(torch.maximum(w_new, box[0]), box[1])
    g_sum = state.g_sum + corr / w_total
    if fit_intercept:
        # intercept step with the same SAGA estimator: fresh batch-mean
        # gradient change + stale average
        grad_est_b = sum_gc / bw + state.g_sum_intercept
        intercept = state.intercept - scal.gdecay * grad_est_b
        g_sum_i = state.g_sum_intercept + sum_gc / w_total
    else:
        intercept = state.intercept
        g_sum_i = state.g_sum_intercept
    return type(state)(w_new, intercept, state.g_mem, g_sum, g_sum_i)


def _check(t, shape, dtype, device, what: str) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != dtype or t.device != device:
        got = f"{t.dtype} on {t.device}" if isinstance(t, torch.Tensor) else type(t).__name__
        raise ValueError(f"step_finish: {what} must be a {dtype} tensor on {device}; got {got}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"step_finish: {what} must be a contiguous {tuple(shape)} tensor; got {tuple(t.shape)}"
                         f"{'' if t.is_contiguous() else ', not contiguous'}")


class FinishLauncher:
    """K6 bound to a step: batch B, k classes, p columns, a head corr of D
    columns (0: none), `dtype` on the card `device`, the penalty (Ridge or
    elastic net), w_total, whether the intercept is fitted, and the
    optional `pf` (p,) and box (lo, hi), each (k, p), checked here (and
    `weights` (n,), the rows of wb, where given).  A call
    `launcher(state, scal, wb, g_change, corr, corr_head)` takes wb (B,),
    g_change (B, k), corr (k, p) and corr_head (k, D) or None, and a state
    `prepare` passed (w, g_sum (k, p), intercept, g_sum_intercept (k,)),
    all contiguous of `dtype` on `device`, and checks nothing.  It launches
    on the stream `refresh_stream` last read."""

    def __init__(self, B: int, k: int, p: int, D: int, dtype, device, penalty, w_total: float,
                 fit_intercept: bool, pf=None, box=None, weights=None):
        device = torch.device(device)
        if dtype not in _DTYPE_CODE or device.type != "cuda":
            raise ValueError(f"step_finish: takes f32 / f64 operands on the card; got {dtype} on {device}")
        if type(penalty) not in _PROX:
            raise ValueError(f"step_finish: takes a Ridge or elastic-net penalty; got {type(penalty).__name__}")
        if min(B, k, p) < 1 or not 0 <= D <= p:
            raise ValueError(f"step_finish: needs B, k, p >= 1 and 0 <= D <= p; got B {B}, k {k}, p {p}, D {D}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if pf is not None:
            _check(pf, (p,), dtype, device, "pf")
        if box is not None:
            if len(box) != 2:
                raise ValueError("step_finish: box must be a pair (lo, hi)")
            for t, name in zip(box, ("box lo", "box hi")):
                _check(t, (k, p), dtype, device, name)
        if weights is not None:
            _check(weights, (weights.shape[0],), dtype, device, "weights")
        self.B, self.k, self.p, self.D = B, k, p, D
        self.dtype, self.device, self.fit_intercept = dtype, device, bool(fit_intercept)
        # what the twin takes to compute the same finish; the bound operands
        # outlive the launcher's calls
        self.penalty, self.w_total, self.pf, self.box = penalty, float(w_total), pf, box
        kp = k * p
        self.n_out = 2 * kp + 2 * k + 1  # w, g_sum, intercept, g_sum_intercept, then the kernel's bw
        self.views = (((k, p), (p, 1), 0), ((k, p), (p, 1), kp), ((k,), (1,), 2 * kp), ((k,), (1,), 2 * kp + k))
        lo, hi = (0, 0) if box is None else (box[0].data_ptr(), box[1].data_ptr())
        self.args = (_DTYPE_CODE[dtype], B, k, p, D, _PROX[type(penalty)], int(self.fit_intercept), self.w_total,
                     0 if pf is None else pf.data_ptr(), lo, hi)
        self.fn = build.load_library().sgd_step_finish
        self.refresh_stream()

    def refresh_stream(self) -> None:
        self.stream = torch.cuda.current_stream(self.device).cuda_stream

    def prepare(self, state):
        """The state with w, g_sum, intercept and g_sum_intercept
        contiguous (each the input where it already is), checked against
        the bound shapes, dtype and device: once an epoch, not a call."""
        k, p = self.k, self.p
        parts = {}
        for name, shape in (("w", (k, p)), ("g_sum", (k, p)), ("intercept", (k,)), ("g_sum_intercept", (k,))):
            t = getattr(state, name).contiguous()
            _check(t, shape, self.dtype, self.device, f"state.{name}")
            parts[name] = t
        return state._replace(**parts)

    def __call__(self, state, scal, wb, g_change, corr, corr_head=None):
        out = torch.empty(self.n_out, dtype=self.dtype, device=self.device)
        code = self.fn(wb.data_ptr(), g_change.data_ptr(), corr.data_ptr(),
                       0 if corr_head is None else corr_head.data_ptr(), state.w.data_ptr(),
                       state.g_sum.data_ptr(), state.intercept.data_ptr(), state.g_sum_intercept.data_ptr(), *scal,
                       out.data_ptr(), *self.args, self.stream)
        if code:
            build.check(code, "step_finish")
        finish_step.launches += 1
        (sw, sg, si, sgi) = self.views
        w, g_sum = out.as_strided(*sw), out.as_strided(*sg)
        if self.fit_intercept:
            intercept, g_sum_i = out.as_strided(*si), out.as_strided(*sgi)
        else:
            intercept, g_sum_i = state.intercept, state.g_sum_intercept
        return type(state)(w, intercept, state.g_mem, g_sum, g_sum_i)


def finish_step(state, scal, wb, g_change, corr, penalty, w_total: float, fit_intercept: bool = True, pf=None,
                box=None, corr_head=None):
    """The step's finish for one call: on CPU tensors the twin; on the card
    every operand is checked and K6 launches through a launcher bound for
    the call.  Returns the new state (the input's g_mem)."""
    if not corr.is_cuda:
        return finish_step_reference(state, scal, wb, g_change, corr, penalty, w_total, fit_intercept, pf=pf,
                                     box=box, corr_head=corr_head)
    k, p = corr.shape
    B, D = wb.shape[0], 0 if corr_head is None else corr_head.shape[1]
    launcher = FinishLauncher(B, k, p, D, corr.dtype, corr.device, penalty, w_total, fit_intercept, pf=pf, box=box)
    for t, shape, name in ((wb, (B,), "wb"), (g_change, (B, k), "g_change"), (corr, (k, p), "corr"),
                           (corr_head, (k, D), "corr_head")):
        if t is not None:
            _check(t, shape, corr.dtype, corr.device, name)
    return launcher(launcher.prepare(state), scal, wb, g_change, corr, corr_head)


#: K6 calls since the last reset, one a step on its route (the twin never counts)
finish_step.launches = 0
