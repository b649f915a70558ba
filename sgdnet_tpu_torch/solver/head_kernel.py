"""K2: the fused head step (twin of sgdnet_tpu/solver/pallas_kernels.py).

`fused_head_step_at` fuses the dense part of one batched SAGA step over
rows [start, start+B) of the FULL head array:

    lp   = head[start:start+B] @ w_h.T + lp_extra
    g    = family_gradient(lp, yb) * wb
    gc   = g - g_mem_b
    corr = gc.T @ head[start:start+B]

On a CUDA tensor it launches the hand-written Hopper kernel
(csrc/head_step.cu); on a CPU tensor it runs `fused_head_step_reference`,
the plain torch version of the same function (the counterpart of the JAX
package's Pallas interpret mode).  Nothing falls back: a CUDA input the
kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from sgdnet_tpu_torch.utils import build

#: families with a K2 gradient (poisson has none, as in the JAX kernel)
FAMILIES = ("gaussian", "binomial", "multinomial", "mgaussian")
_FAMILY_CODE = {"gaussian": 0, "binomial": 1, "multinomial": 3, "mgaussian": 4}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the device kernels one launch runs, by their names in a profile
#: (csrc/head_step.cu): the resident design's kernel, then `sum_partials`
#: where its plan has more than one partial corr; or the streamed design's
#: three, w rounded, lp / gradient / gc, corr
RESIDENT_KERNELS = ("head_step_resident", "sum_partials")
STREAMED_KERNELS = ("head_round_w", "head_step_streamed", "head_corr_streamed")
KERNEL_NAMES = RESIDENT_KERNELS + STREAMED_KERNELS
#: class count limit (the JAX kernel pads k to at most 128 lanes)
MAX_K = 128
#: threads of a CTA, and the shared memory one CTA can use on Hopper
THREADS = 256
SMEM_LIMIT = 232448
#: SMs of an H100 SXM, and the shared memory of one (each CTA on it takes
#: its own bytes and 1024 reserved): the persistent grid's default size
N_SM = 132
SMEM_PER_SM = 233472
#: the streamed design (csrc/head_step.cu): rows of an lp tile, columns of
#: a corr strip, ring stages; by the head's item size, columns of an lp
#: stage (128 bytes), rows of a corr stage and the 16-byte row padding
S_ROWS, S_COLS, S_STAGES = 128, 128, 4
_S_TILES = {2: (64, 64, 8), 4: (32, 32, 4)}  # item size -> (BK, BR, PAD)


class HeadPlan(NamedTuple):
    """What `plan` chose for one (B, D, k, dtype); the kernel's launch
    parameters, as csrc/head_step.cu `sgd_head_step` takes them."""

    resident: bool  # a row tile stays in shared memory between the two products
    bt: int  # rows of a tile
    C: int  # CTAs of a cluster = column strips of the head
    W: int  # columns of a strip (a multiple of 16 bytes)
    S: int  # ring stages
    tpc: int  # consecutive tiles one cluster walks
    n_parts: int  # clusters: partial corrs
    single: bool  # corr accumulators live in registers across the tiles
    smem: int  # dynamic shared memory of a CTA, bytes

    @property
    def ctas(self) -> int:
        return self.n_parts * self.C


class StreamPlan(NamedTuple):
    """The streamed design's launch parameters (`stream_plan`), as
    csrc/head_step.cu `sgd_head_step_streamed` takes them."""

    kp: int  # classes rounded up to 16 (the mma's tiles); pad classes are zero
    C: int  # lp kernel: CTAs of a cluster, D cut into C runs of BK-column chunks
    n_kc: int  # BK-column chunks of D
    R: int  # corr kernel: CTAs of a cluster, the rows cut into R runs of BR-row chunks
    tiles: int  # 128-row tiles of B: the lp grid's clusters
    strips: int  # 128-column strips of D: the corr grid's clusters
    smem: int  # the lp kernel's dynamic shared memory, bytes
    smem2: int  # the corr kernel's
    resident = False

    @property
    def ctas(self) -> tuple:
        return self.tiles * self.C, self.strips * self.R


def stream_plan(B: int, D: int, k: int, dtype, C: int, R: int) -> StreamPlan:
    """The streamed design at lp clusters of C CTAs and corr clusters of R.

    Shared memory of an lp CTA: 4 stages of a 128 x BK head chunk and a kp
    x BK w chunk (rows padded by 16 bytes), then the lp of the 128 / C rows
    it owns (f32); the tile's lp part (128 x kp f32) reuses the drained
    ring.  Of a corr CTA: 4 stages of a BR x 128 head chunk and a BR x kp
    gc chunk; the strip's part (kp x 128 f32, where R > 1) reuses the ring.
    BK / BR: 64 / 64 on a bf16 head, 32 / 32 on an f32 one."""
    es = dtype.itemsize
    bk, br, pad = _S_TILES[es]
    kp = -(-k // 16) * 16
    smem = max(S_STAGES * (S_ROWS + kp) * (bk + pad) * es, 4 * S_ROWS * kp) + 4 * (S_ROWS // C) * kp
    smem2 = max(S_STAGES * br * (S_COLS + pad + kp + pad) * es, 4 * kp * S_COLS if R > 1 else 0)
    return StreamPlan(kp, C, -(-D // bk), R, -(-B // S_ROWS), -(-D // S_COLS), smem, smem2)


def streamed_plan(B: int, D: int, k: int, dtype, max_ctas: int | None = None) -> StreamPlan:
    """The streamed design's plan: C (and R) the largest of 1, 2, 4, 8 whose
    lp (corr) grid is at most `max_ctas` CTAs, one wave of the card (by
    default N_SM: a CTA of either kernel takes most of an SM's shared
    memory at the wide shapes), with no CTA left without columns (rows).

    bf16 D 16384 k 53 B 8192 (slice M): kp 64, 64 tiles x C 2 (128 CTAs,
    128 of 256 chunks of 64 columns each), 128 strips x R 1; f32 D 3072 k
    100 B 4096 (CIFAR-100): kp 112, 32 tiles x C 4, 24 strips x R 4."""
    cap = N_SM if max_ctas is None else max_ctas
    bk, br, _ = _S_TILES[dtype.itemsize]
    tiles, strips = -(-B // S_ROWS), -(-D // S_COLS)
    n_kc, n_ch = -(-D // bk), tiles * S_ROWS // br
    C = max(c for c in (1, 2, 4, 8) if c == 1 or (tiles * c <= cap and c <= n_kc))
    R = max(r for r in (1, 2, 4, 8) if r == 1 or (strips * r <= cap and r <= n_ch))
    return stream_plan(B, D, k, dtype, C, R)


def _resident_smem(bt: int, W: int, S: int, k: int, es: int, single: bool) -> int:
    return S * bt * W * es + k * W * es + (0 if single else 4 * k * W) + 4 * k * (2 * max(bt, 16) + 2 * bt)


def ctas_per_sm(smem: int, k: int) -> int:
    """CTAs of the resident kernel one SM holds: by shared memory, and at
    most 3 (k = 1) or 2 (the wider accumulators' registers)."""
    return max(1, min(3 if k == 1 else 2, SMEM_PER_SM // (smem + 1024)))


def resident_plans(B: int, D: int, k: int, dtype, max_ctas: int | None = None):
    """Every resident HeadPlan that fits shared memory: C ascending, rows
    of a tile descending, stages descending from 3 (or a cluster's tiles).
    The grid is `max_ctas` CTAs at most; by default what the card holds at
    once, N_SM x `ctas_per_sm`."""
    es = dtype.itemsize
    ve = 16 // es
    kc = 1 if k == 1 else 64 // ve  # classes of one chunk: 64 accumulators over 16 bytes of columns
    for C in (1, 2, 4, 8):
        W = -(-(-(-D // C)) // ve) * ve
        if (C - 1) * W >= D:  # an empty strip
            continue
        single = k <= kc and W // ve <= THREADS
        for bt in (32, 16, 8):
            if B % bt:
                continue
            n_tiles = B // bt
            for S in (3, 2, 1):
                smem = _resident_smem(bt, W, S, k, es, single)
                if smem > SMEM_LIMIT:
                    continue
                ctas = N_SM * ctas_per_sm(smem, k) if max_ctas is None else max_ctas
                if ctas < C:
                    continue
                tpc = -(-n_tiles // (ctas // C))
                if S <= tpc:
                    yield HeadPlan(True, bt, C, W, S, tpc, -(-n_tiles // tpc), single, smem)


def _preference(k: int):
    """The order `plan` prefers resident plans in (least first)."""
    return lambda p: (-ctas_per_sm(p.smem, k), p.C, -p.bt, -p.S)


@functools.lru_cache(maxsize=None)
def plan(B: int, D: int, k: int, dtype=torch.float32, max_ctas: int | None = None):
    """Launch parameters of K2 for a batch of B rows of a (n, D) head of
    `dtype` and k classes, or None where the kernel takes no such shape
    (B not a multiple of 8).

    The resident design splits D into C strips (C in 1, 2, 4, 8: a thread
    block cluster), W = ceil(D / C) columns rounded up to 16 bytes, and
    keeps in each CTA's shared memory, with es the head's item size:

        S * bt * W * es           the ring of S stages of bt-row tiles
        k * W * es                w's strip, in the head's type
        4 * k * W                 the corr accumulators, unless `single`: then
                                  they are registers (k within one class
                                  chunk: 1, or 64 accumulators over 16 bytes
                                  of columns; and at most 256 16-byte
                                  vectors a strip, one a thread)
        4 * k * (2 max(bt, 16) + 2 bt)
                                  the strip's parts of lp (two buffers; an
                                  8-row tile has two column segments a row),
                                  lp and gc

    which may not exceed 232448 bytes (`SMEM_LIMIT`).  Of the (C, bt, S)
    that fit, the one that puts most CTAs on an SM is taken (`ctas_per_sm`:
    a tile's steps depend on each other, and on the card other CTAs of the
    same SM hide that better than a deeper ring in one CTA:
    tools/tune_head_step.py measures every candidate), then the smallest
    C, the most rows a tile, the most stages (at most 3, and no more than
    a cluster's tiles).  The grid is persistent: `max_ctas // C` clusters
    at most (by default what the card holds at once), each walking `tpc`
    consecutive tiles, so the partial corrs are one per cluster.

    bf16 D 16384 k 1 B 8192: C 8, W 2048, bt 16, S 1 (65536 + 4096 + 256 =
    69888 bytes, three CTAs an SM), 47 clusters x 11 tiles (43 x 12 on an
    H100, which holds 43 such clusters at once); f32 D 784 k 10 B 4096: C
    1, bt 16, one tile a CTA (50176 + 31360 + 2560 = 84096 bytes, two an
    SM).  A shape no C holds (k x D large) takes the streamed design, a
    `StreamPlan` (`streamed_plan`): its scratch is w rounded (kp x D) and
    gc (B x kp), no partial corr.
    """
    if B < 8 or B % 8 or D < 1 or k < 1:
        return None
    found = list(resident_plans(B, D, k, dtype, max_ctas))
    if found:
        return min(found, key=_preference(k))
    return streamed_plan(B, D, k, dtype, max_ctas)


def supported(B: int, D: int, k: int, dtype=torch.float32, family: str = "gaussian") -> bool:
    """Shapes, types and families the Hopper kernel takes.  Poisson is
    rejected: the kernel has no poisson gradient, so a poisson fit never
    selects K2."""
    return (
        family in FAMILIES
        and dtype in _DTYPE_CODE
        and 1 <= k <= MAX_K
        and plan(B, D, k, dtype) is not None
    )


def _gradient(family: str, lp: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    if family in ("gaussian", "mgaussian"):
        return lp - yb
    if family == "binomial":
        return 1.0 / (1.0 + torch.exp(-lp)) - yb
    if family == "multinomial":
        m = torch.amax(lp, dim=1, keepdim=True)
        e = torch.exp(lp - m)
        return e / torch.sum(e, dim=1, keepdim=True) - yb
    raise ValueError(f"head kernel: unsupported family {family}")


def fused_head_step_reference(head, start: int, w_h, lp_extra, yb, g_mem_b, wb, family: str):
    """Plain torch version of the fused head step.  A bf16 head casts w
    and gc to bf16 before each product and accumulates in f32, as the
    kernel does; f32 (and f64) heads compute in their own type."""
    B = yb.shape[0]
    cdt = torch.promote_types(head.dtype, torch.float32)
    xb = head[start : start + B].to(cdt)
    wq = w_h.to(head.dtype).to(cdt)
    lp = xb @ wq.T + lp_extra.to(cdt)
    g = _gradient(family, lp, yb.to(cdt)) * wb.to(cdt)[:, None]
    gc = (g - g_mem_b.to(cdt)).to(head.dtype).to(cdt)
    return g, gc.T @ xb


#: (device, C, smem, dtype, k == 1), or a streamed plan's shape class ->
#: clusters of that shape the card holds at once
_MAX_CLUSTERS: dict = {}
#: (device, stream, what, shape, dtype) -> a scratch kept between calls (the
#: resident design's partial corrs; the streamed design's rounded w and
#: gc); one per stream, so calls of one shape on two streams share none
_SCRATCH: dict = {}
#: (device, dtype, B, D, k) -> the HeadPlan of that shape on that card
_PLANS: dict = {}


def _f32_operand(t: torch.Tensor, shape, dev) -> torch.Tensor:
    """t as the kernel reads it: f32, contiguous, on the head's device;
    converted only when it is not already so."""
    if tuple(t.shape) != shape:
        raise ValueError(f"head kernel: expected shape {shape}, got {tuple(t.shape)}")
    if t.dtype is torch.float32 and t.device == dev and t.is_contiguous():
        return t
    return t.to(device=dev, dtype=torch.float32).contiguous()


def _copy_bytes(head: torch.Tensor) -> int:
    """The widest copy every row start of the head is aligned to."""
    row = head.shape[1] * head.element_size()
    for nbytes in (16, 4):
        if row % nbytes == 0 and head.data_ptr() % nbytes == 0:
            return nbytes
    return 2


def _launch(lib, head, start, B, k, p, ptrs, family, stream, max_clusters=None) -> int:
    if not p.resident:
        return lib.sgd_head_step_streamed(
            head.data_ptr(), _DTYPE_CODE[head.dtype], int(start), head.shape[1], k, B, p.kp, p.C, p.n_kc, p.R,
            p.smem, p.smem2, _copy_bytes(head), *ptrs, _FAMILY_CODE[family], stream, max_clusters,
        )
    return lib.sgd_head_step(
        head.data_ptr(), _DTYPE_CODE[head.dtype], int(start), head.shape[1], k, B,
        p.bt, p.C, p.W, p.S, p.tpc, p.n_parts, _copy_bytes(head), int(p.single), p.smem,
        *ptrs, _FAMILY_CODE[family], stream, max_clusters,
    )


def held_clusters(head: torch.Tensor, B: int, k: int, p: HeadPlan) -> int:
    """Clusters of p's shape (C CTAs of p.smem bytes) the card holds at
    once: asked of the CUDA occupancy calculator once per shape class,
    then remembered."""
    key = (head.device, p.C, p.smem, head.dtype, k == 1)
    if key not in _MAX_CLUSTERS:
        out = ctypes.c_int(0)
        code = _launch(build.load_library(), head, 0, B, k, p, (None,) * 8, "gaussian", None, ctypes.byref(out))
        build.check(code, "fused head step (occupancy)")
        if out.value < 1:
            raise RuntimeError(f"fused head step: the card holds no cluster of {p.C} CTAs with {p.smem} bytes each")
        _MAX_CLUSTERS[key] = out.value
    return _MAX_CLUSTERS[key]


def plans_on_card(head: torch.Tensor, B: int, k: int, p: HeadPlan) -> list:
    """The resident plans whose persistent grid the card holds at once, so
    that no cluster waits for another: p alone where its grid fits, else
    every resident plan on a grid cut to the clusters of p's shape the card
    holds (p's own (C, bt, S) is always among them)."""
    held = held_clusters(head, B, k, p)
    if p.n_parts <= held:
        return [p]
    return list(resident_plans(B, head.shape[1], k, head.dtype, max_ctas=held * p.C))


def held_stream_clusters(head: torch.Tensor, B: int, k: int, p: StreamPlan) -> tuple:
    """Clusters of p's lp kernel (C CTAs of p.smem bytes) and of its corr
    kernel (R CTAs of p.smem2) the card holds at once: asked of the CUDA
    occupancy calculator once per shape class, then remembered."""
    key = (head.device, "streamed", p.C, p.smem, p.R, p.smem2, head.dtype)
    if key not in _MAX_CLUSTERS:
        out = (ctypes.c_int * 2)()
        code = _launch(build.load_library(), head, 0, B, k, p, (None,) * 9, "gaussian", None, out)
        build.check(code, "fused head step (occupancy)")
        _MAX_CLUSTERS[key] = (out[0], out[1])
    return _MAX_CLUSTERS[key]


def stream_plan_on_card(head: torch.Tensor, B: int, k: int, p: StreamPlan) -> StreamPlan:
    """p with its clusters halved until each grid is one wave of what the
    card holds at once (or its clusters are single CTAs); raises where the
    card holds not even one cluster of single CTAs."""
    while True:
        held_lp, held_corr = held_stream_clusters(head, B, k, p)
        C = p.C // 2 if p.C > 1 and p.tiles > held_lp else p.C
        R = p.R // 2 if p.R > 1 and p.strips > held_corr else p.R
        if (C, R) == (p.C, p.R):
            if min(held_lp, held_corr) < 1:
                raise RuntimeError(f"fused head step: the card holds no CTA of {p}")
            return p
        p = stream_plan(B, head.shape[1], k, head.dtype, C, R)


def device_plan(head: torch.Tensor, B: int, k: int):
    """`plan` for this head on its card: the preferred of `plans_on_card`,
    or the streamed plan cut to the card (`stream_plan_on_card`)."""
    p = plan(B, head.shape[1], k, head.dtype)
    if p is None:
        return p
    if not p.resident:
        return stream_plan_on_card(head, B, k, p)
    return min(plans_on_card(head, B, k, p), key=_preference(k))


def _scratch(dev, stream, what: str, shape, dtype) -> torch.Tensor:
    key = (dev, stream, what, shape, dtype)
    t = _SCRATCH.get(key)
    if t is None:
        t = _SCRATCH[key] = torch.empty(shape, device=dev, dtype=dtype)
    return t


def head_step_with(p, head, start: int, w_h, lp_extra, yb, g_mem_b, wb, family: str):
    """Launch K2 on a CUDA head with the launch parameters p (a HeadPlan
    that fits this card: `device_plan`, or one of `plans_on_card`; or a
    StreamPlan); returns (g (B, k), corr (k, D)), f32."""
    n_pad, D = head.shape
    B, k = yb.shape
    dev = head.device
    if not (0 <= start and start + B <= n_pad):
        raise ValueError(f"head kernel: rows [{start}, {start + B}) outside the head's {n_pad} rows")
    if not head.is_contiguous():
        raise ValueError("head kernel: the head must be contiguous")
    w = _f32_operand(w_h, (k, D), dev)
    lpe = _f32_operand(lp_extra, (B, k), dev)
    y = _f32_operand(yb, (B, k), dev)
    gm = _f32_operand(g_mem_b, (B, k), dev)
    wt = _f32_operand(wb, (B,), dev)
    g = torch.empty((B, k), device=dev, dtype=torch.float32)
    corr = torch.empty((k, D), device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (w.data_ptr(), lpe.data_ptr(), y.data_ptr(), gm.data_ptr(), wt.data_ptr(), g.data_ptr())
    if not p.resident:
        w_r = _scratch(dev, stream, "w_r", (p.kp, p.n_kc * _S_TILES[head.element_size()][0]), head.dtype)
        gc = _scratch(dev, stream, "gc", (p.tiles * S_ROWS, p.kp + _S_TILES[head.element_size()][2]), head.dtype)
        ptrs += (corr.data_ptr(), w_r.data_ptr(), gc.data_ptr())
    else:
        part = corr if p.n_parts == 1 else _scratch(dev, stream, "part", (p.n_parts, k, D), torch.float32)
        ptrs += (part.data_ptr(), corr.data_ptr())
    code = _launch(build.load_library(), head, start, B, k, p, ptrs, family, stream)
    build.check(code, "fused head step")
    fused_head_step_at.launches += 1
    return g, corr


def fused_head_step_at(head, start: int, w_h, lp_extra, yb, g_mem_b, wb, family: str):
    """Fused lp / gradient / corr on rows [start, start+B) of the full
    head; returns (g (B, k), corr (k, D)), f32 on the card."""
    if not head.is_cuda:
        return fused_head_step_reference(head, start, w_h, lp_extra, yb, g_mem_b, wb, family)
    B, k = yb.shape
    if head.dtype not in _DTYPE_CODE or family not in _FAMILY_CODE:
        raise ValueError(f"head kernel takes f32/bf16 heads and {FAMILIES}; got {head.dtype}, {family}")
    key = (head.device, head.dtype, B, head.shape[1], k)
    p = _PLANS.get(key)
    if p is None:
        if not supported(B, head.shape[1], k, head.dtype, family):
            raise ValueError(f"head kernel: unsupported shape B={B}, D={head.shape[1]}, k={k}")
        p = _PLANS[key] = device_plan(head, B, k)
    return head_step_with(p, head, start, w_h, lp_extra, yb, g_mem_b, wb, family)


#: kernel launches since the last reset (the twin never counts)
fused_head_step_at.launches = 0
