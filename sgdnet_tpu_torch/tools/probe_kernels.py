"""P1-P3: the measurement probes' kernels (csrc/probes.cu), with their
plain torch twins and launch counters.

  * `epoch_probe` (P1, twin of tools/bench_epoch_kernel.py `run_pallas`):
    one gaussian SAGA epoch of the single-block prototype of K1, state
    updated in place, on K1's design (a ring of prefetched blocks in shared
    memory, the launch shape of K1's `plan`: `epoch_probe_plan`);
  * `block_colsum` (P2, twin of tools/bench_pallas_dma.py `mk_reduce`): f32
    column sums of rows [start, start + B) of a bf16 head, in bt-row tiles;
  * `block_colsum_pipelined` (P3, twin of tools/bench_dma_streams.py `mk`):
    the same sums through a ring of n_buf asynchronous copies of chunk_rows
    rows each: TMA stages fed by one producer thread, over a grid that
    covers the card evenly (`pipeline_plan`).

On CUDA tensors each launches its kernel on the current stream and raises
if the launch is refused; on CPU tensors each runs its plain torch
version.  Nothing falls back: a CUDA input the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from sgdnet_tpu_torch.solver import epoch_kernel as ek
from sgdnet_tpu_torch.solver.epoch_kernel import SMEM_LIMIT
from sgdnet_tpu_torch.utils import build

#: P1's step size and penalties, fixed in its body (tools/bench_epoch_kernel.py:39-41)
GAMMA, L1, L2 = np.float32(3e-3), np.float32(1e-3), np.float32(1e-4)
#: lane padding of P1's (N, 8) and (8, P) arrays
LANES = 8
#: P3's consumer threads and all its threads (8 consumer warps, a producer
#: warp: csrc/probes.cu P3_CONSUMERS, P3_THREADS); a TMA box's most rows
_P3_CONSUMERS, _P3_THREADS, _BOX_MAX = 256, 288, 256
#: an H100 SM's shared memory and threads for its CTAs, and the shared
#: memory the runtime keeps a CTA: P3's default CTAs an SM off the card
_SM_SMEM, _SM_THREADS, _CTA_RESERVED = 233472, 2048, 1024
#: ring depths the P3 launcher is instantiated for (those of the TPU probe's configs)
RING_DEPTHS = (2, 4, 8)


def epoch_probe_reference(starts, x, y, wt, w, g_mem, g_sum, batch: int):
    """Plain torch P1: the step loop of `run_xla` (bench_epoch_kernel.py
    :102-129) over one epoch's block starts, updating w, g_mem and g_sum in
    place; returns them."""
    # the update's constants rounded as the f32 kernel computes them
    shrink, thr, g32 = float(np.float32(1) - GAMMA * L2), float(GAMMA * L1), float(GAMMA)
    n = float(x.shape[0])
    for s in torch.as_tensor(starts).tolist():
        rows = slice(s, s + batch)
        xb = x[rows]
        lp = torch.sum(xb * w[0:1], dim=1, keepdim=True)
        g = (lp - y[rows, 0:1]) * wt[rows, 0:1]
        gc = g - g_mem[rows, 0:1]
        g_mem[rows, 0:1] = g
        corr = torch.sum(xb * gc, dim=0, keepdim=True)
        w_half = w[0:1] * shrink - g32 * (corr / float(batch) + g_sum[0:1])
        w[0:1] = torch.sign(w_half) * torch.clamp(torch.abs(w_half) - thr, min=0.0)
        g_sum[0:1] += corr / n
    return w, g_mem, g_sum


def epoch_probe_smem_floats(B: int, P: int, stages: int, groups: int) -> int:
    """P1's shared memory in floats: csrc/probes.cu `p1_smem_floats`, the
    same expression (the ring's slots of x, y and wt, w, g_sum, gc, the
    column groups' partials, the ring of 8 starts)."""
    return stages * (B * P + 2 * B) + 2 * P + B + (groups > 1) * groups * P + 8


def epoch_probe_plan(P: int, batch: int) -> tuple[int, int, int, int]:
    """P1's launch, (threads, lanes a row, column groups, ring stages): the
    lane mapping of K1's `plan` at (p = P, k = 1, B = batch), and the deepest
    ring (3, else 2 stages) that fits one CTA's shared memory.  Raises for
    shapes the kernel does not take (P not a multiple of 4, an odd batch,
    more than RMAX rows a row slot, no ring that fits)."""
    if P % 4 or batch < 2 or batch % 2:
        raise ValueError(f"epoch_probe: P={P} must be a multiple of 4 and batch={batch} even")
    pl = ek.plan(P, 1, batch)
    if pl.rows <= ek.RMAX:
        for stages in (3, 2):
            if 4 * epoch_probe_smem_floats(batch, P, stages, pl.groups) <= SMEM_LIMIT:
                return pl.threads, pl.lanes, pl.groups, stages
    raise ValueError(f"epoch_probe: no ring of blocks fits one CTA at P={P}, batch={batch}")


def epoch_probe(starts, x, y, wt, w, g_mem, g_sum, batch: int):
    """P1: one epoch over `starts` (T block starts), x (N, P), y / wt / g_mem
    (N, 8), w / g_sum (8, P), f32; lane / row 0 is the model.  Updates w,
    g_mem and g_sum in place (the TPU probe aliases them) and returns them."""
    if not x.is_cuda:
        return epoch_probe_reference(starts, x, y, wt, w, g_mem, g_sum, batch)
    N, P = x.shape
    dev = x.device
    shapes = {"x": (x, (N, P)), "y": (y, (N, LANES)), "wt": (wt, (N, LANES)), "w": (w, (LANES, P)),
              "g_mem": (g_mem, (N, LANES)), "g_sum": (g_sum, (LANES, P))}
    for name, (t, shape) in shapes.items():
        if t.dtype != torch.float32 or t.device != dev or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"epoch_probe: {name} must be a contiguous f32 {shape} tensor on {dev}")
    if starts.dtype != torch.int32 or starts.device != dev or starts.ndim != 1 or not starts.is_contiguous():
        raise ValueError(f"epoch_probe: starts must be a contiguous int32 vector on {dev}")
    if batch < 1 or N % batch != 0 or x.data_ptr() % 16:
        raise ValueError(f"epoch_probe: unsupported N={N}, batch={batch} (or x not on 16 bytes)")
    threads, lanes, groups, stages = epoch_probe_plan(P, batch)
    code = build.load_library().sgd_epoch_probe(
        starts.data_ptr(), starts.shape[0], batch, x.data_ptr(), P, N, y.data_ptr(), wt.data_ptr(),
        w.data_ptr(), g_mem.data_ptr(), g_sum.data_ptr(), threads, lanes, groups, stages,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(code, "epoch_probe")
    epoch_probe.launches += 1
    return w, g_mem, g_sum


def block_colsum_reference(head, start: int, batch: int, bt: int) -> torch.Tensor:
    """Plain torch P2 / P3: head[start:start+B].float().sum(0), taken in
    bt-row tiles added in tile order; (D,) f32."""
    D = head.shape[1]
    parts = head[start : start + batch].float().reshape(batch // bt, bt, D).sum(dim=1)
    out = parts[0].clone()
    for t in range(1, parts.shape[0]):
        out += parts[t]
    return out


def _check_block(head, start: int, batch: int, tile: int, what: str) -> None:
    n, D = head.shape
    if head.dtype != torch.bfloat16 or not head.is_contiguous():
        raise ValueError(f"{what}: takes a contiguous bf16 head, got {head.dtype}")
    if tile < 1 or batch % tile != 0:
        raise ValueError(f"{what}: {tile}-row tiles do not divide B={batch}")
    if not 0 <= start <= n - batch:
        raise ValueError(f"{what}: rows [{start}, {start + batch}) outside the head's {n} rows")


def block_colsum(head, start: int, batch: int, bt: int) -> torch.Tensor:
    """P2: f32 column sums of head[start:start+B] (bf16, (n, D), D even),
    one CTA per (512-column strip, bt-row tile) and an in-order sum of the
    tiles' partial rows; (D,) f32."""
    if not head.is_cuda:
        return block_colsum_reference(head, start, batch, bt)
    _check_block(head, start, batch, bt, "block_colsum")
    D = head.shape[1]
    if D % 2 != 0:
        raise ValueError(f"block_colsum: D={D} must be even (bf16x2 loads)")
    dev = head.device
    part = torch.empty((batch // bt, D), dtype=torch.float32, device=dev)
    out = torch.empty((D,), dtype=torch.float32, device=dev)
    code = build.load_library().sgd_block_colsum(head.data_ptr(), int(start), D, batch, bt, part.data_ptr(),
                                                 out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "block_colsum")
    block_colsum.launches += 1
    return out


def pipeline_smem_bytes(n_buf: int, rows: int, W: int, groups: int) -> int:
    """P3's shared memory in bytes: csrc/probes.cu `p3_smem_bytes`, the same
    expression (n_buf stages of rows x W bf16, the consumers' groups x W f32
    reduction rows, a full and an empty mbarrier a slot)."""
    return n_buf * rows * W * 2 + groups * W * 4 + n_buf * 16


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """P3's launch: strips of `width` columns (the last may be partial), a
    strip's `chunks` stages of chunk_rows rows landed as `boxes` TMA boxes of
    `box_rows` rows, `groups` consumer row groups, `smem` bytes a CTA;
    `grid` CTAs (`ctas_per_sm` on each of `sms` SMs, at most one a stage)
    stream the `stages` = strips x chunks, `rounds` whole strips each and
    then the strips left (`pipeline_deal`), `stages_per_cta` (min, max);
    `pieces` rows of partial sums (the most CTAs a leftover strip is dealt
    to)."""

    width: int
    strips: int
    chunks: int
    box_rows: int
    boxes: int
    groups: int
    smem: int
    sms: int
    ctas_per_sm: int
    grid: int
    rounds: int
    stages: int
    stages_per_cta: tuple[int, int]
    pieces: int


def pipeline_cta_of(u: int, left: int, grid: int) -> int:
    """The CTA whose run holds leftover stage u when `left` stages are dealt
    in contiguous runs over `grid` CTAs, CTA g taking [left g / grid,
    left (g + 1) / grid): csrc/probes.cu `p3_cta_of`."""
    return ((u + 1) * grid + left - 1) // left - 1


def pipeline_deal(plan: PipelinePlan, g: int) -> list[tuple[int, int, int, bool]]:
    """CTA g's stages in the order it streams them, as (strip, chunk, the
    partial row its piece lands in, whether its piece ends there):
    csrc/probes.cu `p3_stage`.  In round i < rounds it streams strip
    i grid + g whole (one piece, row 0); then its contiguous run [R C g /
    grid, R C (g + 1) / grid) of the R strips left, strip-major, a piece
    for each strip the run meets, in row g - (the CTA of the strip's first
    stage)."""
    G, C, q = plan.grid, plan.chunks, plan.rounds
    left = (plan.strips - q * G) * C
    out = [(i * G + g, c, 0, c == C - 1) for i in range(q) for c in range(C)]
    end = left * (g + 1) // G
    for u in range(left * g // G, end):
        s, c = divmod(u, C)
        out.append((q * G + s, c, g - pipeline_cta_of(s * C, left, G), c == C - 1 or u + 1 == end))
    return out


@functools.lru_cache(maxsize=256)
def pipeline_plan(n_buf: int, chunk_rows: int, D: int, batch: int, sms: int,
                  ctas_per_sm: int | None = None) -> PipelinePlan | None:
    """P3's plan at (n_buf, chunk_rows) for a bf16 (n, D) head and blocks of
    `batch` rows on a card of `sms` SMs (the dealing: `pipeline_deal`).  W
    is the widest multiple of 16 columns (a 32-byte sector a row), at most
    256 (a TMA box) and at most D, whose n_buf stages and reduction rows
    fit one CTA (SMEM_LIMIT), evened out over the strips it makes;
    `ctas_per_sm` defaults to what the SM's shared memory and threads hold
    (the wrapper passes the device's own count).  None when no width fits;
    raises for shapes the kernel never takes (a ring depth it is not built
    for, D not a multiple of 8, chunks that do not tile B, boxes off
    128-byte boundaries)."""
    if n_buf not in RING_DEPTHS:
        raise ValueError(f"pipeline_plan: n_buf={n_buf} is not one of {RING_DEPTHS}")
    if D < 8 or D % 8 or chunk_rows < 1 or batch % chunk_rows:
        raise ValueError(f"pipeline_plan: D={D} must be a multiple of 8 and {chunk_rows}-row chunks tile B={batch}")
    boxes = -(-chunk_rows // _BOX_MAX)
    box_rows = chunk_rows // boxes
    if chunk_rows % boxes or box_rows % 4:
        raise ValueError(f"pipeline_plan: {chunk_rows}-row chunks do not split into equal boxes of at most "
                         f"{_BOX_MAX} rows, a multiple of 4 (every box on a 128-byte boundary)")
    groups_of = lambda w: _P3_CONSUMERS // (w // 8)  # noqa: E731
    fits = [w for w in range(16, min(_BOX_MAX, D) + 1, 16)
            if pipeline_smem_bytes(n_buf, chunk_rows, w, groups_of(w)) <= SMEM_LIMIT]
    if not fits:
        return None
    strips = -(-D // fits[-1])
    W = -(-(-(-D // strips)) // 16) * 16  # the same strips, evened out
    smem = pipeline_smem_bytes(n_buf, chunk_rows, W, groups_of(W))
    if ctas_per_sm is None:
        ctas_per_sm = min(_SM_SMEM // (smem + _CTA_RESERVED), _SM_THREADS // _P3_THREADS)
    chunks = batch // chunk_rows
    stages = strips * chunks
    grid = max(1, min(sms * ctas_per_sm, stages))
    rounds = strips // grid
    left = (strips - rounds * grid) * chunks  # the leftover strips' stages, dealt in runs
    pieces = max([pipeline_cta_of(s + chunks - 1, left, grid) - pipeline_cta_of(s, left, grid) + 1
                  for s in range(0, left, chunks)], default=1)
    return PipelinePlan(W, strips, chunks, box_rows, boxes, groups_of(W), smem, sms, ctas_per_sm, grid, rounds,
                        stages, (rounds * chunks + left // grid, rounds * chunks + -(-left // grid)), pieces)


@functools.lru_cache(maxsize=64)
def _device_plan(index: int, n_buf: int, chunk_rows: int, D: int, batch: int) -> PipelinePlan | None:
    """`pipeline_plan` with the SM count and the CTAs an SM holds read from
    card `index` (the occupancy of the kernel at the plan's shared memory)."""
    plan = pipeline_plan(n_buf, chunk_rows, D, batch, 1)
    if plan is None:
        return None
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    ctas = ctypes.c_int(0)
    with torch.cuda.device(index):
        build.check(build.load_library().sgd_colsum_pipelined_occupancy(n_buf, plan.smem, ctypes.byref(ctas)),
                    "block_colsum_pipelined occupancy")
    if ctas.value < 1:
        raise RuntimeError(f"block_colsum_pipelined: no CTA of {plan.smem} bytes fits an SM")
    return pipeline_plan(n_buf, chunk_rows, D, batch, sms, ctas.value)


def launch_plan(dev: torch.device, n_buf: int, chunk_rows: int, D: int, batch: int) -> PipelinePlan | None:
    """The plan `block_colsum_pipelined` launches with on CUDA device `dev`."""
    dev = torch.device(dev)
    return _device_plan(torch.cuda.current_device() if dev.index is None else dev.index, n_buf, chunk_rows, D,
                        batch)


def block_colsum_pipelined(head, start: int, batch: int, n_buf: int, chunk_rows: int) -> torch.Tensor:
    """P3: the same column sums as `block_colsum`, streamed by a grid that
    covers the card evenly, each CTA through a ring of n_buf TMA stages of
    chunk_rows rows (`launch_plan`), then its pieces added in a fixed order;
    (D,) f32.  Raises when no strip width fits or the head is not 16-byte
    aligned."""
    if not head.is_cuda:
        return block_colsum_reference(head, start, batch, chunk_rows)
    _check_block(head, start, batch, chunk_rows, "block_colsum_pipelined")
    n, D = head.shape
    plan = launch_plan(head.device, n_buf, chunk_rows, D, batch)
    if plan is None or head.data_ptr() % 16 != 0:
        raise ValueError(f"block_colsum_pipelined: unsupported n_buf={n_buf}, chunk_rows={chunk_rows}, D={D} "
                         f"(no strip width fits one CTA, or the head is not 16-byte aligned)")
    dev = head.device
    part = torch.empty((plan.pieces, D), dtype=torch.float32, device=dev)
    out = torch.empty((D,), dtype=torch.float32, device=dev)
    code = build.load_library().sgd_block_colsum_pipelined(
        head.data_ptr(), n, int(start), D, batch, n_buf, chunk_rows, plan.width, plan.box_rows, plan.grid,
        plan.pieces, part.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(code, "block_colsum_pipelined")
    block_colsum_pipelined.launches += 1
    return out


def pipeline_encode_ns(head, n_buf: int, chunk_rows: int, batch: int, reps: int = 200) -> float:
    """Mean host ns of one tensor-map encode of `head` at P3's plan (CUDA
    only): the host time each call spends on its map."""
    n, D = head.shape
    plan = launch_plan(head.device, n_buf, chunk_rows, D, batch)
    ns = ctypes.c_double(0.0)
    build.check(build.load_library().sgd_colsum_pipelined_encode_ns(
        head.data_ptr(), n, D, plan.width, plan.box_rows, reps, ctypes.byref(ns)), "tensor-map encode")
    return ns.value


#: kernel launches since the last reset (the twins never count)
epoch_probe.launches = 0
block_colsum.launches = 0
block_colsum_pipelined.launches = 0
