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
    rows each.

On CUDA tensors each launches its kernel on the current stream and raises
if the launch is refused; on CPU tensors each runs its plain torch
version.  Nothing falls back: a CUDA input the kernel does not take raises.
"""

from __future__ import annotations

import numpy as np
import torch

from sgdnet_tpu_torch.solver import epoch_kernel as ek
from sgdnet_tpu_torch.solver.epoch_kernel import SMEM_LIMIT
from sgdnet_tpu_torch.utils import build

#: P1's step size and penalties, fixed in its body (tools/bench_epoch_kernel.py:39-41)
GAMMA, L1, L2 = np.float32(3e-3), np.float32(1e-3), np.float32(1e-4)
#: lane padding of P1's (N, 8) and (8, P) arrays
LANES = 8
#: threads of a P3 CTA (csrc/probes.cu CT); its reduction buffer is CT float2
_CT = 256
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


def pipeline_strip_width(n_buf: int, chunk_rows: int, D: int) -> int | None:
    """P3's strip width W: the widest power of two in [8, 512] that divides
    D and lets n_buf stages of chunk_rows x W bf16 (plus the CTA's reduction
    buffer) fit one CTA's shared memory; None when no width fits."""
    w = 512
    while w >= 8:
        if D % w == 0 and n_buf * chunk_rows * w * 2 + _CT * 8 <= SMEM_LIMIT:
            return w
        w //= 2
    return None


def block_colsum_pipelined(head, start: int, batch: int, n_buf: int, chunk_rows: int) -> torch.Tensor:
    """P3: the same column sums as `block_colsum`, each CTA streaming its
    column strip through a ring of n_buf cp.async stages of chunk_rows rows;
    (D,) f32.  Raises when no strip width fits (`pipeline_strip_width`)."""
    if not head.is_cuda:
        return block_colsum_reference(head, start, batch, chunk_rows)
    _check_block(head, start, batch, chunk_rows, "block_colsum_pipelined")
    D = head.shape[1]
    W = pipeline_strip_width(n_buf, chunk_rows, D)
    if n_buf not in RING_DEPTHS or W is None or head.data_ptr() % 16 != 0:
        raise ValueError(f"block_colsum_pipelined: unsupported n_buf={n_buf}, chunk_rows={chunk_rows}, D={D} "
                         f"(strip width {W}; 16-byte aligned head required)")
    dev = head.device
    out = torch.empty((D,), dtype=torch.float32, device=dev)
    code = build.load_library().sgd_block_colsum_pipelined(
        head.data_ptr(), int(start), D, batch, n_buf, chunk_rows, W, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(code, "block_colsum_pipelined")
    block_colsum_pipelined.launches += 1
    return out


#: kernel launches since the last reset (the twins never count)
epoch_probe.launches = 0
block_colsum.launches = 0
block_colsum_pipelined.launches = 0
