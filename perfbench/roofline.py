"""The least time a kernel's work can take on the card, from the shapes of
the work the step needs, whatever implements it.

Each count reads every input byte once and writes every output byte once
(4-byte indices and float32 operands; the head in its own type), and the
bound is the larger of bytes over the memory rate and operations over
the peak rate of their type.  A roofline share is that bound over the
device time the kernel took.
"""

from __future__ import annotations

#: NVIDIA H100 SXM (NVIDIA's data sheet; dense rates at the 700 W limit):
#: HBM3 bytes/s, and FLOP/s of bf16 tensor cores and of float32 outside them
PEAK = {"hbm_bytes_per_s": 3.35e12, "bf16_flops": 989e12, "f32_flops": 67e12}


def bound_s(nbytes: float, flops: float, flops_peak: float) -> float:
    """Seconds: the larger of bytes over the memory rate and operations over
    `flops_peak`."""
    return max(nbytes / PEAK["hbm_bytes_per_s"], flops / flops_peak)


def head_step(B: int, D: int, k: int, head_itemsize: int) -> float:
    """K2, one step on the head (either design): the B x D block read once,
    w (k, D) read, lp_extra, y, g_mem (B, k) and the row weights read, g
    (B, k) and corr (k, D) written; 4 B D k operations (two products) on
    bf16 tensor cores for a bf16 head, else in float32."""
    nbytes = B * D * head_itemsize + 4 * (2 * k * D + 4 * B * k + B)
    peak = PEAK["bf16_flops"] if head_itemsize == 2 else PEAK["f32_flops"]
    return bound_s(nbytes, 4 * B * D * k, peak)


def tail_forward(entries: int, columns: int, B: int, k: int) -> float:
    """K3, one block: each true entry's row, column and value once, the
    touched columns of w (k each) once, the (B, k) output once; 2 k
    operations an entry."""
    return bound_s(12 * entries + 4 * columns * k + 4 * B * k, 2 * k * entries, PEAK["f32_flops"])


def tail_outer(entries: int, B: int, p: int, k: int) -> float:
    """K4, one block: each true entry once, gc (B, k) read once, the (k, p)
    corr written once; 2 k operations an entry."""
    return bound_s(12 * entries + 4 * B * k + 4 * p * k, 2 * k * entries, PEAK["f32_flops"])
