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

import torch

from sgdnet_tpu_torch.utils import build

#: families with a K2 gradient (poisson has none, as in the JAX kernel)
FAMILIES = ("gaussian", "binomial", "multinomial", "mgaussian")
_FAMILY_CODE = {"gaussian": 0, "binomial": 1, "multinomial": 3, "mgaussian": 4}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: class count limit (the JAX kernel pads k to at most 128 lanes)
MAX_K = 128


def pick_bt(B: int):
    """Rows per CTA: 32 when the batch allows it (B = 4096 -> 128 CTAs,
    about one per SM), else the largest of 16 / 8 dividing B."""
    for bt in (32, 16, 8):
        if B % bt == 0:
            return bt
    return None


def supported(B: int, D: int, k: int, dtype=torch.float32, family: str = "gaussian") -> bool:
    """Shapes, types and families the Hopper kernel takes.  Poisson is
    rejected: the kernel has no poisson gradient, so a poisson fit never
    selects K2."""
    return (
        family in FAMILIES
        and dtype in _DTYPE_CODE
        and 1 <= k <= MAX_K
        and D >= 1
        and pick_bt(B) is not None
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


def fused_head_step_at(head, start: int, w_h, lp_extra, yb, g_mem_b, wb, family: str):
    """Fused lp / gradient / corr on rows [start, start+B) of the full
    head; returns (g (B, k), corr (k, D)), f32 on the card."""
    if not head.is_cuda:
        return fused_head_step_reference(head, start, w_h, lp_extra, yb, g_mem_b, wb, family)
    n_pad, D = head.shape
    B, k = yb.shape
    if head.dtype not in _DTYPE_CODE or family not in _FAMILY_CODE:
        raise ValueError(f"head kernel takes f32/bf16 heads and {FAMILIES}; got {head.dtype}, {family}")
    if not supported(B, D, k, head.dtype, family):
        raise ValueError(f"head kernel: unsupported shape B={B}, D={D}, k={k}")
    if not (0 <= start and start + B <= n_pad):
        raise ValueError(f"head kernel: rows [{start}, {start + B}) outside the head's {n_pad} rows")
    if not head.is_contiguous():
        raise ValueError("head kernel: the head must be contiguous")
    dev = head.device

    def f32(t, shape):
        t = t.to(device=dev, dtype=torch.float32).contiguous()
        if tuple(t.shape) != shape:
            raise ValueError(f"head kernel: expected shape {shape}, got {tuple(t.shape)}")
        return t

    w = f32(w_h, (k, D))
    lpe = f32(lp_extra, (B, k))
    y = f32(yb, (B, k))
    gm = f32(g_mem_b, (B, k))
    wt = f32(wb, (B,))
    bt = pick_bt(B)
    g = torch.empty((B, k), device=dev, dtype=torch.float32)
    part = torch.empty((B // bt, k, D), device=dev, dtype=torch.float32)
    corr = torch.empty((k, D), device=dev, dtype=torch.float32)
    lib = build.load_library()
    code = lib.sgd_head_step(
        head.data_ptr(), _DTYPE_CODE[head.dtype], int(start), D, k, B, bt,
        w.data_ptr(), lpe.data_ptr(), y.data_ptr(), gm.data_ptr(), wt.data_ptr(),
        _FAMILY_CODE[family], g.data_ptr(), part.data_ptr(), corr.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(code, "fused head step")
    fused_head_step_at.launches += 1
    return g, corr


#: kernel launches since the last reset (the twin never counts)
fused_head_step_at.launches = 0
