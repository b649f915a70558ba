"""K2's streamed design at the many-class shapes, against its twin and timed.

    python -m sgdnet_tpu_torch.tools.bench_head_streamed [--seed N] [--shapes M,CIFAR]

Timed shapes (multinomial, w scaled so lp is O(1)):

  * M: slice M's head step, a bf16 head of 106496 x 16384 (slice C's
    padded rows at the north star's head width), k 53 (LIBSVM
    rcv1.multiclass), B 8192;
  * CIFAR: CIFAR-100's shape, an f32 head of 53248 x 3072, k 100, B 4096.

`run_shape` holds the launch against `fused_head_step_reference` with
identical bits over two launches.  The twin rounds w and gc to the head's
type as the kernels do, so only the order of the f32 sums differs; the
bounds follow that gap: bf16 max|dg| <= 1e-4 x max(max|g|, 1) and
max|dcorr| <= 1e-3 x max|corr| (the gaps read on the card are in PERF.md
section 6), f32 max|dg| <= 1e-5 and max|dcorr| <= 2e-3 (chip_smoke.py
phase 3's).  It checks that
a profile shows each of the streamed design's kernels (where `plan` keeps
a shape resident, the streamed design runs through its own plan).  Timed,
it adds ms a call (CUDA events over back-to-back calls cycling over the
head's blocks, so that no call finds its block in L2), ms on the device
(torch.profiler: each kernel's time a launch, and their sum), the plain
twin, the two `torch.mm` products of the same operands (TF32 off), the
bound (the block, w and the (B, k) operands read once, g and corr written
once, against the products at the type's peak) and the card's name and
power limit.  Prints one JSON line a timed shape.  CUDA only: without a
card it raises.
"""

from __future__ import annotations

import argparse
import itertools
import json

import torch

from sgdnet_tpu_torch.solver import head_kernel as hk
from sgdnet_tpu_torch.tools.profile_sparse_slices import cuda_ms
from sgdnet_tpu_torch.utils.device import card_line

#: H100 SXM peaks (NVIDIA's data sheet): device memory, FP32 outside the
#: tensor cores, dense bf16 tensor cores
HBM_BYTES_PER_S, F32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12
#: name -> (family, n_pad, B, D, k, dtype): the timed shapes
SHAPES = {"M": ("multinomial", 106496, 8192, 16384, 53, torch.bfloat16),
          "CIFAR": ("multinomial", 53248, 4096, 3072, 100, torch.float32)}
#: the streamed design's checked shapes (chip_smoke.py phase 3): k just
#: past the resident limit at D 16384, slice M's 53 classes, MAX_K, an
#: elementwise family, CIFAR-100's, f32 rows only 4-byte aligned (D 785,
#: which `plan` keeps resident) and a B only 8 divides
CASES = [("multinomial", 16384, 8192, 16384, 17, torch.bfloat16),
         ("multinomial", 16384, 8192, 16384, 53, torch.bfloat16),
         ("multinomial", 16384, 8192, 16384, 128, torch.bfloat16),
         ("mgaussian", 16384, 8192, 16384, 53, torch.bfloat16),
         ("multinomial", 8192, 4096, 3072, 100, torch.float32),
         ("multinomial", 2064, 1032, 785, 128, torch.float32),
         ("binomial", 2064, 1032, 4096, 128, torch.bfloat16)]


def device_by_kernel(fn, reps: int, names=hk.STREAMED_KERNELS) -> dict:
    """ms a launch of each kernel in `names` over `reps` calls of fn
    (torch.profiler after a warm-up; None for a kernel it saw no time of)."""
    from torch.profiler import ProfilerActivity, profile

    from sgdnet_tpu_torch.utils.profiling import device_kernels, self_device_us

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names)
    for e in device_kernels(prof):
        for nm in names:
            if nm in e.key:
                out[nm] = (out[nm] or 0.0) + self_device_us(e) / e.count / 1e3
    return out


def bound(B: int, D: int, k: int, dtype) -> dict:
    """The least time of one step: the block, w and the (B, k) operands read
    once, g and corr written once, or the 4 B D k operations at the type's
    peak, whichever is longer."""
    nbytes = B * D * dtype.itemsize + 4 * (2 * k * D + 4 * B * k + B)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4 * B * D * k / (BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
    return {"bound_ms": 1e3 * max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def run_shape(dev, seed: int, family: str, n_pad: int, B: int, D: int, k: int, dtype, timed: bool = True,
              reps: int = 20) -> dict:
    """The streamed design on a seeded (n_pad, D) head at its last block:
    checked (see the module's note); timed where `timed`."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    head = torch.randn((n_pad, D), generator=gen, device=dev).to(dtype)
    w = torch.randn((k, D), generator=gen, device=dev) / D**0.5
    lpe = 0.1 * torch.randn((B, k), generator=gen, device=dev)
    if family == "multinomial":
        y = torch.nn.functional.one_hot(torch.randint(0, k, (B,), generator=gen, device=dev), k).float()
    elif family == "binomial":
        y = (torch.rand((B, k), generator=gen, device=dev) < 0.5).float()
    else:
        y = torch.randn((B, k), generator=gen, device=dev)
    gm = 0.1 * torch.randn((B, k), generator=gen, device=dev)
    wb = (torch.rand((B,), generator=gen, device=dev) < 0.9).float()
    last = n_pad - B
    args = (head, last, w, lpe, y, gm, wb, family)
    p = hk.device_plan(head, B, k)
    planned = not p.resident
    if not planned:
        p = hk.stream_plan_on_card(head, B, k, hk.streamed_plan(B, D, k, dtype))

    def step(h, s, *rest):
        return hk.head_step_with(p, h, s, *rest)

    g, corr = step(*args)
    g2, corr2 = step(*args)
    g_ref, corr_ref = hk.fused_head_step_reference(*args)
    same = torch.equal(g, g2) and torch.equal(corr, corr2)
    if planned:  # fused_head_step_at takes this very plan
        same = same and all(torch.equal(u, v) for u, v in zip((g, corr), hk.fused_head_step_at(*args)))
    torch.cuda.synchronize()
    eg, ec = float((g - g_ref).abs().max()), float((corr - corr_ref).abs().max())
    gmax, cmax = float(g_ref.abs().max()), float(corr_ref.abs().max())
    ok = eg <= 1e-4 * max(gmax, 1.0) and ec <= 1e-3 * cmax if dtype == torch.bfloat16 else eg <= 1e-5 and ec <= 2e-3
    name = f"{family} {str(dtype)[6:]} D={D} k={k} B={B}"
    if not (ok and same):
        raise RuntimeError(f"K2 streamed, {name}: max|dg| {eg:.3e} (max|g| {gmax:.3e}), max|dcorr| {ec:.3e} "
                           f"(max|corr| {cmax:.3e}), identical bits over two launches: {same}")
    starts = itertools.cycle(range(0, last + 1, B))

    def cycling(fn):
        return lambda: fn(head, next(starts), w, lpe, y, gm, wb, family)

    by_kernel = device_by_kernel(cycling(step), 10 if timed else 3)
    missing = [nm for nm, v in by_kernel.items() if v is None]
    if missing:
        raise RuntimeError(f"K2 streamed, {name}: the profile shows no {missing}")
    out = {"shape": {"family": family, "n_pad": n_pad, "B": B, "D": D, "k": k, "dtype": str(dtype)[6:]},
           "plan": p._asdict(), "planned": planned, "max_abs_dg": eg, "max_abs_g": gmax, "max_abs_dcorr": ec,
           "max_abs_corr": cmax, "device_ms_by_kernel": by_kernel}
    if not timed:
        return out

    # the two products on the same operands: lp = x_b w^T and corr = gc^T x_b
    # (bf16 operands accumulated in f32 on a bf16 head)
    op = w.to(dtype).T.contiguous()
    gct = torch.zeros((k, B), device=dev, dtype=dtype)
    f32 = {"out_dtype": torch.float32} if dtype == torch.bfloat16 else {}

    def two(_h, s, *_a):
        xb = head[s:s + B]
        return torch.mm(xb, op, **f32), torch.mm(gct, xb, **f32)

    out.update(ms=cuda_ms(cycling(step), reps), device_ms=sum(by_kernel.values()),
               plain_ms=cuda_ms(cycling(hk.fused_head_step_reference), reps),
               two_products_ms=cuda_ms(cycling(two), reps), **bound(B, D, k, dtype))
    return out


def run(dev, seed: int, names=("M", "CIFAR")) -> list:
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmul is enabled: the f32 products would not be f32")
    card = card_line()
    out = []
    for name in names:
        r = run_shape(dev, seed, *SHAPES[name])
        r.update(name=name, card=card)
        out.append(r)
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shapes", default="M,CIFAR")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_head_streamed needs a CUDA device")
    for r in run(torch.device("cuda", 0), a.seed, a.shapes.split(",")):
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
