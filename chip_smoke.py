#!/usr/bin/env python3
"""Drive the PyTorch port (sgdnet_tpu_torch) end to end on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. the card (nvidia-smi name and power limit), torch, CUDA and nvcc;
  2. build the hand-written kernels' five sources in csrc/ and report the
     seconds; the SASS of K2's streamed bf16 kernels holds HMMA (tensor
     core) instructions (cuobjdump, beside nvcc, run meanwhile and read
     after phase 3);
  3. K2 (fused head step) against its plain torch twin at the dense
     multinomial shape n_pad=65536, D=784, B=4096, f32 and bf16, on rows
     that are not a multiple of 16 bytes (D 785, 786) with a B only 8
     divides, and at k = 128 (a narrow head, and a wide one that takes the
     streamed design, by its kernels' names in a profile), with identical bits
     over two runs; its time, device time and GB/s of head beside the two
     torch.matmul products; then K2's streamed design (three kernels: w
     rounded, lp / gradient / gc, corr; tools/bench_head_streamed.py) at
     bf16 D 16384 k 17, 53 and 128 (multinomial) and k 53 (mgaussian), B
     8192, f32 D 3072 k 100 B 4096 (CIFAR-100), f32 D 785 k 128 (rows
     4-byte aligned) and bf16 D 4096 k 128 B 1032, against its twin (bf16:
     g within 1e-4 x max(max|g|, 1), corr within 1e-3 x max|corr|; f32: g
     1e-5, corr 2e-3) with identical bits over two launches and each kernel
     in a profile; timed
     at CIFAR-100's shape on a 53248-row head (a call, on the device by
     kernel, the plain twin, the two torch.mm products, the bound);
  4. K1 (the whole-epoch kernel) against its twins: one epoch on the
     bundled datasets and a seeded poisson set; then every variant (one
     warp at p 11 and 20, many warps with column groups, 16 lanes a row,
     and l2) on the
     five families and three penalties, four epochs a launch whose orders
     repeat a block across each epoch boundary, and a stop inside a chunk,
     against `epochs_reference` (the epoch count and stop flag, 1e-4 x
     scale, pad lanes zero, identical bits over two runs); its time a
     step, an epoch and the refresh (CUDA events and profiler device
     time) and an epoch inside a 16-epoch launch, beside the earlier
     design's;
  5. slice A: fit(abalone, gaussian, alpha=0.8) through K1, with its wall,
     epochs, K1 launches (chunks), host syncs and device busy share (as
     tools/profile_slice_a.py measures them), held against the plain step
     path on the card over the first 5 lambdas of the path, predict/score,
     and a golden path;
  6. slice B: a 65536 x 784, 10-class dense multinomial fit through K2
     (10 lambdas), held against the plain step path on the card, with
     wall times and samples/s;
  7. K3 / K4 (the BlockCOO tail kernels) against their plain versions at
     the shape of the Pallas probes they replace (p 47000, E 11520, B
     8192), on every block of slice C's tail and on every block of slice
     E's (split at the layout planner's width): K3 at k 1, 3 and 10, f32
     and f64, without and with its epilogue (base, intercept, offsets), K4
     at k 1; relative error, identical bits over two runs; K3's time a
     call (the checked wrapper, and the step's bound launcher bare and with
     the plain step's operands), on the device, its plain version,
     torch.sparse.mm and the bound on C's and E's largest block, K4's the
     same;
  8. K2 against its twin on a bf16 head at slice C's width (106496 x 16384,
     B 8192, k 1, the last block), identical bits over two runs, its time,
     device time and GB/s of head beside the two bf16 torch.mm products;
  9. slice C, the north-star sparse workload (a copy of bench.py's
     make_sparse_binomial in tools/profile_sparse_slices.py: n 100000, p
     47000, 76 nonzeros a row, Zipf columns; binomial, alpha 1, 10 lambdas)
     through fit() on a bf16 16384-wide hybrid head: K2 + K3 + K4 by
     default, held per lambda by penalized objective against the same fit
     on plain torch ops on the first 5 lambdas; its K3 launches, walls, and
     the step it built run
     for one epoch (ms a step, kernel launches a step under torch.profiler);
     then K5 (the g_sum refresh's tail sum) at k 1 on the tail the fit
     packed, against its twin and the padded tail's `matvec_T` (the
     scatter it replaced; 1e-5 relative, the same bits over two launches),
     its time a call, on the device, the twin, the scatter,
     torch.sparse.mm and the bound; then K6 (the step's finish) through
     a launcher bound at the fit's step's shapes (k 1, p 47000, the head's
     16384 columns, B 8192; the fit itself, standardized, carries the
     centering term xc and keeps the chain) on a seeded state, against the chain of torch
     ops it replaces run on the card (w and g_sum the same bits, the
     intercept within 1e-6 relative; the same bits over two launches), its
     time a call, on the device, the chain's and the bound;
 9b. slice M: slice C's design with 53 classes (LIBSVM rcv1.multiclass's
     count) drawn from a seeded softmax model over head and tail columns
     (tools/profile_sparse_slices.py `make_sparse_multiclass_labels`),
     multinomial, slice C's settings, the first 3 lambdas: K2's streamed
     design at the step's shape (bf16 106496 x 16384, k 53, B 8192)
     against its twin and timed as at CIFAR-100's shape, then fit()
     through K2 (streamed) + K3 + K4 at k 53, K3 (with and without its
     epilogue) and K4 at k 53 against their plain versions on every block
     of the tail the fit packed (1e-5 relative, the same bits over two
     runs), K5 and K6 at k 53 on that tail and step as in phase 9, the fit held per lambda by penalized
     objective against the
     same fit on plain torch ops on the first 2 lambdas (1e-4 relative),
     with its walls, epochs, nnz/s, peak
     device memory, the step's profile and the streamed kernels in the
     fit's profile;
 10. slice D: the same data on an int8 32768-wide head (K3 + K4; the head
     products are torch), on the first 3 lambdas of its 10-lambda path,
     held the same way on the first 2 lambdas;
 11. P1 (the whole-epoch prototype probe, on K1's design) against its twin
     over 2 epochs at the probe's size (N 4224, P 128, B 32), identical
     bits over two runs, and K1 at P1's shape (the same data, starts, gamma,
     l1 and l2, no intercept, no refresh) against the same twin; P1's and
     K1's time a call and ns a step of device time, one epoch a launch,
     whose difference is what K1's generality costs a step; then the
     probe's entry point (sgdnet_tpu_torch.tools.bench_epoch_kernel, 200
     epochs);
 12. P2 and P3 (the head-stream probes) against their twin on a seeded
     106496 x 16384 bf16 head, per tile height and ring config, each with
     identical bits over two runs; P3's plan a ring (strip width, stages,
     grid, CTAs an SM, rounds, partial rows), its share of the bound and
     the library call, P3 on the first block too, and its tensor-map
     encode time; the full-head torch.sum ceiling; then their entry points
     (tools.bench_head_dma, which also streams K2, and
     tools.bench_dma_streams);
 13. slice E: slice D's data and settings with hybrid_max_head="auto", the
     head width the port's layout planner picks from the card's constants
     (K3 + K4 on the tail it leaves), on the first 3 lambdas of its
     10-lambda path, held the same way on the first 2 lambdas, with the
     plan's predicted epoch beside the measured one; then the same fit
     made afresh on the path's first lambda at the plan's width, half and
     twice it, each width's measured epoch beside the cost model's, which
     says whether the plan's width is the fastest of the three;
 14. cross-validation on abalone (slice A's fit, 3 folds, the full path,
     thresh 1e-6): serial `cv_fit` (a fit a fold) and `parallel=True` (the
     folds as weight masks over one design), both through K1, every fit
     and fold checked to launch it; the two held to each other as
     tests/test_parallel.py holds the JAX package's (cv_raw rtol 0.05, atol
     1e-3; lambda_min equal), and two folds on the first 3 lambdas (slice
     A's thresh) against the same folds on the plain step (1e-3
     relative);
 15. fold-parallel CV at the north-star width: slice C's data and settings
     on its 10-lambda path, 3 folds, use_pallas=True (K2 + K3 + K4 in
     every fold), against the same call on plain torch ops on the first 2
     lambdas (1e-3 relative), with each fold's wall beside slice C's unmasked path, the
     call's wall and peak device memory; then serial CV of the same folds
     on the first 3 lambdas (a fit on each fold's rows), each fit's wall;
 16. screening: slice C with screen=True and screen="auto" on slice C's
     path, each lambda's penalized objective within 1e-4 relative of the
     unscreened fit's; a seeded 65536 x 4096 dense gaussian (32 true
     features, B 4096, block sampling, use_pallas=True) screened both ways
     against its unscreened fit (2e-3 x scale); walls, mean active set,
     full_tail_from and K2's launches on the column subsets; then K2
     against its twin at every shape of this phase's K2 fits (f32, k 1:
     slice C's rows, B 8192, D 128, 256 and 512; the wide gaussian's,
     B 4096, D 128 and 4096), timed at D 512;
 17. data-parallel fits (parallel/dist.py) on the card: K2 against its twin
     on a rank's bf16 head at B 4096 and K3 / K4 on every block of slice C's
     tail packed at B 4096; (a) DP-C1, slice C's fit on a 1-rank NCCL mesh
     (K2 + K3 + K4, phase 9's lambdas) held to phase 9's per-lambda
     objective (1e-4 relative), one all-reduce a step checked against K2's
     launches, its path wall and step beside phase 9's, the step's
     all-reduce timed alone; (d) measure_scaling at 1 rank (nnz/s); then two
     spawned ranks share the card over gloo (every all-reduce through the
     host, so their walls are no scaling number): (b) DP-C2, slice C's data
     on 3 lambdas at B 4096 a rank (global 8192) through K2 + K3 + K4, held
     to DP-C1's first 3 lambdas (1e-4 relative), w the same bits on both
     ranks, each rank's peak device memory beside phase 9's; (c) CV-A over a
     fold mesh of the two ranks, K1 in every fold, its scores within 1e-6
     relative of phase 14's fold-parallel ones, lambda_min and lambda_1se
     the same;
 18. the rest of the surface: (a) Protocol-4, `benchmarks.convergence.
     run_reference_protocol` on the four bundled datasets, lasso and ridge
     at lambda = 1/n, maxit 1000, 5 tolerances from 0.9 to 1e-3, through
     K1 (every loss finite, the tightest no worse than the loosest, K1 in
     every fit its gate admits), and `convergence_curve_trace` on heart
     (its tail within 1e-3 relative of the sweep's tightest loss); (b)
     Chunk-A, slice A with `lambda_chunk=25` through K1 against slice A
     (2e-3 x scale, dev_ratio 1e-3, the same lambdas); (c) Ckpt-A, the
     first 97 lambdas of slice A's path through K1, its state saved by
     `utils.checkpoint.save_state` and loaded back onto the card bit for
     bit, the last 3 lambdas resumed from it on the plain step under block
     sampling against slice A's (2e-3 x scale), and under the default
     permutation sampling (reported); (d) Libsvm-C, slice C's first 16384 rows written
     as libsvm text and parsed by `utils.native.load_libsvm` (equal to the
     rows in memory), K2 / K3 / K4 held to their twins at its fit's
     shapes, then one lambda at slice C's settings fitted on it (K2 + K3 +
     K4) against the same fit of the rows in memory (objective 1e-6
     relative); the native library built under sgdnet_tpu_torch/_build/
     and native/_sgdnet_native.so untouched; (e) `utils.profiling.trace`
     around an abalone fit through K1, whose Chrome trace names
     saga_epochs_kernel once a launch, and `time_fn` of a K1 epoch beside
     phase 4's CUDA-event time;
 19. the bench leg (sgdnet_tpu_torch/tools, on phase 7's data): (a)
     bench.py's three sparse configs at full width through the bench's
     `build_hybrid_device` and `run_epochs` (int8 D 32768 and 24576,
     refresh 8; bf16 D 16384 through K2, refresh 4; B 8192): every block
     of each layout's BlockCOO tail through K3 / K4 against their twins as
     in phase 7, K2 against its twin on the bf16 layout's own head, one
     epoch through the kernels against one on plain ops from the same
     state and order (w, intercept and g_sum within 1e-3 x scale), then
     `bench_sparse_epoch`'s best of 3 (nnz/s, ms an epoch, K2 / K3 / K4
     launches an epoch: 13 each where the config runs the kernel, peak
     memory) and the bench's metric line; (b) the dense secondaries
     (65536 x 784 k 10 on slice B's data, 131072 x 8192 k 64 with TF32
     and without; TF32 off again afterwards); (c) `validate_bf16` at n
     20000 and 8 epochs, bf16 and int8 against f32 (objective 1e-4
     relative, coefficients 1e-2 x scale); (d) `bench_path_e2e` quick (n
     20000, D 16384, 10 lambdas) cold, warm and screened, the screened
     path within 1e-3 relative of the full one by each lambda's penalized
     objective (its coefficient gap and the JAX tool's 2e-3 x scale
     verdict printed beside it).
Each path (slices A-E and M, the three probe entry points, the CV calls, the
screened fits, the meshed fits, in each rank, phase 18's and phase 19's)
runs with the launch counts set to 0 just before it and read just after.
Then a JSON line with every number, one JSON line of the kernels, the
card's name and power limit, and last {"ok": true, "device": {...}}.  The script needs
the repository checkout and a CUDA device; it has no CPU path.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
#: the times this script measured on an NVIDIA H100 80GB HBM3 at 700.00 W
#: before K2, K4, K3, P1 and P3 were redesigned (K2: a 32-row tile per CTA,
#: read twice; K4: one thread per column; K3: one thread a (row, class),
#: checks and the stream read on every call; P1: K1's first one-CTA design,
#: operands from L2; P3: a cp.async ring, a CTA a strip, its best ring 2 x
#: 512; K2's streamed design, at slice M's and CIFAR-100's shapes: the same
#: tile kernel, w re-read per row, a (k, D) partial per tile): ms a call
#: and ms on the device (P1: and ns a step).  Printed
#: beside the new times only: the `kernels` line holds what this run measured
EARLIER = {"k2_f32": (0.0704, 0.0609), "k2_bf16": (1.2852, 1.2720), "k4": (0.1272, 0.0045),
           "k4_probe_shape": (0.0942, 0.0307), "k3": (0.0316, 0.0034), "p1": (0.4422, 0.4532, 3433),
           "p3": (0.0991, 0.0965), "k2_streamed_m": (8.9518, 8.9285), "k2_streamed_cifar": (2.0913, 2.0672)}
#: the same card model and limit before K1 was redesigned (its earlier
#: persistent 512-thread CTA an epoch, operands from L2, a second launch
#: for the refresh): an abalone epoch in ms a call and ms on the device, µs
#: a step of device time, and slice A's wall in s, epochs and K1 launches
EARLIER_K1 = {"epoch": (0.8248, 0.8108), "step_us": 6.19, "slice_a": (2.072, 1268, 1268)}
#: H100 SXM peaks (NVIDIA's data sheet): device memory rate, FP32 outside
#: the tensor cores, dense bf16 tensor cores
HBM_BYTES_PER_S, F32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def roofline(nbytes: float, flops: float, peak: float) -> dict:
    """The least time for the work: the larger of the bytes over the memory
    rate and the operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return {"bound_ms": 1e3 * max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def device_ms(fn, reps: int, names) -> float | None:
    """Device time per call of fn over the kernels named in `names`
    (torch.profiler, per recorded launch; None where it saw none)."""
    from sgdnet_tpu_torch.utils.profiling import kernel_device_ms

    return kernel_device_ms(fn, reps, names)


def _fmt(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def _pct(bound_ms: float, ms) -> str:
    return "not measured" if ms is None else f"{100 * bound_ms / ms:.1f}%"


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn over `reps` calls (CUDA events,
    after one warm-up call)."""
    from sgdnet_tpu_torch.tools.profile_sparse_slices import cuda_ms as timed

    return timed(fn, reps)


# ---------------------------------------------------------------------------
# phase 3: K2 against its twin
# ---------------------------------------------------------------------------


def phase_k2(rng, dev):
    from sgdnet_tpu_torch.solver import head_kernel as hk

    n_pad, B, start = 65536, 4096, 8192
    # (family, D, k, B, head rows): the dense shapes; a row that is not a
    # multiple of 16 bytes (f32 D 785; bf16 D 785 is only 2-byte aligned, D
    # 786 4-byte) with a B that only 8 divides; k = 128 on a narrow head
    # (resident, corr in shared memory) and on a wide one, where no cluster
    # holds w and the streamed tile kernel runs
    cases = [("gaussian", 784, 1, B, n_pad), ("binomial", 784, 1, B, n_pad), ("multinomial", 784, 10, B, n_pad),
             ("mgaussian", 784, 10, B, n_pad), ("binomial", 4096, 1, B, n_pad), ("multinomial", 785, 10, 1032, n_pad),
             ("binomial", 786, 1, 1032, n_pad), ("multinomial", 256, 128, 1032, n_pad),
             ("multinomial", 4096, 128, 1032, 16384)]
    worst_f32 = 0.0
    for family, D, k, B, n_pad in cases:
        head32 = torch.as_tensor(rng.standard_normal((n_pad, D), dtype=np.float32), device=dev)
        # w scaled so lp is O(1), as on a fitted path
        w = torch.as_tensor(rng.standard_normal((k, D), dtype=np.float32) / np.sqrt(D), device=dev)
        lpe = torch.as_tensor(0.1 * rng.standard_normal((B, k), dtype=np.float32), device=dev)
        if family == "binomial":
            yb = (rng.random((B, k)) < 0.5).astype(np.float32)
        elif family == "multinomial":
            yb = np.eye(k, dtype=np.float32)[rng.integers(0, k, B)]
        else:
            yb = rng.standard_normal((B, k), dtype=np.float32)
        yb = torch.as_tensor(yb, device=dev)
        gm = torch.as_tensor(0.1 * rng.standard_normal((B, k), dtype=np.float32), device=dev)
        wb = torch.as_tensor((rng.random(B) < 0.9).astype(np.float32), device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            head = head32.to(dtype)
            args = (head, start, w, lpe, yb, gm, wb, family)
            g, corr = hk.fused_head_step_at(*args)
            g_ref, corr_ref = hk.fused_head_step_reference(*args)
            same = all(torch.equal(u, v) for u, v in zip((g, corr), hk.fused_head_step_at(*args)))
            torch.cuda.synchronize()
            check(same, f"K2 gave different bits in two runs: {family} D={D} k={k} {dtype}")
            # only the wide k = 128 head streams, and a profile shows the kernel `plan` names
            kernel = "head_step_streamed" if (D, k) == (4096, 128) else "head_step_resident"
            check(hk.plan(B, D, k, dtype).resident == (kernel == "head_step_resident"),
                  f"K2 D={D} k={k} {dtype}: `plan` does not take the {kernel} kernel")
            if kernel == "head_step_streamed":
                check(device_ms(lambda: hk.fused_head_step_at(*args), 5, (kernel,)) is not None,
                      f"K2 D={D} k={k} {dtype}: the profile shows no {kernel}")
            eg = float((g - g_ref).abs().max())
            ec = float((corr - corr_ref).abs().max())
            cmax = float(corr_ref.abs().max())
            if dtype == torch.float32:
                ok = eg <= 1e-5 and ec <= 2e-3
                worst_f32 = max(worst_f32, eg, ec)
                bound = "g 1e-5, corr 2e-3"
            else:
                ok = eg <= 3e-2 and ec <= 2e-2 * max(cmax, 1.0)
                bound = "g 3e-2, corr 2e-2*max|corr|"
            print(f"  K2 {family:11s} D={D} k={k:3d} B={B} {str(dtype)[6:]:8s} {kernel[10:]:8s}: max|dg|={eg:.3e} "
                  f"max|dcorr|={ec:.3e} (max|corr|={cmax:.3e}; bound {bound}), bits identical over two runs "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"K2 disagrees with its twin: {family} D={D} k={k} {dtype}")
    # time at the main path's shape: f32 multinomial k=10
    n_pad, B = 65536, 4096
    head = torch.as_tensor(rng.standard_normal((n_pad, 784), dtype=np.float32), device=dev)
    k = 10
    w = torch.as_tensor(rng.standard_normal((k, 784), dtype=np.float32) / 28.0, device=dev)
    lpe = torch.zeros((B, k), device=dev)
    yb = torch.as_tensor(np.eye(k, dtype=np.float32)[rng.integers(0, k, B)], device=dev)
    gm = torch.zeros((B, k), device=dev)
    wb = torch.ones((B,), device=dev)
    args = (head, start, w, lpe, yb, gm, wb, "multinomial")
    ms = cuda_ms(lambda: hk.fused_head_step_at(*args), 50)
    plain_ms = cuda_ms(lambda: hk.fused_head_step_reference(*args), 50)
    xb = head[start:start + B]
    gct = torch.zeros((k, B), device=dev)
    two_ms = cuda_ms(lambda: (xb @ w.T, gct @ xb), 50)
    # the block once, w, lp_extra / y / g_mem / wb in; g and corr out
    b = roofline(4 * (B * 784 + 2 * k * 784 + 4 * B * k + B), 4 * B * 784 * k, F32_FLOPS)
    dev_ms = device_ms(lambda: hk.fused_head_step_at(*args), 20, hk.KERNEL_NAMES)
    check(dev_ms is not None, "the profile shows no K2 kernel: no device time measured")
    gbs = 4 * B * 784 / dev_ms / 1e6
    print(f"  K2 time at n_pad=65536 D=784 k=10 B=4096 f32 ({hk.device_plan(head, B, k)}): kernel {ms:.4f} ms a call "
          f"({dev_ms:.4f} ms on the device, {gbs:.1f} GB/s of head; earlier {EARLIER['k2_f32'][0]} / "
          f"{EARLIER['k2_f32'][1]}), plain torch {plain_ms:.4f} ms, the two torch.matmul products {two_ms:.4f} ms, "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    return {"max_abs_err": worst_f32, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": None,
            "two_products_ms": two_ms, "device_ms": dev_ms, "head_gb_per_s": gbs}


def start_sass_dump(lib_path: str) -> subprocess.Popen:
    """cuobjdump (beside nvcc) of the library's SASS, started in the
    background: it takes seconds of the host, not of the card."""
    from sgdnet_tpu_torch.utils import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    return subprocess.Popen([tool, "-sass", lib_path], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def tensor_core_check(dump: subprocess.Popen) -> dict:
    """HMMA instructions in the SASS of K2's streamed bf16 kernels: their
    products run on the tensor cores."""
    sass, err = dump.communicate()
    check(dump.returncode == 0, f"cuobjdump failed: {err}")
    found = {"head_step_streamed": 0, "head_corr_streamed": 0}
    fn = ""
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
        elif "HMMA" in line and "nv_bfloat16" in fn:
            for name in found:
                found[name] += name in fn
    print(f"  HMMA instructions in the bf16 SASS of {found}")
    check(all(found.values()), f"K2's streamed bf16 kernels hold no tensor-core instructions: {found}")
    return found


def _streamed_line(r) -> str:
    sh = r["shape"]
    by = ", ".join(f"{k} {_fmt(v)}" for k, v in r["device_ms_by_kernel"].items())
    return (f"{sh['family']:11s} {sh['dtype']:8s} D={sh['D']} k={sh['k']:3d} B={sh['B']} "
            f"({'planned' if r['planned'] else 'resident by plan, launched streamed'}; C {r['plan']['C']}, "
            f"R {r['plan']['R']}, kp {r['plan']['kp']}): max|dg|={r['max_abs_dg']:.3e} (max|g|={r['max_abs_g']:.3e}) "
            f"max|dcorr|="
            f"{r['max_abs_dcorr']:.3e} (max|corr|={r['max_abs_corr']:.3e}), bits identical over two launches; "
            f"device by kernel: {by}")


def _streamed_times(label, r, earlier, card) -> None:
    print(f"  K2 streamed at {label} ({r['plan']}): {r['ms']:.4f} ms a call, {r['device_ms']:.4f} ms on the device "
          f"({_pct(r['bound_ms'], r['device_ms'])} of the bound {r['bound_ms']:.4f} ms, {r['bound_by']}; "
          f"earlier {earlier[0]} / {earlier[1]}), plain twin {r['plain_ms']:.4f} ms, the two torch.mm products "
          f"{r['two_products_ms']:.4f} ms [{card}]")


def phase_k2_streamed(dev, seed, card) -> dict:
    """K2's streamed design at every checked shape, then timed at
    CIFAR-100's (tools/bench_head_streamed.py)."""
    from sgdnet_tpu_torch.tools import bench_head_streamed as bhs

    worst = 0.0
    for case in bhs.CASES:
        r = bhs.run_shape(dev, seed, *case, timed=False)
        print(f"  K2 streamed {_streamed_line(r)} ok")
        if r["shape"]["dtype"] == "float32":
            worst = max(worst, r["max_abs_dg"], r["max_abs_dcorr"])
        torch.cuda.empty_cache()
    r = bhs.run_shape(dev, seed, *bhs.SHAPES["CIFAR"])
    _streamed_times("CIFAR-100's shape, f32 53248 x 3072 k 100 B 4096", r, EARLIER["k2_streamed_cifar"], card)
    torch.cuda.empty_cache()
    return dict(r, f32_max_abs_err=worst)


# ---------------------------------------------------------------------------
# phase 4: K1 against its twin
# ---------------------------------------------------------------------------


def _standardize(x):
    sd = x.std(0)
    sd[sd == 0] = 1.0
    return (x - x.mean(0)) / sd


def _same_state(a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a, b))


def _k1_case(rng, dev, name, x, y, family_name, alpha, grouped=False, offs=None, pf=None):
    from sgdnet_tpu_torch.families import get_family
    from sgdnet_tpu_torch.penalties import select_penalty
    from sgdnet_tpu_torch.solver import epoch_kernel as ek
    from sgdnet_tpu_torch.solver.stepsize import saga_step_sizes

    B = 32
    fam = get_family(family_name, smoothness=float(2 ** np.ceil(np.log2(max(2 * y.max(), 2.0))))
                     if family_name == "poisson" else 1.0)
    y_enc, _ = fam.encode(y)
    if family_name in ("gaussian", "mgaussian"):
        y_enc = _standardize(y_enc)
    pen = select_penalty(alpha, family_name, "grouped" if grouped else "ungrouped")
    x = _standardize(np.asarray(x, np.float64))
    n, p = x.shape
    k = y_enc.shape[1]
    n_pad = -(-n // B) * B
    T = n_pad // B

    def padrows(a):
        return np.concatenate([a, np.zeros((n_pad - n,) + a.shape[1:])]).astype(np.float32)

    t = lambda a: None if a is None else torch.as_tensor(a, device=dev)  # noqa: E731
    wts = padrows(np.ones(n))
    data = ek.pad_data(t(padrows(x)), t(padrows(y_enc)), t(wts),
                       None if offs is None else t(padrows(offs.reshape(n, -1))),
                       None if pf is None else t(pf.astype(np.float32)))
    P = -(-p // 128) * 128  # the padded state's width
    ps = ek.PadState(
        w=np.zeros((ek.KP, P), np.float32), ivec=np.zeros((2, ek.KP), np.float32),
        g_mem=np.zeros((n_pad, ek.KP), np.float32), g_sum=np.zeros((ek.KP, P), np.float32),
    )
    ps.w[:k, :p] = 0.1 * rng.standard_normal((k, p))
    ps.ivec[:, :k] = 0.1 * rng.standard_normal((2, k))
    ps.g_mem[:n, :k] = 0.1 * rng.standard_normal((n, k))
    ps.g_sum[:k, :p] = 0.01 * rng.standard_normal((k, p))
    ps = ek.PadState(*(t(a) for a in ps))
    max_sq = float((x**2).sum(1).max())
    top = float(np.linalg.eigvalsh(x.T @ x)[-1]) / n
    lam = 0.05
    gamma = float(saga_step_sizes(max_sq, top, [(1 - alpha) * lam], n, B, True, fam.L_scaling)[0])
    starts = torch.as_tensor(rng.permutation(T) * B, dtype=torch.int32, device=dev)
    args = (data, ps, starts, B, fam, pen, gamma, alpha * lam, (1 - alpha) * lam, float(n))
    out = ek.saga_epoch(*args)
    same = _same_state(out, ek.saga_epoch(*args))
    ref = ek.epoch_reference(*args)
    dims = (n, p, k, B)
    torch.cuda.synchronize()
    rel = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max())) for a, b in zip(out, ref))
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    pads_zero = float(out.w[k:].abs().max() if k < ek.KP else 0.0) == 0.0 and float(out.w[:, p:].abs().max()) == 0.0
    ok = rel <= 1e-4 and pads_zero and same
    extras = "+offs" if offs is not None else ""
    extras += "+pf" if pf is not None else ""
    print(f"  K1 {name:8s} {family_name:11s} {pen.name:11s}{extras:8s} n_pad={n_pad} P={P} k={k} "
          f"({ek.plan(p, k, B, offs is not None).variant}): rel err {rel:.3e} (bound 1e-4), pads zero: {pads_zero}, "
          f"bits identical over two runs: {same} {'ok' if ok else 'FAIL'}")
    check(ok, f"K1 disagrees with its twin on {name}")
    return err, args, dims


#: K1's variants and shapes that take them (n, p, B): one warp (slice A's
#: shape, and p 20), many warps with column groups, 16 lanes a row, and l2
#: (no ring fits beside the state at B 2048)
K1_SHAPES = {"ring_warp": (500, 11, 32), "ring_warp20": (600, 20, 32), "ring_groups": (1000, 9, 256),
             "ring_lanes": (300, 200, 32), "l2": (4096, 9, 2048)}
K1_FAMILIES = (("gaussian", 1), ("binomial", 1), ("poisson", 1), ("multinomial", 3), ("mgaussian", 2))
K1_PENALTIES = ((0.0, "ungrouped"), (0.7, "ungrouped"), (0.7, "grouped"))


def _k1_problem(rng, dev, family, k, n, p, B, E=4):
    """A seeded problem with offsets and penalty factors, a nonzero state,
    and E epochs of block orders in which each epoch's last block is the
    next epoch's first."""
    from sgdnet_tpu_torch.families import get_family
    from sgdnet_tpu_torch.solver import epoch_kernel as ek
    from sgdnet_tpu_torch.solver.saga import SagaState

    x = rng.standard_normal((n, p))
    y = {"binomial": lambda: (rng.random((n, 1)) < 0.4).astype(float),
         "poisson": lambda: rng.poisson(1.5, (n, 1)).astype(float),
         "multinomial": lambda: np.eye(3)[rng.integers(0, 3, n)]}.get(family, lambda: rng.standard_normal((n, k)))()
    n_pad = -(-n // B) * B
    pad = lambda a: torch.as_tensor(  # noqa: E731
        np.concatenate([a, np.zeros((n_pad - n,) + a.shape[1:])]).astype(np.float32), device=dev)
    fam = get_family(family, n_classes=k, smoothness=8.0)
    fam.n_classes = k
    data = ek.pad_data(pad(x), pad(y), pad(rng.uniform(0.5, 1.5, n)), pad(0.2 * rng.standard_normal((n, k))),
                       torch.as_tensor(rng.uniform(0, 2, p).astype(np.float32), device=dev))
    st0 = SagaState(*(torch.as_tensor((0.1 * rng.standard_normal(s)).astype(np.float32), device=dev)
                      for s in [(k, p), (k,), (n_pad, k), (k, p), (k,)]))
    T = n_pad // B
    orders = np.stack([rng.permutation(T) for _ in range(E)])
    for e in range(E - 1):
        first = int(np.nonzero(orders[e + 1] == orders[e, -1])[0][0])
        orders[e + 1, [0, first]] = orders[e + 1, [first, 0]]
    return data, ek.pad_state(st0, p), fam, torch.as_tensor(orders * B, dtype=torch.int32, device=dev)


def _k1_chunk_check(data, ps, orders, B, fam, pen, run):
    """saga_epochs against epochs_reference: (max relative error, max abs
    error, epochs run, twin's epochs run, stop flags equal, bits identical
    over two launches, pad lanes zero)."""
    from sgdnet_tpu_torch.solver import epoch_kernel as ek

    out, stats = ek.saga_epochs(data, ps, orders, B, fam, pen, **run)
    again, stats2 = ek.saga_epochs(data, ps, orders, B, fam, pen, **run)
    ref, rstats = ek.epochs_reference(data, ps, orders, B, fam, pen, **run)
    torch.cuda.synchronize()
    rel = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max())) for a, b in zip(out, ref))
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    k, p = data.k, data.p
    pads = float(out.w[:, p:].abs().max()) == 0.0 and float(out.w[k:].abs().max() if k < ek.KP else 0.0) == 0.0
    same = _same_state(out, again) and torch.equal(stats, stats2)
    st, rst = stats.tolist(), rstats.tolist()
    return rel, err, int(st[0]), int(rst[0]), st[3] == rst[3], same, pads


def _k1_variants(rng, dev) -> dict:
    """Every variant on the five families and three penalties (four epochs
    a launch, refresh every second, the wrap orders), and a stop inside a
    chunk on each variant."""
    from sgdnet_tpu_torch.penalties import select_penalty
    from sgdnet_tpu_torch.solver import epoch_kernel as ek

    worst_rel, worst_err, cases = 0.0, 0.0, 0
    for shape, (n, p, B) in K1_SHAPES.items():
        pl = ek.plan(p, 3, B, True)
        check(pl.variant == shape.split("_")[0], f"K1 shape {shape} plans the {pl.variant} variant")
        shape_rel = 0.0
        for family, k in K1_FAMILIES:
            for alpha, tm in K1_PENALTIES:
                data, ps, fam, orders = _k1_problem(rng, dev, family, k, n, p, B)
                pen = select_penalty(alpha, family, tm)
                run = dict(gamma=0.01, l1=0.02 * alpha, l2=0.02 * (1 - alpha), w_total=float(n), it0=0,
                           t_conv=0.0, refresh_every=2)
                rel, err, ran, ran_ref, stop_same, same, pads = _k1_chunk_check(data, ps, orders, B, fam, pen, run)
                ok = rel <= 1e-4 and ran == ran_ref == 4 and stop_same and same and pads
                check(ok, f"K1 {shape} {family} {pen.name}: rel {rel:.3e}, epochs {ran} vs {ran_ref}, "
                          f"stop flags equal {stop_same}, bits identical {same}, pads zero {pads}")
                shape_rel, worst_err, cases = max(shape_rel, rel), max(worst_err, err), cases + 1
        # a tolerance that stops inside the chunk: the twin's third epoch's relative change
        data, ps, fam, orders = _k1_problem(rng, dev, "gaussian", 1, n, p, B, E=8)
        pen = select_penalty(0.5, "gaussian", "ungrouped")
        run = dict(gamma=0.01, l1=0.01, l2=0.01, w_total=float(n), it0=0, refresh_every=1)
        cut, _ = ek.epochs_reference(data, ps, orders[:2], B, fam, pen, **run)
        _, st3 = ek.epochs_reference(data, cut, orders[2:3], B, fam, pen, **run)
        run["t_conv"] = float(st3[1] / st3[2]) * 1.0001
        rel, err, ran, ran_ref, stop_same, same, pads = _k1_chunk_check(data, ps, orders, B, fam, pen, run)
        check(rel <= 1e-4 and ran == ran_ref < 8 and stop_same and same and pads,
              f"K1 {shape}: the stop inside a chunk: epochs {ran} vs {ran_ref}, rel {rel:.3e}")
        worst_rel = max(worst_rel, shape_rel, rel)
        print(f"  K1 variant {pl.variant:4s} ({shape}: n {n}, p {p}, B {B}; {pl.threads} threads, {pl.lanes} lanes a "
              f"row, {pl.groups} column groups, {pl.stages} stages): 15 families x penalties, 4 epochs a launch with a "
              f"block repeated across each epoch boundary: worst rel err {shape_rel:.3e} (bound 1e-4), epochs and "
              f"stop flags as the twin's, pads zero, bits identical over two runs; stop inside a chunk after "
              f"{ran} of 8 epochs as the twin")
    return {"max_rel_err": worst_rel, "max_abs_err": worst_err, "cases": cases + len(K1_SHAPES)}


def phase_k1(rng, dev):
    from sgdnet_tpu_torch import data as d
    from sgdnet_tpu_torch.solver import epoch_kernel as ek

    worst = 0.0
    xa, ya = d.load_abalone()
    err, timing_args, (n, p, k, B) = _k1_case(rng, dev, "abalone", xa, ya, "gaussian", 0.8)
    worst = max(worst, err)
    xh, yh = d.load_heart()
    pf = np.ones(xh.shape[1])
    pf[0], pf[3] = 0.0, 3.0
    err, _, _ = _k1_case(rng, dev, "heart", xh, yh, "binomial", 0.0,
                      offs=0.2 * rng.standard_normal(len(yh)), pf=pf)
    worst = max(worst, err)
    xw, yw = d.load_wine()
    err, _, _ = _k1_case(rng, dev, "wine", xw, yw, "multinomial", 0.9, grouped=True)
    worst = max(worst, err)
    xs, ys = d.load_student()
    err, _, _ = _k1_case(rng, dev, "student", xs, ys, "mgaussian", 0.5)
    worst = max(worst, err)
    xp = rng.standard_normal((600, 12))
    yp = rng.poisson(np.exp(0.3 + xp @ (0.3 * rng.standard_normal(12)))).astype(np.float64)
    err, _, _ = _k1_case(rng, dev, "poisson", xp, yp, "poisson", 0.5)
    worst = max(worst, err)
    variants = _k1_variants(rng, dev)
    worst = max(worst, variants["max_abs_err"])

    # times on abalone: an epoch as one launch, with and without the
    # refresh; 16 epochs in one launch (no stop: t_conv 0) with the refresh
    # every epoch and never, whose difference over 16 is the refresh's time
    # (a difference of device-bound launches: one-epoch calls are host-bound
    # enough that theirs is noise); a step is an epoch without it over T
    T = -(-n // B)
    data, ps = timing_args[0], timing_args[1]
    no_refresh = lambda: ek.saga_epoch(*timing_args, refresh=False)  # noqa: E731
    orders16 = torch.stack([timing_args[2][torch.randperm(T, generator=torch.Generator().manual_seed(e))]
                            for e in range(16)])
    chunk = lambda every=1: ek.saga_epochs(data, ps, orders16, *timing_args[3:], refresh_every=every)  # noqa: E731
    names = ("saga_epochs_kernel",)
    ms = cuda_ms(lambda: ek.saga_epoch(*timing_args), 50)
    ms_nr = cuda_ms(no_refresh, 50)
    ms_chunk, ms_chunk_nr = cuda_ms(chunk, 10) / 16, cuda_ms(lambda: chunk(0), 10) / 16
    plain_ms = cuda_ms(lambda: ek.epoch_reference(*timing_args), 5)
    dev_ms = device_ms(lambda: ek.saga_epoch(*timing_args), 20, names)
    dev_nr = device_ms(no_refresh, 20, names)
    dev_chunk, dev_chunk_nr = device_ms(chunk, 5, names), device_ms(lambda: chunk(0), 5, names)
    check(None not in (dev_ms, dev_nr, dev_chunk, dev_chunk_nr),
          "the profile shows no K1 kernel: no device time measured")
    dev_chunk, dev_chunk_nr = dev_chunk / 16, dev_chunk_nr / 16
    refresh_ms, refresh_dev = ms_chunk - ms_chunk_nr, dev_chunk - dev_chunk_nr
    step_us, step_dev_us = ms_nr / T * 1e3, dev_nr / T * 1e3
    # the real data and state once in (x, y, weights, g_mem, w, g_sum, the
    # block order), the state once out; two products a step over the epoch.
    # Its time is set by the T dependent steps, not by this roofline
    b = roofline(4 * (n * p + 3 * n * k + n + 2 * k * p + T) + 4 * (n * k + 2 * k * p + 2 * k), 4 * n * p * k,
                 F32_FLOPS)
    pl = ek.plan(p, k, B)
    print(f"  K1 time, one abalone epoch (n_pad=4192, p=9, B=32, {T} steps; the {pl.variant} variant, {pl.threads} "
          f"threads, {pl.stages} stages): {ms:.4f} ms a call ({dev_ms:.4f} ms on the device; earlier: "
          f"{EARLIER_K1['epoch'][0]} / {EARLIER_K1['epoch'][1]}), plain torch {plain_ms:.4f} ms, bound "
          f"{b['bound_ms']:.6f} ms ({b['bound_by']})")
    print(f"  K1 a step: {step_us:.3f} us a call, {step_dev_us:.3f} us of device time (earlier: "
          f"{EARLIER_K1['step_us']} us); an epoch inside a 16-epoch launch: {ms_chunk:.4f} ms a call, "
          f"{dev_chunk:.4f} ms of device time, and without the refresh {ms_chunk_nr:.4f} / {dev_chunk_nr:.4f} ms: "
          f"the refresh {refresh_ms * 1e3:.3f} us a call, {refresh_dev * 1e3:.3f} us of device time")
    return {"max_abs_err": worst, "max_rel_err": variants["max_rel_err"], "variant_cases": variants["cases"],
            "ms": ms, "plain_ms": plain_ms, **b, "library_ms": None, "device_ms": dev_ms,
            "no_refresh_ms": ms_nr, "no_refresh_device_ms": dev_nr, "refresh_ms": refresh_ms,
            "refresh_device_ms": refresh_dev, "step_us": step_us, "step_device_us": step_dev_us,
            "chunk16_ms_per_epoch": ms_chunk, "chunk16_device_ms_per_epoch": dev_chunk}, \
        lambda: ek.saga_epoch(*timing_args)


# ---------------------------------------------------------------------------
# phases 5 and 6: the fit path
# ---------------------------------------------------------------------------


def _rel_diff(a, b) -> float:
    """max |a - b| / max(1, max |b|)"""
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


def run_slice_a(dev):
    import sgdnet_tpu_torch as st

    x, y = st.load_abalone()
    t0 = time.perf_counter()
    f = st.fit(x, y, family="gaussian", alpha=0.8, device=dev)
    return f, time.perf_counter() - t0


def check_slice_a(f, wall, launches, dev, card):
    import sgdnet_tpu_torch as st

    from sgdnet_tpu_torch.tools import profile_slice_a

    x, y = st.load_abalone()
    chunks = f.stats["epoch_chunks"]
    print(f"  slice A (abalone gaussian alpha=0.8, 100 lambdas, K1): {wall:.3f} s wall, {f.npasses} epochs, "
          f"{launches} K1 launches ({chunks} chunks), epoch_kernel={f.stats['epoch_kernel']} (earlier: "
          f"{EARLIER_K1['slice_a'][0]} s, {EARLIER_K1['slice_a'][1]} epochs, {EARLIER_K1['slice_a'][2]} launches) "
          f"[{card}]")
    check(f.stats["epoch_kernel"] is True, "slice A did not run through K1")
    check(0 < launches == chunks < f.npasses, "slice A: K1 launches are not its chunks, fewer than its epochs")
    prof = profile_slice_a.run(dev, reps=3)
    check(prof["epoch_kernel"] is True and prof["busy_share"] is not None, "slice A's profile saw no K1 device time")
    print(f"  slice A again ({profile_slice_a.__name__}): median wall {prof['wall_s']:.3f} s of "
          f"{[round(w, 3) for w in prof['walls_s']]}, {prof['host_syncs']} host syncs torch reports, device busy "
          f"{prof['device_s']:.3f} s = {prof['busy_share']:.3f} of the wall; top kernels "
          f"{[(t['kernel'][:40], t['calls'], round(t['device_ms'], 2)) for t in prof['top'][:3]]} [{card}]")
    dr = f.dev_ratio
    check(np.isfinite(dr).all() and np.isfinite(f.beta).all(), "slice A: non-finite path")
    check(np.all(np.diff(dr) >= -1e-6), f"slice A: dev_ratio decreases along the path: {np.diff(dr).min()}")
    # the plain comparison fit takes a minute or more for the 100 lambdas on a
    # host-bound path: it is made for the first 5, for the run's time
    head_n = 5
    t0 = time.perf_counter()
    f_plain = st.fit(x, y, family="gaussian", alpha=0.8, device=dev, use_epoch_kernel=False,
                     sampling="block", lambda_path=f.lambda_[:head_n])
    wall_plain = time.perf_counter() - t0
    check(f_plain.stats["epoch_kernel"] is False, "plain slice A ran the kernel")
    rel = _rel_diff(f.beta[:head_n], f_plain.beta)
    print(f"  slice A plain step path, the first {head_n} lambdas: {wall_plain:.3f} s wall, {f_plain.npasses} epochs; "
          f"K1 vs plain max|dbeta|/scale = {rel:.3e} (bound 1e-3) [{card}]")
    check(rel <= 1e-3, "slice A: K1 fit disagrees with the plain step path")
    pred = f.predict(x, type="response")
    sc = f.score(x, y)
    check(pred.shape == (x.shape[0], f.n_lambda) and np.isfinite(pred).all(), "slice A: bad predictions")
    check(sc.shape == (f.n_lambda,) and np.isfinite(sc).all() and sc[-1] < sc[0], "slice A: bad scores")
    print(f"  slice A predict {pred.shape} finite; score (mse) {sc[0]:.4f} -> {sc[-1]:.4f}")
    # the golden path (sklearn coordinate descent, f64), as tests/test_golden.py
    g = np.load(os.path.join(ROOT, "tests", "golden", "abalone.npz"))
    fg = st.fit(x, y, alpha=1.0, nlambda=10, thresh=1e-6, maxit=5000, device=dev)
    check(fg.stats["epoch_kernel"] is True, "golden fit did not run through K1")
    np.testing.assert_allclose(fg.lambda_, g["a1.0_s1_lambda"], rtol=1e-6)
    rel_g = _rel_diff(fg.beta[:, 0, :], g["a1.0_s1_beta"])
    print(f"  slice A golden path (alpha=1, f32 through K1): max|dbeta|/scale = {rel_g:.3e} (bound 2e-3)")
    check(rel_g <= 2e-3, "slice A: K1 fit misses the golden path")
    return {"wall_s": wall, "epochs": f.npasses, "chunks": chunks, "plain_lambdas": head_n,
            "plain_wall_s": wall_plain, "plain_epochs": f_plain.npasses, "profile": prof}


def _multinomial_data(seed: int, n=65536, p=784, k=10):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, p), dtype=np.float32)
    beta = np.zeros((p, k), np.float32)
    active = rng.choice(p, 60, replace=False)
    beta[active] = rng.standard_normal((60, k), dtype=np.float32) / np.sqrt(15.0)
    logits = x @ beta + rng.gumbel(size=(n, k)).astype(np.float32)
    return x, logits.argmax(1)


SLICE_B = dict(family="multinomial", alpha=0.9, nlambda=10, lambda_min_ratio=0.01, maxit=100,
               batch_size=4096, sampling="block")


def run_slice_b(dev, seed):
    import sgdnet_tpu_torch as st

    x, y = _multinomial_data(seed)
    xt = torch.as_tensor(x, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f = st.fit(xt, y, use_pallas=True, device=dev, seed=seed, **SLICE_B)
    return f, time.perf_counter() - t0, xt, y


def check_slice_b(f, wall, launches, xt, y, dev, card, seed):
    import sgdnet_tpu_torch as st

    n = xt.shape[0]
    check(f.stats["head_kernel"] is True and launches > 0, "slice B did not run through K2")
    check(np.isfinite(f.beta).all() and np.isfinite(f.dev_ratio).all(), "slice B: non-finite path")
    t0 = time.perf_counter()
    f_plain = st.fit(xt, y, use_pallas=False, device=dev, seed=seed,
                     **{**SLICE_B, "nlambda": None, "lambda_path": f.lambda_})
    wall_plain = time.perf_counter() - t0
    check(f_plain.stats["head_kernel"] is False, "plain slice B ran the kernel")
    rel = _rel_diff(f.beta, f_plain.beta)
    # samples/s over the whole fit() call and over the lambda path alone
    sps, sps_plain = f.npasses * n / wall, f_plain.npasses * n / wall_plain
    path_sps = f.npasses * n / f.stats["wall_time_s"]
    path_sps_plain = f_plain.npasses * n / f_plain.stats["wall_time_s"]
    print(f"  slice B (65536 x 784, k=10, B=4096, block, 10 lambdas) through K2: {wall:.3f} s fit wall "
          f"({f.stats['wall_time_s']:.3f} s path), {f.npasses} epochs, {sps:.4g} samples/s "
          f"({path_sps:.4g} on the path), {launches} K2 launches [{card}]")
    print(f"  slice B plain step path: {wall_plain:.3f} s fit wall ({f_plain.stats['wall_time_s']:.3f} s path), "
          f"{f_plain.npasses} epochs, {sps_plain:.4g} samples/s ({path_sps_plain:.4g} on the path) [{card}]")
    print(f"  slice B K2 vs plain max|dbeta|/scale = {rel:.3e} (bound 1e-3); dev_ratio {f.dev_ratio.round(4)}")
    check(rel <= 1e-3, "slice B: K2 fit disagrees with the plain step path")
    return {"wall_s": wall, "path_s": f.stats["wall_time_s"], "epochs": f.npasses, "samples_per_s": sps,
            "path_samples_per_s": path_sps, "plain_wall_s": wall_plain,
            "plain_path_s": f_plain.stats["wall_time_s"], "plain_epochs": f_plain.npasses,
            "plain_samples_per_s": sps_plain, "plain_path_samples_per_s": path_sps_plain}


# ---------------------------------------------------------------------------
# phase 7: K3 / K4 against their twins
# ---------------------------------------------------------------------------


def _tail_block_check(tk, bt, blk, rng, dev, what, ks=(1, 3, 10), outer_k=1, f64=True):
    """K3 against its plain version on one block at each k of `ks`, f32 and
    (where `f64`) f64, without and with its epilogue (base, intercept,
    offsets), and K4 at `outer_k` in f32: the worst relative and absolute
    errors; each kernel gives the same bits in two runs."""
    import dataclasses

    worst_rel = worst_err = 0.0
    kinds = (bt, dataclasses.replace(bt, vals=bt.vals.double(), vals_by_col=bt.vals_by_col.double())) if f64 else (bt,)
    for bd in kinds:
        for k in ks:
            t = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=bd.dtype, device=dev)  # noqa: E731
            w = t(k, bd.n_cols)
            for given in ({}, dict(base=t(bd.batch, k), intercept=t(k), offs=t(bd.batch, k))):
                f = tk.coo_tail_forward(bd, blk, w, **given)
                ref = tk.coo_tail_forward_reference(bd, blk, w, **given)
                same = torch.equal(f, tk.coo_tail_forward(bd, blk, w, **given))
                torch.cuda.synchronize()
                err = float((f - ref).abs().max())
                rel = err / max(float(ref.abs().max()), 1e-30)
                tag = f"{what}, block {blk}, k {k}, {bd.dtype}, {'with' if given else 'without'} its epilogue"
                check(rel <= 1e-5, f"K3 disagrees with its plain version ({tag}): rel {rel:.3e}")
                check(same, f"K3 gave different bits in two runs ({tag})")
                worst_rel, worst_err = max(worst_rel, rel), max(worst_err, err)
    gc = torch.as_tensor(rng.standard_normal((bt.batch, outer_k), dtype=np.float32), device=dev)
    o, o_ref = tk.coo_tail_outer(bt, blk, gc), tk.coo_tail_outer_reference(bt, blk, gc)
    same = torch.equal(o, tk.coo_tail_outer(bt, blk, gc))
    torch.cuda.synchronize()
    err = float((o - o_ref).abs().max())
    rel = err / max(float(o_ref.abs().max()), 1e-30)
    check(rel <= 1e-5, f"K4 disagrees with its plain version ({what}, block {blk}, k {outer_k}): rel {rel:.3e}")
    check(same, f"K4 gave different bits in two runs ({what}, block {blk}, k {outer_k})")
    return max(worst_rel, rel), max(worst_err, err)


def _tail_times(tk, bt, blk, dev, rng, outer=True):
    """K3 (and K4) on one block at k 1: a call (the checked wrapper; for K3
    also the step's bound launcher, bare and with the plain step's base and
    intercept), device time, the plain version and torch.sparse.mm, and the
    bounds: each true entry's row, column and value once, the touched w
    columns / gc rows once, the output once; 2 flops an entry."""
    import scipy.sparse as sp

    c = int(bt.counts[blk])
    rows = bt.rows[blk, :c].cpu().numpy()
    cols = bt.cols[blk, :c].cpu().numpy()
    vals = bt.vals[blk, :c].cpu().numpy()
    a = sp.csr_matrix((vals, (rows, cols)), shape=(bt.batch, bt.n_cols))
    at = a.T.tocsr()

    def csr(m):
        return torch.sparse_csr_tensor(torch.as_tensor(m.indptr), torch.as_tensor(m.indices),
                                       torch.as_tensor(m.data), size=m.shape, device=dev)

    w = torch.as_tensor(rng.standard_normal((1, bt.n_cols), dtype=np.float32), device=dev)
    gc = torch.as_tensor(rng.standard_normal((bt.batch, 1), dtype=np.float32), device=dev)
    base, icpt = torch.zeros((bt.batch, 1), device=dev), torch.zeros(1, device=dev)
    a_t, at_t = csr(a), csr(at)
    wt = w.T.contiguous()
    u = int((bt.col_seg[blk, 1:] > bt.col_seg[blk, :-1]).sum())  # distinct columns
    launch = tk.ForwardLauncher(bt, 1, torch.float32)
    k3 = {"ms": cuda_ms(lambda: tk.coo_tail_forward(bt, blk, w), 200),
          "bound_call_ms": cuda_ms(lambda: launch(blk, w), 200),
          "step_call_ms": cuda_ms(lambda: launch(blk, w, base=base, intercept=icpt), 200),
          "device_ms": device_ms(lambda: tk.coo_tail_forward(bt, blk, w), 50, ("coo_forward",)),
          "plain_ms": cuda_ms(lambda: tk.coo_tail_forward_reference(bt, blk, w), 50),
          "library_ms": cuda_ms(lambda: torch.sparse.mm(a_t, wt), 200),
          **roofline(12 * c + 4 * u + 4 * bt.batch, 2 * c, F32_FLOPS), "block": blk, "block_entries": c,
          "lanes": bt.lanes}
    check(k3["device_ms"] is not None, "the profile shows no coo_forward kernel: no K3 device time measured")
    if not outer:
        return k3, None, u
    k4 = {"ms": cuda_ms(lambda: tk.coo_tail_outer(bt, blk, gc), 200),
          "device_ms": device_ms(lambda: tk.coo_tail_outer(bt, blk, gc), 50, ("coo_outer",)),
          "plain_ms": cuda_ms(lambda: tk.coo_tail_outer_reference(bt, blk, gc), 50),
          "library_ms": cuda_ms(lambda: torch.sparse.mm(at_t, gc), 200),
          **roofline(12 * c + 4 * bt.batch + 4 * bt.n_cols, 2 * c, F32_FLOPS), "block": blk, "block_entries": c}
    check(k4["device_ms"] is not None, "the profile shows no coo_outer kernel: no K4 device time measured")
    return k3, k4, u


def _packed_tail(tail, n, B, seed, dev):
    """A tail as fit() packs it: the row shuffle, rows padded to B, per-block COO."""
    from sgdnet_tpu_torch.core.sparse import BlockCOO

    rperm = torch.as_tensor(np.random.default_rng(seed + 0x5EED).permutation(n), device=dev)
    return BlockCOO.from_padded(tail.take_rows(rperm).pad_rows(-(-n // B) * B), B)


def _print_times(label, r):
    print(f"    {label}: {r['ms']:.4f} ms a call"
          + (f" ({r['bound_call_ms']:.4f} through the step's bound launcher, {r['step_call_ms']:.4f} with the "
             f"plain step's base and intercept)" if "bound_call_ms" in r else "")
          + f", {_fmt(r['device_ms'])} on the device; plain {r['plain_ms']:.4f} ms, torch.sparse.mm "
          f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']})")


def phase_tail(rng, dev, csr, seed):
    from sgdnet_tpu_torch.core.layout import plan_layout
    from sgdnet_tpu_torch.core.sparse import BlockCOO, HybridCSR, scipy_column_stats
    from sgdnet_tpu_torch.solver import tail_kernel as tk
    from sgdnet_tpu_torch.tools.profile_sparse_slices import SLICE_C, SLICE_E

    B, n = SLICE_C["batch_size"], csr.shape[0]
    # (a) the probes' own shapes: one block of E = 11520 true entries over
    # B = 8192 rows and p = 47000 Zipf columns
    p, E = 47000, 11520
    zipf = (np.arange(p) + 10.0) ** -1.15
    cols = np.searchsorted(np.cumsum(zipf) / zipf.sum(), rng.random(E)).clip(0, p - 1).astype(np.int32)
    rows = np.sort(rng.integers(0, B, E)).astype(np.int32)
    bt4 = BlockCOO.from_arrays(rows[None], cols[None], rng.standard_normal((1, E)).astype(np.float32), B, p,
                               counts=[E], device=dev)
    rel4, err4 = _tail_block_check(tk, bt4, 0, rng, dev, "probe shape")
    k3_4, k4_4, u4 = _tail_times(tk, bt4, 0, dev, rng)
    print(f"  K3/K4 at the probes' shape (p 47000, E 11520, B 8192; {u4} distinct columns, K3 {bt4.lanes} lanes a "
          f"row): K3 at k 1, 3, 10, f32 / f64, with and without its epilogue, K4 at k 1: worst rel err {rel4:.3e} "
          f"(bound 1e-5), bits identical over two runs")
    _print_times("K3 forward", k3_4)
    _print_times("K4 outer", k4_4)
    # (b) slice C's tail as fit() packs it: split, the row shuffle, pad, pack;
    # (c) slice E's, split at the planner's width with the int8 ingestion's
    # scale-only standardized tail
    th, _ = HybridCSR.split_columns(csr, coverage=SLICE_C["hybrid_coverage"], max_head=SLICE_C["hybrid_max_head"],
                                    memory_budget=SLICE_C["hybrid_memory_budget"], head_dtype="bfloat16", device=dev)
    bt_c = _packed_tail(th.tail, n, B, seed, dev)
    th = None
    plan = plan_layout(csr, batch_size=B, head_itemsize=1, g_sum_refresh_every=SLICE_E["g_sum_refresh_every"],
                       hbm_budget=SLICE_E["hybrid_memory_budget"])
    te, _ = HybridCSR.split_columns(csr, coverage=1.0, max_head=plan.max_head, head_dtype="int8",
                                    memory_budget=SLICE_E["hybrid_memory_budget"], std_stats=scipy_column_stats(csr),
                                    head_form="nnz", device=dev)
    bt_e = _packed_tail(te.tail, n, B, seed, dev)
    te = None
    out = {"probe_shape_ms": k3_4["ms"], "probe_shape_device_ms": k3_4["device_ms"]}
    worst_rel, worst_err = rel4, err4
    for name, bt, d in (("C", bt_c, SLICE_C["hybrid_max_head"]), ("E", bt_e, plan.max_head)):
        for blk in range(bt.n_blocks):
            rel, err = _tail_block_check(tk, bt, blk, rng, dev, f"slice {name}")
            worst_rel, worst_err = max(worst_rel, rel), max(worst_err, err)
        counts = bt.counts.cpu().numpy()
        blk = int(np.argmax(counts))
        k3, k4, u = _tail_times(tk, bt, blk, dev, rng)
        print(f"  K3/K4 on slice {name}'s {bt.n_blocks} blocks (head D {d}; B 8192, p 47000, E {bt.rows.shape[1]}, "
              f"true entries {counts.min()}-{counts.max()}, {counts.sum() / (bt.n_blocks * B):.2f} a row, K3 "
              f"{bt.lanes} lanes a row): K3 at k 1, 3, 10, f32 / f64, with and without its epilogue, K4 at k 1: "
              f"worst rel err {worst_rel:.3e} (bound 1e-5), bits identical over two runs")
        print(f"    block {blk}: {counts[blk]} entries, {u} distinct columns")
        _print_times("K3 forward", k3)
        _print_times("K4 outer", k4)
        out[name] = (k3, k4)
    print(f"    earlier (PR 2's K3, one thread a row): {EARLIER['k3'][0]} ms a call / {EARLIER['k3'][1]} ms on the "
          f"device on slice C's block; K4 earlier: {EARLIER['k4'][0]} / {EARLIER['k4'][1]} ms")
    extra = {"max_abs_err": worst_err, "max_rel_err": worst_rel}
    k3c, k4c = out["C"]
    k3e, k4e = out["E"]
    k3 = {**k3c, **extra, "probe_shape_ms": k3_4["ms"], "probe_shape_device_ms": k3_4["device_ms"],
          "slice_e_block": k3e}
    k4 = {**k4c, **extra, "probe_shape_ms": k4_4["ms"], "probe_shape_device_ms": k4_4["device_ms"],
          "probe_shape_library_ms": k4_4["library_ms"], "slice_e_block": k4e}
    return k3, k4


# ---------------------------------------------------------------------------
# phases 9 and 9b: K5 against its twin and the scatter it replaced
# ---------------------------------------------------------------------------


def phase_k5(x, k, fit_launches, seed, dev, what, card) -> dict:
    """K5 on the BlockCOO tail a fit packed (its own x), at k classes in
    f32, on a g drawn from its own seed so that the other phases' draws
    stay as they were: within 1e-5 relative (the worst error over the
    largest of the reference) of its twin and of the padded tail's
    `matvec_T`, the scatter the refresh ran before, and the same bits from
    two launches;
    then a call (CUDA events), device time, the twin, the scatter,
    torch.sparse.mm of the tail's transpose (its true entries), and the
    bound: g, each true entry's row and value, col_seg and the output once
    each; 2 flops an entry and class."""
    import scipy.sparse as sp

    from sgdnet_tpu_torch.solver import tail_kernel as tk

    bt, tail = x.blk_tail, x.tail
    n_pad, p = bt.n_blocks * bt.batch, bt.n_cols
    check(fit_launches > 0, f"{what}'s fit ran no K5: its refreshes did not take the BlockCOO route")
    g = np.random.default_rng(seed + k).standard_normal((n_pad, k), dtype=np.float32)
    g = torch.as_tensor(g, device=dev)
    before = tk.coo_tail_sum.launches
    out, again = tk.coo_tail_sum(bt, g), tk.coo_tail_sum(bt, g)
    check(tk.coo_tail_sum.launches == before + 2, f"K5 ({what}): not one launch a call")
    same = torch.equal(out, again)
    worst_rel = worst_err = 0.0
    for name, ref in (("twin", tk.coo_tail_sum_reference(bt, g)), ("padded tail's matvec_T", tail.matvec_T(g))):
        err = float((out - ref).abs().max())
        rel = err / max(float(ref.abs().max()), 1e-30)
        check(rel <= 1e-5, f"K5 disagrees with its {name} ({what}, k {k}): rel {rel:.3e}")
        worst_rel, worst_err = max(worst_rel, rel), max(worst_err, err)
    check(same, f"K5 gave different bits in two launches ({what}, k {k})")
    counts = bt.counts.cpu().numpy()
    nnz = int(counts.sum())
    live = np.arange(bt.rows.shape[1])[None] < counts[:, None]
    rows = (np.arange(bt.n_blocks)[:, None] * bt.batch + bt.rows.cpu().numpy())[live]
    at = sp.csr_matrix((bt.vals.cpu().numpy()[live], (bt.cols.cpu().numpy()[live], rows)), shape=(p, n_pad))
    at_t = torch.sparse_csr_tensor(torch.as_tensor(at.indptr), torch.as_tensor(at.indices),
                                   torch.as_tensor(at.data), size=at.shape, device=dev)
    r = {"k": k, "blocks": bt.n_blocks, "true_entries": nnz, "fit_launches": fit_launches,
         "ms": cuda_ms(lambda: tk.coo_tail_sum(bt, g), 50),
         "device_ms": device_ms(lambda: tk.coo_tail_sum(bt, g), 20, ("coo_tail_sum",)),
         "plain_ms": cuda_ms(lambda: tk.coo_tail_sum_reference(bt, g), 5),
         "scatter_ms": cuda_ms(lambda: tail.matvec_T(g), 5),
         "library_ms": cuda_ms(lambda: torch.sparse.mm(at_t, g), 20),
         **roofline(4 * n_pad * k + 8 * nnz + 4 * bt.n_blocks * (p + 1) + 4 * p * k, 2 * nnz * k, F32_FLOPS),
         "max_rel_err": worst_rel, "max_abs_err": worst_err}
    check(r["device_ms"] is not None, "the profile shows no coo_tail_sum kernel: no K5 device time measured")
    print(f"  K5 on {what}'s tail as the fit packed it ({bt.n_blocks} blocks of {bt.batch} rows, p {p}, {nnz} true "
          f"entries, k {k}, f32): vs its twin and the padded tail's matvec_T worst rel err {worst_rel:.3e} (bound "
          f"1e-5), bits identical over two launches; the fit's K5 launches {fit_launches}")
    print(f"    K5 tail sum: {r['ms']:.4f} ms a call, {_fmt(r['device_ms'])} on the device; twin {r['plain_ms']:.4f} "
          f"ms, the scatter it replaced {r['scatter_ms']:.4f} ms, torch.sparse.mm {r['library_ms']:.4f} ms, bound "
          f"{r['bound_ms']:.6f} ms ({r['bound_by']}) [{card}]")
    return r


# ---------------------------------------------------------------------------
# phase 8: K2 at slice C's width
# ---------------------------------------------------------------------------


def _k2_bf16_case(rng, dev, seed, n_pad, B):
    """K2 against its twin on a seeded bf16 head (n_pad, 16384), binomial,
    k 1, at the last block start (the largest offsets), with identical bits
    over two runs: (its arguments, the larger of max|dg| and max|dcorr|);
    fails beyond g 3e-2, corr 2e-2 x max|corr|."""
    from sgdnet_tpu_torch.solver import head_kernel as hk

    D, k = 16384, 1
    torch.manual_seed(seed)
    head = torch.randn((n_pad, D), device=dev, dtype=torch.bfloat16)
    start = n_pad - B
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    w = t(rng.standard_normal((k, D)) / np.sqrt(D))
    args = (head, start, w, t(0.1 * rng.standard_normal((B, k))), t(rng.random((B, k)) < 0.5),
            t(0.1 * rng.standard_normal((B, k))), t(rng.random(B) < 0.9), "binomial")
    g, corr = hk.fused_head_step_at(*args)
    g_ref, corr_ref = hk.fused_head_step_reference(*args)
    same = all(torch.equal(u, v) for u, v in zip((g, corr), hk.fused_head_step_at(*args)))
    torch.cuda.synchronize()
    eg, ec = float((g - g_ref).abs().max()), float((corr - corr_ref).abs().max())
    cmax = float(corr_ref.abs().max())
    ok = eg <= 3e-2 and ec <= 2e-2 * max(cmax, 1.0)
    print(f"  K2 binomial bf16 n_pad={n_pad} D={D} B={B} k=1 at start {start}: max|dg|={eg:.3e} "
          f"max|dcorr|={ec:.3e} (max|corr|={cmax:.3e}; bound g 3e-2, corr 2e-2*max|corr|), bits identical over "
          f"two runs: {same} {'ok' if ok else 'FAIL'}")
    check(ok, f"K2 disagrees with its twin at bf16 n_pad {n_pad} B {B}")
    check(same, f"K2 gave different bits in two runs at bf16 n_pad {n_pad} B {B}")
    return args, max(eg, ec)


def phase_k2_wide(rng, dev, seed):
    from sgdnet_tpu_torch.solver import head_kernel as hk

    n_pad, B, k = 106496, 8192, 1
    args, err = _k2_bf16_case(rng, dev, seed, n_pad, B)
    head, start, w = args[:3]
    D = head.shape[1]
    ms = cuda_ms(lambda: hk.fused_head_step_at(*args), 20)
    plain_ms = cuda_ms(lambda: hk.fused_head_step_reference(*args), 20)
    xb = head[start:start + B]
    wt = w.to(torch.bfloat16).T.contiguous()
    gct = torch.zeros((k, B), device=dev, dtype=torch.bfloat16)
    two_ms = cuda_ms(lambda: (torch.mm(xb, wt, out_dtype=torch.float32),
                              torch.mm(gct, xb, out_dtype=torch.float32)), 20)
    # the bf16 block once, w and the (B, k) operands in, g and corr out
    b = roofline(2 * B * D + 4 * (2 * k * D + 4 * B * k + B), 4 * B * D * k, BF16_FLOPS)
    dev_ms = device_ms(lambda: hk.fused_head_step_at(*args), 10, hk.KERNEL_NAMES)
    check(dev_ms is not None, "the profile shows no K2 kernel: no device time measured")
    gbs = 2 * B * D / dev_ms / 1e6
    print(f"  K2 time there ({hk.device_plan(head, B, k)}): kernel {ms:.4f} ms a call ({dev_ms:.4f} ms on the device, "
          f"{gbs:.1f} GB/s of head, beside the full-head torch.sum rate of phase 12; earlier "
          f"{EARLIER['k2_bf16'][0]} / {EARLIER['k2_bf16'][1]}), plain torch {plain_ms:.4f} ms, the two bf16 torch.mm "
          f"products {two_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": None,
            "two_products_ms": two_ms, "device_ms": dev_ms, "head_gb_per_s": gbs}


# ---------------------------------------------------------------------------
# phases 9 and 10: the sparse slices
# phases 9 and 9b: K6 against the chain it replaced
# ---------------------------------------------------------------------------


def all_device_ms(fn, reps: int) -> float | None:
    """Device time per call of fn over every kernel it launches
    (torch.profiler over `reps` calls after a warm-up; None where it saw
    none)."""
    from sgdnet_tpu_torch.utils.profiling import device_kernels, self_device_us
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(self_device_us(e) for e in device_kernels(prof))
    return us / 1e3 / reps if us > 0 else None


def phase_k6(made, fit_launches, seed, dev, what, card) -> dict:
    """K6 at the step's shapes (`made` is the fit's (step, x, y, config)):
    through the step's own bound launcher (`step.finish`), or, where the
    fit took the chain (a standardized sparse fit carries the centering
    term xc, which keeps it), through a launcher bound to the same B, k, p,
    head width, elastic net, w_total and intercept; on a state and
    operands drawn from its own seed (wb of 0s and 1s, as the fits'
    weights), against the chain of torch ops it replaced
    (`finish_step_reference`) run on the card: the new w and g_sum the
    same bits, the intercept within 1e-6 relative (its sum runs in another
    order), the same bits from two launches; then a call (CUDA events),
    device time, the chain's (its head merge on a copy) and the bound:
    corr, the head's corr, w and g_sum read once, w and g_sum written once,
    wb and g_change read once."""
    from sgdnet_tpu_torch.solver import finish_kernel as fk
    from sgdnet_tpu_torch.solver import saga

    from sgdnet_tpu_torch.penalties import ElasticNet

    step, x, y, config = made
    L = step.finish
    check((L is None) == (fit_launches == 0), f"{what}: K6 bound {L is not None}, its calls {fit_launches}")
    if L is None:
        L = fk.FinishLauncher(config.batch_size, y.shape[1], x.n_cols, x.n_head, y.dtype, dev, ElasticNet(),
                              float(x.n_rows), config.fit_intercept)
    B, k, p, D, dt = L.B, L.k, L.p, L.D, L.dtype
    rng = np.random.default_rng(seed + 1000 + k)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev).to(dt)  # noqa: E731
    state = saga.SagaState(w=t(0.05 * rng.standard_normal((k, p))), intercept=t(rng.standard_normal(k)),
                           g_mem=torch.zeros((B, k), dtype=dt, device=dev), g_sum=t(1e-3 * rng.standard_normal((k, p))),
                           g_sum_intercept=t(1e-3 * rng.standard_normal(k)))
    ops = dict(wb=t(rng.random(B) < 0.95), g_change=t(0.1 * rng.standard_normal((B, k))),
               corr=t(rng.standard_normal((k, p))), corr_head=t(rng.standard_normal((k, D))) if D else None)
    scal = saga._scalars(3e-3, 5.0, 0.0, 1.0, saga.np_dtype(dt))
    state = L.prepare(state)
    before = fk.finish_step.launches
    a, b = L(state, scal, **ops), L(state, scal, **ops)
    check(fk.finish_step.launches == before + 2, f"K6 ({what}): not one counted call a launch")

    def chain():
        return fk.finish_step_reference(state, scal, ops["wb"], ops["g_change"], ops["corr"], L.penalty, L.w_total,
                                        L.fit_intercept, pf=L.pf, box=L.box, corr_head=ops["corr_head"])

    ref = chain()
    torch.cuda.synchronize()
    check(all(torch.equal(u, v) for u, v in zip(a, b)), f"K6 gave different bits in two launches ({what})")
    same = torch.equal(a.w, ref.w) and torch.equal(a.g_sum, ref.g_sum)
    rel = max(float((u - v).abs().max()) / max(float(v.abs().max()), 1e-30)
              for u, v in ((a.intercept, ref.intercept), (a.g_sum_intercept, ref.g_sum_intercept)))
    zeros = int((a.w == 0).sum())
    print(f"  K6 at {what}'s step (B {B}, k {k}, p {p}, head {D}, {dt}): w and g_sum the chain's bits {same}, "
          f"intercept max rel diff {rel:.3e} (bound 1e-6), bits identical over two launches; {zeros} of {k * p} "
          f"coefficients zeroed by the prox; the fit's K6 calls {fit_launches} (0: its xc kept the chain)")
    check(same, f"K6's w / g_sum differ from the chain's bits ({what})")
    check(rel <= 1e-6, f"K6's intercept disagrees with the chain ({what}): rel {rel:.3e}")
    item = torch.empty((), dtype=dt).element_size()
    nbytes = item * (5 * k * p + k * D + B * k + B)
    r = {"k": k, "p": p, "D": D, "B": B, "fit_launches": fit_launches, "same_bits_as_chain": same,
         "intercept_max_rel_diff": rel,
         "ms": cuda_ms(lambda: L(state, scal, **ops), 200),
         "device_ms": device_ms(lambda: L(state, scal, **ops), 50, ("finish_bw", "finish_columns")),
         "plain_ms": cuda_ms(chain, 50), "plain_device_ms": all_device_ms(chain, 20),
         **roofline(nbytes, 10 * k * p, F32_FLOPS), "max_abs_err": 0.0 if same else None}
    check(r["device_ms"] is not None, "the profile shows no finish_bw / finish_columns kernel: no K6 device time")
    print(f"    K6 step finish: {r['ms']:.4f} ms a call, {_fmt(r['device_ms'])} on the device "
          f"({_pct(r['bound_ms'], r['device_ms'])} of the bound); the chain {r['plain_ms']:.4f} ms a call, "
          f"{_fmt(r['plain_device_ms'])} on the device; bound {r['bound_ms']:.6f} ms ({r['bound_by']}) [{card}]")
    return r


# ---------------------------------------------------------------------------


def _wrappers() -> dict:
    from sgdnet_tpu_torch.solver import epoch_kernel as ek
    from sgdnet_tpu_torch.solver import finish_kernel as fk
    from sgdnet_tpu_torch.solver import head_kernel as hk
    from sgdnet_tpu_torch.solver import tail_kernel as tk
    from sgdnet_tpu_torch.tools import probe_kernels as pk

    return {"K1": ek.saga_epochs, "K2": hk.fused_head_step_at, "K3": tk.coo_tail_forward, "K4": tk.coo_tail_outer,
            "K5": tk.coo_tail_sum, "K6": fk.finish_step, "P1": pk.epoch_probe, "P2": pk.block_colsum,
            "P3": pk.block_colsum_pipelined}


def _reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0


def _launches() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def _objective(f, x, y, sd):
    """Per-lambda penalized objective of a binomial lasso fit on the
    original data: mean log-loss + lambda |beta * sd|_1."""
    lp = np.asarray(x @ f.beta[:, 0, :].T) + np.asarray(f.a0)[None, :]
    loss = np.mean(np.logaddexp(0.0, lp) - y[:, None] * lp, axis=0)
    return loss + f.lambda_ * np.abs(f.beta[:, 0, :] * sd[None, :]).sum(axis=1)


#: slices D's and E's depth here: the first 3 lambdas of their 10-lambda
#: path (the same points, lambda_max down to 0.05^(2/9) lambda_max)
FIRST_THREE = dict(nlambda=3, lambda_min_ratio=0.05 ** (2 / 9))


def run_sparse_slice(csr, y, dev, seed, kw):
    """The slice's fit: (fit, wall, peak device memory, the step it built)."""
    import sgdnet_tpu_torch as st
    from sgdnet_tpu_torch.tools.profile_sparse_slices import capture_steps

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with capture_steps() as made:
        t0 = time.perf_counter()
        f = st.fit(csr, y, device=dev, seed=seed, **kw)
        wall = time.perf_counter() - t0
    return f, wall, torch.cuda.max_memory_allocated(), made[-1]


def profile_slice(name, csr, y, dev, seed, kw, card) -> dict:
    """Where a short fit of the slice (2 lambdas, 4 epochs an attempt)
    spends the device's time: torch.profiler over the whole fit(), warmed
    up by the slice's own fits that ran just before it in this process;
    the busy share is the kernels' device time over the fit's wall, and
    the top kernels by device time with their calls."""
    import sgdnet_tpu_torch as st
    from sgdnet_tpu_torch.utils.profiling import device_kernels, self_device_us as dev_us
    from torch.profiler import ProfilerActivity, profile

    short = dict(kw, nlambda=2, maxit=4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        f = st.fit(csr, y, device=dev, seed=seed, **short)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kern = device_kernels(prof)
    busy = sum(dev_us(e) for e in kern) / 1e6
    top = [{"kernel": e.key[:60], "calls": e.count, "device_ms": dev_us(e) / 1e3} for e in
           sorted(kern, key=dev_us, reverse=True)[:6]]
    from sgdnet_tpu_torch.solver.head_kernel import KERNEL_NAMES

    k2 = {nm: sum(e.count for e in kern if nm in e.key) for nm in KERNEL_NAMES}
    print(f"  slice {name} profile (a 2-lambda fit, {f.npasses} epochs, under torch.profiler): {wall:.3f} s wall, "
          f"{f.stats['wall_time_s']:.3f} s path, device busy {busy:.3f} s = {busy / wall:.3f} of the wall [{card}]")
    for t in top:
        print(f"    {t['device_ms']:10.3f} ms  {t['calls']:6d} calls  {t['kernel']}")
    return {"wall_s": wall, "path_s": f.stats["wall_time_s"], "epochs": f.npasses, "busy_s": busy,
            "busy_share": busy / wall, "top": top, "k2_kernel_calls": k2}


def check_sparse_slice(name, f, wall, peak, launches, step, csr, y, sd, dev, seed, kw, card, plain_lambdas=None,
                       profile=True):
    """The slice's checks and numbers; the plain comparison fit runs the
    first `plain_lambdas` lambdas of its path (None: all); `profile`:
    where its device time goes (`profile_slice`)."""
    import sgdnet_tpu_torch as st
    from sgdnet_tpu_torch.tools.profile_sparse_slices import step_profile

    lay = f.stats["layout"]
    k2 = kw["hybrid_head_dtype"] == "bfloat16"
    n = csr.shape[0]
    print(f"  slice {name} ({n} x {csr.shape[1]}, {lay['head_dtype']} head {lay['head_width']} wide, "
          f"B {kw['batch_size']}, {len(f.lambda_)} lambdas): launches K2 {launches['K2']}, K3 {launches['K3']}, "
          f"K4 {launches['K4']} [{card}]")
    check(f.stats["tail_kernel"] is True and launches["K3"] > 0 and launches["K4"] > 0,
          f"slice {name} did not run through K3 / K4")
    check(f.stats["head_kernel"] is k2 and (launches["K2"] > 0) is k2,
          f"slice {name}: K2 {'did not run' if k2 else 'ran'}")
    check(np.isfinite(f.beta).all() and np.isfinite(f.dev_ratio).all(), f"slice {name}: non-finite path")
    dr = f.dev_ratio
    check(dr[-1] > dr[0] and np.all(np.diff(dr) >= -1e-3), f"slice {name}: dev_ratio does not rise: {dr}")
    path = f.stats["wall_time_s"]
    nnz_s = f.npasses * n * 76 / path
    print(f"  slice {name} through the kernels: {wall:.3f} s fit wall, {path:.3f} s path, {wall - path:.3f} s set-up, "
          f"{f.npasses} epochs, {nnz_s:.4g} nnz/s on the path, peak device memory {peak / 2**30:.2f} GiB [{card}]")
    sp_ = step_profile(*step, dev)
    print(f"  slice {name} step (one epoch of its {sp_['steps']} blocks, the fit's own step): {sp_['ms_per_step']:.4f} "
          f"ms a step on the host clock, {sp_['kernels_per_step']:.2f} kernel launches a step "
          f"({sp_['device_events_per_step']:.2f} device events) as torch.profiler counts them [{card}]")
    plain_kw = {k: v for k, v in kw.items() if k != "nlambda"}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fp = st.fit(csr, y, device=dev, seed=seed, lambda_path=f.lambda_[:plain_lambdas], use_pallas=False,
                use_tail_kernel=False, **plain_kw)
    wall_p = time.perf_counter() - t0
    peak_p = torch.cuda.max_memory_allocated()
    check(fp.stats["head_kernel"] is False and fp.stats["tail_kernel"] is False, f"plain slice {name} ran a kernel")
    path_p = fp.stats["wall_time_s"]
    nnz_p = fp.npasses * n * 76 / path_p
    print(f"  slice {name} on plain torch ops, the first {fp.n_lambda} lambdas: {wall_p:.3f} s fit wall, "
          f"{path_p:.3f} s path, {wall_p - path_p:.3f} s "
          f"set-up, {fp.npasses} epochs, {nnz_p:.4g} nnz/s on the path, peak {peak_p / 2**30:.2f} GiB [{card}]")
    ok, op = _objective(f, csr, y, sd)[: fp.n_lambda], _objective(fp, csr, y, sd)
    rel = float(np.max(np.abs(ok - op) / np.abs(op)))
    print(f"  slice {name} penalized objective per lambda, kernels vs plain: max rel diff {rel:.3e} (bound 1e-4); "
          f"objective {ok.round(6)}; dev_ratio {dr.round(4)}; return codes {f.return_codes.tolist()}")
    check(rel <= 1e-4, f"slice {name}: the kernels' path disagrees with the plain path")
    prof = profile_slice(name, csr, y, dev, seed, kw, card) if profile else None
    return {"profile": prof, "step": sp_, "wall_s": wall, "path_s": path, "setup_s": wall - path, "epochs": f.npasses,
            "nnz_per_s": nnz_s,
            "peak_bytes": peak, "head_width": lay["head_width"], "launches": launches, "plain_wall_s": wall_p,
            "plain_lambdas": fp.n_lambda, "plain_path_s": path_p, "plain_epochs": fp.npasses, "plain_nnz_per_s": nnz_p,
            "plain_peak_bytes": peak_p,
            "objective_max_rel_diff": rel}


def _objective_multinomial(f, xt, yt, sd):
    """Per-lambda penalized objective of a multinomial lasso fit on the
    original data: mean cross-entropy + lambda |beta * sd|_1 over classes
    and columns, in f64 torch ops on the card (xt the design as a sparse
    CSR tensor, yt the class codes 0 .. k - 1)."""
    out = []
    rows = torch.arange(xt.shape[0], device=xt.device)
    for i, lam in enumerate(f.lambda_):
        b = torch.as_tensor(f.beta[i], device=xt.device)
        lp = xt @ b.T + torch.as_tensor(np.asarray(f.a0)[i], device=xt.device)[None, :]
        loss = torch.mean(torch.logsumexp(lp, 1) - lp[rows, yt])
        out.append(float(loss) + lam * float(np.abs(f.beta[i] * sd[None, :]).sum()))
    return np.asarray(out)


def phase_slice_m(csr, sd, rng, dev, seed, card, launches) -> tuple:
    """Slice M: K2's streamed design at the step's shape, then the fit
    through K2 + K3 + K4 at 53 classes, held to the plain fit; K3 / K4 at
    k 53 on every block of the tail the fit packed."""
    import sgdnet_tpu_torch as st
    from sgdnet_tpu_torch.solver import head_kernel as hk
    from sgdnet_tpu_torch.solver import tail_kernel as tk
    from sgdnet_tpu_torch.tools import bench_head_streamed as bhs
    from sgdnet_tpu_torch.tools.profile_sparse_slices import SLICE_M, make_sparse_multiclass_labels, step_profile

    t_ph = time.perf_counter()

    def since() -> str:
        return f"[{time.perf_counter() - t_ph:.1f} s into phase 9b]"

    k2 = bhs.run_shape(dev, seed, *bhs.SHAPES["M"])
    print(f"  K2 streamed {_streamed_line(k2)} ok {since()}")
    _streamed_times("slice M's shape, bf16 106496 x 16384 k 53 B 8192", k2, EARLIER["k2_streamed_m"], card)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    y = make_sparse_multiclass_labels(csr, seed=seed)
    counts = np.bincount(y)
    print(f"  slice M labels: {len(counts)} classes, {counts.min()} to {counts.max()} rows a class, made in "
          f"{time.perf_counter() - t0:.2f} s")
    kw = {**SLICE_M, **FIRST_THREE}
    _reset_launches()
    f, wall, peak, step = run_sparse_slice(csr, y, dev, seed, kw)
    launches["M"] = n = _launches()
    lay = f.stats["layout"]
    B, D, k = kw["batch_size"], lay["head_width"], f.beta.shape[1]
    print(f"  slice M ({csr.shape[0]} x {csr.shape[1]}, {k} classes, {lay['head_dtype']} head {D} wide, B {B}, "
          f"{len(f.lambda_)} lambdas): launches K2 {n['K2']}, K3 {n['K3']}, K4 {n['K4']} [{card}]")
    check(k == 53 and not hk.plan(B, D, k, torch.bfloat16).resident, "slice M's step does not take the streamed K2")
    check(f.stats["head_kernel"] is True and f.stats["tail_kernel"] is True and min(n["K2"], n["K3"], n["K4"]) > 0,
          "slice M did not run through K2 + K3 + K4")
    check(np.isfinite(f.beta).all() and np.isfinite(f.dev_ratio).all(), "slice M: non-finite path")
    dr = f.dev_ratio
    check(dr[-1] > dr[0] and np.all(np.diff(dr) >= -1e-3), f"slice M: dev_ratio does not rise: {dr}")
    path = f.stats["wall_time_s"]
    nnz_s = f.npasses * csr.shape[0] * 76 / path
    print(f"  slice M through the kernels: {wall:.3f} s fit wall, {path:.3f} s path, {wall - path:.3f} s set-up, "
          f"{f.npasses} epochs, {nnz_s:.4g} nnz/s on the path, peak device memory {peak / 2**30:.2f} GiB [{card}] "
          f"{since()}")
    bt = step[1].blk_tail
    tail_rel = tail_err = 0.0
    for blk in range(bt.n_blocks):
        rel, err = _tail_block_check(tk, bt, blk, rng, dev, "slice M", ks=(k,), outer_k=k, f64=False)
        tail_rel, tail_err = max(tail_rel, rel), max(tail_err, err)
    print(f"  K3/K4 on slice M's {bt.n_blocks} tail blocks as the fit packed them (E {bt.rows.shape[1]}): K3 at "
          f"k {k}, f32, with and without its epilogue, K4 at k {k}: worst rel err {tail_rel:.3e} (bound 1e-5), "
          f"bits identical over two runs {since()}")
    bt = None
    k5 = phase_k5(step[1], k, n["K5"], seed, dev, "slice M", card)
    k6 = phase_k6(step, n["K6"], seed, dev, "slice M", card)
    torch.cuda.empty_cache()
    sp_ = step_profile(*step, dev)
    step = None
    print(f"  slice M step (one epoch of its {sp_['steps']} blocks, the fit's own step): {sp_['ms_per_step']:.4f} ms "
          f"a step on the host clock, {sp_['kernels_per_step']:.2f} kernel launches a step [{card}] {since()}")
    plain_kw = {key: v for key, v in kw.items() if key != "nlambda"}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fp = st.fit(csr, y, device=dev, seed=seed, lambda_path=f.lambda_[:2], use_pallas=False, use_tail_kernel=False,
                **plain_kw)
    wall_p = time.perf_counter() - t0
    peak_p = torch.cuda.max_memory_allocated()
    check(fp.stats["head_kernel"] is False and fp.stats["tail_kernel"] is False, "plain slice M ran a kernel")
    xt = torch.sparse_csr_tensor(torch.as_tensor(csr.indptr, dtype=torch.int64),
                                 torch.as_tensor(csr.indices, dtype=torch.int64),
                                 torch.as_tensor(csr.data, dtype=torch.float64), csr.shape).to(dev)
    yt = torch.as_tensor(y, device=dev)
    ok, op = _objective_multinomial(f, xt, yt, sd)[: fp.n_lambda], _objective_multinomial(fp, xt, yt, sd)
    xt = yt = None
    rel = float(np.max(np.abs(ok - op) / np.abs(op)))
    print(f"  slice M on plain torch ops, the first {fp.n_lambda} lambdas: {wall_p:.3f} s fit wall, "
          f"{fp.stats['wall_time_s']:.3f} s path, {fp.npasses} epochs, peak {peak_p / 2**30:.2f} GiB [{card}] "
          f"{since()}")
    print(f"  slice M penalized objective per lambda, kernels vs plain: max rel diff {rel:.3e} (bound 1e-4); "
          f"objective {ok.round(6)}; dev_ratio {dr.round(4)}; return codes {f.return_codes.tolist()}")
    check(rel <= 1e-4, "slice M: the kernels' path disagrees with the plain path")
    prof = profile_slice("M", csr, y, dev, seed, kw, card)
    streamed = {nm: prof["k2_kernel_calls"][nm] for nm in hk.STREAMED_KERNELS}
    print(f"  slice M's profile: the streamed K2 kernels' calls {streamed} {since()}")
    check(min(streamed.values()) > 0, f"slice M's profile shows no streamed K2 kernel: {streamed}")
    out = {"k2": k2, "profile": prof, "step": sp_, "wall_s": wall, "path_s": path, "setup_s": wall - path,
           "epochs": f.npasses, "nnz_per_s": nnz_s, "peak_bytes": peak, "head_width": D, "launches": n,
           "plain_wall_s": wall_p, "plain_lambdas": fp.n_lambda, "plain_path_s": fp.stats["wall_time_s"],
           "plain_epochs": fp.npasses, "plain_peak_bytes": peak_p, "objective_max_rel_diff": rel,
           "class_rows": [int(counts.min()), int(counts.max())], "tail_max_abs_err": tail_err,
           "tail_max_rel_err": tail_rel, "k5": k5, "k6": k6}
    return out


# ---------------------------------------------------------------------------
# phase 11: P1, the whole-epoch prototype probe
# ---------------------------------------------------------------------------


def phase_p1(rng, dev):
    """P1 against its plain version (two epochs, identical bits over two
    runs), its times, and K1 at P1's shape: gaussian, no intercept, P1's
    gamma, l1 and l2, the same data, B and block starts (K1's sampler
    orders replaced by P1's starts), its refresh off, one epoch a launch as
    P1 runs; K1's epoch is held to P1's plain version too."""
    from sgdnet_tpu_torch.families import get_family
    from sgdnet_tpu_torch.penalties import select_penalty
    from sgdnet_tpu_torch.solver import epoch_kernel as ek
    from sgdnet_tpu_torch.solver.saga import SagaState
    from sgdnet_tpu_torch.tools import probe_kernels as pk

    N, P, B = 4224, 128, 32
    T = N // B
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    x, y, wt = t(rng.standard_normal((N, P))), t(rng.standard_normal((N, 8))), t(np.ones((N, 8)))
    starts = [torch.as_tensor(rng.permutation(T) * B, dtype=torch.int32, device=dev) for _ in range(2)]

    def two_epochs(fn):
        state = [torch.zeros((8, P), device=dev), torch.zeros((N, 8), device=dev), torch.zeros((8, P), device=dev)]
        for st in starts:
            fn(st, x, y, wt, *state, B)
        return state

    a, b, ref = two_epochs(pk.epoch_probe), two_epochs(pk.epoch_probe), two_epochs(pk.epoch_probe_reference)
    torch.cuda.synchronize()
    same = all(torch.equal(u, v) for u, v in zip(a, b))
    rel = max(float((u - r).abs().max()) / float(r.abs().max()) for u, r in zip(a, ref))
    err = max(float((u - r).abs().max()) for u, r in zip(a, ref))
    threads, lanes, groups, stages = pk.epoch_probe_plan(P, B)
    print(f"  P1 two epochs at N {N}, P {P}, B {B} ({threads} threads, {lanes} lanes a row, {groups} column groups, "
          f"{stages} ring stages): max rel err in w, g_mem, g_sum {rel:.3e} (bound 1e-5), bits identical over two "
          f"runs: {same}")
    check(rel <= 1e-5 and same, "P1 disagrees with its twin or with itself")

    # K1 at P1's shape on the same data and starts
    fam, pen = get_family("gaussian"), select_penalty(0.5, "gaussian", "ungrouped")
    check(pen.name == "elastic_net", "K1 at P1's shape needs the elastic-net prox")
    data = ek.pad_data(x, y[:, :1], wt[:, 0])
    z = lambda *s: torch.zeros(s, device=dev)  # noqa: E731
    ps0 = ek.pad_state(SagaState(z(1, P), z(1), z(N, 1), z(1, P), z(1)), P)
    k1_args = (B, fam, pen, float(pk.GAMMA), float(pk.L1), float(pk.L2), float(N))
    k1_kw = dict(fit_intercept=False, refresh_every=0)
    ps = ps0
    for st in starts:
        ps, _ = ek.saga_epochs(data, ps, st.reshape(1, -1), *k1_args, **k1_kw)
    torch.cuda.synchronize()
    k1_rel = max(float((u - r).abs().max()) / float(r.abs().max())
                 for u, r in ((ps.w[0, :P], ref[0][0]), (ps.g_mem[:, 0], ref[1][:, 0]), (ps.g_sum[0, :P], ref[2][0])))
    print(f"  K1 at P1's shape ({ek.plan(P, 1, B).threads} threads, {ek.plan(P, 1, B).lanes} lanes a row): two "
          f"epochs against P1's plain version, max rel err {k1_rel:.3e} (bound 1e-5)")
    check(k1_rel <= 1e-5, "K1 at P1's shape disagrees with P1's plain version")

    state = two_epochs(pk.epoch_probe)
    p1_call = lambda: pk.epoch_probe(starts[0], x, y, wt, *state, B)  # noqa: E731
    k1_call = lambda: ek.saga_epochs(data, ps, starts[0].reshape(1, -1), *k1_args, **k1_kw)  # noqa: E731
    ms = cuda_ms(p1_call, 200)
    plain_ms = cuda_ms(lambda: pk.epoch_probe_reference(starts[0], x, y, wt, *state, B), 3)
    dev_ms = device_ms(p1_call, 50, ("epoch_probe",))
    k1_ms = cuda_ms(k1_call, 200)
    k1_dev = device_ms(k1_call, 50, ("saga_epochs_kernel",))
    check(dev_ms is not None and k1_dev is not None, "the profile shows no P1 or K1 kernel: no device time")
    # x, the used lanes of y / wt / g_mem, w, g_sum and the starts once in;
    # g_mem's lane, w and g_sum once out; two products a step
    bnd = roofline(4 * (N * P + 3 * N + 2 * P + T) + 4 * (N + 2 * P), 4 * N * P, F32_FLOPS)
    p1_ns, k1_ns = dev_ms / T * 1e6, k1_dev / T * 1e6
    print(f"  P1 time an epoch ({T} steps): {ms:.4f} ms a call ({dev_ms:.4f} ms on the device, {p1_ns:.1f} ns a "
          f"step; earlier design: {EARLIER['p1'][0]} / {EARLIER['p1'][1]} ms, {EARLIER['p1'][2]} ns), twin "
          f"{plain_ms:.4f} ms, bound {bnd['bound_ms']:.6f} ms ({bnd['bound_by']})")
    print(f"  K1 at P1's shape, one epoch a launch: {k1_ms:.4f} ms a call ({k1_dev:.4f} ms on the device, {k1_ns:.1f} "
          f"ns a step): K1's generality costs {k1_ns - p1_ns:.1f} ns a step over P1")
    return {"max_abs_err": err, "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": None,
            "device_ms": dev_ms, "ns_per_step_device": p1_ns, "k1_at_p1_shape_ms": k1_ms,
            "k1_at_p1_shape_device_ms": k1_dev, "k1_at_p1_shape_ns_per_step_device": k1_ns,
            "k1_at_p1_shape_max_rel_err": k1_rel}


# ---------------------------------------------------------------------------
# phase 12: P2 and P3, the head-stream probes
# ---------------------------------------------------------------------------


def _colsum_err(out, ref, head, start, B) -> float:
    """max over columns of |out - ref| / sum |x|"""
    absum = head[start:start + B].float().abs().sum(0)
    return float(((out - ref).abs() / absum).max())


def phase_p23(dev, seed):
    from sgdnet_tpu_torch.tools import probe_kernels as pk
    from sgdnet_tpu_torch.tools.bench_dma_streams import CONFIGS, plan_keys
    from sgdnet_tpu_torch.tools.bench_head_dma import seeded_head

    n_pad, D, B = 106496, 16384, 8192
    head = seeded_head(n_pad, D, seed, dev)
    start = n_pad - B  # the last block: the largest offsets
    b = roofline(2 * B * D + 4 * D, B * D, F32_FLOPS)
    lib_ms = cuda_ms(lambda: head[start:start + B].sum(0, dtype=torch.float32), 50)

    def measure(name, fn, ref_fn, names, extra):
        out = fn()
        ref = ref_fn()
        again = fn()
        torch.cuda.synchronize()
        rel = _colsum_err(out, ref, head, start, B)
        same = torch.equal(out, again)
        r = {**extra, "max_rel_err": rel, "max_abs_err": float((out - ref).abs().max()), "bits_identical": same,
             "ms": cuda_ms(fn, 50), "plain_ms": cuda_ms(ref_fn, 10), "device_ms": device_ms(fn, 20, names),
             **b, "library_ms": lib_ms}
        r["gb_per_s"] = 2 * B * D / r["ms"] / 1e6
        print(f"  {name}: max |err| / sum|x| {rel:.3e} (bound 1e-6), bits identical over two runs: {same}; "
              f"{r['ms']:.4f} ms a call ({_fmt(r['device_ms'])} on the device), {r['gb_per_s']:.1f} GB/s; "
              f"twin {r['plain_ms']:.4f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        check(rel <= 1e-6, f"{name} disagrees with its twin")
        return r

    p2 = [measure(f"P2 bt {bt}", lambda bt=bt: pk.block_colsum(head, start, B, bt),
                  lambda bt=bt: pk.block_colsum_reference(head, start, B, bt), ("colsum_tile", "sum_partials"),
                  {"bt": bt}) for bt in (256, 512, 1024)]
    check(all(r["bits_identical"] for r in p2), "P2 gave different bits in two runs")
    p3 = []
    for nb, cr in CONFIGS:
        plan = pk.launch_plan(dev, nb, cr, D, B)
        print(f"  P3 n_buf {nb} chunk {cr}: strips of {plan.width} columns ({plan.width * 2} bytes a row) x "
              f"{plan.chunks} chunks = {plan.stages} stages of {cr * plan.width * 2} bytes ({plan.boxes} TMA box(es) "
              f"each), dealt to {plan.grid} CTAs ({plan.ctas_per_sm} an SM on {plan.sms} SMs, {plan.smem} bytes "
              f"of shared memory each): {plan.rounds} round(s) of whole strips, then "
              f"{plan.strips - plan.rounds * plan.grid} strips left in contiguous runs; {plan.stages_per_cta[0]}-{plan.stages_per_cta[1]} stages a CTA, "
              f"{plan.pieces} rows of partial sums")
        p3.append(measure(f"P3 n_buf {nb} chunk {cr}",
                          lambda nb=nb, cr=cr: pk.block_colsum_pipelined(head, start, B, nb, cr),
                          lambda cr=cr: pk.block_colsum_reference(head, start, B, cr), ("colsum_pipelined",),
                          {"n_buf": nb, "chunk_rows": cr, "plan": plan_keys(plan, True)}))
        print(f"    {100 * b['bound_ms'] / p3[-1]['ms']:.1f}% of the bound a call, "
              f"{_pct(b['bound_ms'], p3[-1]['device_ms'])} on the device; the library call {lib_ms:.4f} ms")
    check(all(r["bits_identical"] for r in p3), "P3 gave different bits in two runs")
    print(f"  P3's earlier design (a cp.async ring, a CTA a strip), best ring: {EARLIER['p3'][0]} / "
          f"{EARLIER['p3'][1]} ms")
    first = pk.block_colsum_pipelined(head, 0, B, *CONFIGS[0])  # the first block: the smallest offsets
    check(_colsum_err(first, pk.block_colsum_reference(head, 0, B, CONFIGS[0][1]), head, 0, B) <= 1e-6,
          "P3 disagrees with its twin on the first block")
    encode_ns = pk.pipeline_encode_ns(head, *CONFIGS[0], B)
    print(f"  P3's tensor-map encode on the host: {encode_ns:.0f} ns a call")
    ceil_ms = cuda_ms(lambda: torch.sum(head, dtype=torch.float32), 10)
    ceil = {"ms": ceil_ms, "gb_per_s": 2 * n_pad * D / ceil_ms / 1e6, **roofline(2 * n_pad * D + 4, n_pad * D,
                                                                               F32_FLOPS)}
    print(f"  the library call head[s:s+B].sum(0, dtype=float32): {lib_ms:.4f} ms; full-head torch.sum "
          f"(3.489 GB): {ceil_ms:.4f} ms, {ceil['gb_per_s']:.1f} GB/s, bound {ceil['bound_ms']:.4f} ms")
    head = None
    torch.cuda.empty_cache()

    def best(rows):
        top = min(rows, key=lambda r: r["ms"])
        return {**top, "configs": rows}

    return best(p2), {**best(p3), "encode_ns": encode_ns}, ceil


def run_probe_paths(dev, seed, launches):
    """The three probe entry points as a user runs them, each with the
    launch counts set to 0 just before it and read just after."""
    from sgdnet_tpu_torch.tools import bench_dma_streams, bench_epoch_kernel, bench_head_dma

    out = {}
    for key, tool, kw in (("P1", bench_epoch_kernel, dict(twin_epochs=5)), ("H", bench_head_dma, {}),
                          ("S", bench_dma_streams, {})):
        _reset_launches()
        t0 = time.perf_counter()
        out[key] = tool.run(dev, seed, **kw)
        launches[key] = _launches()
        print(f"  {tool.__name__} ({time.perf_counter() - t0:.1f} s): {json.dumps(out[key])}")
        torch.cuda.empty_cache()
    check(launches["P1"]["P1"] > 0 and launches["H"]["P2"] > 0 and launches["H"]["K2"] > 0
          and launches["S"]["P3"] > 0, f"a probe entry point launched no kernel: {launches}")
    return out


def planner_check(f, ceiling, k3, k4, card) -> dict:
    """The plan slice E ran on, its predicted epoch beside the measured
    one, and the planner's constants beside this run's measurements of
    them: the full-head torch.sum rate, and K3 + K4's device time on slice
    C's largest block over 4 x its entries."""
    from sgdnet_tpu_torch.core import layout

    plan = f.stats["layout_plan"]
    check(plan is not None and f.stats["layout"]["head_width"] == plan["max_head"], "slice E ran without its plan")
    ms_epoch = f.stats["wall_time_s"] / f.npasses * 1e3
    stream = 2 * 106496 * 16384 / (ceiling["ms"] / 1e3)
    elem = None
    if k3["device_ms"] is not None and k4["device_ms"] is not None:
        elem = (k3["device_ms"] + k4["device_ms"]) / 1e3 / (4 * k3["block_entries"])
    predicted = plan["head_ms"] + plan["tail_ms"]
    print(f"  slice E plan: D {plan['max_head']}, coverage {plan['coverage']:.4f}, break-even "
          f"{plan['break_even_nnz']:.1f} nonzeros a column; predicted {plan['head_ms']:.4f} + {plan['tail_ms']:.4f} "
          f"= {predicted:.4f} ms an epoch, measured {ms_epoch:.4f} ms an epoch ({ms_epoch / predicted:.1f}x) [{card}]")
    print(f"  planner constants: STREAM_BYTES_PER_S {layout.STREAM_BYTES_PER_S:.4g} (this run {stream:.4g}), "
          f"ELEM_OP_S {layout.ELEM_OP_S:.4g} (this run {elem if elem is None else f'{elem:.4g}'})")
    return {**plan, "predicted_ms_per_epoch": predicted, "measured_ms_per_epoch": ms_epoch,
            "stream_bytes_per_s_measured": stream, "elem_op_s_measured": elem,
            "stream_bytes_per_s_constant": layout.STREAM_BYTES_PER_S, "elem_op_s_constant": layout.ELEM_OP_S}


def model_epoch_ms(csr, width: int, kw) -> float:
    """The planner's cost model (core/layout.py) at a given head width:
    the head's stream plus the tail's element-ops, ms an epoch."""
    from sgdnet_tpu_torch.core import layout

    col_nnz = np.sort(np.bincount(csr.indices, minlength=csr.shape[1]))[::-1].astype(np.int64)
    B = kw["batch_size"]
    n_pad = -(-csr.shape[0] // B) * B
    passes = 2.0 + 1.0 / kw["g_sum_refresh_every"]
    head_s = passes * n_pad * width * 1 / layout.STREAM_BYTES_PER_S  # int8 head: 1 byte an element
    tail_s = int(col_nnz[width:].sum()) * layout.TAIL_OPS_PER_ENTRY * layout.ELEM_OP_S
    return (head_s + tail_s) * 1e3


def planner_neighbours(csr, y, dev, seed, plan, lambdas, card) -> list:
    """Slice E through the same kernels at the plan's width, half of it
    (rounded up to 128 columns) and twice it, coverage 1.0, each fit made
    fresh on `lambdas` (the first lambdas of slice E's path), the plan's
    width first: each width's measured ms an epoch beside the cost
    model's.  The model is checked
    against the plan's own prediction at the plan's width first."""
    from sgdnet_tpu_torch.tools.profile_sparse_slices import SLICE_E

    d = plan["max_head"]
    model_d = model_epoch_ms(csr, d, SLICE_E)
    check(abs(model_d - (plan["head_ms"] + plan["tail_ms"])) <= 1e-9 * model_d,
          f"the cost model here ({model_d} ms) is not the planner's ({plan['head_ms'] + plan['tail_ms']} ms)")
    rows = []
    kw = {k: v for k, v in SLICE_E.items() if k not in ("nlambda", "lambda_min_ratio")}
    for width in (d, -(-(d // 2) // 128) * 128, 2 * d):
        f, _, _, _ = run_sparse_slice(csr, y, dev, seed, dict(kw, lambda_path=lambdas, hybrid_max_head=width,
                                                              hybrid_coverage=1.0))
        check(f.stats["layout_plan"] is None and f.stats["layout"]["head_width"] == width
              and f.stats["tail_kernel"] is True and np.isfinite(f.beta).all(),
              f"slice E at width {width} did not run as asked: {f.stats['layout']}")
        path = f.stats["wall_time_s"]
        rows.append({"width": width, "plan": width == d, "epochs": f.npasses, "path_s": path,
                     "ms_per_epoch": path / f.npasses * 1e3, "model_ms_per_epoch": model_epoch_ms(csr, width, SLICE_E)})
        print(f"  slice E at D {width}{' (the plan)' if width == d else ''}, {len(lambdas)} lambdas: {path:.3f} s "
              f"path, "
              f"{f.npasses} epochs, "
              f"{rows[-1]['ms_per_epoch']:.4f} ms an epoch measured, {rows[-1]['model_ms_per_epoch']:.4f} modelled "
              f"[{card}]")
    fastest = min(rows, key=lambda r: r["ms_per_epoch"])
    print(f"  the fastest of the three widths is D {fastest['width']}"
          f"{' (the plan)' if fastest['plan'] else ', not the plan'}")
    return rows


# ---------------------------------------------------------------------------
# phases 14-16: cross-validation and screening
# ---------------------------------------------------------------------------


class FoldClock:
    """Each fold of parallel/cv.py timed (host clock, after a synchronize)
    with the K1-K4 launches it made, while installed."""

    def __init__(self):
        from sgdnet_tpu_torch.parallel import cv as pcv

        self.pcv, self.real, self.folds = pcv, pcv._fold_fit_and_score, []

    def __enter__(self):
        def timed(*a, **kw):
            before = _launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.real(*a, **kw)
            torch.cuda.synchronize()
            after = _launches()
            self.folds.append({"wall_s": time.perf_counter() - t0,
                               **{k: after[k] - before[k] for k in ("K1", "K2", "K3", "K4")}})
            return out

        self.pcv._fold_fit_and_score = timed
        return self

    def __exit__(self, *exc):
        self.pcv._fold_fit_and_score = self.real


#: phase 14's folds (and phase 17's fold mesh's): 3 of cv_fit's default 10,
#: for the run's time
CV_A_FOLDS = 3


def phase_cv_abalone(dev, card, launches) -> dict:
    """Phase 14: 3-fold CV of slice A's fit, serial (a fit a fold) and
    fold-parallel, the full path through K1; each fold's K1 launches; the
    two held to each other as tests/test_parallel.py holds the JAX
    package's (cv_raw rtol 0.05, atol 1e-3; lambda_min equal); two folds of
    the parallel path on the first 3 lambdas (slice A's thresh) against
    the plain step.  The fold-parallel scores are returned for phase 17's
    fold mesh."""
    import sgdnet_tpu_torch as st
    from sgdnet_tpu_torch.api import cv as cvmod
    from sgdnet_tpu_torch.parallel.cv import parallel_fold_scores

    x, y = st.load_abalone()
    # thresh 1e-6: the CV curve's tail is flat (an OLS regime), and at the
    # default 1e-3 the solver's error there outweighs the curve's slope, so
    # which of its last lambdas is lambda_min would be a coin toss
    kw = dict(family="gaussian", alpha=0.8, nfolds=CV_A_FOLDS, thresh=1e-6, maxit=5000, device=dev)
    fits, real_fit = [], cvmod.fit_fn

    def recorded(*a, **k):
        f = real_fit(*a, **k)
        fits.append(f.stats)
        return f

    cvmod.fit_fn = recorded
    try:
        _reset_launches()
        t0 = time.perf_counter()
        cv_s = st.cv_fit(x, y, **kw)
        wall_s = time.perf_counter() - t0
        launches["cv_serial"] = _launches()
    finally:
        cvmod.fit_fn = real_fit
    check(len(fits) == CV_A_FOLDS + 1 and all(s["epoch_kernel"] and s["epoch_chunks"] > 0 for s in fits),
          f"serial CV: a fit did not run through K1: {[(s['epoch_kernel'], s['epoch_chunks']) for s in fits]}")
    check(launches["cv_serial"]["K1"] == sum(s["epoch_chunks"] for s in fits), "serial CV: K1 launches are not chunks")
    _reset_launches()
    with FoldClock() as clock:
        t0 = time.perf_counter()
        cv_p = st.cv_fit(x, y, parallel=True, **kw)
        wall_p = time.perf_counter() - t0
    launches["cv_parallel"] = _launches()
    folds_k1 = [f["K1"] for f in clock.folds]
    check(len(folds_k1) == CV_A_FOLDS and min(folds_k1) > 0, f"fold-parallel CV: a fold did not launch K1: {folds_k1}")
    rel = float(np.max(np.abs(cv_p.cv_raw[0] - cv_s.cv_raw[0]) / (np.abs(cv_s.cv_raw[0]) * 0.05 + 1e-3)))
    same_min = abs(np.log(cv_p.lambda_min) - np.log(cv_s.lambda_min)) < 1e-9
    print(f"  CV abalone (gaussian alpha 0.8, {len(cv_s.lambda_[0])} lambdas, thresh 1e-6, {CV_A_FOLDS} folds) "
          f"serial: {wall_s:.3f} s, {launches['cv_serial']['K1']} K1 launches over {len(fits)} fits; parallel: "
          f"{wall_p:.3f} s, K1 launches a fold {folds_k1}, fold walls "
          f"{[round(f['wall_s'], 3) for f in clock.folds]} s [{card}]")
    print(f"  CV abalone parallel vs serial: max |d cv_raw| / (0.05 |serial| + 1e-3) = {rel:.3f} (bound 1); "
          f"lambda_min {cv_p.lambda_min:.6g} / {cv_s.lambda_min:.6g}, lambda_1se {cv_p.lambda_1se:.6g} / "
          f"{cv_s.lambda_1se:.6g}")
    check(rel <= 1.0 and same_min, "CV abalone: fold-parallel CV disagrees with serial CV")
    # two of the folds on the first 3 lambdas, K1 against the plain step
    foldid = np.zeros(len(y), dtype=int)
    for j, chunk in enumerate(np.array_split(np.random.default_rng(0).permutation(len(y)), CV_A_FOLDS)):
        foldid[chunk] = j
    lam3 = cv_s.lambda_[0][:3]
    two = dict(alpha=0.8, lambda_path=lam3, family="gaussian", device=dev, sampling="block")  # slice A's thresh
    t0 = time.perf_counter()
    k1 = parallel_fold_scores(x, y, foldid, 2, **two)
    wall_k1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = parallel_fold_scores(x, y, foldid, 2, use_epoch_kernel=False, **two)
    wall_plain = time.perf_counter() - t0
    rel2 = float(np.max(np.abs(k1 - plain) / np.abs(plain)))
    print(f"  CV abalone folds 0-1, first 3 lambdas: K1 {wall_k1:.3f} s, plain step {wall_plain:.3f} s; scores "
          f"max rel diff {rel2:.3e} (bound 1e-3) [{card}]")
    check(rel2 <= 1e-3, "CV abalone: K1 folds disagree with the plain step")
    return {"serial_wall_s": wall_s, "parallel_wall_s": wall_p, "fold_walls_s": [f["wall_s"] for f in clock.folds],
            "k1_launches_per_fold": folds_k1, "serial_k1_launches": launches["cv_serial"]["K1"],
            "parallel_vs_serial": rel, "lambda_min": cv_s.lambda_min, "lambda_1se": cv_s.lambda_1se,
            "two_folds_k1_s": wall_k1, "two_folds_plain_s": wall_plain, "two_folds_rel_diff": rel2,
            "parallel_cv_raw": cv_p.cv_raw[0].tolist(), "parallel_lambda_min": cv_p.lambda_min,
            "parallel_lambda_1se": cv_p.lambda_1se}


def phase_cv_slice_c(csr, y, lam_c, path_c, dev, seed, card, launches) -> dict:
    """Phase 15: 3-fold fold-parallel CV at slice C's data and settings on
    its 10-lambda path, use_pallas=True (K2 + K3 + K4), held to the same
    call on plain torch ops; each fold's wall beside one unmasked slice C
    path of this run, the whole call's wall and peak device memory; then
    serial CV of the same folds on the path's first 3 lambdas (`cv_fit`, a
    fit on each fold's rows) with each fit's wall, the other way to run
    them."""
    import sgdnet_tpu_torch as st
    from sgdnet_tpu_torch.api import cv as cvmod
    from sgdnet_tpu_torch.parallel.cv import parallel_fold_scores
    from sgdnet_tpu_torch.tools.profile_sparse_slices import SLICE_C

    kw = {k: v for k, v in SLICE_C.items() if k not in ("alpha", "nlambda", "lambda_min_ratio")}
    foldid = np.arange(csr.shape[0]) % 3
    out = {}
    # the plain comparison on the first 2 lambdas of the path, for the run's time
    for name, lam, extra in (("kernels", lam_c, dict(use_pallas=True)),
                             ("plain", lam_c[:2], dict(use_pallas=False, use_tail_kernel=False))):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        with FoldClock() as clock:
            t0 = time.perf_counter()
            scores = parallel_fold_scores(csr, y, foldid, 3, 1.0, lam, device=dev, seed=seed, **kw, **extra)
            wall = time.perf_counter() - t0
        launches["cv_slice_c" if name == "kernels" else "cv_slice_c_plain"] = _launches()
        out[name] = {"scores": scores, "wall_s": wall, "peak_bytes": torch.cuda.max_memory_allocated(),
                     "folds": clock.folds}
        print(f"  CV slice C ({name}, {len(lam)} lambdas): {wall:.3f} s for 3 folds, fold walls "
              f"{[round(f['wall_s'], 3) for f in clock.folds]} s (one unmasked slice C path {path_c:.3f} s), peak "
              f"device memory {out[name]['peak_bytes'] / 2**30:.2f} GiB; launches K2 / K3 / K4 a fold "
              f"{[(f['K2'], f['K3'], f['K4']) for f in clock.folds]} [{card}]")
    k, p_ = out["kernels"], out["plain"]
    check(all(f["K2"] > 0 and f["K3"] > 0 and f["K4"] > 0 for f in k["folds"]),
          "CV slice C: a fold did not run through K2, K3 and K4")
    check(sum(f["K2"] + f["K3"] + f["K4"] for f in p_["folds"]) == 0, "CV slice C: the plain call ran a kernel")
    check(np.isfinite(k["scores"]).all() and k["scores"].shape == (3, len(lam_c)), "CV slice C: bad scores")
    rel = float(np.max(np.abs(k["scores"][:, :2] - p_["scores"]) / np.abs(p_["scores"])))
    print(f"  CV slice C kernels vs plain, the first 2 lambdas: scores max rel diff {rel:.3e} (bound 1e-3); mean deviance by lambda "
          f"{k['scores'].mean(axis=0).round(4)}")
    check(rel <= 1e-3, "CV slice C: the kernels' folds disagree with plain ops")
    walls, real_fit = [], cvmod.fit_fn

    def timed(*a, **kw_):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = real_fit(*a, **kw_)
        walls.append((time.perf_counter() - t0, f.stats["wall_time_s"], f.npasses))
        return f

    cvmod.fit_fn = timed
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cv_s = st.cv_fit(csr, y, foldid=foldid, lambda_path=lam_c[:3], alpha=1.0, device=dev, seed=seed, **kw)
        wall_s = time.perf_counter() - t0
    finally:
        cvmod.fit_fn = real_fit
    peak_s = torch.cuda.max_memory_allocated()
    gap = float(np.max(np.abs(cv_s.cv_raw[0] - k["scores"][:, :3]) / np.abs(cv_s.cv_raw[0])))
    check(np.isfinite(cv_s.cv_raw[0]).all() and len(walls) == 4, "CV slice C: serial CV failed")
    print(f"  CV slice C serial (cv_fit on the first 3 lambdas: the full-data fit, then a fit on each fold's rows): "
          f"{wall_s:.3f} s; fold "
          f"fits {[round(w[0], 3) for w in walls[1:]]} s wall, {[round(w[1], 3) for w in walls[1:]]} s path, "
          f"{[w[2] for w in walls[1:]]} epochs (the full-data fit {walls[0][0]:.3f} s); peak "
          f"{peak_s / 2**30:.2f} GiB; its scores vs the fold-parallel ones: max rel diff {gap:.3e} [{card}]")
    return {"wall_s": k["wall_s"], "fold_walls_s": [f["wall_s"] for f in k["folds"]], "peak_bytes": k["peak_bytes"],
            "launches_per_fold": [{n: f[n] for n in ("K2", "K3", "K4")} for f in k["folds"]],
            "plain_wall_s": p_["wall_s"], "plain_fold_walls_s": [f["wall_s"] for f in p_["folds"]],
            "plain_peak_bytes": p_["peak_bytes"], "slice_c_path_s": path_c, "rel_diff": rel,
            "serial_wall_s": wall_s, "serial_fold_walls_s": [w[0] for w in walls[1:]],
            "serial_fold_paths_s": [w[1] for w in walls[1:]], "serial_full_fit_s": walls[0][0],
            "serial_peak_bytes": peak_s, "serial_vs_parallel_rel": gap}


#: phase 16's wide dense gaussian: rows, columns
WIDE = (65536, 4096)


class SubsetLaunches:
    """K2 launches of screening's fit_path calls on its column subsets
    (told from the full-layout calls by the subset tensors it made)."""

    def __init__(self):
        from sgdnet_tpu_torch.solver import screening

        self.mod, self.subset_ptrs, self.k2, self.calls = screening, set(), 0, 0
        self.real = (screening._column_subset, screening.fit_path)

    def __enter__(self):
        real_subset, real_fit_path = self.real

        def subset(*a, **kw):
            sub = real_subset(*a, **kw)
            self.subset_ptrs.add(sub.data_ptr())
            return sub

        def fit_path(x, *a, **kw):
            before = _launches()["K2"]
            out = real_fit_path(x, *a, **kw)
            if isinstance(x, torch.Tensor) and x.data_ptr() in self.subset_ptrs:
                self.k2 += _launches()["K2"] - before
                self.calls += 1
            return out

        self.mod._column_subset, self.mod.fit_path = subset, fit_path
        return self

    def __exit__(self, *exc):
        self.mod._column_subset, self.mod.fit_path = self.real


def k2_subset_check(rng, dev, card) -> dict:
    """K2 at the shapes phase 16 gives it, held against the twin (f32: g
    1e-5, corr 2e-3) with identical bits over two runs: slice C's dense f32
    column subsets (n_pad 106496, B 8192, binomial, k 1, a fold's 0/1
    weights) at the widths its groups took (128, 256, 512), and the wide
    gaussian's (n_pad 65536, B 4096, gaussian, k 1, weights 1) at its
    subsets' width (128) and its unscreened fit's (4096, the WIDE design);
    then time a call, device time and the bound at slice C's K 512, beside
    the plain version and the two torch.mm products."""
    from sgdnet_tpu_torch.solver import head_kernel as hk

    cases = [(106496, 8192, K, "binomial") for K in (128, 256, 512)]
    cases += [(WIDE[0], 4096, K, "gaussian") for K in (128, WIDE[1])]
    worst, out, timed = 0.0, {}, None
    for n_pad, B, K, family in cases:
        start = B * 5
        head = torch.as_tensor(rng.standard_normal((n_pad, K), dtype=np.float32), device=dev)
        w = torch.as_tensor(rng.standard_normal((1, K), dtype=np.float32) / float(np.sqrt(K)), device=dev)
        lpe = torch.as_tensor(0.1 * rng.standard_normal((B, 1), dtype=np.float32), device=dev)
        gm = torch.as_tensor(0.1 * rng.standard_normal((B, 1), dtype=np.float32), device=dev)
        if family == "binomial":
            yb = torch.as_tensor((rng.random((B, 1)) < 0.5).astype(np.float32), device=dev)
            wb = torch.as_tensor((rng.random(B) < 0.67).astype(np.float32), device=dev)  # a fold's mask
        else:
            yb = torch.as_tensor(rng.standard_normal((B, 1), dtype=np.float32), device=dev)
            wb = torch.ones(B, device=dev)
        args = (head, start, w, lpe, yb, gm, wb, family)
        g, corr = hk.fused_head_step_at(*args)
        g_ref, corr_ref = hk.fused_head_step_reference(*args)
        same = all(torch.equal(u, v) for u, v in zip((g, corr), hk.fused_head_step_at(*args)))
        eg, ec = float((g - g_ref).abs().max()), float((corr - corr_ref).abs().max())
        worst = max(worst, eg, ec)
        print(f"  K2 on a screened problem's shape, {family} f32 n_pad={n_pad} D={K} k=1 B={B} "
              f"({hk.device_plan(head, B, 1)}): max|dg|={eg:.3e} max|dcorr|={ec:.3e} (bound g 1e-5, corr 2e-3), "
              f"bits identical over two runs {same}")
        check(same and eg <= 1e-5 and ec <= 2e-3, f"K2 disagrees with its twin at {family} n_pad {n_pad} D {K} B {B}")
        if (n_pad, B, K) == (106496, 8192, 512):
            timed = (args, head, w, start, B, K, n_pad)
        head = None
    args, head, w, start, B, K, n_pad = timed
    ms = cuda_ms(lambda: hk.fused_head_step_at(*args), 50)
    plain_ms = cuda_ms(lambda: hk.fused_head_step_reference(*args), 50)
    xb = head[start:start + B]
    gct = torch.zeros((1, B), device=dev)
    two_ms = cuda_ms(lambda: (xb @ w.T, gct @ xb), 50)
    dev_ms = device_ms(lambda: hk.fused_head_step_at(*args), 20, hk.KERNEL_NAMES)
    check(dev_ms is not None, "the profile shows no K2 kernel at the subset width")
    b = roofline(4 * (B * K + 2 * K + 4 * B + B), 4 * B * K, F32_FLOPS)
    print(f"  K2 time at the subset width (n_pad {n_pad}, f32 D={K} k=1 B={B}, {hk.device_plan(head, B, 1)}): kernel "
          f"{ms:.4f} ms a call ({dev_ms:.4f} ms on the device), plain torch {plain_ms:.4f} ms, the two torch.mm "
          f"products {two_ms:.4f} ms, bound {b['bound_ms']:.5f} ms ({b['bound_by']}) [{card}]")
    out.update({"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": None,
                "two_products_ms": two_ms, "device_ms": dev_ms})
    return out


def _screened(x, y, dev, seed, kw, label, launches, card):
    import sgdnet_tpu_torch as st

    torch.cuda.synchronize()
    _reset_launches()
    with SubsetLaunches() as sub:
        t0 = time.perf_counter()
        f = st.fit(x, y, device=dev, seed=seed, **kw)
        wall = time.perf_counter() - t0
    launches[label] = _launches()
    check(f.stats["tail_kernel"] == (launches[label]["K3"] > 0),
          f"{label}: stats['tail_kernel'] is {f.stats['tail_kernel']} with {launches[label]['K3']} K3 launches")
    scr = f.stats["screening"]
    print(f"  {label}: {wall:.3f} s fit wall, {f.stats['wall_time_s']:.3f} s path, {f.npasses} epochs, mean active "
          f"{scr['mean_active']:.1f} of {scr['p']} (groups {scr['active_per_group']}), full_tail_from "
          f"{scr['full_tail_from']}, fallback groups {scr['full_fallback_groups']}, KKT rounds "
          f"{scr['kkt_rounds_per_group']}; K2 launches {launches[label]['K2']} ({sub.k2} on subsets, in "
          f"{sub.calls} subset fits), K1 {launches[label]['K1']}, K3 {launches[label]['K3']}, K4 "
          f"{launches[label]['K4']} [{card}]")
    return f, wall, sub


def phase_screening(csr, y, sd, lam_c, obj_c, path_c, dev, seed, card, launches) -> dict:
    """Phase 16: slice C screened (True and "auto") on slice C's path, each
    lambda's penalized objective within 1e-4 relative of the unscreened
    fit's (phase 9); a seeded wide dense gaussian (n 65536, p 4096, 32 true
    features, B 4096, block sampling, use_pallas=True) screened and
    unscreened, coefficients within 2e-3 x scale (tests/test_screening.py)."""
    import sgdnet_tpu_torch as st
    from sgdnet_tpu_torch.tools.profile_sparse_slices import SLICE_C

    out = {"slice_c_path_s": path_c}
    kw_c = {k: v for k, v in SLICE_C.items() if k not in ("nlambda", "lambda_min_ratio")}
    for screen in (True, "auto"):
        label = f"screen_{'true' if screen is True else 'auto'}_c"
        f, wall, sub = _screened(csr, y, dev, seed, dict(kw_c, lambda_path=lam_c, screen=screen), label, launches,
                                 card)
        rel = float(np.max(np.abs(_objective(f, csr, y, sd) - obj_c) / np.abs(obj_c)))
        print(f"  {label} penalized objective vs the unscreened slice C fit: max rel diff {rel:.3e} (bound 1e-4); "
              f"unscreened path {path_c:.3f} s")
        check(np.isfinite(f.beta).all() and rel <= 1e-4, f"{label}: the screened path misses the unscreened one")
        scr = f.stats["screening"]
        out[label] = {"wall_s": wall, "path_s": f.stats["wall_time_s"], "epochs": f.npasses,
                      "mean_active": scr["mean_active"], "active_per_group": scr["active_per_group"],
                      "full_tail_from": scr["full_tail_from"], "fallback_groups": scr["full_fallback_groups"],
                      "k2_on_subsets": sub.k2, "subset_fits": sub.calls, "objective_rel_diff": rel}
    # the wide dense gaussian
    rng = np.random.default_rng(seed + 16)
    n, p = WIDE
    x = torch.randn((n, p), generator=torch.Generator(device=dev).manual_seed(seed + 16), device=dev)
    beta = np.zeros(p, np.float32)
    beta[rng.choice(p, 32, replace=False)] = rng.normal(size=32) * 2
    y_w = (x @ torch.as_tensor(beta, device=dev)).cpu().numpy() + rng.normal(size=n).astype(np.float32)
    kw_w = dict(family="gaussian", nlambda=10, lambda_min_ratio=0.1, thresh=1e-4, maxit=300, batch_size=4096,
                sampling="block", use_pallas=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f_full = st.fit(x, y_w, device=dev, seed=seed, **kw_w)
    wall_full = time.perf_counter() - t0
    check(f_full.stats["head_kernel"] is True, "the wide gaussian's unscreened fit did not run through K2")
    kw_s = dict(kw_w, nlambda=None, lambda_path=f_full.lambda_)
    res = {"unscreened_wall_s": wall_full, "unscreened_path_s": f_full.stats["wall_time_s"],
           "unscreened_epochs": f_full.npasses}
    for screen in (True, "auto"):
        label = f"screen_{'true' if screen is True else 'auto'}_wide"
        f, wall, sub = _screened(x, y_w, dev, seed, dict(kw_s, screen=screen), label, launches, card)
        scale = max(1.0, float(np.abs(f_full.beta).max()))
        rel = float(np.abs(f.beta - f_full.beta).max()) / scale
        print(f"  {label} vs unscreened ({wall_full:.3f} s fit wall, {f_full.stats['wall_time_s']:.3f} s path, "
              f"{f_full.npasses} epochs): max |d beta| / scale {rel:.3e} (bound 2e-3)")
        check(sub.k2 > 0, f"{label}: no subset fit ran through K2")
        check(rel <= 2e-3, f"{label}: the screened fit misses the unscreened one")
        scr = f.stats["screening"]
        res[label] = {"wall_s": wall, "path_s": f.stats["wall_time_s"], "epochs": f.npasses,
                      "mean_active": scr["mean_active"], "full_tail_from": scr["full_tail_from"],
                      "k2_on_subsets": sub.k2, "subset_fits": sub.calls, "beta_rel_diff": rel}
    out["wide"] = res
    return out


# ---------------------------------------------------------------------------
# phase 17: data-parallel fits on the card
# ---------------------------------------------------------------------------


def dp_kernel_check(rng, dev, csr, seed) -> dict:
    """K2, K3 and K4 against their twins at the shapes of the 2-rank fit
    (DP-C2: B 4096 a rank): K2 on a bf16 head of a rank's 53248 rows, K3
    (k 1, f32, bare and with the intercept the step adds) and K4 (k 1) on
    every block of slice C's tail packed at B 4096 (a rank's blocks are
    these: the shards split the padded rows at a block boundary)."""
    from sgdnet_tpu_torch.core.sparse import HybridCSR
    from sgdnet_tpu_torch.solver import tail_kernel as tk
    from sgdnet_tpu_torch.tools.profile_sparse_slices import SLICE_C

    _, k2_err = _k2_bf16_case(rng, dev, seed, 53248, 4096)
    th, _ = HybridCSR.split_columns(csr, coverage=SLICE_C["hybrid_coverage"], max_head=SLICE_C["hybrid_max_head"],
                                    memory_budget=SLICE_C["hybrid_memory_budget"], head_dtype="bfloat16", device=dev)
    bt = _packed_tail(th.tail, csr.shape[0], 4096, seed, dev)
    th = None
    worst = 0.0
    for blk in range(bt.n_blocks):
        w = torch.as_tensor(rng.standard_normal((1, bt.n_cols), dtype=np.float32), device=dev)
        icpt = torch.as_tensor(rng.standard_normal(1, dtype=np.float32), device=dev)
        gc = torch.as_tensor(rng.standard_normal((bt.batch, 1), dtype=np.float32), device=dev)
        pairs = [(tk.coo_tail_forward(bt, blk, w), tk.coo_tail_forward_reference(bt, blk, w)),
                 (tk.coo_tail_forward(bt, blk, w, intercept=icpt),
                  tk.coo_tail_forward_reference(bt, blk, w, intercept=icpt)),
                 (tk.coo_tail_outer(bt, blk, gc), tk.coo_tail_outer_reference(bt, blk, gc))]
        for name, (out, ref) in zip(("K3", "K3 with the intercept", "K4"), pairs):
            err = float((out - ref).abs().max())
            rel = err / max(float(ref.abs().max()), 1e-30)
            check(rel <= 1e-5, f"{name} disagrees with its plain version on slice C's block {blk} at B 4096: "
                               f"rel {rel:.3e}")
            worst = max(worst, err)
    counts = bt.counts.cpu().numpy()
    print(f"  K3 / K4 on slice C's {bt.n_blocks} blocks at B 4096 (E {bt.rows.shape[1]}, true entries "
          f"{counts.min()}-{counts.max()}, K3 {bt.lanes} lanes a row): worst abs err {worst:.3e} (rel bound 1e-5)")
    return {"k2_max_abs_err": k2_err, "tail_max_abs_err": worst}


def phase_dp_c1(csr, y, sd, lam_c, obj_c, slice_c, dev, seed, card, launches) -> dict:
    """Phase 17 (a) and (d), on a 1-rank NCCL mesh of this process: DP-C1,
    slice C's fit (bf16 head D 16384, B 8192, use_pallas=True, phase 9's
    lambdas) through K2 + K3 + K4, held to phase 9's per-lambda penalized
    objective (1e-4 relative), its path wall beside phase 9's, its
    all-reduces (one a step, one a refresh, one a loss pass), its step (ms
    and kernel launches a step) beside phase 9's, and the all-reduce of the
    step's buffer timed alone (a call, and the NCCL kernel's device time);
    then measure_scaling at 1 rank (nnz/s on the card, efficiency 1 by
    definition)."""
    import torch.distributed as dist

    import sgdnet_tpu_torch as st
    from sgdnet_tpu_torch.parallel.dist import make_mesh
    from sgdnet_tpu_torch.parallel.multihost import free_port, init_multihost
    from sgdnet_tpu_torch.parallel.scaling import measure_scaling
    from sgdnet_tpu_torch.tools.profile_sparse_slices import SLICE_C, capture_steps, step_profile

    init_multihost(f"localhost:{free_port()}", 1, 0)
    try:
        mesh = make_mesh()
        check(mesh.backend == "nccl" and mesh.device == dev, f"the 1-rank mesh is not NCCL on {dev}: {mesh}")
        kw = {k: v for k, v in SLICE_C.items() if k not in ("nlambda", "lambda_min_ratio")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        with capture_steps() as made:
            t0 = time.perf_counter()
            f = st.fit(csr, y, device=dev, seed=seed, lambda_path=lam_c, mesh=mesh, use_pallas=True, **kw)
            wall = time.perf_counter() - t0
        launches["dp_c1"] = _launches()
        peak = torch.cuda.max_memory_allocated()
        ln, ar = launches["dp_c1"], f.stats["allreduces"]
        blocks, epochs = -(-csr.shape[0] // SLICE_C["batch_size"]), f.npasses
        check(f.stats["mesh"] == {"axis": "data", "size": 1, "rank": 0, "backend": "nccl"}, f"DP-C1: {f.stats['mesh']}")
        check(f.stats["head_kernel"] and f.stats["tail_kernel"] and min(ln["K2"], ln["K3"], ln["K4"]) > 0,
              f"DP-C1 did not run through K2 + K3 + K4: {ln}")
        check(ar["step"] == epochs * blocks == ln["K2"], f"DP-C1: not one all-reduce a step: {ar}, {ln}, "
                                                         f"{epochs} epochs of {blocks} blocks")
        obj = _objective(f, csr, y, sd)
        rel = float(np.max(np.abs(obj - obj_c) / np.abs(obj_c)))
        path = f.stats["wall_time_s"]
        print(f"  DP-C1 (slice C on a 1-rank NCCL mesh, {len(lam_c)} lambdas): {wall:.3f} s fit wall, {path:.3f} s "
              f"path (phase 9's unmeshed path {slice_c['path_s']:.3f} s: {path / slice_c['path_s']:.3f}x), "
              f"{f.npasses} epochs (phase 9: {slice_c['epochs']}), peak {peak / 2**30:.2f} GiB; launches K2 "
              f"{ln['K2']}, K3 {ln['K3']}, K4 {ln['K4']}; all-reduces {ar} [{card}]")
        print(f"  DP-C1 penalized objective per lambda vs phase 9's fit: max rel diff {rel:.3e} (bound 1e-4)")
        check(rel <= 1e-4, "DP-C1 disagrees with phase 9's fit")
        sp_ = step_profile(*made[-1], dev)
        made = None
        c_step = slice_c["step"]
        print(f"  DP-C1 step (one epoch of its {sp_['steps']} blocks): {sp_['ms_per_step']:.4f} ms a step, "
              f"{sp_['kernels_per_step']:.2f} kernel launches a step ({sp_['device_events_per_step']:.2f} device "
              f"events); phase 9's unmeshed step {c_step['ms_per_step']:.4f} ms, {c_step['kernels_per_step']:.2f} "
              f"launches [{card}]")
        buf = torch.zeros(2 + csr.shape[1], device=dev)  # the step's [sum wb, sum gc, corr] at k 1
        red_ms = cuda_ms(lambda: mesh.all_reduce(buf, "timed"), 200)
        red_dev = device_ms(lambda: mesh.all_reduce(buf, "timed"), 50, ("nccl",))
        print(f"  the step's all-reduce alone ({buf.numel()} f32, one rank, NCCL): {red_ms:.4f} ms a call, "
              f"{_fmt(red_dev)} of NCCL kernel on the device [{card}]")
        f = None
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        scaling = measure_scaling(device_counts=[1])
        wall_s = time.perf_counter() - t0
        print(f"  measure_scaling at 1 rank (n 20000, p 512, density 0.1, B 256, 3 epochs, best of 3): "
              f"{scaling[1]:.4g} nnz/s, efficiency {scaling['efficiency'][1]}, shared_device "
              f"{scaling['shared_device']} ({wall_s:.1f} s) [{card}]")
        check(scaling["efficiency"][1] == 1.0 and not scaling["shared_device"], f"measure_scaling: {scaling}")
    finally:
        dist.destroy_process_group()
    return {"wall_s": wall, "path_s": path, "epochs": epochs, "peak_bytes": peak,
            "launches": ln, "allreduces": ar, "objective_max_rel_diff": rel, "step": sp_,
            "allreduce_ms": red_ms, "allreduce_device_ms": red_dev, "objective": obj.tolist(),
            "scaling_nnz_per_s": scaling[1], "scaling_efficiency": scaling["efficiency"][1]}


def _dp_rank(go, csr, y, lam3, seed) -> dict:
    """One of phase 17's two ranks sharing the card (spawned; gloo through
    the host).  It starts while the script's own phases run and waits for
    `go` before it touches the card's time: (b) DP-C2, slice C's data on 3
    lambdas at B 4096 a rank with K2 + K3 + K4, its launches, walls and
    device memory; (c) CV-A over a fold mesh of the two ranks, K1 in every
    fold."""
    import sgdnet_tpu_torch as st
    from sgdnet_tpu_torch.parallel.dist import make_mesh
    from sgdnet_tpu_torch.tools.profile_sparse_slices import SLICE_C
    from sgdnet_tpu_torch.utils import build

    build.load_library()
    mesh = make_mesh()
    dev = mesh.device
    if not go.wait(timeout=900.0):
        raise SmokeFailure("phase 17's ranks were never told to start")
    kw = {k: v for k, v in SLICE_C.items() if k not in ("nlambda", "lambda_min_ratio", "batch_size")}
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches()
    t0 = time.perf_counter()
    f = st.fit(csr, y, device=dev, seed=seed, lambda_path=lam3, mesh=mesh, use_pallas=True, batch_size=4096, **kw)
    wall = time.perf_counter() - t0
    dp = {"launches": _launches(), "wall_s": wall, "path_s": f.stats["wall_time_s"], "epochs": f.npasses,
          "beta": f.beta, "a0": f.a0, "lambda": f.lambda_, "w": f.final_state.w.cpu().numpy(),
          "mesh": f.stats["mesh"], "allreduces": f.stats["allreduces"], "head_kernel": f.stats["head_kernel"],
          "tail_kernel": f.stats["tail_kernel"], "peak_bytes": torch.cuda.max_memory_allocated(dev),
          "resident_bytes": torch.cuda.memory_allocated(dev)}
    f = None
    torch.cuda.empty_cache()
    x, yy = st.load_abalone()
    folds = make_mesh(axis="folds")
    _reset_launches()
    with FoldClock() as clock:
        t0 = time.perf_counter()
        cv = st.cv_fit(x, yy, parallel=True, cv_mesh=folds, family="gaussian", alpha=0.8, nfolds=CV_A_FOLDS,
                       thresh=1e-6, maxit=5000, device=dev)
        wall_cv = time.perf_counter() - t0
    cvm = {"cv_raw": cv.cv_raw[0], "lambda_min": cv.lambda_min, "lambda_1se": cv.lambda_1se, "folds": clock.folds,
           "launches": _launches(), "wall_s": wall_cv, "mesh": (folds.axis, folds.size, folds.rank, folds.backend)}
    return {"dp_c2": dp, "cv_mesh": cvm}


def start_dp_ranks(csr, y, lam_c, seed):
    """Start phase 17's two ranks (the kernels were built here first): they
    import, join their gloo group and load the kernels while the script's
    phases 16-17 (a) run, then wait for the event.  Returns (the event, a
    box that gets run_ranks' result or exception, the daemon thread that
    waits on it); the ranks are daemon processes, so a script that fails
    first takes them down at its exit."""
    import multiprocessing
    import threading

    from sgdnet_tpu_torch.parallel.multihost import run_ranks

    go, box = multiprocessing.get_context("spawn").Event(), {}

    def wait():
        try:
            box["ranks"] = run_ranks(_dp_rank, 2, args=(go, csr, y, lam_c[:3], seed), timeout=1200.0)
        except Exception as e:  # handed to the main thread, which raises it
            box["error"] = e

    th = threading.Thread(target=wait, daemon=True)
    th.start()
    return go, box, th


def phase_dp_shared(started, csr, y, sd, dp1, cv_a, slice_c, card, launches) -> dict:
    """Phase 17 (b) and (c): two spawned ranks share the card (gloo, each
    all-reduce through the host).  DP-C2 is held to DP-C1's first 3
    lambdas by penalized objective (1e-4 relative) with w the same bits on
    both ranks, each rank's peak device memory beside the unmeshed fit's;
    the fold mesh's CV-A scores to phase 14's fold-parallel scores (1e-6
    relative, lambda_min and lambda_1se the same), every fold through K1."""
    from types import SimpleNamespace

    go, box, th = started
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    go.set()
    th.join()
    wall = time.perf_counter() - t0
    if "error" in box:
        raise box["error"]
    ranks = box["ranks"]
    b = [r["dp_c2"] for r in ranks]
    launches["dp_c2"] = {k: sum(r["launches"][k] for r in b) for k in b[0]["launches"]}
    for r, rb in enumerate(b):
        ln = rb["launches"]
        check(rb["mesh"] == {"axis": "data", "size": 2, "rank": r, "backend": "gloo"}, f"DP-C2 rank {r}: {rb['mesh']}")
        check(rb["head_kernel"] and rb["tail_kernel"] and min(ln["K2"], ln["K3"], ln["K4"]) > 0,
              f"DP-C2 rank {r} did not run through K2 + K3 + K4: {ln}")
    same = np.array_equal(b[0]["w"], b[1]["w"]) and np.array_equal(b[0]["beta"], b[1]["beta"])
    obj = _objective(SimpleNamespace(beta=b[0]["beta"], a0=b[0]["a0"], lambda_=b[0]["lambda"]), csr, y, sd)
    ref = np.asarray(dp1["objective"][:3])
    rel = float(np.max(np.abs(obj - ref) / np.abs(ref)))
    for r, rb in enumerate(b):
        print(f"  DP-C2 rank {r} (2 ranks sharing the card through gloo, every all-reduce through the host: not a "
              f"scaling number; B 4096 a rank, 3 lambdas): {rb['wall_s']:.3f} s fit wall, {rb['path_s']:.3f} s path, "
              f"{rb['epochs']} epochs; launches K2 {rb['launches']['K2']}, K3 {rb['launches']['K3']}, K4 "
              f"{rb['launches']['K4']}; all-reduces {rb['allreduces']}; peak device memory "
              f"{rb['peak_bytes'] / 2**30:.2f} GiB, {rb['resident_bytes'] / 2**30:.2f} GiB held after the fit "
              f"(the unmeshed slice C fit of phase 9: peak {slice_c['peak_bytes'] / 2**30:.2f} GiB) [{card}]")
    print(f"  DP-C2 penalized objective per lambda vs DP-C1's first 3: max rel diff {rel:.3e} (bound 1e-4); w the same "
          f"bits on both ranks: {same}")
    check(same, "DP-C2: the ranks' coefficients differ")
    check(rel <= 1e-4, "DP-C2 disagrees with DP-C1")
    c = [r["cv_mesh"] for r in ranks]
    launches["cv_mesh"] = {k: sum(r["launches"][k] for r in c) for k in c[0]["launches"]}
    folds = [f for r in c for f in r["folds"]]
    check(len(folds) == CV_A_FOLDS and min(f["K1"] for f in folds) > 0,
          f"CV-A mesh: a fold did not run through K1: {[f['K1'] for f in folds]}")
    ref_raw = np.asarray(cv_a["parallel_cv_raw"])
    rel_c = max(float(np.max(np.abs(r["cv_raw"] - ref_raw) / np.abs(ref_raw))) for r in c)
    same_opt = all(r["lambda_min"] == cv_a["parallel_lambda_min"] and r["lambda_1se"] == cv_a["parallel_lambda_1se"]
                   for r in c)
    print(f"  CV-A over a fold mesh of 2 ranks sharing the card ({CV_A_FOLDS} folds, thresh 1e-6): "
          f"{[round(r['wall_s'], 3) for r in c]} s a rank, fold walls {[round(f['wall_s'], 3) for f in folds]} s, "
          f"K1 launches a fold {[f['K1'] for f in folds]}; scores vs phase 14's fold-parallel ones: max rel diff "
          f"{rel_c:.3e} (bound 1e-6), lambda_min / lambda_1se the same: {same_opt} [{card}]")
    check(rel_c <= 1e-6 and same_opt, "CV-A over the fold mesh disagrees with phase 14's fold-parallel CV")
    print(f"  phase 17 (b), (c): {wall:.1f} s from the ranks' start signal to their results")
    return {"dp_c2": [{k: v for k, v in rb.items() if k not in ("beta", "a0", "lambda", "w")} for rb in b],
            "dp_c2_objective_max_rel_diff": rel, "dp_c2_same_bits": same, "cv_mesh_rel_diff": rel_c,
            "cv_mesh_walls_s": [r["wall_s"] for r in c], "cv_mesh_fold_walls_s": [f["wall_s"] for f in folds],
            "cv_mesh_k1_launches_per_fold": [f["K1"] for f in folds], "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 18: the benchmark protocol, lambda_chunk, checkpoints, the libsvm
# loader and profiling
# ---------------------------------------------------------------------------

#: the protocol's tolerances: 5 of the reference's 10 from 0.9 to 1e-3, for
#: the run's time
PROTOCOL_TOLERANCES = np.exp(np.linspace(np.log(0.9), np.log(1e-3), 5))
#: Libsvm-C: slice C's first rows, two blocks of B 8192
LIBSVM_ROWS = 16384


def phase_protocol(dev, card, launches) -> dict:
    """(a) Protocol-4: `run_reference_protocol` on the four bundled datasets,
    lasso and ridge at lambda = 1/n, maxit 1000, through K1 where fit's gate
    admits the fit; each fit's wall, epochs and loss, K1's launches a curve
    (the fits' chunks); then `convergence_curve_trace` on heart, whose
    tail loss must be within 1e-3 relative of the sweep's tightest point."""
    import sgdnet_tpu_torch as st
    from sgdnet_tpu_torch.benchmarks import convergence as conv

    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    curves = conv.run_reference_protocol(device=dev, tolerances=PROTOCOL_TOLERANCES, maxit=1000)
    wall = time.perf_counter() - t0
    launches["protocol"] = _launches()
    out, k1_total = {}, 0
    for name, c in curves.items():
        gate = [s["epoch_kernel"] for s in c["fits"]]
        k1 = sum(s["epoch_chunks"] for s in c["fits"])
        k1_total += k1
        check(np.isfinite(c["losses"]).all(), f"protocol {name}: a loss is not finite: {c['losses']}")
        check(c["losses"][-1] <= c["losses"][0] + 1e-6 * abs(c["losses"][0]),
              f"protocol {name}: the tightest loss {c['losses'][-1]} is worse than the loosest {c['losses'][0]}")
        check(all(k > 0 for g, k in zip(gate, (s["epoch_chunks"] for s in c["fits"])) if g),
              f"protocol {name}: a fit that K1's gate admitted launched no K1")
        print(f"  {name:16s} K1 gate {'all' if all(gate) else sum(gate)} of {len(gate)} fits, {k1} K1 launches; "
              f"walls {[round(float(t), 4) for t in c['times']]} s, epochs {c['epochs'].tolist()}, loss "
              f"{c['losses'][0]:.6g} -> {c['losses'][-1]:.6g} [{card}]")
        out[name] = {"times_s": c["times"].tolist(), "epochs": c["epochs"].tolist(), "losses": c["losses"].tolist(),
                     "k1_gate": gate, "k1_launches": k1}
    check(launches["protocol"]["K1"] >= k1_total > 0, "the protocol's K1 launches are not its fits' chunks")
    print(f"  protocol: {len(curves)} curves of {len(PROTOCOL_TOLERANCES)} tolerances in {wall:.2f} s, "
          f"{launches['protocol']['K1']} K1 launches (with each curve's warm-up fit)")
    xh, yh = st.load_heart()
    _reset_launches()
    t0 = time.perf_counter()
    tr = conv.convergence_curve_trace(xh, yh, family="binomial", alpha=1.0, maxit=1000, device=dev)
    wall_tr = time.perf_counter() - t0
    launches["protocol_trace"] = _launches()
    tight = curves["heart/lasso"]["losses"][-1]
    rel = abs(tr["losses"][-1] - tight) / abs(tight)
    tm = tr["time_model"]
    print(f"  heart/lasso trace: {wall_tr:.2f} s, {int(tr['epochs'][-1])} epochs of the debug fit (plain step), "
          f"time model {tm['overhead_s']:.4f} s + {tm['epoch_s'] * 1e3:.4f} ms an epoch from "
          f"{[(round(w, 4), e) for w, e in tm['measured']]}; tail loss {tr['losses'][-1]:.6g} vs the sweep's "
          f"tightest {tight:.6g}: rel {rel:.3e} (bound 1e-3); K1 {launches['protocol_trace']['K1']} launches [{card}]")
    check(np.isfinite(tr["losses"]).all() and rel <= 1e-3, "the heart trace misses its sweep's tightest point")
    return {"curves": out, "wall_s": wall, "trace": {"wall_s": wall_tr, "epochs": int(tr["epochs"][-1]),
                                                     "time_model": tm, "tail_rel_diff": rel}}


def phase_chunk_a(ref_a, dev, card, launches) -> dict:
    """(b) Chunk-A: slice A's fit with lambda_chunk=25 through K1, against
    slice A's unchunked fit (tests/test_lambda_path.py's bounds:
    coefficients within 2e-3 x scale, dev_ratio within 1e-3, the same
    lambdas)."""
    import sgdnet_tpu_torch as st

    x, y = st.load_abalone()
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    f = st.fit(x, y, family="gaussian", alpha=0.8, lambda_chunk=25, device=dev)
    wall = time.perf_counter() - t0
    launches["chunk_a"] = _launches()
    ch = f.stats["lambda_chunk"]
    scale = max(1.0, float(np.abs(ref_a.beta).max()))
    rel = float(np.abs(f.beta - ref_a.beta).max()) / scale
    dr = float(np.abs(f.dev_ratio - ref_a.dev_ratio).max())
    print(f"  Chunk-A (abalone, 100 lambdas in chunks of 25, K1): {wall:.3f} s wall ({f.stats['wall_time_s']:.3f} s "
          f"path), npasses {f.npasses} (unchunked {ref_a.npasses}), {ch['chunks']} chunks, refit at half the step: "
          f"{ch['refits']}, halvings kept {ch['backoff']}; {launches['chunk_a']['K1']} K1 launches; vs slice A: "
          f"max|dbeta|/scale {rel:.3e} (bound 2e-3), max|d dev_ratio| {dr:.3e} (bound 1e-3) [{card}]")
    check(f.stats["epoch_kernel"] is True and launches["chunk_a"]["K1"] == f.stats["epoch_chunks"] > 0,
          "Chunk-A did not run through K1, or its launches are not its chunks")
    check(np.array_equal(f.lambda_, ref_a.lambda_), "Chunk-A's lambdas are not slice A's")
    check(rel <= 2e-3 and dr <= 1e-3, "Chunk-A disagrees with slice A's unchunked path")
    return {"wall_s": wall, "path_s": f.stats["wall_time_s"], "npasses": f.npasses, **ch,
            "beta_rel_diff": rel, "dev_ratio_diff": dr}


def phase_ckpt_a(ref_a, dev, card, launches) -> dict:
    """(c) Ckpt-A: slice A's first 97 lambdas through K1, the state saved
    and loaded back onto the card bit for bit, the last 3 resumed from it
    against slice A's last 3 within 2e-3 x scale (tests/test_checkpoint.py's
    bound).  A warm state takes the plain step (K1 refuses one).  Slice A
    runs block sampling, which shuffles the rows with the seed's
    permutation, so the state's g_mem is in that row order: the resume
    that is held to the bound passes sampling="block" (the same shuffle,
    its g_mem in line with its rows).  The default resume (permutation
    sampling, as in the JAX package) starts from a g_mem out of line with
    its rows and stops sooner at slice A's thresh: it runs too, and its
    distance is reported."""
    import tempfile

    import sgdnet_tpu_torch as st
    from sgdnet_tpu_torch.utils.checkpoint import load_state, save_state

    x, y = st.load_abalone()
    kw = dict(family="gaussian", alpha=0.8, device=dev)
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    head = st.fit(x, y, lambda_path=ref_a.lambda_[:97], **kw)
    wall_head = time.perf_counter() - t0
    launches["ckpt_head"] = _launches()
    check(head.stats["epoch_kernel"] is True and launches["ckpt_head"]["K1"] > 0, "Ckpt-A's head did not run K1")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_state(path, head.final_state, meta={"lambda": head.lambda_.tolist()})
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        state, meta = load_state(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    same = all(a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(state, head.final_state))
    check(same and meta["lambda"] == head.lambda_.tolist(), "Ckpt-A: the state did not come back bit for bit")
    scale = max(1.0, float(np.abs(ref_a.beta).max()))
    res = {}
    for name, sampling in (("block", "block"), ("default", None)):
        _reset_launches()
        t0 = time.perf_counter()
        tail = st.fit(x, y, lambda_path=ref_a.lambda_[97:], warm_state=state, sampling=sampling, **kw)
        wall = time.perf_counter() - t0
        launches[f"ckpt_resume_{name}"] = _launches()
        check(tail.stats["epoch_kernel"] is False and np.isfinite(tail.beta).all(),
              f"Ckpt-A's {name} resume ran K1 or is not finite")
        res[name] = {"wall_s": wall, "epochs": tail.npasses, "sampling": tail._refit_args["sampling"],
                     "beta_rel_diff": float(np.abs(tail.beta - ref_a.beta[97:]).max()) / scale}
    b, p_ = res["block"], res["default"]
    print(f"  Ckpt-A: head (97 lambdas, K1) {wall_head:.3f} s, {launches['ckpt_head']['K1']} K1 launches; the state "
          f"({', '.join(f'{n} {tuple(t.shape)}' for n, t in zip(state._fields, state))}) in {nbytes} bytes, saved "
          f"in {save_s * 1e3:.2f} ms, loaded onto the card in {load_s * 1e3:.2f} ms, every field bit for bit: "
          f"{same} [{card}]")
    print(f"  Ckpt-A resume, the last 3 lambdas on the plain step: block sampling {b['wall_s']:.3f} s, {b['epochs']} "
          f"epochs, max|dbeta|/scale {b['beta_rel_diff']:.3e} from slice A's (bound 2e-3); the default "
          f"({p_['sampling']}, g_mem out of line with the rows) {p_['wall_s']:.3f} s, {p_['epochs']} epochs, "
          f"{p_['beta_rel_diff']:.3e} [{card}]")
    check(b["beta_rel_diff"] <= 2e-3, "Ckpt-A's resume disagrees with slice A's last lambdas")
    return {"head_wall_s": wall_head, "bytes": nbytes, "save_s": save_s, "load_s": load_s, "bit_for_bit": same,
            "resume": res}


def _libsvm_text(x, y) -> bytes:
    """x's rows as libsvm lines (1-based columns), each value as Python's
    shortest round-trip form of its double, so a parse gives it back
    exactly."""
    ip, ix, vals, labels = x.indptr, (x.indices + 1).tolist(), x.data.astype(np.float64).tolist(), y.tolist()
    lines = []
    for i in range(x.shape[0]):
        a, b = ip[i], ip[i + 1]
        lines.append(f"{labels[i]!r} " + " ".join(f"{j}:{v!r}" for j, v in zip(ix[a:b], vals[a:b])))
    return ("\n".join(lines) + "\n").encode()


def phase_libsvm(csr, y_sp, lam_c, rng, dev, seed, card, launches) -> dict:
    """(d) Libsvm-C: slice C's first 16384 rows written as libsvm text and
    parsed by the port's native loader (equal to the rows in memory, bit
    for bit), then one lambda at slice C's settings fitted on the parsed
    design (K2 + K3 + K4, each held to its twin first at this fit's
    shapes) against the same fit of the rows in memory (objective within
    1e-6 relative).  The loader's library is built under
    sgdnet_tpu_torch/_build/; the JAX package's native/_sgdnet_native.so
    keeps its bytes and mtime."""
    import hashlib

    import scipy.sparse as sp

    import sgdnet_tpu_torch as st
    from sgdnet_tpu_torch.core.sparse import HybridCSR, scipy_column_stats
    from sgdnet_tpu_torch.solver import tail_kernel as tk
    from sgdnet_tpu_torch.tools.profile_sparse_slices import SLICE_C
    from sgdnet_tpu_torch.utils import native

    jax_so = os.path.join(ROOT, "native", "_sgdnet_native.so")

    def so_id():
        with open(jax_so, "rb") as f:
            return os.stat(jax_so).st_mtime_ns, hashlib.sha256(f.read()).hexdigest()

    before = so_id()
    n, B = LIBSVM_ROWS, SLICE_C["batch_size"]
    ip = csr.indptr[: n + 1]
    cols = csr.indices[: ip[-1]]
    x_mem = sp.csr_matrix((csr.data[: ip[-1]], cols, ip), shape=(n, int(cols.max()) + 1))
    y_mem = y_sp[:n].astype(np.float64)
    t0 = time.perf_counter()
    buf = _libsvm_text(x_mem, y_mem)
    write_s = time.perf_counter() - t0
    threads = len(os.sched_getaffinity(0))
    t0 = time.perf_counter()
    native.get_lib()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x_p, y_p = native.load_libsvm(buf, n_threads=threads)
    parse_s = time.perf_counter() - t0
    equal = (x_p.shape == x_mem.shape and np.array_equal(x_p.indptr, x_mem.indptr)
             and np.array_equal(x_p.indices, x_mem.indices) and np.array_equal(x_p.data, x_mem.data.astype(np.float64))
             and np.array_equal(y_p, y_mem))
    print(f"  Libsvm-C: {n} rows x {x_mem.shape[1]} columns, {x_mem.nnz} nonzeros, {len(buf)} bytes of text "
          f"(written in {write_s:.2f} s); parsed in {parse_s:.4f} s = {len(buf) / parse_s / 1e6:.1f} MB/s on "
          f"{threads} threads (the library built or loaded in {build_s:.2f} s at "
          f"{os.path.relpath(native.SO, ROOT)}); indptr, indices, values and labels equal to the rows in "
          f"memory: {equal}")
    check(equal, "Libsvm-C: the parse differs from the rows in memory")
    check(os.path.dirname(native.SO) == os.path.join(ROOT, "sgdnet_tpu_torch", "_build")
          and os.path.exists(native.SO), "the native library is not under sgdnet_tpu_torch/_build/")
    # K2 / K3 / K4 against their twins at this fit's shapes first
    _, k2_err = _k2_bf16_case(rng, dev, seed, n, B)
    th, _ = HybridCSR.split_columns(x_p, coverage=SLICE_C["hybrid_coverage"], max_head=SLICE_C["hybrid_max_head"],
                                    memory_budget=SLICE_C["hybrid_memory_budget"], head_dtype="bfloat16", device=dev)
    bt = _packed_tail(th.tail, n, B, seed, dev)
    th = None
    tail_err = 0.0
    for blk in range(bt.n_blocks):
        tail_err = max(tail_err, _tail_block_check(tk, bt, blk, rng, dev, "Libsvm-C")[1])
    print(f"  K3 / K4 on Libsvm-C's {bt.n_blocks} blocks (E {bt.rows.shape[1]}, K3 {bt.lanes} lanes a row): worst "
          f"abs err {tail_err:.3e} (rel bound 1e-5), bits identical over two runs")
    bt = None
    kw = {**SLICE_C, "lambda_path": [float(lam_c[-1])]}
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    f = st.fit(x_p, y_p, device=dev, seed=seed, **kw)
    wall = time.perf_counter() - t0
    launches["libsvm_c"] = _launches()
    fm = st.fit(x_mem, y_mem, device=dev, seed=seed, **kw)
    sd = scipy_column_stats(x_mem)[1]
    obj, obj_m = _objective(f, x_mem, y_mem, sd)[0], _objective(fm, x_mem, y_mem, sd)[0]
    rel = abs(obj - obj_m) / abs(obj_m)
    lay = f.stats["layout"]
    print(f"  Libsvm-C fit (lambda {kw['lambda_path'][0]:.5g}, {lay['head_dtype']} head {lay['head_width']} wide, B "
          f"{B}): {wall:.3f} s wall, {f.npasses} epochs, launches K2 {launches['libsvm_c']['K2']}, K3 "
          f"{launches['libsvm_c']['K3']}, K4 {launches['libsvm_c']['K4']}; objective {obj:.8g} vs the rows in "
          f"memory {obj_m:.8g}: rel {rel:.3e} (bound 1e-6) [{card}]")
    check(all(launches["libsvm_c"][k] > 0 for k in ("K2", "K3", "K4")), "Libsvm-C's fit did not run K2, K3 and K4")
    check(rel <= 1e-6, "Libsvm-C: the parsed design's fit disagrees with the rows in memory")
    check(so_id() == before, "native/_sgdnet_native.so changed during phase 18")
    return {"rows": n, "cols": x_mem.shape[1], "nnz": x_mem.nnz, "bytes": len(buf), "parse_s": parse_s,
            "mb_per_s": len(buf) / parse_s / 1e6, "threads": threads, "wall_s": wall, "epochs": f.npasses,
            "objective_rel_diff": rel, "k2_max_abs_err": k2_err, "tail_max_abs_err": tail_err}


def phase_trace(k1_epoch, k1, dev, card, launches) -> dict:
    """(e) utils/profiling: `trace()` around one abalone fit through K1 (20
    lambdas), whose Chrome trace must name saga_epochs_kernel once a K1
    launch; `time_fn` of one K1 epoch beside phase 4's CUDA-event time."""
    import tempfile

    import sgdnet_tpu_torch as st
    from sgdnet_tpu_torch.utils import profiling

    x, y = st.load_abalone()
    torch.cuda.synchronize()
    _reset_launches()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        with profiling.trace(d):
            f = st.fit(x, y, family="gaussian", alpha=0.8, nlambda=20, device=dev)
        wall = time.perf_counter() - t0
        tpath = os.path.join(d, profiling.TRACE_FILE)
        tbytes = os.path.getsize(tpath)
        with open(tpath) as fh:
            events = json.load(fh)["traceEvents"]
    launches["trace_a"] = _launches()
    named = sum(1 for e in events if e.get("cat") == "kernel" and "saga_epochs_kernel" in e.get("name", ""))
    k1_s = profiling.time_fn(k1_epoch, iters=50, warmup=2)
    print(f"  trace(): abalone, 20 lambdas through K1 in {wall:.3f} s under the profiler; the Chrome trace "
          f"({tbytes} bytes, {len(events)} events) names saga_epochs_kernel {named} times; the fit's K1 launches "
          f"{launches['trace_a']['K1']}, its chunks {f.stats['epoch_chunks']} [{card}]")
    print(f"  time_fn, one abalone K1 epoch: {k1_s * 1e3:.4f} ms a call (host clock, synchronized) beside phase 4's "
          f"{k1['ms']:.4f} ms (CUDA events) [{card}]")
    check(f.stats["epoch_kernel"] is True and named == launches["trace_a"]["K1"] == f.stats["epoch_chunks"] > 0,
          "the trace's saga_epochs_kernel count is not the fit's K1 launches")
    return {"wall_s": wall, "trace_bytes": tbytes, "trace_k1_kernels": named, "time_fn_epoch_ms": k1_s * 1e3,
            "cuda_events_epoch_ms": k1["ms"]}


# ---------------------------------------------------------------------------
# phase 19: the bench leg (tools/bench.py and its three harnesses)
# ---------------------------------------------------------------------------


def _bench_epoch_check(x, y_sp, kw, dev, seed) -> float:
    """One epoch of the config's step through the kernels and one on plain
    ops (`use_pallas=False, use_tail_kernel=False`), from the same zero
    state and block order: the worst of max|dw| / max|w|, |db| / max(|b|,
    1e-3) and max|dg_sum| / max|g_sum|; fails beyond 1e-3."""
    from sgdnet_tpu_torch.solver import saga
    from sgdnet_tpu_torch.tools import bench

    B, n, n_pad = kw["batch_size"], len(y_sp), x.shape[0]
    yd = torch.zeros((n_pad, 1), device=dev)
    yd[:n, 0] = torch.as_tensor(np.asarray(y_sp, np.float32), device=dev)
    wts = (torch.arange(n_pad, device=dev) < n).to(torch.float32)
    order = saga.default_order_fn(seed, n_pad // B)(0, 0, 0)
    outs = []
    for kernels in (True, False):
        config = bench.solver_config(B, "block", kw["g_sum_refresh_every"], kw.get("use_pallas", False) and kernels,
                                     use_tail_kernel=kernels)
        state = saga.init_state(n_pad, x.shape[1], 1, torch.float32, dev)
        with saga._fp32_matmul():
            outs.append(bench.run_epochs(x, yd, wts, state, [order], config, n))
    k, p = outs
    rel = lambda a, b, floor=1e-30: float((a - b).abs().max()) / max(float(b.abs().max()), floor)  # noqa: E731
    worst = max(rel(k.w, p.w), rel(k.intercept, p.intercept, 1e-3), rel(k.g_sum, p.g_sum))
    check(np.isfinite(worst) and float(p.w.abs().max()) > 0, "the bench epoch gave a zero or non-finite w")
    return worst


def _k2_on_head(hk, head, rng, dev) -> float:
    """K2 against its twin on block 0 of a layout's own bf16 head (binomial,
    k 1): the larger of max|dg| and max|dcorr| / max(max|corr|, 1); fails
    beyond g 3e-2, corr 2e-2 (phase 8's bounds)."""
    B, D = 8192, head.shape[1]
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    args = (head, 0, t(rng.standard_normal((1, D)) / np.sqrt(D)), t(0.1 * rng.standard_normal((B, 1))),
            t(rng.random((B, 1)) < 0.5), t(0.1 * rng.standard_normal((B, 1))), t(rng.random(B) < 0.9), "binomial")
    g, corr = hk.fused_head_step_at(*args)
    g_ref, corr_ref = hk.fused_head_step_reference(*args)
    torch.cuda.synchronize()
    eg = float((g - g_ref).abs().max())
    ec = float((corr - corr_ref).abs().max()) / max(float(corr_ref.abs().max()), 1.0)
    check(eg <= 3e-2 and ec <= 2e-2, f"K2 disagrees with its twin on the bench's bf16 head: dg {eg}, dcorr {ec}")
    return max(eg, ec)


def phase_bench(csr, y_sp, rng, dev, seed, card, launches) -> dict:
    """Phase 19: (a) bench.py's three sparse configs through the bench's
    builder and `run_epochs` (each layout's K3 / K4 blocks and, on the bf16
    head, K2 held to their twins; one epoch through the kernels against one
    on plain ops; the timed best of 3), (b) the dense secondaries, (c)
    `validate_bf16` at n 20000 and 8 epochs, (d) `bench_path_e2e` quick at D
    16384 on 10 lambdas.  Each path runs with the launch counts set to 0
    just before it."""
    from sgdnet_tpu_torch.solver import head_kernel as hk
    from sgdnet_tpu_torch.solver import tail_kernel as tk
    from sgdnet_tpu_torch.tools import bench, bench_path_e2e, validate_bf16

    out = {"configs": [], "k2_max_abs_err": 0.0, "tail_max_abs_err": 0.0}
    t_phase = time.perf_counter()

    def since() -> str:
        return f"[{time.perf_counter() - t_phase:.1f} s into phase 19]"

    for i, kw in enumerate(bench.SPARSE_CONFIGS):
        B = kw["batch_size"]
        n_pad = -(-csr.shape[0] // B) * B
        t0 = time.perf_counter()
        x, _ = bench.build_hybrid_device(csr, n_pad, max_head=kw["max_head"], coverage=kw["coverage"],
                                         head_dtype=kw["head_dtype"], batch_size=B, device=dev)
        build_s = time.perf_counter() - t0
        for blk in range(x.blk_tail.n_blocks):
            _, err = _tail_block_check(tk, x.blk_tail, blk, rng, dev, f"bench config {i + 1}")
            out["tail_max_abs_err"] = max(out["tail_max_abs_err"], err)
        if kw.get("use_pallas"):
            out["k2_max_abs_err"] = max(out["k2_max_abs_err"], _k2_on_head(hk, x.head, rng, dev))
        worst = _bench_epoch_check(x, y_sp, kw, dev, seed)
        check(worst <= 1e-3, f"bench config {i + 1}: the kernels' epoch is {worst:.3e} from the plain epoch")
        _reset_launches()
        r = bench.bench_sparse_epoch(**kw, data=(csr, y_sp), x_prebuilt=x, device=dev, seed=seed)
        launches[f"bench_{i + 1}"] = _launches()
        x = None
        torch.cuda.empty_cache()
        T = n_pad // B
        want_k2 = T if kw.get("use_pallas") else 0
        check(r["k2_per_epoch"] == want_k2 and r["k3_per_epoch"] == T and r["k4_per_epoch"] == T,
              f"bench config {i + 1}: launches an epoch K2 {r['k2_per_epoch']} K3 {r['k3_per_epoch']} K4 "
              f"{r['k4_per_epoch']}, expected {want_k2}, {T}, {T}")
        print(f"  bench config {i + 1} ({kw['head_dtype']} D {r['head_width']}, coverage {kw['coverage']}, refresh "
              f"{kw['g_sum_refresh_every']}, {kw['epochs']} epochs a run): {r['nnz_per_s']:.4e} nnz/s (bench.py's "
              f"count; {r['true_nnz_per_s']:.4e} of the {r['true_nnz']} true nonzeros), {r['ms_per_epoch']:.3f} ms an "
              f"epoch, launches an epoch K2 {r['k2_per_epoch']:g} K3 {r['k3_per_epoch']:g} K4 "
              f"{r['k4_per_epoch']:g}, peak device memory {bench._gib(r['peak_bytes'])}; layout built in "
              f"{build_s:.2f} s; one epoch through the kernels vs plain ops: {worst:.3e} (bound 1e-3) [{card}] "
              f"{since()}")
        out["configs"].append({**r, "build_s": build_s, "epoch_vs_plain": worst})
    name, power = bench.card_of(dev)
    best = max(c["nnz_per_s"] for c in out["configs"])
    line = {"metric": bench.METRIC, "value": best, "card": name, "power_limit_w": power}
    print(f"  the bench's line: {json.dumps(line)}")

    _reset_launches()
    dense = {"65536x784_k10": bench.bench_dense_multinomial(data=_multinomial_data(seed), device=dev, seed=seed)}
    for kw in bench.DENSE_CONFIGS[:2]:
        dense[kw["label"]] = bench.bench_dense_multinomial(**kw, device=dev, seed=seed)
    launches["dense"] = _launches()
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is still on after the dense bench")
    check(all(d["finite"] for d in dense.values()) and launches["dense"]["K2"] == 0,
          f"the dense bench gave a non-finite w or launched K2: {launches['dense']}")
    for label, d in dense.items():
        print(f"  dense {label} ({d['matmul_precision']}): {d['samples_per_s']:.4e} samples/s, "
              f"{d['tflop_per_s']:.3f} TFLOP/s, {d['seconds']:.4f} s for {d['epochs']} epochs [{card}] {since()}")
    out["dense"] = dense

    _reset_launches()
    t0 = time.perf_counter()
    val = validate_bf16.validate(["bfloat16", "int8"], bench.make_sparse_binomial(n=20_000, seed=seed), 8, dev, seed)
    launches["validate"] = _launches()
    print(f"  validate_bf16 (n 20000, 8 epochs, {time.perf_counter() - t0:.2f} s): bf16 objective "
          f"{val['bfloat16']['objective_rel_diff']:.3e}, coefficients {val['bfloat16']['coef_rel_diff']:.3e}; int8 "
          f"{val['int8']['objective_rel_diff']:.3e}, {val['int8']['coef_rel_diff']:.3e} (bounds 1e-4, 1e-2 x scale); "
          f"launches {launches['validate']} {since()}")
    check(val["bfloat16"]["passed"] and val["int8"]["passed"], "a reduced head missed validate_bf16's bounds")
    check(launches["validate"]["K3"] > 0 and launches["validate"]["K4"] > 0, "validate_bf16 ran no K3 / K4")
    out["validate"] = val

    data, y = bench.make_sparse_binomial(n=20_000, seed=3)
    xs = bench._to_scipy(data)
    _reset_launches()
    e2e = bench_path_e2e.run_one(xs, y.ravel(), xs.nnz, 16384, screen_modes=(True,), nlambda=10, device=dev)
    launches["e2e"] = _launches()
    check(e2e["tail_kernel"] is True and launches["e2e"]["K3"] > 0 and launches["e2e"]["K4"] > 0,
          f"bench_path_e2e ran no K3 / K4: {launches['e2e']}")
    # the screened path against the full one by each lambda's penalized
    # objective, within the solver's tolerance (thresh 1e-3), the tool's
    # first verdict.  At thresh 1e-3 the coefficients of this workload's
    # one-row columns wander along flat directions, and the reference
    # records its own screened and full paths 4.4e-3 x scale and more apart
    # (RESULTS.md:47-54, 170-173)
    print(f"  bench_path_e2e quick (n 20000, D 16384, 10 lambdas): cold {e2e['t_full']:.3f} s ({e2e['ep_full']} "
          f"epochs), warm {e2e['t_warm']:.3f} s ({e2e['ep_warm']} epochs), screened {e2e['t_scr']:.3f} s "
          f"({e2e['ep_scr']} epochs); screened vs full: objective {e2e['scr_objective_rel']:.3e} relative (bound "
          f"1e-3), coefficients {e2e['scr_diff']:.3e} x scale (the JAX tool's contract 2e-3: "
          f"{'PASS' if e2e['scr_coef_pass'] else 'FAIL'}); launches {launches['e2e']} [{card}] {since()}")
    check(e2e["finite"] and e2e["scr_objective_pass"],
          f"the screened path's objective is {e2e['scr_objective_rel']:.3e} from the full path's")
    out["e2e"] = e2e
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the generated data")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False); nothing to run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from sgdnet_tpu_torch.utils import build
    from sgdnet_tpu_torch.utils.device import card_line

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def phase(title):
        print(f"{title} [{time.perf_counter() - t_start:.1f} s into the run]")

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is enabled globally")
    rng = np.random.default_rng(args.seed)

    phase("phase 1: card")
    card = card_line()
    print(card)
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True, text=True, check=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}; {torch.cuda.get_device_name(0)}")

    phase("phase 2: build")
    build.load_library()
    info = build.build_info()
    print(f"  {'built' if info['built'] else 'loaded'} {os.path.relpath(info['path'], ROOT)} "
          f"in {info['seconds']:.2f} s")
    sass_dump = start_sass_dump(info["path"])

    phase("phase 3: K2 vs twin")
    k2 = phase_k2(rng, dev)
    phase("phase 3: K2's streamed design vs twin")
    k2_streamed = phase_k2_streamed(dev, args.seed, card)
    k2["max_abs_err"] = max(k2["max_abs_err"], k2_streamed["f32_max_abs_err"])
    hmma = tensor_core_check(sass_dump)
    phase("phase 4: K1 vs twin")
    k1, k1_epoch = phase_k1(rng, dev)

    phase("phase 7: K3 / K4 vs twins")
    from sgdnet_tpu_torch.core.sparse import scipy_column_stats
    from sgdnet_tpu_torch.tools.profile_sparse_slices import SLICE_C, SLICE_D, SLICE_E, make_sparse_binomial

    t0 = time.perf_counter()
    csr, y_sp = make_sparse_binomial(seed=args.seed)
    sd = scipy_column_stats(csr)[1]
    print(f"  slice C/D data: {csr.shape[0]} x {csr.shape[1]}, {csr.nnz} nonzeros after summing duplicates, "
          f"made in {time.perf_counter() - t0:.2f} s")
    k3, k4 = phase_tail(rng, dev, csr, args.seed)
    phase("phase 8: K2 vs twin at slice C's width")
    k2w = phase_k2_wide(rng, dev, args.seed)

    phase("phases 5, 6, 9, 10: the paths, each with the launch counts set to 0 just before it")
    launches = {}
    _reset_launches()
    fit_a, wall_a = run_slice_a(dev)
    launches["A"] = _launches()
    _reset_launches()
    fit_b, wall_b, xt, y = run_slice_b(dev, args.seed)
    launches["B"] = _launches()
    print(f"  launches: slice A {launches['A']}, slice B {launches['B']}")
    phase("phase 5: slice A")
    slice_a = check_slice_a(fit_a, wall_a, launches["A"]["K1"], dev, card)
    ref_a = SimpleNamespace(beta=fit_a.beta, dev_ratio=fit_a.dev_ratio, lambda_=fit_a.lambda_, npasses=fit_a.npasses)
    phase("phase 6: slice B")
    slice_b = check_slice_b(fit_b, wall_b, launches["B"]["K2"], xt, y, dev, card, args.seed)
    fit_a = fit_b = xt = None
    phase("phase 9: slice C")
    _reset_launches()
    fit_c, wall_c, peak_c, step_c = run_sparse_slice(csr, y_sp, dev, args.seed, SLICE_C)
    launches["C"] = _launches()
    slice_c = check_sparse_slice("C", fit_c, wall_c, peak_c, launches["C"], step_c, csr, y_sp, sd, dev, args.seed,
                                 SLICE_C, card, plain_lambdas=5)
    lam_c, obj_c = fit_c.lambda_, _objective(fit_c, csr, y_sp, sd)
    k5_c = phase_k5(step_c[1], 1, launches["C"]["K5"], args.seed, dev, "slice C", card)
    k6_c = phase_k6(step_c, launches["C"]["K6"], args.seed, dev, "slice C", card)
    fit_c = step_c = None
    torch.cuda.empty_cache()
    phase("phase 9b: slice M (53 classes on slice C's design: K2's streamed design + K3 + K4), with the launch "
          "counts set to 0 just before its fit")
    slice_m = phase_slice_m(csr, sd, rng, dev, args.seed, card, launches)
    torch.cuda.empty_cache()
    phase("phase 10: slice D")
    kw_d = {**SLICE_D, **FIRST_THREE}
    _reset_launches()
    fit_d, wall_d, peak_d, step_d = run_sparse_slice(csr, y_sp, dev, args.seed, kw_d)
    launches["D"] = _launches()
    slice_d = check_sparse_slice("D", fit_d, wall_d, peak_d, launches["D"], step_d, csr, y_sp, sd, dev, args.seed,
                                 kw_d, card, plain_lambdas=2, profile=False)
    fit_d = step_d = None
    torch.cuda.empty_cache()

    phase("phase 11: P1 vs twin")
    p1 = phase_p1(rng, dev)
    phase("phase 12: P2 / P3 vs twin")
    p2, p3, ceiling = phase_p23(dev, args.seed)
    phase("phases 11, 12: the probe entry points, each with the launch counts set to 0 just before it")
    probes = run_probe_paths(dev, args.seed, launches)

    phase("phase 13: slice E (the layout planner)")
    kw_e = {**SLICE_E, **FIRST_THREE}
    _reset_launches()
    fit_e, wall_e, peak_e, step_e = run_sparse_slice(csr, y_sp, dev, args.seed, kw_e)
    launches["E"] = _launches()
    slice_e = check_sparse_slice("E", fit_e, wall_e, peak_e, launches["E"], step_e, csr, y_sp, sd, dev, args.seed,
                                 kw_e, card, plain_lambdas=2, profile=False)
    step_e = None
    slice_e["plan"] = planner_check(fit_e, ceiling, k3, k4, card)
    # the widths on the path's first lambda (its maxit of epochs): ms an
    # epoch is what they compare
    slice_e["widths"] = planner_neighbours(csr, y_sp, dev, args.seed, slice_e["plan"], fit_e.lambda_[:1], card)
    fit_e = None
    torch.cuda.empty_cache()

    phase("phases 14-16: cross-validation and screening, each path with the launch counts set to 0 just before it")
    phase("phase 14: CV on abalone (serial and fold-parallel, through K1)")
    cv_a = phase_cv_abalone(dev, card, launches)
    phase("phase 15: fold-parallel CV at slice C's width (K2 + K3 + K4)")
    cv_c = phase_cv_slice_c(csr, y_sp, lam_c, slice_c["path_s"], dev, args.seed, card, launches)
    torch.cuda.empty_cache()
    phase("phase 16: screening (slice C, and a wide dense gaussian through K2 on subsets); phase 17's two ranks "
          "start meanwhile and wait")
    dp_ranks = start_dp_ranks(csr, y_sp, lam_c, args.seed)
    screening = phase_screening(csr, y_sp, sd, lam_c, obj_c, slice_c["path_s"], dev, args.seed, card, launches)
    phase("phase 16: K2 against its twin at the shapes of the screened problems' fits")
    k2s = k2_subset_check(rng, dev, card)
    torch.cuda.empty_cache()
    phase("phase 17: K2 / K3 / K4 against their twins at the 2-rank fit's shapes (B 4096 a rank)")
    dpk = dp_kernel_check(rng, dev, csr, args.seed)
    k2w["max_abs_err"] = max(k2w["max_abs_err"], dpk["k2_max_abs_err"])
    for k in (k3, k4):
        k["max_abs_err"] = max(k["max_abs_err"], dpk["tail_max_abs_err"])
    torch.cuda.empty_cache()
    phase("phase 17 (a), (d): DP-C1, slice C on a 1-rank NCCL mesh; measure_scaling at 1 rank")
    dp1 = phase_dp_c1(csr, y_sp, sd, lam_c, obj_c, slice_c, dev, args.seed, card, launches)
    phase("phase 17 (b), (c): DP-C2 and CV-A over a fold mesh, 2 spawned ranks sharing the card (gloo)")
    dp2 = phase_dp_shared(dp_ranks, csr, y_sp, sd, dp1, cv_a, slice_c, card, launches)
    torch.cuda.empty_cache()
    phase("phase 18 (a): Protocol-4, the reference's benchmark protocol on the bundled datasets (K1)")
    protocol = phase_protocol(dev, card, launches)
    phase("phase 18 (b): Chunk-A, slice A in chunks of 25 lambdas (K1)")
    chunk_a = phase_chunk_a(ref_a, dev, card, launches)
    phase("phase 18 (c): Ckpt-A, a checkpoint of slice A's head, loaded and resumed")
    ckpt_a = phase_ckpt_a(ref_a, dev, card, launches)
    phase("phase 18 (d): Libsvm-C, slice C's first rows through the libsvm loader and fit (K2 + K3 + K4)")
    libsvm_c = phase_libsvm(csr, y_sp, lam_c, rng, dev, args.seed, card, launches)
    k2w["max_abs_err"] = max(k2w["max_abs_err"], libsvm_c["k2_max_abs_err"])
    for k in (k3, k4):
        k["max_abs_err"] = max(k["max_abs_err"], libsvm_c["tail_max_abs_err"])
    phase("phase 18 (e): trace() around an abalone fit through K1; time_fn of a K1 epoch")
    trace_a = phase_trace(k1_epoch, k1, dev, card, launches)
    torch.cuda.empty_cache()
    phase("phase 19: the bench leg (tools/bench.py's configs, its dense secondaries, validate_bf16, "
          "bench_path_e2e), each path with the launch counts set to 0 just before it")
    bench_leg = phase_bench(csr, y_sp, rng, dev, args.seed, card, launches)
    k2w["max_abs_err"] = max(k2w["max_abs_err"], bench_leg["k2_max_abs_err"])
    for k in (k3, k4):
        k["max_abs_err"] = max(k["max_abs_err"], bench_leg["tail_max_abs_err"], slice_m["tail_max_abs_err"])
    phase("every phase passed")
    print(json.dumps({"card": card, "build_s": info["seconds"], "hmma": hmma, "k2_streamed_cifar": k2_streamed,
                      "slice_a": slice_a, "slice_b": slice_b, "slice_c": slice_c, "slice_m": slice_m,
                      "slice_d": slice_d, "slice_e": slice_e, "probes": probes,
                      "full_head_sum": ceiling, "cv_abalone": cv_a, "cv_slice_c": cv_c, "screening": screening,
                      "data_parallel": {"dp_c1": dp1, **dp2},
                      "surface": {"protocol": protocol, "chunk_a": chunk_a, "ckpt_a": ckpt_a, "libsvm_c": libsvm_c,
                                  "trace_a": trace_a}, "bench_leg": bench_leg}))

    def by_path(key, paths):
        return {"launches": sum(launches[p][key] for p in paths),
                "launches_by_path": {p: launches[p][key] for p in paths}}

    k2m = slice_m["k2"]
    tail_src, tail_rep = "sgdnet_tpu_torch/csrc/coo_tail.cu", "tools/bench_pallas_gather.py:80,100,116,140"
    tail_paths = ["C", "M", "D", "E", "cv_slice_c", "screen_true_c", "screen_auto_c", "dp_c1", "dp_c2", "libsvm_c",
                  "bench_1", "bench_2", "bench_3", "validate", "e2e"]
    probe_src = "sgdnet_tpu_torch/csrc/probes.cu"
    print(json.dumps({"kernels": [
        {"name": "saga_epochs (K1), one abalone epoch", "route": "cuda",
         "source": "sgdnet_tpu_torch/csrc/epoch_kernel.cu",
         "replaces": "sgdnet_tpu/solver/epoch_kernel.py:290",
         **by_path("K1", ["A", "cv_serial", "cv_parallel", "cv_mesh", "protocol", "protocol_trace", "chunk_a",
                          "ckpt_head", "trace_a"]), **k1},
        {"name": "fused_head_step_at (K2), f32 D=784 k=10 B=4096", "route": "cuda",
         "source": "sgdnet_tpu_torch/csrc/head_step.cu", "replaces": "sgdnet_tpu/solver/pallas_kernels.py:265",
         **by_path("K2", "B"), **k2},
        {"name": "fused_head_step_at (K2), bf16 D=16384 k=1 B=8192", "route": "cuda",
         "source": "sgdnet_tpu_torch/csrc/head_step.cu", "replaces": "sgdnet_tpu/solver/pallas_kernels.py:265",
         **by_path("K2", ["C", "H", "cv_slice_c", "dp_c1", "dp_c2", "libsvm_c", "bench_3"]), **k2w},
        {"name": "fused_head_step_at (K2, streamed), bf16 D=16384 k=53 B=8192", "route": "cuda",
         "source": "sgdnet_tpu_torch/csrc/head_step.cu", "replaces": "sgdnet_tpu/solver/pallas_kernels.py:265",
         **by_path("K2", ["M"]), "max_abs_err": max(k2m["max_abs_dg"], k2m["max_abs_dcorr"]),
         **{key: k2m[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "two_products_ms", "device_ms")},
         "library_ms": None},
        {"name": "fused_head_step_at (K2), f32 screened subsets, D=512 k=1 B=8192", "route": "cuda",
         "source": "sgdnet_tpu_torch/csrc/head_step.cu", "replaces": "sgdnet_tpu/solver/pallas_kernels.py:265",
         **by_path("K2", ["screen_true_c", "screen_auto_c", "screen_true_wide", "screen_auto_wide"]), **k2s},
        {"name": "coo_tail_forward (K3)", "route": "cuda", "source": tail_src, "replaces": tail_rep,
         **by_path("K3", tail_paths), **k3},
        {"name": "coo_tail_outer (K4)", "route": "cuda", "source": tail_src, "replaces": tail_rep,
         **by_path("K4", tail_paths), **k4},
        {"name": "coo_tail_sum (K5), the refresh's tail sum, slice M's tail at k 53", "route": "cuda",
         "source": tail_src, "replaces": "sgdnet_tpu/solver/saga.py:461 (_refresh_g_sum's tail scatter)",
         **by_path("K5", tail_paths), **slice_m["k5"], "slice_c": k5_c},
        {"name": "step_finish (K6), the step's finish, slice M's step at k 53", "route": "cuda",
         "source": "sgdnet_tpu_torch/csrc/step_finish.cu",
         "replaces": "none: the step's finish (sgdnet_tpu/solver/saga.py, left to XLA)",
         **by_path("K6", list(launches)), **slice_m["k6"], "library_ms": None, "slice_c": k6_c},
        {"name": "epoch_probe (P1)", "route": "cuda", "source": probe_src,
         "replaces": "tools/bench_epoch_kernel.py:65", **by_path("P1", ["P1"]), **p1},
        {"name": "block_colsum (P2), bf16 106496 x 16384, B 8192", "route": "cuda", "source": probe_src,
         "replaces": "tools/bench_pallas_dma.py:61", **by_path("P2", ["H"]), **p2},
        {"name": "block_colsum_pipelined (P3), bf16 106496 x 16384, B 8192", "route": "cuda",
         "source": probe_src, "replaces": "tools/bench_dma_streams.py:96", **by_path("P3", ["S"]), **p3},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
