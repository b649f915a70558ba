"""Slices C, D and E on the card: the sparse binomial paths through the
BlockCOO tail kernels, with their walls, K3 / K4 launches, the step's
launches and host time a step, and K3's time on the fit's largest block.

    python -m sgdnet_tpu_torch.tools.profile_sparse_slices [--device cuda|cpu] [--seed 0]
        [--slices C,D,E] [--n 100000] [--p 47000] [--nlambda 10] [--maxit 100]

The data is the bench's `make_sparse_binomial` (tools/bench.py, a copy
of bench.py's: n 100000, p 47000, 76 nonzeros a row, Zipf columns); the
slices are bench.py's sparse configs (C: a bf16 16384-wide head through
K2 + K3 + K4; D: an int8 32768-wide head through K3 + K4; E: slice D
with the layout planner's head width), cut to 10 lambdas to 0.05
lambda_max and maxit 100.  For each slice one fit gives the fit and path walls, the epochs and the K3 /
K4 launches; the step it built, captured, then runs one epoch of its
blocks from a zero state, once to warm up, once on the host clock (ms a
step, ending in a synchronize) and once under torch.profiler, which
counts the device's kernel launches a step; and K3 is timed a call (CUDA
events over back-to-back calls) and on the device (the profiler) on the
fit's largest tail block at k = 1, through the checked wrapper and, where
the package has one, the step's bound launcher.  Prints one JSON line.
`--device` defaults to the card and raises without one; on the CPU the
device numbers are None.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

#: the sparse slices' settings (bench.py:517-523, cut as the docstring says)
SLICE_C = dict(family="binomial", alpha=1.0, nlambda=10, lambda_min_ratio=0.05, maxit=100, batch_size=8192,
               sampling="block", hybrid=True, hybrid_max_head=16384, hybrid_coverage=0.98,
               hybrid_head_dtype="bfloat16", g_sum_refresh_every=4, hybrid_memory_budget=8e9)
SLICE_D = dict(SLICE_C, hybrid_max_head=32768, hybrid_coverage=0.995, hybrid_head_dtype="int8",
               g_sum_refresh_every=8)
#: the planner picks the head width (and the split: coverage 1.0)
SLICE_E = dict(SLICE_D, hybrid_max_head="auto")
SLICES = {"C": SLICE_C, "D": SLICE_D, "E": SLICE_E}
#: slice M: slice C's design and settings on a 53-class response (LIBSVM
#: rcv1.multiclass: 53 classes over 47,236 features), through the streamed
#: K2 (no resident plan holds 53 x 16384) and K3 / K4 at k 53
SLICE_M = dict(SLICE_C, family="multinomial")


def make_sparse_binomial(n=100_000, p=47_000, nnz_per_row=76, seed=0):
    """The bench's workload (tools/bench.py `make_sparse_binomial`, a copy of
    bench.py:142-165) as a canonical scipy CSR (duplicates summed) and y (n,)."""
    from sgdnet_tpu_torch.tools import bench

    data, y = bench.make_sparse_binomial(n, p, nnz_per_row, seed)
    x = bench._to_scipy(data)
    x.sum_duplicates()
    return x, y.ravel()


def make_sparse_multiclass_labels(x, k: int = 53, per_class: int = 300, head: int = 16384, seed: int = 0):
    """Slice M's labels on the design x (a scipy CSR, n x p): a seeded
    softmax model over k classes, each with `per_class` nonzero true
    coefficients N(0, 3^2), half drawn among the `head` most used columns
    and half among the rest, and y (n,) drawn from softmax(x W) by the
    Gumbel trick.  Raises if a class draws no row."""
    rng = np.random.default_rng(seed)
    n, p = x.shape
    order = np.argsort(-np.bincount(x.indices, minlength=p), kind="stable")
    w = np.zeros((p, k))
    for c in range(k):
        cols = np.concatenate([rng.choice(order[:head], per_class // 2, replace=False),
                               rng.choice(order[head:], per_class - per_class // 2, replace=False)])
        w[cols, c] = 3.0 * rng.normal(size=per_class)
    y = np.argmax(np.asarray(x @ w) + rng.gumbel(size=(n, k)), axis=1)
    counts = np.bincount(y, minlength=k)
    if counts.min() == 0:
        raise RuntimeError(f"slice M's labels: class {int(np.argmin(counts))} drew no row")
    return y


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn over `reps` back-to-back calls (CUDA
    events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def capture_steps():
    """Collect (step, x, y, config) of every step `fit` builds while the
    block is open (solver/saga.py `_make_step`, wrapped)."""
    from sgdnet_tpu_torch.solver import saga

    made, orig = [], saga._make_step

    def wrapped(x, y, weights, w_total, family, penalty, config, *args, **kw):
        step = orig(x, y, weights, w_total, family, penalty, config, *args, **kw)
        made.append((step, x, y, config))
        return step

    saga._make_step = wrapped
    try:
        yield made
    finally:
        saga._make_step = orig


def step_profile(step, x, y, config, dev) -> dict:
    """One epoch of the captured step over every block from a zero state:
    ms a step on the host clock (T steps, then a synchronize, after a
    warm-up epoch) and, on the card, the device's kernel launches (all
    device events, and kernels alone) a step as torch.profiler counts
    them."""
    from sgdnet_tpu_torch.solver import saga
    from sgdnet_tpu_torch.utils.device import sync

    B, k = config.batch_size, y.shape[1]
    n_pad = y.shape[0]
    T = n_pad // B
    scal = saga._scalars(1e-3, 1e-4, 0.0, config.intercept_decay, saga.np_dtype(y.dtype))

    def epoch():
        state = saga.init_state(n_pad, x.shape[1], k, y.dtype, dev)
        if getattr(step, "tail_forward", None) is not None:
            step.tail_forward.refresh_stream()
        for blk in range(T):
            state = step(state, scal, blk * B)
        return state

    epoch()
    sync(dev)
    t0 = time.perf_counter()
    epoch()
    sync(dev)
    out = {"steps": T, "ms_per_step": (time.perf_counter() - t0) / T * 1e3, "device_events_per_step": None,
           "kernels_per_step": None}
    if dev.type != "cuda":
        return out
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        epoch()
        sync(dev)
    ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    out["device_events_per_step"] = sum(e.count for e in ev) / T
    out["kernels_per_step"] = sum(e.count for e in ev if not e.key.startswith(("Memcpy", "Memset"))) / T
    return out


def k3_times(bt, dev, seed: int) -> dict:
    """K3 on the tail's largest block at k = 1: ms a call through the checked
    wrapper and, where there is one, the bound launcher; device ms."""
    from sgdnet_tpu_torch.solver import tail_kernel as tk
    from sgdnet_tpu_torch.utils.profiling import kernel_device_ms

    blk = int(torch.argmax(bt.counts))
    rng = np.random.default_rng(seed)
    w = torch.as_tensor(rng.standard_normal((1, bt.n_cols)), dtype=bt.dtype, device=dev)
    out = {"block": blk, "entries": int(bt.counts[blk]), "lanes": getattr(bt, "lanes", None), "ms": None,
           "bound_call_ms": None, "device_ms": None}
    if dev.type != "cuda":
        return out
    out["ms"] = cuda_ms(lambda: tk.coo_tail_forward(bt, blk, w), 200)
    if hasattr(tk, "ForwardLauncher"):
        launch = tk.ForwardLauncher(bt, 1, bt.dtype)
        out["bound_call_ms"] = cuda_ms(lambda: launch(blk, w), 200)
    out["device_ms"] = kernel_device_ms(lambda: tk.coo_tail_forward(bt, blk, w), 50, ("coo_forward",))
    return out


def run_slice(name: str, csr, y, dev, seed: int, nlambda: int = 10, maxit: int = 100) -> dict:
    """One fit of the slice, its step's profile and K3's times."""
    import sgdnet_tpu_torch as st
    from sgdnet_tpu_torch.solver import tail_kernel as tk
    from sgdnet_tpu_torch.utils.device import sync

    kw = dict(SLICES[name], nlambda=nlambda, maxit=maxit)
    before = (tk.coo_tail_forward.launches, tk.coo_tail_outer.launches)
    with capture_steps() as made:
        sync(dev)
        t0 = time.perf_counter()
        f = st.fit(csr, y, device=dev, seed=seed, **kw)
        wall = time.perf_counter() - t0
    step, x, yp, config = made[-1]
    out = {"slice": name, "head_width": f.stats["layout"]["head_width"], "head_dtype": f.stats["layout"]["head_dtype"],
           "wall_s": wall, "path_s": f.stats["wall_time_s"], "epochs": f.npasses,
           "k3_launches": tk.coo_tail_forward.launches - before[0],
           "k4_launches": tk.coo_tail_outer.launches - before[1],
           "head_kernel": f.stats["head_kernel"], "tail_kernel": f.stats["tail_kernel"],
           "dev_ratio_last": float(f.dev_ratio[-1])}
    out["step"] = step_profile(step, x, yp, config, dev)
    out["k3"] = k3_times(x.blk_tail, dev, seed)
    return out


def run(device=None, seed: int = 0, slices="CDE", n: int = 100_000, p: int = 47_000, nlambda: int = 10,
        maxit: int = 100) -> dict:
    from sgdnet_tpu_torch.utils.device import describe, resolve_device

    dev = resolve_device(device)
    csr, y = make_sparse_binomial(n, p, seed=seed)
    out = {"device": describe(dev), "n": n, "p": p, "nnz": int(csr.nnz), "slices": {}}
    for name in slices:
        out["slices"][name] = run_slice(name, csr, y, dev, seed, nlambda, maxit)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card; raises without one)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slices", default="C,D,E")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--p", type=int, default=47_000)
    ap.add_argument("--nlambda", type=int, default=10)
    ap.add_argument("--maxit", type=int, default=100)
    a = ap.parse_args(argv)
    print(json.dumps(run(a.device, a.seed, a.slices.replace(",", ""), a.n, a.p, a.nlambda, a.maxit)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
