"""The port's bench: sparse-CSR binomial SAGA epoch throughput (nnz/s) on
the card, the counterpart of bench.py.

    python -m sgdnet_tpu_torch.tools.bench [--device cuda|cpu] [--seed 0] [--n 100000] [--p 47000]
        [--configs 1,2,3] [--epochs N] [--no-secondary]

The workload is bench.py's: `make_sparse_binomial` (n 100000, p 47000, 76
nonzeros a row, Zipf columns; the same arrays, bit for bit, from the same
seed), binomial, alpha 1, lambda 1/n, a fixed step of 3e-3.  Its three
sparse configs run in bench.py's order (bench.py:515-524): an int8 head
D 32768 (coverage 0.995, refresh 8), an int8 head D 24576 (0.99, refresh
8), and a bf16 head D 16384 (0.98, refresh 4) through K2; each under block
sampling at B 8192 with K3 / K4 on its BlockCOO tail, `epochs` = its
refresh period, a warm-up run and then the best of 3 timed runs.  A
config's layout is built inside its call and freed on return.  Then the
dense multinomial secondaries (bench.py:540-547) and a logged-only sklearn
sanity check of the frozen CPU baseline.

Diagnostics go to stderr.  After each sparse config stdout gets one JSON
line with the best value so far (the last line wins):

    {"metric": "torch_sparse_saga_nnz_per_s", "value": ..., "unit": "nnz/s", "vs_baseline": ...,
     "card": "<name>", "power_limit_w": ...}

nnz/s counts as bench.py counts: n x 76 x epochs over the best run's
seconds (the nominal 7.6e6 nonzeros a pass; the count after summing
duplicates is logged beside it).  A config that fails is logged with its
traceback and the next one runs; the bench exits non-zero if any stage
failed, and prints no value for a failure.  Every selected stage runs:
`--configs` and `--no-secondary` choose them.  `--device` defaults to the
card: without one, and without `--device cpu`, it prints one line and
exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback

import numpy as np
import torch

#: a frozen single-core CPU rate, not a TPU's: sklearn's Cython SAGA on this
#: workload (3 epochs, full data; BASELINE.md), bench.py's constant
CPU_BASELINE_NNZ_PER_S = 4.50e5

METRIC = "torch_sparse_saga_nnz_per_s"

#: bench.py's sparse configs (bench.py:515-524)
SPARSE_CONFIGS = [
    dict(batch_size=8192, hybrid=True, max_head=32768, coverage=0.995, sampling="block",
         g_sum_refresh_every=8, head_dtype="int8", epochs=8),
    dict(batch_size=8192, hybrid=True, max_head=24576, coverage=0.99, sampling="block",
         g_sum_refresh_every=8, head_dtype="int8", epochs=8),
    dict(batch_size=8192, hybrid=True, max_head=16384, coverage=0.98, sampling="block",
         g_sum_refresh_every=4, head_dtype="bfloat16", use_pallas=True, epochs=8),
]

_T0 = time.monotonic()


def log(*a):
    print(f"[{time.monotonic() - _T0:6.1f}s]", *a, file=sys.stderr, flush=True)


def _to_scipy(csr_np):
    """numpy padded-CSR dict -> scipy CSR (duplicates summed, as bench.py's)."""
    import scipy.sparse as sp

    n, p = csr_np["n"], csr_np["p"]
    ind = csr_np["indices"].reshape(-1)
    val = csr_np["values"].reshape(-1)
    rows = np.repeat(np.arange(n), csr_np["indices"].shape[1])
    keep = val != 0
    return sp.csr_matrix((val[keep], (rows[keep], ind[keep])), shape=(n, p))


def _scipy_of(data):
    """A scipy matrix as it is, a padded-CSR dict through `_to_scipy`."""
    return _to_scipy(data) if isinstance(data, dict) else data


def cpu_baseline_sanity(csr_np, y, rows=20_000):
    """Logged-only sanity check of the frozen CPU baseline: sklearn SAGA, 1
    epoch on a row subsample; never feeds `vs_baseline`.  Where sklearn is
    absent it logs so and returns None."""
    try:
        from sklearn.linear_model import LogisticRegression
    except ImportError:
        log("cpu baseline sanity: sklearn is not installed here; not measured")
        return None
    import warnings

    xs = _scipy_of(csr_np)[:rows]
    yv = np.asarray(y).ravel()[:rows]
    clf = LogisticRegression(solver="saga", penalty="l1", C=1.0, max_iter=1, tol=0.0, fit_intercept=True)
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        clf.fit(xs, yv)
    rate = xs.nnz / (time.perf_counter() - t0)
    log(f"cpu baseline sanity (sklearn saga, {rows} rows, 1 epoch, the host's CPU): {rate:.3e} nnz/s = "
        f"{rate / CPU_BASELINE_NNZ_PER_S:.2f}x the frozen {CPU_BASELINE_NNZ_PER_S:.2e}")
    return rate


def make_sparse_binomial(n=100_000, p=47_000, nnz_per_row=76, seed=0, dtype=np.float32):
    """rcv1-scale synthetic (bench.py:142-165): fixed nonzeros a row, Zipf
    column use (rank + 10)^-1.15, 5% true features.  Returns a numpy
    padded-CSR dict (indices, values (n, L), nnz, n, p) and y (n, 1)."""
    rng = np.random.default_rng(seed)
    weights = (np.arange(p) + 10.0) ** -1.15
    cdf = np.cumsum(weights) / weights.sum()
    cols = np.searchsorted(cdf, rng.random((n, nnz_per_row))).astype(np.int32).clip(0, p - 1)
    vals = rng.normal(size=(n, nnz_per_row)).astype(dtype)
    w_true = rng.normal(size=p) * (rng.random(p) < 0.05) * 3.0
    lp = (vals * w_true[cols]).sum(axis=1)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-lp))).astype(dtype)

    L = ((nnz_per_row + 7) // 8) * 8
    indices = np.zeros((n, L), np.int32)
    values = np.zeros((n, L), dtype)
    indices[:, :nnz_per_row] = cols
    values[:, :nnz_per_row] = vals
    x = dict(indices=indices, values=values, nnz=np.full((n,), nnz_per_row, np.int32), n=n, p=p)
    return x, y.reshape(-1, 1)


def as_padded(csr_np, device=None):
    """numpy padded-CSR dict -> PaddedCSR on `device`."""
    from sgdnet_tpu_torch.core.sparse import PaddedCSR
    from sgdnet_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    return PaddedCSR(torch.as_tensor(csr_np["indices"], device=dev), torch.as_tensor(csr_np["values"], device=dev),
                     torch.as_tensor(csr_np["nnz"], device=dev), csr_np["n"], csr_np["p"])


def _pad_scipy_rows(xs, n_pad: int):
    """xs with empty rows appended up to n_pad."""
    import scipy.sparse as sp

    xs = xs.tocsr()
    extra = n_pad - xs.shape[0]
    if extra <= 0:
        return xs
    indptr = np.concatenate([xs.indptr, np.full(extra, xs.indptr[-1], xs.indptr.dtype)])
    return sp.csr_matrix((xs.data, xs.indices, indptr), shape=(n_pad, xs.shape[1]))


def build_hybrid_device(csr_np, n_pad, max_head=4096, coverage=0.9, head_dtype=None, batch_size=None, device=None):
    """The bench configs' HybridCSR on `device`: the columns split on the
    host (an int8 head in nonzero form), the rows padded to n_pad on the
    host (the split of the padded matrix: zero rows), the BlockCOO tail
    packed on the host; an int8 head is then built on the device from its
    nonzeros (`materialize_int8_head`), a bf16 or f32 head moved by one
    copy.  `csr_np` is a padded-CSR dict or a scipy matrix.  Returns
    (layout, perm): the layout's column j is the input's column perm[j]."""
    from dataclasses import replace

    from sgdnet_tpu_torch.core.sparse import BlockCOO, HybridCSR, as_head_dtype, materialize_int8_head
    from sgdnet_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    t0 = time.monotonic()
    xs = _scipy_of(csr_np)
    hd = as_head_dtype(head_dtype)
    quant_int8 = hd == torch.int8
    xh, perm = HybridCSR.split_columns(_pad_scipy_rows(xs, n_pad), coverage=coverage, max_head=max_head,
                                       head_dtype=hd, head_form="nnz" if quant_int8 else "dense", device="cpu")
    d = getattr(xh.head, "n_head", None) or xh.n_head  # a HeadNNZ or a dense head
    head_nnz = int(np.bincount(xs.indices, minlength=xs.shape[1])[perm[:d]].sum())
    log(f"hybrid split: head D={d} covers {head_nnz / max(xs.nnz, 1):.1%} of nnz, tail width L={xh.tail.row_width}")
    blk = None if batch_size is None else BlockCOO.from_padded(xh.tail, batch_size).to(dev)
    log(f"host-side split, row padding and BlockCOO packing in {time.monotonic() - t0:.1f}s")
    t1 = time.monotonic()
    if quant_int8:
        head = materialize_int8_head(xh.head, device=dev)
    else:
        head = xh.head.to(dev)
    scale = None if xh.head_scale is None else xh.head_scale.to(dev)
    x = replace(xh, head=head, tail=xh.tail.to(dev), blk_tail=blk, head_scale=scale)
    int(torch.sum(x.head[-2:, :8].to(torch.int32)))  # the head is on the device before the clock reads
    log(f"head D={x.n_head} {head.dtype} on {dev} in {time.monotonic() - t1:.1f}s "
        f"({'built from its nonzeros' if quant_int8 else 'one copy'})")
    return x, perm


def _family_penalty(family_name: str, k: int):
    """The family and the lasso penalty (alpha 1) of the bench's epochs."""
    from sgdnet_tpu_torch.families import get_family
    from sgdnet_tpu_torch.penalties import select_penalty

    return get_family(family_name, n_classes=k), select_penalty(1.0, family_name)


def solver_config(batch_size, sampling="block", g_sum_refresh_every=1, use_pallas=False, sparse_mode="gather",
                  intercept_decay=0.01, use_tail_kernel=True):
    """bench.py's SolverConfig (bench.py:367-376); `use_pallas=False,
    use_tail_kernel=False` is the plain-ops comparison."""
    from sgdnet_tpu_torch.solver.saga import SolverConfig

    return SolverConfig(batch_size=batch_size, fit_intercept=True, sparse_mode=sparse_mode,
                        intercept_decay=intercept_decay, use_pallas=use_pallas, sampling=sampling,
                        g_sum_refresh_every=g_sum_refresh_every, use_tail_kernel=use_tail_kernel)


def run_epochs(x, y, weights, state, orders, config, w_total, gamma=3e-3, l1=None, l2=0.0, family="binomial"):
    """One epoch of the solver's `_make_epoch` per order in `orders`, from
    `state`, epoch i with it=i so that the refresh runs at its cadence
    (bench.py:384-394): the lasso (alpha 1) of `family` (binomial: k = 1;
    multinomial: k = y's columns), l1 = 1/w_total by default.  Products in
    f32 run with TF32 as the caller set it (`precision_scope`).  Returns
    the state."""
    from sgdnet_tpu_torch.solver import saga

    fam, pen = _family_penalty(family, y.shape[1])
    epoch = saga._make_epoch(x, y, weights, float(w_total), fam, pen, config)
    l1 = 1.0 / w_total if l1 is None else l1
    for i, order in enumerate(orders):
        state = epoch(state, order, gamma, l1, l2, it=i)
    return state


@contextlib.contextmanager
def precision_scope(precision: str):
    """bench.py's `matmul_precision` for torch: "highest" runs f32 products
    in true FP32 (TF32 off), "default" with TF32 on; the previous flag is
    restored on exit."""
    from sgdnet_tpu_torch.solver import saga

    if precision == "highest":
        with saga._fp32_matmul():
            yield
        return
    if precision != "default":
        raise ValueError(f"matmul_precision must be 'highest' or 'default', got {precision!r}")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _launch_counts() -> tuple:
    from sgdnet_tpu_torch.solver import head_kernel, tail_kernel

    return (head_kernel.fused_head_step_at.launches, tail_kernel.coo_tail_forward.launches,
            tail_kernel.coo_tail_outer.launches)


def best_of_runs(run, state, runs: int, dev) -> tuple:
    """`state = run(r, state)` once to warm up (r = 0), then timed for r =
    1..runs, each window ended by a synchronize and a scalar read back;
    returns (the best run's seconds, the last state)."""
    from sgdnet_tpu_torch.utils.device import sync

    state = run(0, state)
    float(torch.sum(state.w))
    best = float("inf")
    for r in range(1, runs + 1):
        sync(dev)
        t0 = time.perf_counter()
        state = run(r, state)
        float(torch.sum(state.w))
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best, state


def _gib(nbytes) -> str:
    return "not measured" if nbytes is None else f"{nbytes / 2**30:.2f} GiB"


def bench_sparse_epoch(n=100_000, p=47_000, nnz_per_row=76, batch_size=1024, epochs=5, sparse_mode="gather",
                       hybrid=False, use_pallas=False, max_head=4096, coverage=0.9, sampling="permutation",
                       g_sum_refresh_every=1, head_dtype=None, data=None, x_prebuilt=None, device=None, seed=0):
    """bench.py's `bench_sparse_epoch` (bench.py:322-427) on `device`: the
    layout (built here, or `x_prebuilt`, already padded to the batch), a
    warm-up run and the best of 3 timed runs of `epochs` epochs, each from
    the state the run before left and with orders from its own seed
    (`default_order_fn(seed + r)`).  `data` is (padded-CSR dict or scipy
    matrix, y).  Returns nnz/s (bench.py's count), ms an epoch, K2 / K3 /
    K4 launches an epoch over the four runs, the true nonzeros and the
    peak device memory."""
    from sgdnet_tpu_torch.solver import saga
    from sgdnet_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    csr_np, y = data if data is not None else make_sparse_binomial(n, p, nnz_per_row)
    y = np.asarray(y, np.float32).reshape(-1, 1)
    n = y.shape[0]
    n_pad = ((n + batch_size - 1) // batch_size) * batch_size
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if x_prebuilt is not None:
        x = x_prebuilt
        if x.shape[0] != n_pad:
            raise ValueError(f"x_prebuilt has {x.shape[0]} rows; the batch needs {n_pad}")
    elif hybrid:
        x, _ = build_hybrid_device(csr_np, n_pad, max_head=max_head, coverage=coverage, head_dtype=head_dtype,
                                   batch_size=batch_size if sampling == "block" else None, device=dev)
    else:
        x = as_padded(csr_np, dev).pad_rows(n_pad)
    true_nnz = int(_scipy_of(csr_np).nnz)
    yd = torch.cat([torch.as_tensor(y, device=dev), torch.zeros((n_pad - n, 1), device=dev)])
    wts = torch.cat([torch.ones((n,), device=dev), torch.zeros((n_pad - n,), device=dev)])
    config = solver_config(batch_size, sampling, g_sum_refresh_every, use_pallas, sparse_mode)
    n_orders = saga.order_count(config, n_pad)

    def run(r, state):
        order_fn = saga.default_order_fn(seed + r, n_orders)
        with saga._fp32_matmul():
            return run_epochs(x, yd, wts, state, [order_fn(0, 0, i) for i in range(epochs)], config, n)

    t0 = time.perf_counter()
    before = _launch_counts()
    best, _ = best_of_runs(run, saga.init_state(n_pad, x.shape[1], 1, torch.float32, dev), 3, dev)
    k2, k3, k4 = ((a - b) / (4 * epochs) for a, b in zip(_launch_counts(), before))
    nnz_per_s = n * nnz_per_row * epochs / best
    out = {"nnz_per_s": nnz_per_s, "ms_per_epoch": best / epochs * 1e3, "epochs": epochs,
           "k2_per_epoch": k2, "k3_per_epoch": k3, "k4_per_epoch": k4, "true_nnz": true_nnz,
           "true_nnz_per_s": true_nnz * epochs / best,
           "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
           "head_width": getattr(x, "n_head", None), "wall_s": time.perf_counter() - t0}
    log(f"sparse epoch bench: n={n} p={x.shape[1]} nnz/row={nnz_per_row} B={batch_size} "
        f"mode={'hybrid' if hybrid or x_prebuilt is not None else sparse_mode}{'+K2' if use_pallas else ''}"
        f"{'+block' if sampling == 'block' else ''}"
        f"{f'+refresh/{g_sum_refresh_every}' if g_sum_refresh_every > 1 else ''}"
        f"{f'+head:{head_dtype}' if head_dtype is not None else ''}: "
        f"{epochs} epochs in {best:.4f}s -> {nnz_per_s:.4e} nnz/s, {out['ms_per_epoch']:.3f} ms an epoch "
        f"({out['true_nnz_per_s']:.4e} nnz/s of the {true_nnz} nonzeros after summing duplicates); "
        f"launches an epoch K2 {k2:g} K3 {k3:g} K4 {k4:g}; peak device memory {_gib(out['peak_bytes'])}")
    return out


def dense_multinomial_problem(n, p, k, device=None, data=None, seed=0):
    """(x (n, p), y one-hot (n, k), weights) on `device`: from a
    torch.Generator there (seeded), or from `data` = (x, class labels),
    numpy or tensors, when given (its shape then stands)."""
    from sgdnet_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if data is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        x = torch.randn((n, p), generator=gen, device=dev)
        yi = torch.randint(0, k, (n,), generator=gen, device=dev)
    else:
        x = torch.as_tensor(data[0], device=dev)
        yi = torch.as_tensor(data[1], device=dev).long()
    y = torch.nn.functional.one_hot(yi, k).to(x.dtype)
    return x, y, torch.ones((n,), dtype=x.dtype, device=dev)


def bench_dense_multinomial(n=65536, p=784, k=10, batch_size=4096, epochs=3, matmul_precision="highest",
                            label="dense multinomial", device=None, data=None, seed=0):
    """bench.py's dense multinomial secondary (bench.py:430-491): block
    sampling, gamma 1e-3, l1 1e-4, the plain step (no K2, as bench.py never
    sets `use_pallas` here), a warm-up run and the best of 3 of `epochs`
    epochs, each from the state the run before left, with its own orders;
    f32 products
    under `matmul_precision` ("highest": TF32 off; "default": TF32 on,
    restored after).  Returns samples/s and TFLOP/s (4 n p k epochs)."""
    from sgdnet_tpu_torch.solver import saga

    x, y, wts = dense_multinomial_problem(n, p, k, device, data, seed)
    (n, p), dev = x.shape, x.device
    config = solver_config(batch_size, "block", intercept_decay=1.0)
    state0 = saga.init_state(n, p, k, x.dtype, dev)
    n_orders = saga.order_count(config, n)

    def run(r, state):
        order_fn = saga.default_order_fn(seed + r, n_orders)
        orders = [order_fn(0, 0, i) for i in range(epochs)]
        with precision_scope(matmul_precision):
            return run_epochs(x, y, wts, state, orders, config, n, gamma=1e-3, l1=1e-4, family="multinomial")

    best, state = best_of_runs(run, state0, 3, dev)
    flops = 4 * n * p * k * epochs  # the forward and backward products, 2 flops a multiply-add
    out = {"samples_per_s": n * epochs / best, "tflop_per_s": flops / best / 1e12, "seconds": best,
           "epochs": epochs, "matmul_precision": matmul_precision, "finite": bool(torch.isfinite(state.w).all())}
    log(f"{label} bench: n={n} p={p} k={k} B={batch_size} prec={matmul_precision}: {epochs} epochs in "
        f"{best:.4f}s -> {out['samples_per_s']:.4e} samples/s, {out['tflop_per_s']:.3f} TFLOP/s")
    return out


#: bench.py's dense secondaries (bench.py:540-547)
DENSE_CONFIGS = [
    dict(n=131072, p=8192, k=64, batch_size=8192, epochs=3, matmul_precision="default",
         label="dense multinomial TF32"),
    dict(n=131072, p=8192, k=64, batch_size=8192, epochs=3, matmul_precision="highest",
         label="dense multinomial f32"),
    dict(),
]


def card_of(dev) -> tuple:
    """(name, power limit in W) of the device a run measured: the card's as
    nvidia-smi reads them (the limit None where it was not read); ("cpu",
    None) off the card."""
    from sgdnet_tpu_torch.utils.device import describe

    if dev.type != "cuda":
        return str(dev), None
    name, _, limit = describe(dev).partition(", ")
    try:
        return name, float(limit.split()[0])
    except (IndexError, ValueError):
        return name, None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card; exits non-zero without one)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the generated data")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--p", type=int, default=47_000)
    ap.add_argument("--configs", default="1,2,3", help="the sparse configs to run, numbered from 1")
    ap.add_argument("--epochs", type=int, default=None, help="epochs a run (default: each config's)")
    ap.add_argument("--no-secondary", action="store_true", help="skip the dense and CPU-baseline stages")
    a = ap.parse_args(argv)
    from sgdnet_tpu_torch.utils.device import resolve_device

    if a.device is None and not torch.cuda.is_available():
        print("bench: no CUDA device (torch.cuda.is_available() is False); pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    dev = resolve_device(a.device)
    card, power = card_of(dev)
    log(f"device {dev}: {card}, power limit {power} W; torch {torch.__version__}")

    csr_np, y = make_sparse_binomial(n=a.n, p=a.p, seed=a.seed)
    data = (_to_scipy(csr_np), y)  # converted once: every config splits the same matrix
    best, failed = None, []
    for idx in (int(i) for i in a.configs.split(",")):
        kw = SPARSE_CONFIGS[idx - 1]
        if a.epochs is not None:
            kw = dict(kw, epochs=a.epochs)
        try:
            r = bench_sparse_epoch(**kw, n=a.n, p=a.p, data=data, device=dev, seed=a.seed)
        except Exception:  # noqa: BLE001 - a failed config is recorded and the next one runs
            log(f"config {idx} {kw} failed:\n{traceback.format_exc()}")
            failed.append(f"config {idx}")
            continue
        finally:
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        best = r["nnz_per_s"] if best is None else max(best, r["nnz_per_s"])
        print(json.dumps({"metric": METRIC, "value": best, "unit": "nnz/s",
                          "vs_baseline": best / CPU_BASELINE_NNZ_PER_S, "card": card, "power_limit_w": power}),
              flush=True)

    secondaries = [] if a.no_secondary else [
        *(lambda kw=kw: bench_dense_multinomial(**kw, device=dev, seed=a.seed) for kw in DENSE_CONFIGS),
        lambda: cpu_baseline_sanity(*data),
    ]
    for fn in secondaries:
        try:
            fn()
        except Exception:  # noqa: BLE001 - a failed stage is recorded and the next one runs
            log(f"secondary stage failed:\n{traceback.format_exc()}")
            failed.append("a secondary stage")
        finally:
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    if best is None:
        log("no sparse config completed: no value printed")
    log(f"done in {time.monotonic() - _T0:.1f}s; best {best} nnz/s; failed: {failed or 'none'}")
    return 1 if failed or best is None else 0


if __name__ == "__main__":
    sys.exit(main())
