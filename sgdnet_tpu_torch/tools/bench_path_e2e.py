"""The end-to-end path wall on the card: a full 50-lambda lasso path on the
bench workload through the public `fit`, with and without strong-rule
screening (the counterpart of tools/bench_path_e2e.py).

    python -m sgdnet_tpu_torch.tools.bench_path_e2e [quick] [D ...] [--nlambda 50] [--device cuda|cpu]

The workload is the bench's (tools/bench.py `make_sparse_binomial`, seed
3): n 100000 (20000 with `quick`), p 47000, 76 nonzeros a row.  Each head
width D (default 16384 and 32768) fits the path with the JAX tool's
settings: an int8 hybrid head of width D at coverage 0.995, block
sampling at B 8192, refresh every 8 epochs, thresh 1e-3, maxit 200, in
warm-started chunks of 4 lambdas; cold (the first fit in the process),
then warm (the same fit again), then, at the first width only, with
`screen=True` and `screen="auto"` on the full path's lambdas.  Each
screened path is compared with the full one by each lambda's penalized
objective on the original data (against thresh, 1e-3 relative) and by the
JAX tool's coefficient contract, 2e-3 x max(max|beta|, 1); both verdicts
are printed for information, as the JAX tool prints its own.  Neither
decides the exit code: at thresh 1e-3 this workload's minimizers are not
unique, its coefficients wander along flat directions, and deep in the
path (where lambdas stop at maxit) the two schedules can pick up features
at different lambdas, as the reference records on the TPU (RESULTS.md).
Reports each wall, epochs, the end-to-end nnz/s (true nonzeros x epochs
over the wall) and the solver's (`stats["nnz_per_s"]`), and the penalized
objective of each lambda.  The first kernel build in the process is timed
apart, before the fits.  Prints its lines on stderr and one JSON line;
exits non-zero when a path's coefficients or objectives are not finite.
`--device` defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

#: the verdicts printed on a screened path against the full one: its
#: penalized objective, each lambda, relative (the fits' thresh), and the
#: JAX tool's contract on the coefficients, x max(max|beta|, 1)
OBJECTIVE_BOUND, SCREEN_CONTRACT = 1e-3, 2e-3


def path_kwargs(D, nlambda=50):
    """The JAX tool's fit settings (tools/bench_path_e2e.py:40-56)."""
    return dict(family="binomial", alpha=1.0, nlambda=nlambda, thresh=1e-3, batch_size=8192, sampling="block",
                hybrid_head_dtype="int8", hybrid_max_head=D, hybrid_coverage=0.995, hybrid_memory_budget=4e9,
                g_sum_refresh_every=8, seed=0, lambda_chunk=4, maxit=200)


def path_objective(f, xs, yv) -> np.ndarray:
    """Each lambda's penalized objective on the original data: mean
    log-loss + lambda |beta * sd|_1 (the lasso on the standardized scale),
    float64 on the host."""
    from sgdnet_tpu_torch.core.sparse import scipy_column_stats

    sd = scipy_column_stats(xs)[1]
    beta = np.asarray(f.beta, np.float64)[:, 0, :]
    lp = np.asarray(xs @ beta.T) + np.asarray(f.a0, np.float64).reshape(len(beta), -1)[:, 0][None, :]
    loss = np.mean(np.logaddexp(0.0, lp) - np.asarray(yv, np.float64)[:, None] * lp, axis=0)
    return loss + np.asarray(f.lambda_) * np.abs(beta * sd[None, :]).sum(axis=1)


def _timed_fit(xs, yv, dev, **kw):
    import sgdnet_tpu_torch as st
    from sgdnet_tpu_torch.utils.device import sync

    sync(dev)
    t0 = time.perf_counter()
    f = st.fit(xs, yv, device=dev, **kw)
    float(np.asarray(f.beta[-1]).sum())
    return f, time.perf_counter() - t0


def run_one(xs, yv, nnz, D, screen_modes=(True, "auto"), nlambda=50, device=None) -> dict:
    """The path at head width D, cold then warm, then screened in each of
    `screen_modes` on the full path's lambdas.  Each screened path's
    largest relative gap to the full one in penalized objective
    (`scr_objective_rel`, `auto_` for "auto") and its coefficient gap over
    the scale (`scr_diff`) are recorded with their verdicts
    (`scr_objective_pass`, `scr_coef_pass`); `finite` says whether every
    path's coefficients and objectives are finite."""
    from sgdnet_tpu_torch.tools.bench import log
    from sgdnet_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    kw = path_kwargs(D, nlambda)
    full, t_full = _timed_fit(xs, yv, dev, **kw)
    ep_full = full.stats["epochs"]
    log(f"[D={D}] layout: {full.stats['layout']}")
    log(f"[D={D}] FULL path: {t_full:.3f}s wall (incl. build), {ep_full} epochs, effective "
        f"{nnz * ep_full / t_full:.4e} nnz/s end-to-end, solver-only {full.stats['nnz_per_s']:.4e} nnz/s "
        f"(in-path wall {full.stats['wall_time_s']:.3f}s)")
    warm, t_warm = _timed_fit(xs, yv, dev, **kw)
    log(f"[D={D}] FULL path (warm): {t_warm:.3f}s wall, {warm.stats['epochs']} epochs, solver-only "
        f"{warm.stats['nnz_per_s']:.4e} nnz/s (in-path wall {warm.stats['wall_time_s']:.3f}s)")
    log(f"[D={D}] return codes: {np.asarray(warm.return_codes).tolist()}")
    obj = path_objective(full, xs, yv)
    out = dict(D=D, head_width=full.stats["layout"]["head_width"], t_full=t_full, ep_full=ep_full,
               solver_nnz_s=full.stats["nnz_per_s"], e2e_nnz_s=nnz * ep_full / t_full, t_warm=t_warm,
               ep_warm=warm.stats["epochs"], warm_solver_nnz_s=warm.stats["nnz_per_s"],
               warm_inpath_s=warm.stats["wall_time_s"], lambda_=np.asarray(full.lambda_).tolist(),
               objective=obj.tolist(),
               return_codes=np.asarray(full.return_codes).tolist(), epoch_kernel=full.stats["epoch_kernel"],
               head_kernel=full.stats["head_kernel"], tail_kernel=full.stats["tail_kernel"],
               finite=bool(np.isfinite(full.beta).all() and np.isfinite(obj).all()))
    scale = max(np.abs(full.beta).max(), 1.0)
    for mode in screen_modes:
        key, tag = ("scr", "SCREENED") if mode is True else ("auto", "SCREEN=auto")
        scr, t_scr = _timed_fit(xs, yv, dev, screen=mode, **dict(kw, lambda_path=full.lambda_))
        sstats = {k: v for k, v in scr.stats.get("screening", {}).items() if k != "active_per_group"}
        diff = float(np.abs(scr.beta - full.beta).max())
        log(f"[D={D}] {tag} path: {t_scr:.3f}s wall, {scr.stats['epochs']} epochs, work-based "
            f"{scr.stats['nnz_per_s']:.4e} elem/s, stats {sstats}")
        obj_scr = path_objective(scr, xs, yv)
        rel = float(np.max(np.abs(obj_scr - obj) / np.abs(obj)))
        coef_ok = bool(diff <= SCREEN_CONTRACT * scale)
        log(f"[D={D}] {tag} vs full: penalized objective {rel:.3e} relative (thresh {OBJECTIVE_BOUND:g}): "
            f"{'PASS' if rel <= OBJECTIVE_BOUND else 'FAIL'}; max|diff| {diff:.3e} ({diff / scale:.2e} relative; the "
            f"JAX tool's contract {SCREEN_CONTRACT:g}): {'PASS' if coef_ok else 'FAIL'} -> {t_full / t_scr:.2f}x wall")
        out.update({f"t_{key}": t_scr, f"ep_{key}": scr.stats["epochs"], f"{key}_objective": obj_scr.tolist(),
                    f"{key}_objective_rel": rel, f"{key}_objective_pass": bool(rel <= OBJECTIVE_BOUND),
                    f"{key}_diff": diff / scale, f"{key}_coef_pass": coef_ok,
                    "finite": out["finite"] and bool(np.isfinite(scr.beta).all() and np.isfinite(obj_scr).all())})
    return out


def kernel_build_s(dev) -> float | None:
    """Seconds of the one-time kernel build (or load) of this process, timed
    apart from the fits; None off the card."""
    if dev.type != "cuda":
        return None
    from sgdnet_tpu_torch.utils import build

    t0 = time.perf_counter()
    build.load_library()
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("args", nargs="*", help="`quick` (n 20000) and head widths (default 16384 32768)")
    ap.add_argument("--nlambda", type=int, default=50)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card; raises without one)")
    a = ap.parse_args(argv)
    from sgdnet_tpu_torch.tools import bench
    from sgdnet_tpu_torch.utils.device import describe, resolve_device

    quick = "quick" in a.args
    widths = tuple(int(v) for v in a.args if v != "quick") or (16384, 32768)
    dev = resolve_device(a.device)
    build_s = kernel_build_s(dev)
    bench.log(f"device {describe(dev)}; kernel build {build_s} s (excluded from the timings)")
    n = 20_000 if quick else 100_000
    data, y = bench.make_sparse_binomial(n=n, p=47_000, nnz_per_row=76, seed=3)
    xs = bench._to_scipy(data)
    yv = np.asarray(y).ravel()
    bench.log(f"workload: {n}x{xs.shape[1]}, {xs.nnz / 1e6:.2f}M nnz")
    # screening once, at the first width: its active sets are narrow, so its
    # cost does not depend on the width
    results = [run_one(xs, yv, xs.nnz, D, (True, "auto") if i == 0 else (), a.nlambda, dev)
               for i, D in enumerate(widths)]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(json.dumps({"device": describe(dev), "n": n, "nnz": int(xs.nnz), "kernel_build_s": build_s,
                      "widths": results}))
    return 0 if all(r["finite"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
