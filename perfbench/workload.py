"""The general generator: one run of a cell's traffic against the port.

A traffic file's `kind` picks the loop; its other keys and the
configuration's file are the parameters:

- "epochs", a closed loop of SAGA epochs at one lambda and a fixed step:
  set-up makes the design from the run's seed, builds the layout, and
  runs the first `warm_epochs` epochs through the window's own call
  (they build or load every kernel and are the epochs the reference
  follows); the
  window then runs epochs back to back, each with its block order drawn
  from the seed, and ends with a synchronize.  With --trace 1 the
  window is `trace_epochs` epochs under the profiler.
- "fits", a closed loop of whole `fit()` calls on the host's scipy
  matrix: set-up makes the design and runs one fit (every kernel and
  shape); the window holds whole fits, a fit that starts before the
  deadline finishing and counting, each with its own fit seed drawn
  from the run's seed (the design as for "epochs").  With --trace 1 the
  window is one fit under the profiler.  The reference runs the path of
  one fit of the window, drawn from the seed, each attempt for the
  epochs that fit ran it.

Both compare after the window has closed, the peak memory has been read
and the program's state is freed.
"""

from __future__ import annotations

import gc
import importlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import record_function

from perfbench import adapter, check, trace
from perfbench.reference import saga as ref


@dataclass
class Outcome:
    """What a run measured and compared."""

    end_to_end: dict  # metric name -> value
    attempted: int
    failed: int
    readings: dict  # number compared -> value
    peak_bytes: int
    ctx: dict = field(default_factory=dict)  # what the per-layer readers read
    summary: object = None  # trace.Summary of a traced window


def make_data(config: dict, seed: int):
    """(x scipy CSR, y, k) from the configuration's data kind."""
    return importlib.import_module(f"perfbench.data.{config['data_kind']}").make(config, seed)


def block_orders(seed: int, count: int, n_blocks: int) -> torch.Tensor:
    """(count, n_blocks): epoch i's order of the blocks, drawn from the seed."""
    rng = np.random.default_rng([seed, 0x0DE7])
    return torch.as_tensor(np.argsort(rng.random((count, n_blocks)), axis=1))


def fit_settings(config: dict, traffic: dict) -> dict:
    """`fit()`'s keywords: the configuration's model and layout, the traffic's path."""
    lay = config["layout"]
    return dict(config["model"], batch_size=lay["batch_size"], sampling="block", hybrid=True,
                hybrid_max_head=lay["max_head"], hybrid_coverage=lay["coverage"],
                hybrid_head_dtype=lay["head_dtype"], g_sum_refresh_every=lay["g_sum_refresh_every"],
                hybrid_memory_budget=lay["memory_budget"], **traffic["path"])


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# epochs
# ---------------------------------------------------------------------------


def state_leaves(s: dict, head_cols, tail_cols) -> dict:
    """The leaves a state is judged by (columns in the input's order)."""
    return {"w_head": s["w"][:, head_cols], "w_tail": s["w"][:, tail_cols], "intercept": s["intercept"],
            "g_mem": s["g_mem"], "g_sum_head": s["g_sum"][:, head_cols], "g_sum_tail": s["g_sum"][:, tail_cols],
            "g_sum_intercept": s["g_sum_intercept"]}


def reference_epochs(x, y, k: int, config: dict, orders, device, precision: str = "bfloat16"):
    """The reference's states after each epoch of `orders` from a zero
    state, as snapshots (input column order), with its split (perm, D)
    and its design."""
    lay, model, step = config["layout"], config["model"], config["epochs"]
    n = x.shape[0]
    perm, D = ref.split_columns(x, lay["coverage"], lay["max_head"])
    d = ref.build_design(x, perm, D, lay["batch_size"], device, precision)
    yv = torch.zeros((d.n_pad, k), dtype=ref.F64, device=device)
    if k == 1:
        yv[:n, 0] = torch.as_tensor(np.asarray(y, np.float64), device=device)
    else:
        yv[torch.arange(n, device=device), torch.as_tensor(np.asarray(y), device=device)] = 1.0
    wts = torch.zeros(d.n_pad, dtype=ref.F64, device=device)
    wts[:n] = 1.0
    pr = ref.Problem(d, yv, wts, model["family"], lay["intercept_decay"], lay["g_sum_refresh_every"])
    st = ref.init_state(d, k)
    snaps = []
    for i, order in enumerate(orders):
        st = ref.epoch(pr, st, order.numpy(), step["gamma"], step["lambda"], 0.0, i)
        snap = {"intercept": st.intercept.cpu().numpy(), "g_mem": st.g_mem.cpu().numpy(),
                "g_sum_intercept": st.g_sum_intercept.cpu().numpy()}
        for name in ("w", "g_sum"):
            a = getattr(st, name).cpu().numpy()
            snap[name] = np.empty_like(a)
            snap[name][:, perm] = a
        snaps.append(snap)
    return snaps, perm, D, d


def epoch_gap(program_snaps, reference_snaps, perm, D) -> float:
    """The worst leaf's gap over the compared epochs."""
    head, tail = perm[:D], perm[D:]
    return max(check.worst_gap(state_leaves(p, head, tail), state_leaves(r, head, tail))
               for p, r in zip(program_snaps, reference_snaps))


def run_epochs(cell, seed: int, seconds: float, traced: bool, device, t0: float) -> Outcome:
    config, tr = cell.config, cell.traffic
    x, y, k = make_data(config, seed)
    warm = tr["warm_epochs"]
    with adapter.fp32_products():
        prog = adapter.Epochs(x, y, k, config["layout"], dict(config["model"], **config["epochs"],
                              intercept_decay=config["layout"]["intercept_decay"]), device)
        orders = block_orders(seed, tr["orders"], prog.n_blocks)
        state = prog.init_state()
        snaps = []
        for i in range(warm):
            state = prog.epoch(state, orders[i], i)
            snaps.append(prog.snapshot(state))
        _sync(device)
        setup_s = time.perf_counter() - t0
        i, summary = warm, None
        if traced:
            with trace.traced(device) as tout:
                t_start = time.perf_counter()
                for _ in range(tr["trace_epochs"]):
                    with record_function("perfbench.epoch"):
                        state = prog.epoch(state, orders[i % len(orders)], i)
                    i += 1
            t_end = time.perf_counter()
            summary = tout["summary"]
        else:
            t_start = time.perf_counter()
            while True:
                state = prog.epoch(state, orders[i % len(orders)], i)
                i += 1
                if time.perf_counter() - t_start >= seconds:
                    break
            _sync(device)
            t_end = time.perf_counter()
        epochs = i - warm
        finite = prog.finite(state)
        n_blocks = prog.n_blocks
    peak = _peak(device)
    del prog, state
    _free(device)

    ref_snaps, perm, D, d = reference_epochs(x, y, k, config, orders[:warm], device)
    gap = epoch_gap(snaps, ref_snaps, perm, D)
    blocks = [(int(c.numel()), int(torch.unique(c).numel())) for _, c, _ in d.tail]
    del d
    _free(device)
    e2e = {"nnz_per_s": config["n"] * config["nnz_per_row"] * epochs / (t_end - t_start),
           "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
    ctx = {"kind": "epochs", "epochs": epochs, "steps": epochs * n_blocks, "B": config["layout"]["batch_size"],
           "D": D, "k": k, "p": x.shape[1], "blocks": blocks,
           "head_itemsize": getattr(torch, config["layout"]["head_dtype"]).itemsize}
    return Outcome(e2e, epochs, 0 if finite else epochs, {"state_gap": gap}, peak, ctx, summary)


# ---------------------------------------------------------------------------
# fits
# ---------------------------------------------------------------------------


def fitted_leaves(x, rec: dict) -> dict:
    """A path's fitted linear predictors on the design as given, a leaf
    each a lambda: x beta^T + a0, (n, k), in float64."""
    xd = x.astype(np.float64)
    return {f"eta{i}": np.asarray(xd @ np.atleast_2d(rec["beta"][i]).T) + np.atleast_1d(rec["a0"][i])
            for i in range(len(rec["lambda"]))}


def objectives(x, y, rec: dict, lambdas, x_scale) -> np.ndarray:
    """The binomial lasso's penalized objective of each lambda's coefficients
    in `rec`: the mean negative log-likelihood on the design as given, plus
    lambda sum_j |beta_j| sd_j (the penalty of the standardized problem)."""
    yv = np.asarray(y, np.float64)[:, None]
    eta = fitted_leaves(x, rec)
    return np.array([float(np.mean(np.logaddexp(0.0, eta[f"eta{i}"]) - yv * eta[f"eta{i}"]))
                     + lam * float(np.sum(np.abs(rec["beta"][i]) * x_scale)) for i, lam in enumerate(lambdas)])


def fit_numbers(x, y, rec: dict, r: dict) -> dict:
    """The numbers compared for the path `rec` against the reference's `r`:
    the lambdas, and the worst lambda's relative gap of the penalized
    objective (on the design as given, in original units).  The objective
    is compared, not the coefficients: a path stopped at thresh 1e-3 is
    short of the optimum along the design's flat directions, where float32
    and float64 iterates drift apart while the objective barely moves."""
    f_p = objectives(x, y, rec, r["lambda"], r["x_scale"])
    f_r = objectives(x, y, r, r["lambda"], r["x_scale"])
    return {"lambda_gap": check.relative_gap(rec["lambda"], r["lambda"]),
            "objective_gap": float(np.max(np.abs(f_p - f_r) / np.abs(f_r)))}


def reference_fit(x, y, settings: dict, rec: dict, device, precision: str = "bfloat16") -> dict:
    """The reference's path from the fit `rec`'s seed, running each attempt
    for the epochs `rec` ran it."""
    return ref.fit_path(x, y, settings, rec["seed"], device, precision, follow=rec["epoch_log"])


def run_fits(cell, seed: int, seconds: float, traced: bool, device, t0: float) -> Outcome:
    config, tr = cell.config, cell.traffic
    x, y, _ = make_data(config, seed)
    settings = fit_settings(config, tr)
    rng = np.random.default_rng([seed, 0x0F17])

    def one():
        s = int(rng.integers(0, 2**31 - 1))
        t = time.perf_counter()
        rec = adapter.fit(x, y, settings, s, device)
        rec["wall_s"], rec["seed"] = time.perf_counter() - t, s
        return rec

    one()  # builds or loads every kernel and meets every shape
    _sync(device)
    setup_s = time.perf_counter() - t0
    fits, summary = [], None
    t_start = time.perf_counter()
    if traced:
        with trace.traced(device) as tout, record_function("perfbench.fit"):
            fits.append(one())
        summary = tout["summary"]
    else:
        while not fits or time.perf_counter() - t_start < seconds:
            fits.append(one())
    t_end = time.perf_counter()  # fit() returns host arrays: the card has finished
    peak = _peak(device)
    _free(device)

    pick = fits[int(rng.integers(len(fits)))]
    readings = fit_numbers(x, y, pick, reference_fit(x, y, settings, pick, device))
    _free(device)
    failed = sum(not (np.all(np.isfinite(f["beta"])) and np.all(np.isfinite(f["a0"]))) for f in fits)
    e2e = {"fit_s": (t_end - t_start) / len(fits), "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
    ctx = {"kind": "fits", "fits": fits}
    return Outcome(e2e, len(fits), failed, readings, peak, ctx, summary)


KINDS = {"epochs": run_epochs, "fits": run_fits}


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float) -> Outcome:
    return KINDS[cell.traffic["kind"]](cell, seed, seconds, traced, device, t0)
