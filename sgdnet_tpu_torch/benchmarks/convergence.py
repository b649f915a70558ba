"""The reference's benchmark protocol on the port (twin of
sgdnet_tpu/benchmarks/convergence.py).

The reference (data-raw/benchmarks.R:35-112, vignettes/benchmarks.Rmd:40-53)
fits each dataset at lambda = 1/n for lasso (alpha 1) and ridge (alpha 0)
over log-spaced convergence tolerances (0.9 -> 1e-3), timing each fit and
recording the objective loss it reached: loss-against-time curves.
`run_reference_protocol()` runs that sweep on the bundled datasets with
the wall of each fit, its epochs and loss.

    python -m sgdnet_tpu_torch.benchmarks.convergence [--device cuda|cpu]

prints one JSON line a curve.  The fits run on `device` (None: the card).
"""

from __future__ import annotations

import time

import numpy as np

from sgdnet_tpu_torch.api.fit import fit
from sgdnet_tpu_torch.families import get_family


def _objective_loss(fit_obj, x, y):
    """Mean family loss of the last path point on the original data (the
    reference's EpochLoss: no penalty term)."""
    family = fit_obj.family
    if family == "gaussian":
        pred = fit_obj.predict(np.asarray(x))[:, -1]
        return float(0.5 * np.mean((pred - np.asarray(y).ravel()) ** 2))
    if family == "binomial":
        z = fit_obj.predict(np.asarray(x), type="link")[:, -1]
        y01, _ = get_family("binomial").encode(np.asarray(y))
        return float(np.mean(np.logaddexp(0, z) - y01[:, 0] * z))
    if family == "multinomial":
        lp = fit_obj.predict(np.asarray(x), type="link")[:, :, -1]  # (n, k)
        onehot, _ = get_family("multinomial").encode(np.asarray(y))
        m = lp.max(axis=1, keepdims=True)
        lse = np.log(np.exp(lp - m).sum(axis=1)) + m[:, 0]
        return float(np.mean(lse - (lp * onehot).sum(axis=1)))
    if family == "mgaussian":
        pred = fit_obj.predict(np.asarray(x))[:, :, -1]  # (n, k)
        return float(0.5 * np.mean(np.sum((pred - np.asarray(y)) ** 2, axis=1)))
    raise ValueError(f"unsupported family for the protocol: {family}")


def convergence_curve(x, y, family="gaussian", alpha=1.0, tolerances=None, maxit=1000, device=None,
                      **fit_kwargs):
    """Tolerance sweep at lambda = 1/n: a dict of tolerances, times (s),
    losses and epochs, one entry a tolerance (the reference's
    data-raw/benchmarks.R:41-45), and `fits` (each fit's stats)."""
    if tolerances is None:
        tolerances = np.exp(np.linspace(np.log(0.9), np.log(1e-3), 10))
    lam = 1.0 / np.asarray(y).shape[0]
    base = dict(family=family, alpha=alpha, lambda_path=[lam], device=device, **fit_kwargs)

    # a first fit builds and loads the kernels, so the times are steady-state
    fit(x, y, maxit=2, thresh=0.9, **base)
    times, losses, epochs, stats = [], [], [], []
    for tol in tolerances:
        t0 = time.perf_counter()
        f = fit(x, y, maxit=maxit, thresh=float(tol), **base)
        times.append(time.perf_counter() - t0)
        losses.append(_objective_loss(f, x, y))
        epochs.append(f.npasses)
        stats.append(f.stats)
    return {
        "tolerances": np.asarray(tolerances),
        "times": np.asarray(times),
        "losses": np.asarray(losses),
        "epochs": np.asarray(epochs),
        "alpha": alpha,
        "family": family,
        "fits": stats,
    }


def convergence_curve_trace(x, y, family="gaussian", alpha=1.0, maxit=1000, n_points=28, device=None,
                            **fit_kwargs):
    """The loss-against-time curve at lambda = 1/n from one `debug=True` fit
    (its loss after every epoch) and two timed fits (a tight and a loose
    tolerance, best of 2 each), whose (wall, epochs) pairs fix the time
    model t(e) = overhead + e * epoch_time.  The debug fit runs the plain
    step (fit's K1 gate sends debug fits there), so its cost is that of the
    plain path; the timed fits run the path a user gets.

    The gaussian trace is on the standardized response (the solver's y):
    its losses are rescaled by var(y) to the original scale the other
    curves use.  Returns `convergence_curve`'s dict, with `time_model`."""
    yv = np.asarray(y)
    lam = 1.0 / yv.shape[0]
    base = dict(family=family, alpha=alpha, lambda_path=[lam], device=device, **fit_kwargs)

    fit(x, y, maxit=maxit, thresh=1e-3, **base)
    walls, epochs_meas = [], []
    for thresh in (1e-3, 0.05):
        best = (np.inf, 1)
        for _ in range(2):
            t0 = time.perf_counter()
            f = fit(x, y, maxit=maxit, thresh=thresh, **base)
            w = time.perf_counter() - t0
            if w < best[0]:
                best = (w, max(f.npasses, 1))
        walls.append(best[0])
        epochs_meas.append(best[1])
    (w1, w2), (e1, e2) = walls, epochs_meas
    if e1 > e2 and w1 > w2:
        t_ep = (w1 - w2) / (e1 - e2)
        overhead = max(w1 - e1 * t_ep, 0.0)
    else:  # the same epochs, or timing noise: no split
        t_ep = w1 / e1
        overhead = 0.0

    # thresh 0 always ends at maxit, which would set off the halved-step
    # retries, and a kept retry's trace reaches its best loss only near
    # maxit: the trace fit is a fixed-epoch measurement, without retries
    dbg = fit(x, y, maxit=maxit, thresh=0.0, debug=True, step_backoff=False, **base)
    trace = np.asarray(dbg.diagnostics["loss"][0], dtype=np.float64)
    trace = trace[np.isfinite(trace)]
    if family == "gaussian":
        trace = trace * float(np.var(yv.astype(np.float64)))
    e_grid = np.unique(np.round(np.geomspace(1, len(trace), min(n_points, len(trace)))).astype(int))
    return {
        "tolerances": np.full(len(e_grid), np.nan),
        "times": overhead + e_grid * t_ep,
        "losses": trace[e_grid - 1],
        "epochs": e_grid,
        "alpha": alpha,
        "family": family,
        "time_model": {"overhead_s": overhead, "epoch_s": t_ep, "measured": list(zip(walls, epochs_meas))},
    }


def bundled_datasets() -> dict:
    """The four bundled datasets and their families (the reference's four
    benchmark families, vignettes/benchmarks.Rmd:62-125)."""
    from sgdnet_tpu_torch.data import load_abalone, load_heart, load_student, load_wine

    return {
        "abalone": (load_abalone(), "gaussian"),
        "heart": (load_heart(), "binomial"),
        "wine": (load_wine(), "multinomial"),
        "student": (load_student(), "mgaussian"),
    }


def run_reference_protocol(datasets=None, device=None, **fit_kwargs):
    """The sweep on the bundled datasets (or `datasets`: name -> ((x, y),
    family)) for lasso and ridge: {"name/lasso" | "name/ridge": curve}."""
    out = {}
    for name, ((x, y), family) in (datasets or bundled_datasets()).items():
        for alpha, pen in ((1.0, "lasso"), (0.0, "ridge")):
            out[f"{name}/{pen}"] = convergence_curve(x, y, family=family, alpha=alpha, device=device, **fit_kwargs)
    return out


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card; raises without one)")
    a = ap.parse_args(argv)
    for k, v in run_reference_protocol(device=a.device).items():
        print(json.dumps({"bench": k, "final_loss": float(v["losses"][-1]), "time_to_tightest": float(v["times"][-1]),
                          "epochs": int(v["epochs"][-1])}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
