"""The readings a cell's limits are set from, on the card at the cell's size.

    python3 -m perfbench.calibrate --workload <cell> --seeds 1,2,3 [--control-seeds 4,5,6] [--out FILE]

For each seed of `--seeds`, the program's numbers compared, as a run
computes them but with no measured window: the epoch cells' warm epochs
against the reference, the path cell's fit against the reference's (with
the fitted values' and the coefficients' gaps, the epochs of each
attempt and the decisions the reference took from the fit beside them,
for the look; no limit holds them).
For each seed of `--control-seeds`, the control's: the reference with its
head stored in int8 (a scale a column), the precision below the
configuration's bfloat16, put in the program's place and judged as the
program is.  One JSON line a reading on standard output (and appended to
FILE).  Nothing here runs in a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from perfbench import adapter, check, manifest, workload
from perfbench.reference import saga as ref


def epoch_readings(cell, seed: int, device, program: bool, control: bool) -> list:
    cfg, tr = cell.config, cell.traffic
    x, y, k = workload.make_data(cfg, seed)
    warm = tr["warm_epochs"]
    out = []
    n_blocks = ref.round_up(x.shape[0], cfg["layout"]["batch_size"]) // cfg["layout"]["batch_size"]
    orders = workload.block_orders(seed, warm, n_blocks)
    ref_snaps, perm, D, d = workload.reference_epochs(x, y, k, cfg, orders, device)
    del d
    if program:
        with adapter.fp32_products():
            prog = adapter.Epochs(x, y, k, cfg["layout"], dict(cfg["model"], **cfg["epochs"],
                                  intercept_decay=cfg["layout"]["intercept_decay"]), device)
            st, snaps = prog.init_state(), []
            for i in range(warm):
                st = prog.epoch(st, orders[i], i)
                snaps.append(prog.snapshot(st))
            del prog, st
        out.append({"side": "program", "state_gap": workload.epoch_gap(snaps, ref_snaps, perm, D)})
    if control:
        ctl, _, _, d = workload.reference_epochs(x, y, k, cfg, orders, device, precision="int8")
        del d
        out.append({"side": "control", "state_gap": workload.epoch_gap(ctl, ref_snaps, perm, D)})
    return out


def fit_leaves(rec: dict) -> dict:
    """A path's coefficients and intercepts, a leaf each a lambda."""
    out = {}
    for i in range(len(rec["lambda"])):
        out[f"beta{i}"] = rec["beta"][i]
        out[f"a0_{i}"] = np.atleast_1d(rec["a0"][i])
    return out


def _path_stats(x, y, rec, r) -> dict:
    """Beside the numbers compared, for the look: per lambda the fitted
    values' gap and the penalized objective's signed relative gap, and the
    coefficients' worst gap."""
    eta_p, eta_r = workload.fitted_leaves(x, rec), workload.fitted_leaves(x, r)
    floor = float(np.median([np.linalg.norm(v) for v in eta_r.values()]))
    f_p = workload.objectives(x, y, rec, r["lambda"], r["x_scale"])
    f_r = workload.objectives(x, y, r, r["lambda"], r["x_scale"])
    return {"eta_gap_by_lambda": [float(np.linalg.norm(eta_p[k] - eta_r[k]) / max(np.linalg.norm(eta_r[k]), floor))
                                  for k in eta_r],
            "objective_gap_by_lambda": ((f_p - f_r) / np.abs(f_r)).tolist(),
            "coef_gap": check.worst_gap(fit_leaves(rec), fit_leaves(r))}


def _log(log: dict) -> list:
    return [[lam, a, e] for (lam, a), e in sorted(log.items())]


def fit_readings(cell, seed: int, device, program: bool, control: bool) -> list:
    """The path's numbers for the program's fit (`program`) and the
    control's (`control`), each against the reference running each attempt
    for the epochs that side ran it; for the look, each side's epochs an
    attempt and the decisions the reference took from it against its own
    test."""
    x, y, _ = workload.make_data(cell.config, seed)
    settings = workload.fit_settings(cell.config, cell.traffic)
    sides = ([("program", lambda: adapter.fit(x, y, settings, seed, device))] if program else []) + (
        [("control", lambda: ref.fit_path(x, y, settings, seed, device, precision="int8"))] if control else [])
    out = []
    for side, make in sides:
        rec = make()
        rec["seed"] = seed
        t = time.perf_counter()
        r = workload.reference_fit(x, y, settings, rec, device)
        out.append({"side": side, **workload.fit_numbers(x, y, rec, r), **_path_stats(x, y, rec, r),
                    "fit_gap": check.worst_gap(workload.fitted_leaves(x, rec), workload.fitted_leaves(x, r)),
                    "epochs": int(np.sum(rec["epochs"])), "epoch_log": _log(rec["epoch_log"]),
                    "followed": r["followed"], "reference_s": time.perf_counter() - t})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    cell = manifest.cell(a.workload)
    device = torch.device(a.device)
    seeds = [int(s) for s in a.seeds.split(",") if s]
    controls = [int(s) for s in a.control_seeds.split(",") if s]
    fn = epoch_readings if cell.traffic["kind"] == "epochs" else fit_readings
    for seed in sorted(set(seeds) | set(controls), key=(seeds + controls).index):
        t = time.perf_counter()
        for r in fn(cell, seed, device, seed in seeds, seed in controls):
            line = json.dumps({"workload": a.workload, "seed": seed, **r, "seconds": time.perf_counter() - t})
            print(line, flush=True)
            if a.out:
                with open(a.out, "a", encoding="utf-8") as f:
                    f.write(line + "\n")
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
