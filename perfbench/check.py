"""The comparisons that decide `correct`.

A gap is taken leaf by leaf: the norm of the program's leaf minus the
reference's, over the larger of the reference leaf's norm and the median
of the reference leaves' norms (so a leaf that is all but zero is judged
on the scale of the others).  A number compared is the worst such gap,
and a run is correct when every number is finite and within its limit.
"""

from __future__ import annotations

import numpy as np


def _norm(a) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64).ravel()))


def worst_gap(program: dict, reference: dict) -> float:
    """max over the leaves of |program - reference| / max(|reference|,
    median leaf norm); inf where a leaf is missing, mis-shaped or not
    finite."""
    norms = [_norm(reference[k]) for k in reference]
    floor = float(np.median(norms)) if norms else 0.0
    worst = 0.0
    for key, ref in reference.items():
        got = program.get(key)
        if got is None or np.shape(got) != np.shape(ref) or not np.all(np.isfinite(got)):
            return float("inf")
        den = max(_norm(ref), floor)
        worst = max(worst, _norm(np.asarray(got, np.float64) - np.asarray(ref, np.float64)) / den if den > 0 else 0.0)
    return worst


def relative_gap(program, reference) -> float:
    """max |program - reference| / |reference| elementwise (inf where not finite)."""
    got, ref = np.asarray(program, np.float64), np.asarray(reference, np.float64)
    if got.shape != ref.shape or not np.all(np.isfinite(got)):
        return float("inf")
    return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)))


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every limit's number read and
    within it."""
    out = {}
    ok = True
    for name, limit in limits.items():
        v = readings.get(name)
        v = float("inf") if v is None or not np.isfinite(v) else float(v)
        out[name] = {"value": v, "limit": float(limit)}
        ok = ok and v <= limit
    return ok, out
