"""One run of one benchmark cell on the card.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Makes the cell's inputs from the seed, builds or loads the port's
kernels (in `sgdnet_tpu_torch/_build/` inside the checkout), warms up
the cell's own shapes, measures for `--seconds` (--trace 0: the cell's
end-to-end metrics) or runs a traced window (--trace 1: its per-layer
metrics), then holds what the timed path produced to the plain
reference.  A cell on more than one chip runs as that many ranks, one
process a card (`ranks.py`), whose results make the one line.  The last
line of standard output is one JSON object: correct, attempted, failed,
metrics, device, with --trace 1 a breakdown, and last the numbers
compared beside their limits, which also end standard error.  Without a
CUDA card, or with fewer than the cell asks for, it prints no result and
exits 2; where JAX or the JAX package was loaded, it exits 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

#: top-level modules that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "sgdnet_tpu")
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: `sgdnet_tpu_torch` is not `sgdnet_tpu`."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _cache_dirs() -> None:
    """Kernel caches, at fixed paths inside the checkout.  The port keeps
    its own in `sgdnet_tpu_torch/_build/`; a later kernel built by
    torch.utils.cpp_extension or Triton finds its cache here already, since
    a later change may not edit this file."""
    base = os.path.join(_ROOT, ".perfbench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(base, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))


def card(device) -> dict:
    """The card's name, as torch gives it, and power limit, as nvidia-smi reads it."""
    import subprocess

    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        q = subprocess.run(["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits"], capture_output=True, text=True, check=True, timeout=30)
        out["power_limit_w"] = float(q.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        out["power_limit_w"] = None
    return out


def result(cell, outcome, traced: bool, device_info: dict) -> dict:
    """The result line: the end-to-end or per-layer metrics the manifest
    gives this cell, with the device and the comparisons."""
    from perfbench import check, manifest

    correct, compared = check.judge(outcome.readings, cell.limits)
    metrics = {}
    if traced:
        ctx = dict(outcome.ctx, summary=outcome.summary)
        for m in cell.per_layer:
            v = manifest.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:  # a name is the quantity, with a suffix where it names its cells
            metrics[m["name"]] = {"value": outcome.end_to_end[m["name"].split(".", 1)[0]], "unit": m["unit"]}
    dev = dict(device_info, memory_peak_bytes=outcome.peak_bytes)
    out = {"correct": bool(correct and outcome.failed == 0), "attempted": outcome.attempted,
           "failed": outcome.failed, "metrics": metrics, "device": dev}
    if traced and outcome.summary is not None:
        dev["busy_s"], dev["window_s"] = outcome.summary.busy_s, outcome.summary.window_s
        out["breakdown"] = outcome.summary.breakdown()
    out["checks"] = compared
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    _cache_dirs()
    import torch

    from perfbench import manifest

    cell = manifest.cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: the cell {a.workload} needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result", file=sys.stderr)
        return 2
    if cell.chips > 1:
        from perfbench import ranks

        return ranks.main(cell, a.seed, a.seconds, bool(a.trace), T0)
    from perfbench import workload

    device = torch.device("cuda", 0)
    info = card(device)
    outcome = workload.run(cell, a.seed, a.seconds, bool(a.trace), device, T0)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}: no result", file=sys.stderr)
        return 3
    emit(result(cell, outcome, bool(a.trace), info))
    return 0


def emit(out: dict) -> None:
    """The numbers compared beside their limits as the last lines of standard
    error, then the result as the last line of standard output."""
    for name, c in out["checks"].items():
        print(f"perfbench check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    sys.exit(main())
