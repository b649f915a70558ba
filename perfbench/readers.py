"""What the per-layer metrics' readers (metrics/<name>.py) share: each
reads the run's context (`ctx`: the traced window's trace.Summary under
"summary", the loop's kind and counts, the shapes the roofline counts
take) and returns a number, or None where it finds nothing to read."""

from __future__ import annotations

from perfbench import roofline


def _epochs(ctx):
    s = ctx.get("summary")
    return s if s is not None and ctx.get("kind") == "epochs" and ctx.get("epochs") else None


def launches_per_epoch(ctx):
    """Kernel records of the traced window (copies and fills left out) over
    the epochs it ran."""
    s = _epochs(ctx)
    return None if s is None else len(s.kernels()) / ctx["epochs"]


def _share(ctx, kernels, bound_s: float):
    s = _epochs(ctx)
    t = 0.0 if s is None else s.device_seconds(kernels)
    return None if t <= 0.0 else 100.0 * bound_s / t


def head_step_share(ctx, kernels):
    """K2: its least time a step (roofline.head_step) times the steps traced,
    over the summed device time of `kernels`, %."""
    if _epochs(ctx) is None:
        return None
    return _share(ctx, kernels, ctx["steps"] * roofline.head_step(ctx["B"], ctx["D"], ctx["k"], ctx["head_itemsize"]))


def tail_forward_share(ctx, kernels):
    """K3: every block's least time an epoch (roofline.tail_forward, from its
    tail entries and distinct columns) times the epochs traced, over the
    device time of `kernels`, %."""
    if _epochs(ctx) is None:
        return None
    per_epoch = sum(roofline.tail_forward(c, u, ctx["B"], ctx["k"]) for c, u in ctx["blocks"])
    return _share(ctx, kernels, ctx["epochs"] * per_epoch)


def tail_outer_share(ctx, kernels):
    """K4: every block's least time an epoch (roofline.tail_outer) times the
    epochs traced, over the device time of `kernels`, %."""
    if _epochs(ctx) is None:
        return None
    per_epoch = sum(roofline.tail_outer(c, ctx["B"], ctx["p"], ctx["k"]) for c, _ in ctx["blocks"])
    return _share(ctx, kernels, ctx["epochs"] * per_epoch)


def device_idle(ctx, kind: str):
    """The card's idle share of the traced window, %: 1 minus the union of
    its operations' intervals over the window; None outside a `kind` loop."""
    s = ctx.get("summary")
    if s is None or ctx.get("kind") != kind or s.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
