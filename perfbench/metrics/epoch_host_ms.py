"""The host's time to issue one epoch, ms: over the traced window's
`sgdnet.epoch` spans (the port's utils/profiling.py records), the median
of each span's host duration less that of its `sgdnet.refresh` child.
Read at the epoch, not the step, so that it holds for an epoch launched
as one captured graph too.  Where the port records no spans, None."""

import statistics


def epoch_issue_ms(records):
    """The median host ms of the `sgdnet.epoch` records, each less the
    refresh records inside it; None without epoch records."""
    epochs = [r for r in records if r.name == "sgdnet.epoch" and r.end_ns is not None]
    refreshes = [r for r in records if r.name == "sgdnet.refresh" and r.parent == "sgdnet.epoch"
                 and r.end_ns is not None]
    if not epochs:
        return None
    out = []
    for e in epochs:
        inner = sum(r.end_ns - r.start_ns for r in refreshes if e.start_ns <= r.start_ns and r.end_ns <= e.end_ns)
        out.append((e.end_ns - e.start_ns - inner) * 1e-6)
    return statistics.median(out)


def read(ctx):
    if ctx.get("kind") != "epochs":
        return None
    from sgdnet_tpu_torch.utils import profiling

    records = getattr(profiling, "span_records", None)
    return None if records is None else epoch_issue_ms(records())
