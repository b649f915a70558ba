"""The g_sum refresh's device time, ms: the mean over the traced window's
`sgdnet.refresh` spans of the CUDA events' time between the span's entry
and exit (the port's utils/profiling.py records): the refresh's head
product, its scatter-add over the tail and their elementwise ops.
Where the port records no spans, None."""


def refresh_device_ms(records):
    """The mean device ms of the `sgdnet.refresh` records that have one."""
    ms = [r.device_ms for r in records if r.name == "sgdnet.refresh" and r.device_ms is not None]
    return sum(ms) / len(ms) if ms else None


def read(ctx):
    if ctx.get("kind") != "epochs":
        return None
    from sgdnet_tpu_torch.utils import profiling

    records = getattr(profiling, "span_records", None)
    return None if records is None else refresh_device_ms(records())
