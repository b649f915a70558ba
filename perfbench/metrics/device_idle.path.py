"""The card's idle share of the traced window of whole fits, %."""

from perfbench import readers


def read(ctx):
    return readers.device_idle(ctx, "fits")
