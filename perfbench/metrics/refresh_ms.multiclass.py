"""The g_sum refresh's device time at k 53 in the rcv1-multiclass epoch
cell, ms, read as `refresh_ms` reads it."""

from perfbench import manifest


def read(ctx):
    return manifest.reader("refresh_ms")(ctx)
