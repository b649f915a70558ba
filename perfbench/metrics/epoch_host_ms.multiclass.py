"""The host's time to issue one epoch at k 53 in the rcv1-multiclass epoch
cell, ms, read as `epoch_host_ms` reads it: beside the epoch's device
time it shows how near the host comes to setting the pace."""

from perfbench import manifest


def read(ctx):
    return manifest.reader("epoch_host_ms")(ctx)
