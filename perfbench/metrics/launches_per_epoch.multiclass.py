"""Kernel launches an epoch in the rcv1-multiclass epoch cell: the traced
window's kernel records (copies and fills left out) over the epochs it
ran, as the port's `step_profile` counts them."""

from perfbench import readers


def read(ctx):
    return readers.launches_per_epoch(ctx)
