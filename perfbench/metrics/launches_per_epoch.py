"""Kernel launches an epoch: the traced window's kernel records (copies and
fills left out) over the epochs it ran, as the port's `step_profile`
counts them.  The host launches every one, and the binary epoch loop is
host-bound: moves nnz_per_s."""

from perfbench import readers


def read(ctx):
    return readers.launches_per_epoch(ctx)
