"""The card's idle share of the traced window of epochs in the
rcv1-multiclass epoch cell, %."""

from perfbench import readers


def read(ctx):
    return readers.device_idle(ctx, "epochs")
