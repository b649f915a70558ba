"""K2's streamed design (csrc/head_step.cu, where no cluster holds k x D)
in the rcv1-multiclass epoch cell: its share of its roofline a step,
over the summed device time of its three kernels, %."""

from perfbench import readers

#: the kernels of one K2 step in this design, by their names in the trace
KERNELS = ("head_round_w", "head_step_streamed", "head_corr_streamed")


def read(ctx):
    return readers.head_step_share(ctx, KERNELS)
