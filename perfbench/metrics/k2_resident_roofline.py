"""K2's resident design (csrc/head_step.cu) in the rcv1-binary epoch cell:
its share of its roofline a step, %."""

from perfbench import readers

#: the kernels of one K2 step in this design, by their names in the trace
KERNELS = ("head_step_resident", "sum_partials")


def read(ctx):
    return readers.head_step_share(ctx, KERNELS)
