"""K4, the BlockCOO tail's outer sum (csrc/coo_tail.cu): its share of its
roofline over the traced epochs, %."""

from perfbench import readers

#: K4's kernel, by its name in the trace
KERNELS = ("coo_outer",)


def read(ctx):
    return readers.tail_outer_share(ctx, KERNELS)
