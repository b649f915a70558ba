"""K3, the BlockCOO tail's forward sum (csrc/coo_tail.cu): its share of
its roofline over the traced epochs, %."""

from perfbench import readers

#: K3's kernel, by its name in the trace
KERNELS = ("coo_forward",)


def read(ctx):
    return readers.tail_forward_share(ctx, KERNELS)
