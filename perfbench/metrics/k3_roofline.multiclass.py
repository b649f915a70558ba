"""K3, the BlockCOO tail's forward sum (csrc/coo_tail.cu), at k 53 in the
rcv1-multiclass epoch cell: its share of its roofline over the traced
epochs, %."""

from perfbench import readers

#: K3's kernel, by its name in the trace
KERNELS = ("coo_forward",)


def read(ctx):
    return readers.tail_forward_share(ctx, KERNELS)
