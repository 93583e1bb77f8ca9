"""elementwise_ms.infer: Device ms a batch of the elementwise and reduce
kernels."""

from perfbench import readers


def read(ctx):
    return readers.elementwise_ms(ctx)
