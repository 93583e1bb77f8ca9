"""elementwise_ms.train: Device ms a step of the elementwise and reduce
kernels."""

from perfbench import readers


def read(ctx):
    return readers.elementwise_ms(ctx)
