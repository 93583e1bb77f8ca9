"""host_enqueue_ms.infer: Median host ms of the forward call (returns
before the card finishes) over the window's batches."""

from perfbench import readers


def read(ctx):
    return readers.enqueue_ms(ctx)
