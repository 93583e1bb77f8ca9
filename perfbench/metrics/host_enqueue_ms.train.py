"""host_enqueue_ms.train: Median host ms of the train-step call (returns
before the card finishes) over the window's steps."""

from perfbench import readers


def read(ctx):
    return readers.enqueue_ms(ctx)
