"""launches_per_batch.infer: Device kernel records a batch in the profiled
sub-window."""

from perfbench import readers


def read(ctx):
    return readers.launches_per_unit(ctx)
