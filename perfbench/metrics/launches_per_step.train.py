"""launches_per_step.train: Device kernel records a step in the profiled
sub-window."""

from perfbench import readers


def read(ctx):
    return readers.launches_per_unit(ctx)
