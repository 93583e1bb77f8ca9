"""device_idle_pct.infer: The card's idle share of the profiled sub-window,
in %."""

from perfbench import readers


def read(ctx):
    return readers.idle_pct(ctx)
