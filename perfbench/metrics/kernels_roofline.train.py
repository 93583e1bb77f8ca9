"""kernels_roofline.train: The hand-written kernels' (K1-K5) bounds over
their device time, in %."""

from perfbench import readers


def read(ctx):
    return readers.kernels_roofline_pct(ctx)
