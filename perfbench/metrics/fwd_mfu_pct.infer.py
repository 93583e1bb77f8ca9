"""fwd_mfu_pct.infer: The forwards' operations over the window's time and
the bf16 peak, in %."""

from perfbench import readers


def read(ctx):
    return readers.mfu_pct(ctx)
