"""step_mfu_pct.train: The steps' operations (3 forwards each) over the
window's time and the bf16 peak, in %."""

from perfbench import readers


def read(ctx):
    return readers.mfu_pct(ctx)
