"""What the per-layer metrics read, and the reductions they share.

A traced run hands each reader (perfbench/metrics/<metric>.py) one
:class:`Context`: the timed window (its host spans, its count and
length), the profiled sub-window (None where there was none), and the
work of one batch or step counted by perfbench/work.py. A reader returns
a number, or None where it finds nothing to read; it never reads 0 for a
share of a roofline or a peak that it could not measure.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass

from perfbench import trace, work
from perfbench.loop import Window


@dataclass
class Context:
    window: Window
    sub: trace.SubWindow | None
    enqueue_span: str          # the span around the call into the program
    flops_per_unit: float      # a forward's, or 3 forwards' for a step
    bounds: dict               # seconds of bound a unit, by kernel category


def enqueue_ms(ctx: Context):
    """Median host ms of the call into the program over the window's
    batches or steps (it returns before the card finishes)."""
    times = ctx.window.spans.by_name.get(ctx.enqueue_span)
    return statistics.median(times) * 1e3 if times else None


def launches_per_unit(ctx: Context):
    if ctx.sub is None:
        return None
    return ctx.sub.n_kernels / ctx.sub.units


def elementwise_ms(ctx: Context):
    """Device ms a unit of the elementwise and reduce categories."""
    if ctx.sub is None:
        return None
    cats = ctx.sub.by_category()
    return (cats.get("elementwise", 0.0) + cats.get("reduce", 0.0)) \
        * 1e3 / ctx.sub.units


def kernels_roofline_pct(ctx: Context):
    """For the hand-written kernels that ran: the sum of their bounds over
    the sum of their device times, in %."""
    if ctx.sub is None:
        return None
    cats = ctx.sub.by_category()
    ran = [c for c in trace.KERNEL_CATEGORIES if cats.get(c, 0.0) > 0
           and ctx.bounds.get(c, 0.0) > 0]
    if not ran:
        return None
    spent = sum(cats[c] for c in ran)
    need = sum(ctx.bounds[c] for c in ran) * ctx.sub.units
    return 100.0 * need / spent


def kernel_roofline_pct(ctx: Context, cat: str):
    """One kernel's share of its roofline, in %."""
    if ctx.sub is None:
        return None
    spent = ctx.sub.by_category().get(cat, 0.0)
    if spent <= 0 or ctx.bounds.get(cat, 0.0) <= 0:
        return None
    return 100.0 * ctx.bounds[cat] * ctx.sub.units / spent


def mfu_pct(ctx: Context):
    """The work of the window's batches or steps over its host time and
    the bf16 peak, in %."""
    w = ctx.window
    if not w.units or w.seconds <= 0:
        return None
    return 100.0 * ctx.flops_per_unit * w.units / w.seconds \
        / work.PEAK_OPS_BF16


def idle_pct(ctx: Context):
    """100 less the card's busy share of the profiled sub-window."""
    if ctx.sub is None:
        return None
    return 100.0 * (1.0 - ctx.sub.busy_s / ctx.sub.window_s)
