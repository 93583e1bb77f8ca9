"""The closed loop that every traffic kind drives: one caller keeps
``in_flight`` batches or steps enqueued on the card, enqueueing the next
before it waits for the oldest, so that the card and not the host sets
the pace as long as the host enqueues faster than the card works.

Each unit's latency runs from the start of its call to the moment the
caller sees it complete (a CUDA event after the call, synchronized).
"""

from __future__ import annotations

import collections
import sys
import time
from dataclasses import dataclass, field

import torch

from perfbench.trace import Spans


class _HostEvent:
    """A stand-in for a CUDA event on the CPU, where every call has
    finished when it returns."""

    def record(self):
        pass

    def synchronize(self):
        pass


def event(device):
    return torch.cuda.Event() if device.type == "cuda" else _HostEvent()


@dataclass
class Window:
    """What a timed window saw: ``units`` batches or steps completed in
    ``seconds`` of host clock (first enqueue to last completion), each
    unit's latency, and the host spans."""
    units: int
    seconds: float
    latencies: list = field(default_factory=list)
    spans: Spans = None


def closed_loop(select, call, on_done, device, in_flight: int, spans: Spans,
                enqueue_span: str, wait_span: str, seconds: float = None,
                units: int = None, start: int = 0) -> Window:
    """Run units ``start, start + 1, ...`` until ``seconds`` have passed
    since the first enqueue (then drain what is in flight) or ``units``
    have been enqueued. select(i) -> input; call(input) -> output, which
    returns before the card finishes; on_done(i, output) once it has."""
    pending = collections.deque()
    lat = []
    i = start
    t0 = time.perf_counter()
    t_end = t0
    while True:
        more = (units is None and time.perf_counter() - t0 < seconds) or (
            units is not None and i - start < units)
        if more:
            with spans.span("select_batch"):
                x = select(i)
            s = time.perf_counter()
            with spans.span(enqueue_span):
                out = call(x)
            ev = event(device)
            ev.record()
            pending.append((i, s, ev, out))
            i += 1
            if len(pending) < in_flight:
                continue
        if not pending:
            break
        j, s, ev, out = pending.popleft()
        with spans.span(wait_span):
            ev.synchronize()
        t_end = time.perf_counter()
        lat.append(t_end - s)
        on_done(j, out)
    return Window(units=i - start, seconds=t_end - t0, latencies=lat,
                  spans=spans)


def log_setup(t0, t1, t2, t3) -> None:
    """Where a runner's set-up went, on standard error."""
    print(f"perfbench: weights and inputs {t1 - t0:.3f} s, system "
          f"{t2 - t1:.3f} s, first calls and warm-up {t3 - t2:.3f} s",
          file=sys.stderr, flush=True)
