"""The program's own spans and counters.

Spans name where the host is while it enqueues work: the train step's
phases, the optimizer chain's parts, the models' levels.

    from qpwcnet_torch.utils import tracing

    with tracing.span("step.backward"):
        loss.backward()

Tracing is off by default, and :func:`enable` switches it. Off, a span
costs one test of a module global and returns a shared no-op context:
no clock read, no allocation. On, each span appends one record to a
bounded in-memory list (:class:`Record`: name, the index of the span
that encloses it on the same thread, the thread, start and end on
``time.perf_counter_ns``); :func:`spans` reads the list and
:func:`clear` empties it.

While a ``torch.profiler`` session is active, a span is also a
``record_function`` range named ``qpwcnet.<name>``, in the same trace as
the card's kernels and on that trace's clock. The trace's clock is the
Unix time in ns; :func:`offset_ns`, taken when a span is recorded under
the profiler, is what to add to a record's times to put them on it.

Counters (:func:`count`, :func:`counts`) are always on: plain integers
by name. The CUDA kernels' wrappers count their launches here
(``ops/cuda/__init__.py:launch_counts``). The flow net counts how each
of its eligible eval forwards on the card ran
(``models/pwcnet.py:ForwardGraphs``): ``flow_net.graph_eager`` (the
first call of an input signature), ``flow_net.graph_captures`` and
``flow_net.graph_replays``.

Spans are Python: a forward that replays a CUDA graph runs none of the
code inside it. So the spans inside ``flow_net.forward`` (``encoder``,
``flower.l0`` ...) are recorded when the graph is captured and not when
it replays. The ``launches.*`` counters count every replay: it adds the
counts its capture made.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple, Optional

import torch

PREFIX = "qpwcnet."
# a bound on the records kept: about 50,000 train steps of ~20 spans
MAX_RECORDS = 1 << 20


class Record(NamedTuple):
    """One span: ``parent`` is the index in :func:`spans` of the span
    that enclosed it on its thread (None for a root); ``end_ns`` is None
    while it is open."""
    name: str
    parent: Optional[int]
    thread: int
    start_ns: int
    end_ns: Optional[int]


_on = False
_NOOP = contextlib.nullcontext()
_lock = threading.Lock()
_records: list = []          # [name, parent, thread, start_ns, end_ns]
_local = threading.local()   # .stack: the open spans' indices
_offset: Optional[int] = None
_counts: dict = {}


def enable(on: bool = True) -> bool:
    """Switch tracing on or off; returns the previous setting."""
    global _on
    was, _on = _on, bool(on)
    return was


def enabled() -> bool:
    return _on


def span(name: str):
    """A context manager recording the block as the span ``name`` (no-op
    while tracing is off)."""
    if not _on:
        return _NOOP
    return _Span(name)


class _Span:
    __slots__ = ("name", "index", "range")

    def __init__(self, name: str):
        self.name = name
        self.index = None
        self.range = None

    def __enter__(self):
        global _offset
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if torch.autograd._profiler_enabled():
            _offset = time.time_ns() - time.perf_counter_ns()
            self.range = torch.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        parent = stack[-1] if stack else None
        with _lock:
            if len(_records) < MAX_RECORDS:
                self.index = len(_records)
                _records.append([self.name, parent, threading.get_ident(),
                                 time.perf_counter_ns(), None])
        if self.index is None:
            count("tracing.dropped")
        else:
            stack.append(self.index)
        return self

    def __exit__(self, *exc):
        if self.index is not None:
            _records[self.index][4] = time.perf_counter_ns()
            _local.stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def spans() -> list[Record]:
    """The recorded spans, in the order they started."""
    with _lock:
        return [Record(*r) for r in _records]


def clear() -> None:
    """Empty the store (call it with no span open)."""
    with _lock:
        _records.clear()


def offset_ns() -> Optional[int]:
    """ns to add to a record's times to put them on the clock of the
    ``torch.profiler`` trace; None until a span was recorded under a
    profiler."""
    return _offset


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counts() -> dict[str, int]:
    with _lock:
        return dict(_counts)


def reset_counts(names) -> None:
    """Zero the counters ``names``."""
    with _lock:
        for k in names:
            _counts[k] = 0
