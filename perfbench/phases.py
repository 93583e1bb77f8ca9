"""Where a cell's host time, launches, device time and idle gaps go, by
the program's own spans (``qpwcnet_torch/utils/tracing.py``): a tool
beside the benchmark, whose runs never call it.

    python3 -m perfbench.phases --workload <cell> --seed <n> [--seconds 5] [--pairs 2]

from the root of a checkout, on a CUDA card. After the cell's set-up and
a window of ``--seconds`` that is not read, it

  * runs spans windows of 4 x ``profile_units`` batches or steps with the
    program's tracing off and on in turns (off, on, on, off a pair): the
    host ms a unit of the call into the program, and of the window, each
    way, which is what tracing costs; and from the windows with it on,
    each span's host ms a unit, whole and less its children's (self);
  * profiles ``profile_units`` units with tracing on, and attributes each
    kernel to the innermost program span whose interval holds the time of
    the launch record that launched it (the two joined by the profiler's
    correlation id), on any thread: autograd launches the backward from
    its own thread while the caller waits inside ``step.backward``. Each
    idle gap of the card is labelled ``<benchmark span>/<program span>``
    with the spans that overlapped it most (the innermost among equals).

It prints one JSON object. Launches and device ms are given by the
innermost span (``self``) and by every span that held the launch
(``total``), so a phase's total is its part of the unit's kernels.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

from perfbench import cells, trace

PROGRAM = "qpwcnet."
OUTSIDE = "outside"


def _innermost(spans, t0: float, t1: float):
    """The (name, start, end) of ``spans`` that overlaps [t0, t1] most
    (for t0 == t1: holds the point), the latest to start among equals;
    None where none does."""
    best, key = None, None
    for s in spans:
        ov = min(t1, s[2]) - max(t0, s[1])
        if ov < 0 or (ov == 0 and t1 > t0):
            continue
        if key is None or (ov, s[1]) > key:
            best, key = s, (ov, s[1])
    return best


def attribute(events, units: int) -> dict | None:
    """Launches, device ms and idle ms a unit by program span, from the
    raw events (``kineto_results.events()``) of a sub-window profiled with
    the program's tracing on; None where it holds no sub-window or no
    kernel. Times in the events are ns."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    host = {e.name() for e in events if e.device_type() != cuda}
    window, program, bench, launched, dev = None, [], [], {}, []
    for e in events:
        name, t0 = e.name(), e.start_ns()
        t1 = t0 + e.duration_ns()
        if e.device_type() == cuda:
            if name not in host:
                dev.append((name, t0, t1, e.correlation_id()))
        elif name == trace.SUBWINDOW:
            window = (t0, t1)
        elif name.startswith(PROGRAM):
            program.append((name[len(PROGRAM):], t0, t1))
        elif name.startswith(trace.SPAN_PREFIX):
            bench.append((name[len(trace.SPAN_PREFIX):], t0, t1))
        elif e.correlation_id():
            launched.setdefault(e.correlation_id(), t0)
    if window is None or not dev:
        return None
    lo, hi = window
    dev = [(n, max(a, lo), min(b, hi), c) for n, a, b, c in dev
           if b > lo and a < hi]
    by_span: dict = {}

    def add(name, part, ms):
        entry = by_span.setdefault(name, {"self": [0, 0.0],
                                          "total": [0, 0.0]})
        entry[part][0] += 1
        entry[part][1] += ms

    n_kernels = 0
    for name, a, b, corr in dev:
        if name.startswith(("Memcpy", "Memset")):
            continue
        n_kernels += 1
        ms = (b - a) / 1e6
        t = launched.get(corr)
        if t is None:
            add("unmatched", "self", ms)
            continue
        holding = [s for s in program if s[1] <= t <= s[2]]
        inner = _innermost(holding, t, t)
        add(inner[0] if inner else OUTSIDE, "self", ms)
        for s in {s[0] for s in holding}:
            add(s, "total", ms)
    idle: dict = {}
    longest = []
    for a, b in trace.gaps([(a, b) for _, a, b, _ in dev], lo, hi):
        label = "/".join(s[0] for s in (_innermost(bench, a, b),
                                        _innermost(program, a, b)) if s)
        label = label or "no span"
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
        longest.append((label, (b - a) / 1e6))
    longest.sort(key=lambda kv: -kv[1])
    busy = trace.union([(a, b) for _, a, b, _ in dev])
    return {
        "units": units, "kernels_per_unit": n_kernels / units,
        "idle_pct": 100.0 * (1.0 - busy / (hi - lo)),
        "launches": {k: {p: v[p][0] / units for p in v}
                     for k, v in sorted(by_span.items())},
        "device_ms": {k: {p: v[p][1] / units for p in v}
                      for k, v in sorted(by_span.items())},
        "idle_ms": {k: v / units for k, v in
                    sorted(idle.items(), key=lambda kv: -kv[1])},
        "idle_gaps_ms": [[k, v] for k, v in longest[:10]]}


def host_ms(records, units: int) -> dict:
    """From the program's span records (tracing.Record) of ``units``
    batches or steps: by span name, its host ms a unit, the same less
    the time its children cover (self), and the median of one span."""
    child: dict = {}
    for r in records:
        if r.parent is not None:
            child[r.parent] = child.get(r.parent, 0) + r.end_ns - r.start_ns
    out: dict = {}
    for i, r in enumerate(records):
        d = out.setdefault(r.name, {"total": 0.0, "self": 0.0, "each": []})
        dur = (r.end_ns - r.start_ns) / 1e6
        d["total"] += dur / units
        d["self"] += (dur - child.get(i, 0) / 1e6) / units
        d["each"].append(dur)
    return {k: {"ms_per_unit": v["total"], "self_ms_per_unit": v["self"],
                "median_ms": statistics.median(v["each"]),
                "per_unit": len(v["each"]) / units}
            for k, v in out.items()}


def _spans_window(runner, units: int, tracing, on: bool) -> dict:
    import torch

    was = tracing.enable(on)
    try:
        tracing.clear()
        spans = trace.Spans()
        torch.cuda.synchronize()
        runner.run_units(units, spans)
        torch.cuda.synchronize()
        records = tracing.spans()
    finally:
        tracing.enable(was)
        tracing.clear()
    enqueue = spans.by_name[runner.enqueue_span]
    wall = sum(sum(v) for v in spans.by_name.values())
    return {"enqueue_ms": statistics.median(enqueue) * 1e3,
            "wall_ms_per_unit": wall * 1e3 / units, "records": records}


def profile(runner, units: int, tracing, tries: int = 3):
    """The sub-window of :func:`trace.profile` with the program's tracing
    on: its reduction and its attribution to program spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(tries):
        torch.cuda.synchronize()
        was = tracing.enable()
        try:
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                with torch.profiler.record_function(trace.SUBWINDOW):
                    runner.run_units(units, trace.Spans(profiled=True))
                    torch.cuda.synchronize()
        finally:
            tracing.enable(was)
            tracing.clear()
        events = prof.profiler.kineto_results.events()
        sub = trace.reduce_events(events, units)
        if sub is not None:
            return sub, attribute(events, units)
    raise RuntimeError(f"the profiler dropped kernel records in {tries} "
                       f"sub-windows of {units} units")


def main(argv=None) -> int:
    from perfbench import run

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args(argv)

    run.cache_dirs(str(cells.ROOT))
    cell = cells.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("perfbench.phases: needs a CUDA card", file=sys.stderr)
        return 2
    from qpwcnet_torch.utils import tracing

    device = torch.device("cuda", 0)
    runner = cell.kind.Runner(cell, args.seed, device)
    runner.window(args.seconds)
    units = cell.params["profile_units"]
    n = 4 * units
    cost = {"off": [], "on": []}
    records = []
    for _ in range(args.pairs):
        for on in (False, True, True, False):
            w = _spans_window(runner, n, tracing, on)
            base = len(records)
            records += [r._replace(parent=None if r.parent is None
                                   else r.parent + base)
                        for r in w.pop("records")]
            cost["on" if on else "off"].append(w)
    sub, phases = profile(runner, units, tracing)
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(device),
           "tracing_cost": cost,
           "host_ms": host_ms(records, n * 2 * args.pairs),
           "launches_per_unit": sub.n_kernels / sub.units,
           "subwindow_idle_pct": 100.0 * (1.0 - sub.busy_s / sub.window_s),
           "phases": phases}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
