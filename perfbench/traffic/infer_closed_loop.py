"""Closed-loop batch inference: one caller runs the model's eval forward
on batches cycled from a pool of distinct seeded inputs, with
``in_flight`` batches enqueued (perfbench/loop.py).

Parameters (the workload file's ``params``): ``batch``, ``height``,
``width``, ``head_k`` (the flow heads' scale, perfbench/weights.py),
``inputs`` (a maker of perfbench/data.py), ``pool`` (distinct
batches made on the card at set-up), ``in_flight``, ``warmup`` (batches
run before the window), ``sample_every`` (one batch in so many of the
window, at a phase drawn from the seed, is kept and judged against the
reference after the window), ``profile_units`` (batches in a traced
run's profiled sub-window).

Each sample's output is an answer. The check reads, for the worst answer
of the kept batches, ``flow_rel_l2`` = ||out - ref|| / ||ref|| against
the float32 reference, and ``flow_err_vs_bf16``: that distance over the
distance of the reference itself, rounded at the configuration's
precision (``dtype_rounding``), from its float32 self. A random network's
sensitivity to rounding varies from seed to seed several times over; the
ratio takes it out, and reads about 1 for a sound bf16 program and about
10 or more for one computing in fp8 (PERF.md).

End to end: ``pairs_per_s``, every pair completed in the window over the
window's time, and ``infer_p95_ms``, the 95th percentile of the window's
batch latencies.
"""

from __future__ import annotations

import math
import time

import torch

from perfbench import compare, data, system as systems, weights, work
from perfbench.loop import closed_loop, log_setup
from perfbench.readers import Context
from perfbench.trace import Spans

MAX_KEPT = 32


def p95(values) -> float:
    """The nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


class Runner:
    enqueue_span, wait_span = "forward_enqueue", "wait_batch"

    def __init__(self, cell, seed: int, device, system: str = "program"):
        p, cfg = cell.params, cell.config
        self.cfg, self.p, self.device = cfg, p, device
        b, h, w = p["batch"], p["height"], p["width"]
        gen = torch.Generator(device).manual_seed(seed)
        t0 = time.perf_counter()
        self.sd = weights.make_state_dict(cfg, gen, (h, w), p["head_k"])
        make = data.MAKERS[p["inputs"]]
        self.pool = [make(gen, b, h, w)["ims"] for _ in range(p["pool"])]
        t1 = time.perf_counter()
        self.system = systems.build("infer", cfg, self.sd, device, system)
        t2 = time.perf_counter()
        self.phase = seed % p["sample_every"]
        self.kept, self.last = [], None
        self._run(units=p["warmup"], start=0, keep=False)
        self.next = p["warmup"]
        log_setup(t0, t1, t2, time.perf_counter())

    def _select(self, i):
        return self.pool[i % len(self.pool)]

    def _run(self, spans=None, keep=True, **kw):
        def done(i, out):
            if not keep:
                return
            self.last = (i % len(self.pool), out)
            if (i + self.phase) % self.p["sample_every"] == 0 \
                    and len(self.kept) < MAX_KEPT:
                self.kept.append(self.last)

        return closed_loop(self._select, self.system, done, self.device,
                           self.p["in_flight"], spans or Spans(),
                           self.enqueue_span, self.wait_span, **kw)

    def window(self, seconds: float):
        win = self._run(seconds=seconds, start=self.next)
        self.next += win.units
        return win

    def run_units(self, units: int, spans: Spans) -> None:
        self._run(spans, keep=False, units=units, start=self.next)
        self.next += units

    def end_to_end(self, win) -> dict:
        return {"pairs_per_s": win.units * self.p["batch"] / win.seconds,
                "infer_p95_ms": p95(win.latencies) * 1e3}

    def context(self, win, sub) -> Context:
        p = self.p
        args = (self.cfg, p["batch"], p["height"], p["width"])
        return Context(window=win, sub=sub, enqueue_span=self.enqueue_span,
                       flops_per_unit=work.forward_flops(*args),
                       bounds=work.kernel_bounds(*args, train=False))

    def check(self) -> dict:
        """Frees the system, then judges the kept outputs against the
        reference, one reference forward a pool slot."""
        kept = self.kept or [self.last]
        self.system = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        slots = sorted({s for s, _ in kept})
        ref = systems.build("infer", self.cfg, self.sd, self.device,
                            "reference")
        want = {s: ref(self.pool[s]) for s in slots}
        ref = systems.RefInfer(self.cfg, self.sd, self.device,
                               self.cfg["dtype_rounding"])
        unit = {s: [compare.rel_l2(u, r) for u, r in
                    zip(ref(self.pool[s]), want[s])] for s in slots}
        bad = sum(int(not torch.isfinite(out).all()) for _, out in kept)
        gaps = [[compare.rel_l2(o, r) for o, r in zip(out, want[s])]
                for s, out in kept]
        ratios = [[g / max(u, 1e-12) for g, u in zip(gs, unit[s])]
                  for gs, (s, _) in zip(gaps, kept)]
        self.raw = {"per_sample": gaps, "per_sample_vs_rounded": ratios}
        name = "flow" if self.cfg["model"] == "flow" else "img"
        return {f"{name}_rel_l2": max(max(g) for g in gaps),
                f"{name}_err_vs_bf16": max(max(r) for r in ratios),
                "nonfinite_outputs": bad}
