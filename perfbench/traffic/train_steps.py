"""Training steps in a closed loop: one train-step object (the model, its
optimizer state and the step function) stepped on batches cycled from a
pool of distinct seeded batches made on the card, with ``in_flight``
steps enqueued (perfbench/loop.py).

Set-up builds the one step object, then drives it from the seed through
its first three steps with the window's own call and feed (pool batches
0, 1, 2) and records what the reference will follow: each step's loss,
the gradient the optimizer took in the first step and each leaf's change
after the third (and, on the reference's side, each step's l2 term).
The same object then runs the window.

Parameters: ``batch``, ``height``, ``width``, ``head_k`` (the flow
heads' scale, perfbench/weights.py), ``inputs`` (a maker of
perfbench/data.py: 'pairs' for the flow step, 'triplets' for the
pretraining step), ``pool``, ``in_flight``, ``warmup`` (steps after the
three, before the window), ``profile_units``.

End to end: ``train_samples_per_s``, every sample of the steps completed
in the window over the window's time.
"""

from __future__ import annotations

import sys
import time

import torch

from perfbench import compare, data, system as systems, weights, work
from perfbench.loop import closed_loop, log_setup
from perfbench.readers import Context
from perfbench.trace import Spans

FOLLOWED = 3    # the steps the reference follows


class Runner:
    enqueue_span, wait_span = "step_enqueue", "wait_step"

    def __init__(self, cell, seed: int, device, system: str = "program"):
        p, cfg = cell.params, cell.config
        self.cfg, self.p, self.device = cfg, p, device
        b, h, w = p["batch"], p["height"], p["width"]
        gen = torch.Generator(device).manual_seed(seed)
        t0 = time.perf_counter()
        self.sd = weights.make_state_dict(cfg, gen, (h, w), p["head_k"])
        make = data.MAKERS[p["inputs"]]
        self.pool = [make(gen, b, h, w) for _ in range(p["pool"])]
        t1 = time.perf_counter()
        self.system = systems.build("train", cfg, self.sd, device, system)
        t2 = time.perf_counter()
        self.readings = self.first_steps(self.system)
        self.losses = []
        self._run(units=p["warmup"], start=FOLLOWED)
        self.losses = []
        self.next = FOLLOWED + p["warmup"]
        log_setup(t0, t1, t2, time.perf_counter())

    def first_steps(self, system) -> dict:
        """Steps 1-3 of ``system`` through the window's loop: the losses,
        the first gradient's norms and the norms of the change."""
        self.losses = []
        self._run(units=1, start=0, system=system)
        grads = compare.norms(system.first_grads())
        self._run(units=FOLLOWED - 1, start=1, system=system)
        state = system.state()
        change = {k: state[k].float() - v for k, v in self.sd.items()}
        return {"losses": [float(x) for x in self.losses], "grads": grads,
                "change": compare.norms(change),
                "l2": list(getattr(system, "l2_terms", []))}

    def _select(self, i):
        return self.pool[i % len(self.pool)]

    def _run(self, spans=None, system=None, **kw):
        step = (system or self.system).step
        return closed_loop(self._select, step,
                           lambda i, loss: self.losses.append(loss),
                           self.device, self.p["in_flight"],
                           spans or Spans(), self.enqueue_span,
                           self.wait_span, **kw)

    def window(self, seconds: float):
        win = self._run(seconds=seconds, start=self.next)
        self.next += win.units
        return win

    def run_units(self, units: int, spans: Spans) -> None:
        self._run(spans, units=units, start=self.next)
        self.next += units

    def end_to_end(self, win) -> dict:
        return {"train_samples_per_s":
                win.units * self.p["batch"] / win.seconds}

    def context(self, win, sub) -> Context:
        p = self.p
        args = (self.cfg, p["batch"], p["height"], p["width"])
        return Context(window=win, sub=sub, enqueue_span=self.enqueue_span,
                       flops_per_unit=3 * work.forward_flops(*args),
                       bounds=work.kernel_bounds(*args, train=True))

    def check(self) -> dict:
        """Frees the step object, then runs the reference through the same
        three steps on the same batches and compares."""
        nonfinite = sum(int(not torch.isfinite(x).all()) for x in self.losses)
        self.system = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = systems.build("train", self.cfg, self.sd, self.device,
                            "reference")
        self.raw = {"program": self.readings,
                    "reference": self.first_steps(ref)}
        numbers, worst = compare.train_numbers(self.readings,
                                               self.raw["reference"])
        for k, leaf in worst.items():
            print(f"{k}: worst leaf {leaf}", file=sys.stderr)
        numbers["nonfinite_losses"] = nonfinite
        return numbers
