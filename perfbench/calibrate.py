"""The readings that the limits of ``correct`` are set from, kept apart
from the benchmark's runs (which never call this):

    python3 -m perfbench.calibrate --workload <cell> --seeds 1,2,3 \
        [--system program|control] [--fault none|<fault>] [--seconds 2]

runs the cell's set-up, a short window and its check once a seed, in one
process, and prints one JSON line a seed with the numbers compared.

  * ``--system program``: the sound program, whose readings over a dozen
    seeds or more give each number's lower reading;
  * ``--system control``: the plain reference computed in the
    configuration's control precision (fp8 for its bf16), put in the
    program's place: its readings give the upper one;
  * ``--fault``: the program with one fault planted in the timed path
    (:data:`FAULTS`), to show that ``correct`` catches it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from perfbench import cells, system as systems


class _AlteredAnswer:
    """Inference: the first sample's answer altered where it is produced,
    its first two channels swapped (a flow's x and y)."""

    def __init__(self, inner):
        self.inner = inner

    def __call__(self, ims):
        out = self.inner(ims).clone()
        out[0, ..., :2] = out[0, ..., :2].flip(-1)
        return out


class _HalfBatch:
    """Half of the batch left out: inference answers the first half and
    repeats it; a train step takes the mean over the first half alone."""

    def __init__(self, inner):
        self.inner = inner

    def __call__(self, ims):
        half = self.inner(ims[: ims.shape[0] // 2])
        return torch.cat([half, half], dim=0)

    def step(self, batch):
        return self.inner.step({k: v[: v.shape[0] // 2]
                                for k, v in batch.items()})

    def __getattr__(self, name):
        return getattr(self.inner, name)


class _Unchanged:
    """A train step that returns its loss and leaves the parameters and
    statistics as they were."""

    def __init__(self, inner):
        self.inner = inner

    def step(self, batch):
        saved = {k: v.clone() for k, v in self.inner.state().items()}
        loss = self.inner.step(batch)
        with torch.no_grad():
            for k, v in self.inner.state().items():
                v.copy_(saved[k])
        return loss

    def __getattr__(self, name):
        return getattr(self.inner, name)


FAULTS = {"altered": _AlteredAnswer, "half_batch": _HalfBatch,
          "unchanged": _Unchanged}


@contextlib.contextmanager
def planted(fault: str):
    """Every program system built inside the block has ``fault``."""
    if fault == "none":
        yield
        return
    build = systems.build

    def faulty(kind, cfg, sd, device, system):
        s = build(kind, cfg, sd, device, system)
        return FAULTS[fault](s) if system == "program" else s

    systems.build = faulty
    try:
        yield
    finally:
        systems.build = build


def readings(cell, seeds, device, system="program", fault="none",
             seconds=2.0):
    """One dict of compared numbers a seed."""
    from perfbench import run

    out = []
    with planted(fault):
        for seed in seeds:
            r = run.execute(cell, seed, seconds, False, device, system,
                            t_start=time.perf_counter())
            out.append({"seed": seed, "correct": r["correct"],
                        **{k: c["value"] for k, c in r["checks"].items()},
                        "raw": r["raw"]})
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--system", default="program",
                    choices=("program", "control"))
    ap.add_argument("--fault", default="none",
                    choices=("none", *FAULTS))
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--dump", help="a file for every reading's raw norms")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = readings(cell, seeds, torch.device("cuda", 0), args.system,
                   args.fault, args.seconds)
    for r in out:
        raw = r.pop("raw")
        print(json.dumps({"workload": args.workload, "system": args.system,
                          "fault": args.fault, **r}), flush=True)
        r["raw"] = raw
    if args.dump:
        with open(args.dump, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
