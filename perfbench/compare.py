"""The numbers that decide ``correct``: what the timed path produced
against the plain reference, each beside its limit.

Inference: ``flow_rel_l2`` (or ``img_rel_l2``), the worst over the
compared answers (each sample of each kept batch) of
||out - ref|| / ||ref||, and ``flow_err_vs_bf16``, that distance over
the reference's own distance when rounded at the configuration's
precision (perfbench/traffic/infer_closed_loop.py).

Training, over the first three steps that the timed step object took
(perfbench/traffic/train_steps.py):

  * ``loss_gap``: the worst of the three steps' |loss - ref| / |ref|,
    and ``loss_gap_step1``, the first step's alone; ``data_loss_gap``,
    the worst step's |loss - ref| over the reference's loss less its l2
    term, which is the same on both sides to float32 rounding and makes
    up two thirds of the loss at initialisation (it reads how far the
    part of the loss that the batch sets has moved);
  * ``grad_gap``: the worst leaf's gap between the norms of the first
    gradient the optimizer took, | ||g|| - ||g_ref|| |, over the larger
    of ||g_ref|| and the median leaf's ||g_ref||;
  * ``change_gap``: the same for the change of each parameter and
    BatchNorm statistic after the three steps, leaving out parameters
    whose reference gradient is under a thousandth of the median leaf's
    (nought to rounding: they move under Adam by round-off alone), and
    ``change_gap_median``, the median leaf's gap.

A number is within its limit when it is finite and not above it.
"""

from __future__ import annotations

import math
import statistics

import torch


def rel_l2(out: torch.Tensor, ref: torch.Tensor) -> float:
    d = torch.linalg.vector_norm((out.float() - ref.float()).flatten())
    return float(d / torch.linalg.vector_norm(ref.float().flatten()))


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float().flatten()))
            for k, v in tensors.items()}


def norm_gaps(got: dict, want: dict, skip=()) -> dict:
    """Each leaf's |got - want| / max(want, median want)."""
    floor = statistics.median(want.values())
    return {k: abs(got[k] - w) / max(w, floor, 1e-30)
            for k, w in want.items() if k not in skip}


def train_readings(losses: list, grads: dict, change: dict) -> dict:
    """What one side of a training comparison read: the first three
    losses, each parameter's first-gradient norm, and each leaf's change
    norm after three steps."""
    return {"losses": [float(x) for x in losses], "grads": norms(grads),
            "change": norms(change)}


def train_numbers(prog: dict, ref: dict) -> tuple[dict, dict]:
    """The numbers, and the leaf that set each of the two worst-leaf
    ones; ``data_loss_gap`` where ``ref`` holds its steps' l2 terms."""
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog["losses"], ref["losses"]))
    g_floor = statistics.median(ref["grads"].values())
    nought = {k for k, g in ref["grads"].items() if g < 1e-3 * g_floor}
    grad = norm_gaps(prog["grads"], ref["grads"])
    change = norm_gaps(prog["change"], ref["change"], skip=nought)
    worst = {"grad_gap": max(grad, key=grad.get),
             "change_gap": max(change, key=change.get)}
    first = abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    data = {"data_loss_gap": max(
        abs(p - r) / abs(r - l2)
        for p, r, l2 in zip(prog["losses"], ref["losses"], ref["l2"]))
        } if ref.get("l2") else {}
    return ({"loss_gap": loss_gap, "loss_gap_step1": first, **data,
             "grad_gap": max(grad.values()),
             "change_gap": max(change.values()),
             "change_gap_median": statistics.median(change.values())}, worst)


def verdict(numbers: dict, limits: dict) -> bool:
    """True when every number that has a limit is finite and within it;
    a limit of None means the number is reported and not compared."""
    if not any(lim is not None for lim in limits.values()):
        return False
    ok = True
    for name, value in numbers.items():
        lim = limits.get(name)
        if lim is None:
            continue
        ok = ok and math.isfinite(value) and value <= lim
    return ok and all(name in numbers for name, lim in limits.items()
                      if lim is not None)
