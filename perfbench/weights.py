"""The seeded weights of a configuration, made on the card in three
draws (one normal, one uniform and the flow heads' normal), keyed by the
measured models' state_dict names and loaded into both the program and
the reference.

  * conv and transpose-conv kernels: N(0, GAIN^2 / fan_in), fan_in = the
    kernel's input channels (per group) x the taps an output takes;
  * biases: N(0, 0.01^2), so that the bias path is not vacuous;
  * BatchNorm: scale and running variance U(0.5, 1.5), bias and running
    mean N(0, 0.1^2);
  * the flow heads' 'of_flow' kernels: N(0, (k / s)^2) with s the
    diagonal of the level's map and k = ``head_k``, so that every level
    predicts flows of a few pixels (a zero head, the measured build functions'
    'diag' initialisation, would make every flow exactly 0 and the
    comparison vacuous).
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import models

HEAD_K = 0.3     # the workload files set it per cell
BIAS = 0.01
# 1 / sqrt(E[mish(x)^2]) for x ~ N(0, 1): keeps the activations' scale
# through the Mish layers, so that deep features still depend on the input
GAIN = 1.487


def _head_level(name: str, n_levels: int) -> int:
    """The Flower level of a flow head's parameter: 0 (flow_0, 1/32) to
    n_levels (the last upflow, 1/2)."""
    if ".flow_0." in name:
        return 0
    return int(name.split(".upflows.")[1].split(".")[0]) + 1


def make_state_dict(cfg: dict, gen: torch.Generator, hw: tuple[int, int],
                    head_k: float = HEAD_K) -> dict[str, torch.Tensor]:
    """The float32 state_dict of ``cfg``'s model for inputs of size hw,
    on ``gen``'s device."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape)
                  for k, v in models.build(cfg).state_dict().items()}
    names = sorted(shapes)
    n_levels = len(cfg["decoder_filters"])

    def role(k):
        leaf = k.rsplit(".", 1)[-1]
        if ".norm." in k:
            return "uniform" if leaf in ("weight", "running_var") else "normal"
        return "head" if "of_flow" in k else "normal"

    sizes = {r: sum(math.prod(shapes[k]) for k in names if role(k) == r)
             for r in ("normal", "uniform", "head")}
    dev = gen.device
    pools = {"normal": torch.randn(sizes["normal"], generator=gen,
                                   device=dev),
             "uniform": torch.rand(sizes["uniform"], generator=gen,
                                   device=dev),
             "head": torch.randn(sizes["head"], generator=gen, device=dev)}
    at = dict.fromkeys(pools, 0)
    out = {}
    for k in names:
        r, shape = role(k), shapes[k]
        n = math.prod(shape)
        t = pools[r][at[r]:at[r] + n].view(shape)
        at[r] += n
        leaf = k.rsplit(".", 1)[-1]
        if r == "uniform":
            t = 0.5 + t
        elif r == "head":
            lv = _head_level(k, n_levels)
            h, w = hw[0] >> (5 - lv), hw[1] >> (5 - lv)
            t = t * (head_k / math.sqrt(h * h + w * w))
        elif ".norm." in k:
            t = 0.1 * t
        elif leaf == "bias":
            t = BIAS * t
        else:
            # OIHW, or (I, O, 4, 4) for the transpose convs, whose output
            # pixel takes 2x2 of the 4x4 taps
            d0, d1, kh, kw = shape
            fan_in = d0 * 4 if k.endswith("conv_up.weight") else d1 * kh * kw
            t = t * (GAIN / math.sqrt(fan_in))
        out[k] = t.contiguous()
    return out
