"""Int8 fake quantization with a straight-through gradient (port of
qpwcnet_tpu/quantize/fake_quant.py).

The scheme is tfmot's Default8Bit: symmetric int8 weights with one scale
per output channel, and symmetric int8 activations with one scale per
tensor, tracked during training by an EMA of the batch absmax
(quantize/qlayers.py).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Quantization configuration.

    mode:
      'qat'  — fake-quantized arithmetic with straight-through gradients
               and activation-range EMAs (training, simulation);
      'int8' — int8 x int8 -> int32 conv arithmetic with the ranges
               learned during QAT (inference, quantize/int8.py).
    """

    bits: int = 8
    act_ema: float = 0.999          # EMA decay of the activation ranges
    quantize_weights: bool = True
    quantize_activations: bool = True
    mode: str = "qat"

    def __post_init__(self):
        if self.mode not in ("qat", "int8"):
            raise ValueError(f"unknown quantization mode {self.mode!r}")

    @property
    def qmax(self) -> float:
        return float(2 ** (self.bits - 1) - 1)  # 127 for int8


def fake_quant(x: torch.Tensor, scale: torch.Tensor,
               qmax: float = 127.0) -> torch.Tensor:
    """Symmetric fake quantization with a straight-through gradient.

    ``scale`` broadcasts against x; a zero (or negative) scale passes x
    through (an uncalibrated range at the first step). The value is
    spelled ``x + (q - x).detach()``, as JAX's ``x + stop_gradient(q -
    x)``, so that it rounds where JAX's does."""
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe), -qmax - 1, qmax) * safe
    q = torch.where(scale > 0, q, x)
    return x + (q - x).detach()


def weight_scale(weight: torch.Tensor, out_dim: int = 0,
                 qmax: float = 127.0) -> torch.Tensor:
    """Per-output-channel symmetric scale of a kernel: the absmax over
    every dim but ``out_dim``, over qmax, keeping the dims. ``out_dim``
    is 0 for the OIHW conv and (C, 1, kh, kw) depthwise kernels and 1 for
    the (I, O, kh, kw) transpose-conv kernel (JAX's HWIO last axis in
    each case)."""
    red = tuple(d for d in range(weight.ndim) if d != out_dim)
    return torch.amax(weight.abs(), dim=red, keepdim=True) / qmax


def quantize_weight_scales(model: torch.nn.Module,
                           qmax: float = 127.0) -> dict:
    """The per-channel scale of every conv kernel of ``model``, by the
    kernel's state_dict key (JAX maps every 'kernel' leaf)."""
    from qpwcnet_torch.quantize.qlayers import QuantConv

    out = {}
    for name, m in model.named_modules():
        if isinstance(m, QuantConv):
            key = f"{name}.weight" if name else "weight"
            out[key] = weight_scale(m.weight.detach(), m.OUT_DIM, qmax)
    return out
