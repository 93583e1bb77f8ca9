"""Quantized activations that flow between chained convs (port of
qpwcnet_tpu/quantize/qtensor.py:54-81).

A :class:`QTensor` carries int8 values and one float32 scale across a
layer boundary: where two convs are chained (the DownConv stages, the
OptFlow SepConvs), the producer quantizes its output once with its own
calibrated range and the consumer feeds the int8 values to its int8
product, folding the producer's scale into its dequantization. Consumers
that are not convs (cost volume, warp, BatchNorm, concat, resize) take
floats: the blocks call :func:`dequantize` at those boundaries.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch


class QTensor(NamedTuple):
    """int8 values and a float32 0-d scale: x ≈ q.float() * scale."""

    q: torch.Tensor      # int8, the layout of the float tensor it stands for
    scale: torch.Tensor  # float32, 0-d


def dequantize(x: Union[QTensor, torch.Tensor],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """QTensor -> float tensor in ``dtype`` (the int8 values and the
    scale each cast to it, then multiplied, as JAX does); a float tensor
    is cast."""
    if isinstance(x, QTensor):
        return x.q.to(dtype) * x.scale.to(dtype)
    return x.to(dtype)


def quantize_to(x: torch.Tensor, amax: torch.Tensor,
                qmax: float = 127.0) -> QTensor:
    """Symmetric per-tensor int8 quantization of x with the absmax
    ``amax`` (scale amax / qmax; a zero range quantizes with scale 1)."""
    scale = (amax / qmax).float()
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x.float() / safe), -qmax - 1, qmax)
    return QTensor(q=q.to(torch.int8), scale=safe)
