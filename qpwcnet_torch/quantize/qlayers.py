"""Quantization-capable conv modules (port of
qpwcnet_tpu/quantize/qlayers.py).

Tensors inside the model are logical NCHW; parameters are float32 and are
cast to the module's compute dtype per call, as the JAX modules do.
Weights are stored in PyTorch's layouts: OIHW for convs, (C, 1, kh, kw)
for depthwise convs and (I, O, kh, kw) for transpose convs
(models/from_flax.py maps the Flax HWIO kernels).

Under an H-sharded mesh (qpwcnet_torch.parallel) a conv's input is one
shard's rows: H is padded with the neighbouring shards' rows, and with
zeros only at the global ends, so each shard's output rows are the
unsharded conv's (XLA's partitioning of the JAX model's convs); in int8
mode the int8 convs do the same with the int8 codes (quantize/int8.py).

``quant`` (a :class:`~qpwcnet_torch.quantize.fake_quant.QuantConfig`)
makes a conv quantized, as JAX's constructor flag does:

  * buffers, registered only then (a float model's state_dict is
    unchanged): ``amax_in``, the input range (0-d, or per input channel
    with ``per_channel_in``), and ``act_quant.amax``, the output range
    (when ``quantize_activations``), JAX's 'quant_stats' collection;
  * 'qat': in train mode each forward first updates the ranges with the
    batch absmax (an EMA, the first update taking the absmax itself; over
    every process of the active mesh), then fake-quantizes the input,
    the weights (per output channel, in float32) and the output, with
    straight-through gradients;
  * 'int8': the conv runs int8 x int8 -> int32 (quantize/int8.py) on a
    float input or a :class:`~qpwcnet_torch.quantize.qtensor.QTensor`,
    and emits its output as a QTensor on request (``emit_qtensor``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from qpwcnet_torch.ops.activations import mish
from qpwcnet_torch.ops.conv import conv2d_same
from qpwcnet_torch.ops.cuda import mish_kernel
from qpwcnet_torch.parallel.transport import (
    active_mesh,
    active_shards,
    halo_rows,
)
from qpwcnet_torch.quantize.fake_quant import (
    QuantConfig,
    fake_quant,
    weight_scale,
)
from qpwcnet_torch.quantize.int8 import int8_conv_apply
from qpwcnet_torch.quantize.qtensor import QTensor, quantize_to


@torch.no_grad()
def update_range(amax: torch.Tensor, x: torch.Tensor, ema: float,
                 per_channel: bool = False) -> None:
    """amax <- ema * amax + (1 - ema) * batch absmax, or the batch absmax
    while amax is 0; per channel (dim 1 of NCHW) with ``per_channel``.
    Under a mesh of several processes the batch absmax is the maximum
    over all of them (JAX's jnp.max over a sharded batch is global)."""
    if per_channel:
        batch = torch.amax(x.abs(), dim=(0, 2, 3)).float()
    else:
        batch = torch.amax(x.abs()).float()
    mesh = active_mesh()
    if mesh is not None and mesh.procs > 1:
        batch = mesh.all_max(batch)
    amax.copy_(torch.where(amax > 0, ema * amax + (1.0 - ema) * batch,
                           batch))


def quant_ranges(model: nn.Module) -> dict[str, torch.Tensor]:
    """The QAT range buffers of ``model`` (JAX's 'quant_stats'), by
    state_dict key; empty for a float model."""
    return {k: b for k, b in model.named_buffers()
            if k.rsplit(".", 1)[-1] in ("amax_in", "amax")}


class ActQuant(nn.Module):
    """Per-tensor symmetric output quantization with an EMA absmax range,
    the ``amax`` buffer (updated in train mode under 'qat'): fake quant,
    or with ``emit_int8`` a QTensor quantized with the range."""

    def __init__(self, quant: QuantConfig):
        super().__init__()
        self.quant = quant
        self.register_buffer("amax", torch.zeros(()))

    def forward(self, x: torch.Tensor, emit_int8: bool = False):
        if self.training and self.quant.mode == "qat":
            update_range(self.amax, x, self.quant.act_ema)
        if emit_int8:
            return quantize_to(x, self.amax, self.quant.qmax)
        scale = self.amax / self.quant.qmax
        return fake_quant(x, scale.to(x.dtype), self.quant.qmax)


class QuantConv(nn.Module):
    """What QConv and QConvTranspose share: the weight, bias, activation,
    the quantization buffers and the forward around the conv itself."""

    # the weight's output-channel dim (the per-channel weight scales')
    OUT_DIM = 0
    TRANSPOSE = False

    def __init__(self, weight_shape: tuple, in_ch: int, features: int,
                 stride: int, groups: int, use_bias: bool,
                 dtype: torch.dtype, act: Optional[Callable],
                 quant: Optional[QuantConfig], per_channel_in: bool):
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.dtype = dtype
        self.act = act
        self.quant = quant
        self.per_channel_in = per_channel_in
        self.weight = nn.Parameter(torch.empty(weight_shape))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        if quant is not None:
            self.register_buffer(
                "amax_in", torch.zeros((in_ch,) if per_channel_in else ()))
            if quant.quantize_activations:
                self.act_quant = ActQuant(quant)
        elif per_channel_in:
            raise ValueError("per_channel_in needs quant")

    def conv(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x, emit_qtensor: bool = False):
        """x: a float NCHW tensor, or in int8 mode a QTensor from the
        producing conv. emit_qtensor: in int8 mode, return the output as
        a QTensor quantized with this conv's output range."""
        q = self.quant
        if q is not None and q.mode == "int8":
            y = int8_conv_apply(x, self.weight, self.amax_in,
                                stride=self.stride, groups=self.groups,
                                transpose=self.TRANSPOSE,
                                qmax=q.qmax).to(self.dtype)
        else:
            if isinstance(x, QTensor):
                raise TypeError("a QTensor input needs int8 mode")
            w = self.weight
            if q is not None:
                if self.training:
                    update_range(self.amax_in, x, q.act_ema,
                                 self.per_channel_in)
                scale = self.amax_in / q.qmax
                if self.per_channel_in:
                    scale = scale[:, None, None]
                x = fake_quant(x, scale.to(x.dtype), q.qmax)
                if q.quantize_weights:
                    w = fake_quant(w, weight_scale(w, self.OUT_DIM, q.qmax),
                                   q.qmax)
            y = self.conv(x.to(self.dtype), w.to(self.dtype))
        if self.act is mish:
            # bias + Mish: one kernel each way on the card
            y = mish_kernel.bias_mish_cuda(y, self.bias)
        else:
            if self.bias is not None:
                y = y + self.bias.to(y.dtype)[:, None, None]
            if self.act is not None:
                y = self.act(y)
        if q is not None and q.quantize_activations:
            y = self.act_quant(y, emit_int8=emit_qtensor and q.mode == "int8")
        return y


class QConv(QuantConv):
    """Conv2D with 'SAME' padding, optional bias, activation and
    quantization.

    ``groups == in_ch == out_ch`` is the depthwise case (weight
    (C, 1, kh, kw)).
    """

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 stride: int = 1, groups: int = 1, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 act: Optional[Callable] = None,
                 quant: Optional[QuantConfig] = None,
                 per_channel_in: bool = False):
        super().__init__(
            (features, in_ch // groups, kernel_size, kernel_size), in_ch,
            features, stride, groups, use_bias, dtype, act, quant,
            per_channel_in)

    def conv(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        return conv2d_same(x, weight, self.stride, self.groups)


class QConvTranspose(QuantConv):
    """ConvTranspose2D 4x4/s2 'SAME' (output 2H x 2W), optional bias,
    activation and quantization.

    ``lax.conv_transpose(x, k, (2, 2), 'SAME')`` with an HWIO kernel k is
    ``conv_transpose2d(x, k.flip(0, 1).permute(2, 3, 0, 1), stride=2,
    padding=1)``; the stored weight is that flipped (I, O, 4, 4) tensor.
    """

    OUT_DIM = 1
    TRANSPOSE = True

    def __init__(self, in_ch: int, features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 act: Optional[Callable] = None,
                 quant: Optional[QuantConfig] = None):
        super().__init__((in_ch, features, 4, 4), in_ch, features, 2, 1,
                         use_bias, dtype, act, quant, False)

    def conv(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        shards = active_shards()
        h = x.shape[2]
        if shards is not None:
            # output rows 2i - 1 + ky of input row i: a shard's outputs
            # read one input row of each neighbour
            x = halo_rows(x, 2, 1, 1)
        y = F.conv_transpose2d(x, weight, stride=2, padding=1)
        if shards is not None:
            y = y.narrow(2, 2, 2 * h)
        return y
