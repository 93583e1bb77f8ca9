"""Neural building blocks (port of qpwcnet_tpu/models/blocks.py).

Tensors are logical NCHW in channels_last memory (qpwcnet_torch/layout.py).
Parameters are float32; each block computes in its ``dtype``; BatchNorm,
the flow conv and the OptFlow output scale stay float32
(``blocks.py:245-273``).

``spatial`` (FlowBlock, UpFlowBlock): a ``parallel.SpatialConfig`` when
the model runs H-sharded; the cost volume and the warp then exchange
halo rows between the shards (``parallel/spatial_ops.py``). BatchNorm and
OptFlow read the active mesh (``parallel/transport.py``).

``quant`` (a ``quantize.QuantConfig``) is threaded into every conv, as in
the JAX blocks: the depthwise halves of the SepConvs quantize weights and
inputs only (a Keras SeparableConv2D is one layer: no output fake quant
between its halves); the convs that take a heterogeneous concat (OptFlow's
first SepConv, FrameInterpolate's conv1) range their input per channel;
and in int8 mode the conv chains (the DownConv stages, the OptFlow
SepConvs, FrameInterpolate's conv1 -> conv2) pass QTensors, int8 values
and a scale, from conv to conv.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn as nn

from qpwcnet_torch.layout import cat_channels, nchw, nhwc
from qpwcnet_torch.ops.activations import mish
from qpwcnet_torch.ops.cost_volume import cost_volume
from qpwcnet_torch.ops.cuda.warp_cv_kernel import (
    FUSED_WARP_WINDOW,
    warp_cost_volume_trainable,
)
from qpwcnet_torch.ops.warp import backward_warp
from qpwcnet_torch.parallel.spatial_ops import (
    backward_warp_spatial,
    cost_volume_spatial,
)
from qpwcnet_torch.parallel.transport import active_mesh, n_shards
from qpwcnet_torch.quantize.fake_quant import QuantConfig
from qpwcnet_torch.quantize.qlayers import QConv, QConvTranspose


def dw_quant(quant: Optional[QuantConfig]) -> Optional[QuantConfig]:
    """The depthwise half of a SepConv: no output quantization."""
    if quant is None:
        return None
    return dataclasses.replace(quant, quantize_activations=False)


def int8_mode(quant: Optional[QuantConfig]) -> bool:
    """True when the convs run int8 arithmetic and chains pass
    QTensors."""
    return quant is not None and quant.mode == "int8"


class SepConv(nn.Module):
    """Keras SeparableConv2D: depthwise kxk (no bias) + pointwise 1x1
    (bias) + Mish. ``per_channel_in``: the depthwise half ranges its
    input per channel. In int8 mode the depthwise half takes a QTensor
    or a float and emits float (its output has no range); the pointwise
    half quantizes it with its input range."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32,
                 quant: Optional[QuantConfig] = None,
                 per_channel_in: bool = False):
        super().__init__()
        self.depthwise = QConv(in_ch, in_ch, kernel, groups=in_ch,
                               use_bias=False, dtype=dtype,
                               quant=dw_quant(quant),
                               per_channel_in=per_channel_in)
        self.pointwise = QConv(in_ch, features, 1, dtype=dtype, act=mish,
                               quant=quant)

    def forward(self, x, emit_qtensor: bool = False):
        return self.pointwise(self.depthwise(x), emit_qtensor=emit_qtensor)


class DownConv(nn.Module):
    """Encoder stage: Conv(3x3, s2, Mish) -> Conv(3x3, Mish) ->
    Conv(3x3, Mish), no normalizer. In int8 mode the three convs chain
    QTensors; ``emit_qtensor`` makes the last one emit a QTensor too."""

    def __init__(self, in_ch: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 quant: Optional[QuantConfig] = None):
        super().__init__()
        self.chain_q = int8_mode(quant)
        self.conv_a = QConv(in_ch, features, 3, stride=2, dtype=dtype,
                            act=mish, quant=quant)
        self.conv_aa = QConv(features, features, 3, dtype=dtype, act=mish,
                             quant=quant)
        self.conv_b = QConv(features, features, 3, dtype=dtype, act=mish,
                            quant=quant)

    def params(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """[(weight, bias)] of conv_a, conv_aa, conv_b (the fused stem
        kernel's argument)."""
        return [(c.weight, c.bias)
                for c in (self.conv_a, self.conv_aa, self.conv_b)]

    def forward(self, x, emit_qtensor: bool = False):
        x = self.conv_a(x, emit_qtensor=self.chain_q)
        x = self.conv_aa(x, emit_qtensor=self.chain_q)
        return self.conv_b(x, emit_qtensor=emit_qtensor)


class UpConv(nn.Module):
    """Decoder stage: ConvTranspose(4x4, s2, Mish)."""

    def __init__(self, in_ch: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 quant: Optional[QuantConfig] = None):
        super().__init__()
        self.conv_up = QConvTranspose(in_ch, features, dtype=dtype, act=mish,
                                      quant=quant)

    def params(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """[(weight, bias)] of conv_up (the fused upconv kernel's
        argument)."""
        return [(self.conv_up.weight, self.conv_up.bias)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_up(x)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` in float32 (Keras defaults: eps 1e-3,
    momentum .99).

    Train mode normalizes with the batch statistics, the biased variance
    E[x²] - E[x]² clipped at 0 (Flax's fast variance), and updates
    ``running = momentum * running + (1 - momentum) * batch`` — torch's
    BatchNorm2d would update with the unbiased variance. Under a mesh of
    several processes the statistics are over every shard and data rank
    (the sums all-reduced), so every process updates the same running
    statistics; a local mesh's batch already holds every shard.
    """

    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-3):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            mesh = active_mesh()
            if mesh is None or mesh.procs == 1:
                mean = x.mean(dim=(0, 2, 3))
                sq = (x * x).mean(dim=(0, 2, 3))
            else:
                sums = mesh.all_sum(torch.stack(
                    [x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3))]))
                mean, sq = sums / (x.numel() // x.shape[1] * mesh.procs)
            var = torch.clamp(sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]


class OptFlow(nn.Module):
    """Flow-regression head: 4 SepConvs (128/64/32/16, Mish) -> 1x1 Conv
    Mish -> BatchNorm -> 3x3 Conv (2 ch, no bias), times sqrt(h² + w²) of
    the input resolution under head_scale='diag' (1 under 'unit'): the
    whole image's under an H-sharded mesh, whose input is a shard's
    rows. Under ``quant`` the first SepConv ranges its input (the [cost,
    features, flow] concat) per channel, and in int8 mode the SepConvs
    chain QTensors; the 1x1 conv emits float for the BatchNorm."""

    def __init__(self, in_ch: int, filters: Sequence[int] = (128, 64, 32, 16),
                 dtype: torch.dtype = torch.float32,
                 head_scale: str = "diag",
                 quant: Optional[QuantConfig] = None):
        super().__init__()
        if head_scale not in ("diag", "unit"):
            raise ValueError(f"unknown head_scale: {head_scale!r}")
        self.head_scale = head_scale
        self.chain_q = int8_mode(quant)
        chans = [in_ch, *filters]
        self.of_feats = nn.ModuleList(
            SepConv(chans[i], chans[i + 1], dtype=dtype, quant=quant,
                    per_channel_in=quant is not None and i == 0)
            for i in range(len(filters)))
        self.conv1x1 = QConv(filters[-1], filters[-1], 1, dtype=dtype,
                             act=mish, quant=quant)
        self.norm = BatchNorm(filters[-1])
        self.of_flow = QConv(filters[-1], 2, 3, use_bias=False,
                             dtype=torch.float32, quant=quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2] * n_shards(), x.shape[3]
        scale = (float(h * h + w * w) ** 0.5
                 if self.head_scale == "diag" else 1.0)
        for layer in self.of_feats:
            x = layer(x, emit_qtensor=self.chain_q)
        x = self.norm(self.conv1x1(x))
        return scale * self.of_flow(x)


class FlowBlock(nn.Module):
    """Coarsest-level flow estimator: concat[cost_volume(prv, nxt), prv,
    nxt] -> OptFlow. Under ``spatial`` the cost volume is the
    halo-exchanged :func:`cost_volume_spatial`."""

    def __init__(self, feat_ch: int, dtype: torch.dtype = torch.float32,
                 cv_impl: str = "auto", head_scale: str = "diag",
                 spatial=None, quant: Optional[QuantConfig] = None):
        super().__init__()
        self.cv_impl = cv_impl
        self.spatial = spatial
        self.flow = OptFlow(81 + 2 * feat_ch, dtype=dtype,
                            head_scale=head_scale, quant=quant)

    def forward(self, prv: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
        if self.spatial is not None:
            cost = nchw(cost_volume_spatial(nhwc(prv), nhwc(nxt),
                                            self.spatial))
        else:
            cost = nchw(cost_volume(nhwc(prv), nhwc(nxt),
                                    impl=self.cv_impl))
        return self.flow(cat_channels([cost, prv, nxt]))


class UpFlowBlock(nn.Module):
    """Per-level refinement: warp nxt by the upsampled flow, correlate
    against prv, concat[cost, prv, flo] -> OptFlow (the warped features are
    not concatenated). residual=True adds the head's output to flo.

    cv_impl='fused' runs the fused warp+correlate kernel, whose warp
    clamps each displacement to ±FUSED_WARP_WINDOW. ``spatial`` takes
    precedence: the window warp and the halo-exchanged cost volume
    (``parallel/spatial_ops.py``), as in the JAX block."""

    def __init__(self, feat_ch: int, dtype: torch.dtype = torch.float32,
                 cv_impl: str = "auto", head_scale: str = "diag",
                 residual: bool = False, spatial=None,
                 quant: Optional[QuantConfig] = None):
        super().__init__()
        self.cv_impl = cv_impl
        self.residual = residual
        self.spatial = spatial
        self.flow = OptFlow(81 + feat_ch + 2, dtype=dtype,
                            head_scale=head_scale, quant=quant)

    def forward(self, prv: torch.Tensor, nxt: torch.Tensor,
                flo: torch.Tensor) -> torch.Tensor:
        flo32 = nhwc(flo.float()).contiguous()
        if self.spatial is not None:
            nxt_w = backward_warp_spatial(nhwc(nxt), flo32, self.spatial)
            cost = cost_volume_spatial(nhwc(prv), nxt_w, self.spatial)
        elif self.cv_impl == "fused":
            cost = warp_cost_volume_trainable(nhwc(prv), nhwc(nxt), flo32,
                                              warp_window=FUSED_WARP_WINDOW)
        else:
            nxt_w = backward_warp(nhwc(nxt), flo32)
            cost = cost_volume(nhwc(prv), nxt_w, impl=self.cv_impl)
        feat = cat_channels([nchw(cost), prv, flo.to(prv.dtype)])
        out = self.flow(feat)
        if self.residual:
            out = out + flo.to(out.dtype)
        return out


class FrameInterpolate(nn.Module):
    """Middle-frame synthesis head: warp nxt by 0.5·flo_01 and prv by
    0.5·flo_10 (float32 flows), concat [prv_w, nxt_w, flo_01, flo_10
    (, img_u under ``up``)], SepConv(64, Mish) -> 1x1 QConv to 3 channels;
    float32 output.

    in_ch: channels of prv and nxt (3 for the images of the coarsest
    head, the decoder feature's channels for the up heads). Under
    ``quant`` conv1 ranges its input (the concat) per channel, and in
    int8 mode hands conv2 a QTensor."""

    def __init__(self, in_ch: int, up: bool = False,
                 dtype: torch.dtype = torch.float32,
                 quant: Optional[QuantConfig] = None):
        super().__init__()
        self.up = up
        self.chain_q = int8_mode(quant)
        self.conv1 = SepConv(2 * in_ch + 4 + (3 if up else 0), 64,
                             dtype=dtype, quant=quant,
                             per_channel_in=quant is not None)
        self.conv2 = QConv(64, 3, 1, dtype=dtype, quant=quant)

    def forward(self, prv: torch.Tensor, nxt: torch.Tensor,
                flo_01: torch.Tensor, flo_10: torch.Tensor,
                img_u: torch.Tensor | None = None) -> torch.Tensor:
        flo_01f, flo_10f = flo_01.float(), flo_10.float()
        nxt_w = backward_warp(nhwc(nxt), 0.5 * nhwc(flo_01f).contiguous())
        prv_w = backward_warp(nhwc(prv), 0.5 * nhwc(flo_10f).contiguous())
        feats = [nchw(prv_w), nchw(nxt_w), flo_01f.to(prv.dtype),
                 flo_10f.to(prv.dtype)]
        if self.up:
            if img_u is None:
                raise ValueError("an up FrameInterpolate needs img_u")
            feats.append(img_u.to(prv.dtype))
        x = self.conv2(self.conv1(cat_channels(feats),
                                  emit_qtensor=self.chain_q))
        return x.float()
