"""The flow network and the frame interpolator of the PWC-Net family,
written plainly in float32 from perfbench/reference/ops.py.

The parameter and buffer names are those of the measured models, so one
state_dict loads into both. Inputs and outputs are NHWC, as the measured
models' are: (B, H, W, 6) in; the final (B, H, W, 2) flow or
(B, H, W, 3) middle frame, or the six outputs coarse to fine with
``multiscale``.

``precision`` 'fp8' rounds the operands of every convolution and cost
volume, and the images and results of every warp, to float8
(perfbench/reference/ops.py:round_fp8) around the float32 arithmetic:
the lower precision that a control of the bf16 configurations computes
in.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn as nn

from perfbench.reference import ops


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """'SAME' conv (OIHW weight), optional bias, optional Mish."""

    def __init__(self, rnd: Callable, cin: int, cout: int, k: int,
                 stride: int = 1, groups: int = 1, bias: bool = True,
                 act: bool = False):
        super().__init__()
        self.rnd, self.stride, self.groups, self.act = rnd, stride, groups, act
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        y = ops.conv2d_same(self.rnd(x), self.rnd(self.weight), self.stride,
                            self.groups)
        if self.bias is not None:
            y = y + self.bias[:, None, None]
        return ops.mish(y) if self.act else y


class ConvUp(nn.Module):
    """The 4x4/s2 transpose conv ((I, O, 4, 4) weight) + bias + Mish."""

    def __init__(self, rnd: Callable, cin: int, cout: int):
        super().__init__()
        self.rnd = rnd
        self.weight = nn.Parameter(torch.empty(cin, cout, 4, 4))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        y = ops.conv_transpose_up2(self.rnd(x), self.rnd(self.weight))
        return ops.mish(y + self.bias[:, None, None])


class SepConv(nn.Module):
    def __init__(self, rnd, cin: int, cout: int):
        super().__init__()
        self.depthwise = Conv(rnd, cin, cin, 3, groups=cin, bias=False)
        self.pointwise = Conv(rnd, cin, cout, 1, act=True)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class DownConv(nn.Module):
    def __init__(self, rnd, cin: int, cout: int):
        super().__init__()
        self.conv_a = Conv(rnd, cin, cout, 3, stride=2, act=True)
        self.conv_aa = Conv(rnd, cout, cout, 3, act=True)
        self.conv_b = Conv(rnd, cout, cout, 3, act=True)

    def forward(self, x):
        return self.conv_b(self.conv_aa(self.conv_a(x)))


class UpConv(nn.Module):
    def __init__(self, rnd, cin: int, cout: int):
        super().__init__()
        self.conv_up = ConvUp(rnd, cin, cout)

    def forward(self, x):
        return self.conv_up(x)


class BatchNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.empty(c))
        self.register_buffer("running_var", torch.empty(c))

    def forward(self, x):
        return ops.batch_norm(x, self.weight, self.bias, self.running_mean,
                              self.running_var, self.training)


class OptFlow(nn.Module):
    """4 SepConvs (128/64/32/16) -> 1x1 conv Mish -> BatchNorm -> 3x3
    conv to 2 channels, no bias, times the level's diagonal."""

    def __init__(self, rnd, cin: int, filters: Sequence[int]):
        super().__init__()
        chans = [cin, *filters]
        self.of_feats = nn.ModuleList(SepConv(rnd, chans[i], chans[i + 1])
                                      for i in range(len(filters)))
        self.conv1x1 = Conv(rnd, filters[-1], filters[-1], 1, act=True)
        self.norm = BatchNorm(filters[-1])
        self.of_flow = Conv(rnd, filters[-1], 2, 3, bias=False)

    def forward(self, x):
        scale = math.sqrt(x.shape[2] ** 2 + x.shape[3] ** 2)
        for layer in self.of_feats:
            x = layer(x)
        return scale * self.of_flow(self.norm(self.conv1x1(x)))


class FlowBlock(nn.Module):
    def __init__(self, rnd, feat: int, filters, r: int):
        super().__init__()
        self.rnd, self.r = rnd, r
        self.flow = OptFlow(rnd, (2 * r + 1) ** 2 + 2 * feat, filters)

    def forward(self, prv, nxt):
        cost = ops.cost_volume(self.rnd(prv), self.rnd(nxt), self.r)
        return self.flow(torch.cat([cost, prv, nxt], dim=1))


class UpFlowBlock(nn.Module):
    def __init__(self, rnd, feat: int, filters, r: int):
        super().__init__()
        self.rnd, self.r = rnd, r
        self.flow = OptFlow(rnd, (2 * r + 1) ** 2 + feat + 2, filters)

    def forward(self, prv, nxt, flo):
        nxt_w = self.rnd(ops.backward_warp(self.rnd(nxt), flo))
        cost = ops.cost_volume(self.rnd(prv), self.rnd(nxt_w), self.r)
        return self.flow(torch.cat([cost, prv, flo], dim=1))


class Flower(nn.Module):
    def __init__(self, rnd, enc_ch: int, dec_ch: Sequence[int], filters,
                 r: int):
        super().__init__()
        self.flow_0 = FlowBlock(rnd, enc_ch, filters, r)
        self.upflows = nn.ModuleList(UpFlowBlock(rnd, c, filters, r)
                                     for c in dec_ch)

    def forward(self, enc_prv, enc_nxt, decs_prv, decs_nxt):
        flo = self.flow_0(enc_prv, enc_nxt)
        flos = [flo]
        for i, up in enumerate(self.upflows):
            flo = up(decs_prv[i], decs_nxt[i], ops.upsample2x(flo, 2.0))
            flos.append(flo)
        flos.append(ops.upsample2x(flo, 2.0))
        return flos


class Encoder(nn.Module):
    def __init__(self, rnd, filters: Sequence[int]):
        super().__init__()
        chans = [3, *filters]
        self.stages = nn.ModuleList(DownConv(rnd, chans[i], chans[i + 1])
                                    for i in range(len(filters)))

    def forward(self, img):
        feats = [img]
        for stage in self.stages:
            feats.append(stage(feats[-1]))
        return feats


class Decoder(nn.Module):
    def __init__(self, rnd, filters: Sequence[int], enc: Sequence[int]):
        super().__init__()
        stages, c = [], enc[-1]
        for k, f in enumerate(filters):
            stages.append(UpConv(rnd, c, f))
            c = f + enc[-2 - k]
        self.stages = nn.ModuleList(stages)

    def forward(self, encs):
        f, decs = encs[-1], []
        for k, stage in enumerate(self.stages):
            f = torch.cat([stage(f), encs[-2 - k]], dim=1)
            decs.append(f)
        return decs


def _dec_channels(cfg: dict) -> list[int]:
    enc, dec = cfg["encoder_filters"], cfg["decoder_filters"]
    return [f + e for f, e in zip(dec, enc[-2::-1])]


class FlowNet(nn.Module):
    """The optical-flow model: the siamese encoder and decoder on the
    stacked pair, the Flower on (prv, nxt)."""

    def __init__(self, cfg: dict, precision: str = "float32"):
        super().__init__()
        rnd = ops.ROUNDINGS[precision]
        enc = cfg["encoder_filters"]
        self.encoder = Encoder(rnd, enc)
        self.decoder = Decoder(rnd, cfg["decoder_filters"], enc)
        self.flower = Flower(rnd, enc[-1], _dec_channels(cfg),
                             cfg["flow_head_filters"], cfg["search_range"])

    def forward(self, inputs, multiscale: bool = False):
        x = nchw(inputs.float())
        b = x.shape[0]
        encs = self.encoder(torch.cat([x[:, :3], x[:, 3:]], dim=0))
        decs = self.decoder(encs)
        flos = self.flower(encs[-1][:b], encs[-1][b:], [d[:b] for d in decs],
                           [d[b:] for d in decs])
        flos = [nhwc(f) for f in flos]
        return flos if multiscale else flos[-1]


class FrameInterpolate(nn.Module):
    """Warp nxt by flo_01 / 2 and prv by flo_10 / 2, concat [prv_w, nxt_w,
    flo_01, flo_10 (, img_u)], SepConv(64) -> 1x1 conv to 3 channels."""

    def __init__(self, rnd, cin: int, up: bool):
        super().__init__()
        self.rnd, self.up = rnd, up
        self.conv1 = SepConv(rnd, 2 * cin + 4 + (3 if up else 0), 64)
        self.conv2 = Conv(rnd, 64, 3, 1)

    def forward(self, prv, nxt, flo_01, flo_10, img_u=None):
        r = self.rnd
        feats = [r(ops.backward_warp(r(prv), 0.5 * flo_10)),
                 r(ops.backward_warp(r(nxt), 0.5 * flo_01)), flo_01, flo_10]
        if self.up:
            feats.append(img_u)
        return self.conv2(self.conv1(torch.cat(feats, dim=1)))


class Interpolator(nn.Module):
    """The frame-interpolation model: the shared encoder and decoder, one
    Flower run on the stack of both directions (rows [:B] prv <- nxt,
    flos_01; rows [B:] flos_10), and the img_0..img_4 heads."""

    def __init__(self, cfg: dict, precision: str = "float32"):
        super().__init__()
        rnd = ops.ROUNDINGS[precision]
        enc = cfg["encoder_filters"]
        dec = _dec_channels(cfg)
        self.encoder = Encoder(rnd, enc)
        self.decoder = Decoder(rnd, cfg["decoder_filters"], enc)
        self.flower = Flower(rnd, enc[-1], dec, cfg["flow_head_filters"],
                             cfg["search_range"])
        self.imgs = nn.ModuleList(
            [FrameInterpolate(rnd, 3, up=False)]
            + [FrameInterpolate(rnd, c, up=True) for c in dec])

    def forward(self, inputs, multiscale: bool = False):
        x = nchw(inputs.float())
        b = x.shape[0]
        encs = self.encoder(torch.cat([x[:, :3], x[:, 3:]], dim=0))
        decs = self.decoder(encs)

        def swap(t):
            return torch.cat([t[b:], t[:b]], dim=0)

        flos = self.flower(swap(encs[-1]), encs[-1], [swap(d) for d in decs],
                           decs)
        flos_01 = [f[:b] for f in flos]
        flos_10 = [f[b:] for f in flos]
        pyr_prv, pyr_nxt = x[:, :3], x[:, 3:]
        for _ in range(len(self.decoder.stages) + 1):
            pyr_prv, pyr_nxt = ops.avg_pool_2x(pyr_prv), ops.avg_pool_2x(
                pyr_nxt)
        img = self.imgs[0](pyr_prv, pyr_nxt, flos_01[0], flos_10[0])
        imgs = [img]
        for i, head in enumerate(self.imgs[1:]):
            img = head(decs[i][:b], decs[i][b:], flos_01[i + 1],
                       flos_10[i + 1], ops.upsample2x(img))
            imgs.append(img)
        imgs.append(ops.upsample2x(img))
        imgs = [nhwc(im) for im in imgs]
        return imgs if multiscale else imgs[-1]


MODELS = {"flow": FlowNet, "interp": Interpolator}


def build(cfg: dict, precision: str = "float32") -> nn.Module:
    """The reference model of a configuration, its tensors uninitialised
    (load a state_dict), in eval mode."""
    return MODELS[cfg["model"]](cfg, precision).eval()
