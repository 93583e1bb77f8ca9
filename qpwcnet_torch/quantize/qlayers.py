"""Conv modules (port of the float path of qpwcnet_tpu/quantize/qlayers.py).

Tensors inside the model are logical NCHW; parameters are float32 and are
cast to the module's compute dtype per call, as the JAX modules do.
Weights are stored in PyTorch's layouts: OIHW for convs, (C, 1, kh, kw)
for depthwise convs and (I, O, kh, kw) for transpose convs
(models/from_flax.py maps the Flax HWIO kernels).

Under an H-sharded mesh (qpwcnet_torch.parallel) a conv's input is one
shard's rows: H is padded with the neighbouring shards' rows, and with
zeros only at the global ends, so each shard's output rows are the
unsharded conv's (XLA's partitioning of the JAX model's convs).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from qpwcnet_torch.parallel.transport import active_shards, halo_rows


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA 'SAME' padding (before, after) of one spatial dim: the output
    is ceil(size / s), and an odd total pad puts the extra pixel AFTER —
    so a 3x3/s2 conv on an even size pads (0, 1), not (1, 1)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
                groups: int = 1) -> torch.Tensor:
    """NCHW conv with XLA 'SAME' padding; weight OIHW in x's dtype.

    Under an H-sharded mesh the H padding is that of the whole image
    (stride 2 on an even H: (0, 1), one row of the next shard and none of
    the previous one), filled with the neighbours' rows."""
    kh, kw = weight.shape[-2:]
    shards = active_shards()
    if shards is None:
        pt, pb = same_pads(x.shape[2], kh, stride)
    else:
        if x.shape[2] % stride:
            raise ValueError(f"an H shard of {x.shape[2]} rows does not "
                             f"split by the conv's stride {stride}")
        pt, pb = same_pads(x.shape[2] * shards.n, kh, stride)
        x = halo_rows(x, 2, pt, pb)
        pt = pb = 0
    pl, pr = same_pads(x.shape[3], kw, stride)
    if pt == pb and pl == pr:
        return F.conv2d(x, weight, stride=stride, padding=(pt, pl),
                        groups=groups)
    return F.conv2d(F.pad(x, (pl, pr, pt, pb)), weight, stride=stride,
                    groups=groups)


class QConv(nn.Module):
    """Conv2D with 'SAME' padding, optional bias and activation.

    ``groups == in_ch == out_ch`` is the depthwise case (weight
    (C, 1, kh, kw)).
    """

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 stride: int = 1, groups: int = 1, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 act: Optional[Callable] = None):
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.dtype = dtype
        self.act = act
        self.weight = nn.Parameter(torch.empty(
            features, in_ch // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_same(x.to(self.dtype), self.weight.to(self.dtype),
                        self.stride, self.groups)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[:, None, None]
        if self.act is not None:
            y = self.act(y)
        return y


class QConvTranspose(nn.Module):
    """ConvTranspose2D 4x4/s2 'SAME' (output 2H x 2W).

    ``lax.conv_transpose(x, k, (2, 2), 'SAME')`` with an HWIO kernel k is
    ``conv_transpose2d(x, k.flip(0, 1).permute(2, 3, 0, 1), stride=2,
    padding=1)``; the stored weight is that flipped (I, O, 4, 4) tensor.
    """

    def __init__(self, in_ch: int, features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 act: Optional[Callable] = None):
        super().__init__()
        self.dtype = dtype
        self.act = act
        self.weight = nn.Parameter(torch.empty(in_ch, features, 4, 4))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        shards = active_shards()
        h = x.shape[2]
        if shards is not None:
            # output rows 2i - 1 + ky of input row i: a shard's outputs
            # read one input row of each neighbour
            x = halo_rows(x, 2, 1, 1)
        y = F.conv_transpose2d(x, self.weight.to(self.dtype), stride=2,
                               padding=1)
        if shards is not None:
            y = y.narrow(2, 2, 2 * h)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[:, None, None]
        if self.act is not None:
            y = self.act(y)
        return y
