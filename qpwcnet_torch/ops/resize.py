"""Spatial resizing primitives (port of qpwcnet_tpu/ops/resize.py).

All public functions take and return NHWC tensors, as the JAX functions
do. Bilinear resizes use half-pixel centers (``align_corners=False``),
which is ``jax.image.resize(method='bilinear')``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from qpwcnet_torch.layout import nchw, nhwc


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize to (H', W'), half-pixel centers.

    Downsampling is antialiased (triangle kernel widened by the scale), as
    ``jax.image.resize`` does. x: (B, H, W, C) -> (B, H', W', C).
    """
    y = F.interpolate(nchw(x), size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return nhwc(y)


def upsample2x_bilinear(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """2x bilinear upsampling times a scalar (2.0 doubles flow magnitude).

    x: (B, H, W, C) -> (B, 2H, 2W, C).
    """
    return nhwc(upsample2x_bilinear_nchw(nchw(x), scale))


def upsample2x_bilinear_nchw(x: torch.Tensor,
                             scale: float = 1.0) -> torch.Tensor:
    """:func:`upsample2x_bilinear` on an NCHW tensor (the model's layout)."""
    y = F.interpolate(x, scale_factor=2.0, mode="bilinear",
                      align_corners=False)
    if scale != 1.0:
        y = y * scale
    return y


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, 'same' padding (ceil output size).

    Odd dims are edge-padded by one row/column first, as in the JAX
    function (exact for the even dims the models produce).
    """
    b, h, w, c = x.shape
    ph, pw = h % 2, w % 2
    if ph or pw:
        x = nhwc(F.pad(nchw(x), (0, pw, 0, ph), mode="replicate"))
        h, w = h + ph, w + pw
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def block_mean_downsample(x: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """Exact block-mean pooling by integer factors (sh, sw):
    (B, H, W, C) -> (B, H/sh, W/sw, C)."""
    b, h, w, c = x.shape
    if h % sh or w % sw:
        raise ValueError(f"block_mean_downsample: {(h, w)} is not divisible "
                         f"by {(sh, sw)}")
    return x.reshape(b, h // sh, sh, w // sw, sw, c).mean(dim=(2, 4))
