"""Spatial resizing primitives (port of qpwcnet_tpu/ops/resize.py).

All public functions take and return NHWC tensors, as the JAX functions
do. Bilinear resizes use half-pixel centers (``align_corners=False``),
which is ``jax.image.resize(method='bilinear')``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from qpwcnet_torch.layout import nchw, nhwc
from qpwcnet_torch.parallel.transport import active_shards, halo_rows


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


def _up2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2.0, mode="bilinear",
                         align_corners=False)


def _up2x_adjoint(g: torch.Tensor, d: int) -> torch.Tensor:
    """The transpose of 2x bilinear upsampling (half-pixel centers) along
    dim d: output row 2k holds 0.75 of input row k and 0.25 of row k - 1,
    row 2k + 1 0.75 of row k and 0.25 of row k + 1, a missing neighbour's
    share going to the edge row."""
    n = g.shape[d] // 2
    even, odd = g.unflatten(d, (n, 2)).unbind(d + 1)
    even_next = torch.cat([even.narrow(d, 1, n - 1), odd.narrow(d, n - 1, 1)],
                          d)
    odd_prev = torch.cat([even.narrow(d, 0, 1), odd.narrow(d, 0, n - 1)], d)
    return 0.75 * (even + odd) + 0.25 * (even_next + odd_prev)


class _Upsample2x(torch.autograd.Function):
    """2x bilinear upsampling whose backward is the same from run to run.
    The forward is ``F.interpolate``; its CUDA backward scatters with
    atomics, in an order (and so, in bf16, with roundings) that changes
    between runs. This backward is the transpose written as slices, in
    float32 (or wider), rounded once to the gradient's dtype."""

    @staticmethod
    def forward(ctx, x):
        return _up2x(x)

    @staticmethod
    def backward(ctx, g):
        gf = g.to(torch.promote_types(g.dtype, torch.float32))
        return _up2x_adjoint(_up2x_adjoint(gf, 2), 3).to(g.dtype)


def upsample2x_bilinear_nchw(x: torch.Tensor,
                             scale: float = 1.0) -> torch.Tensor:
    """:func:`upsample2x_bilinear` on an NCHW tensor (the model's layout),
    with :class:`_Upsample2x`'s reproducible backward.

    Under an H-sharded mesh each shard takes one row of each neighbour
    (its own edge row at the global ends, the resize's clamp there) and
    keeps its 2h output rows."""
    if active_shards() is None:
        y = _Upsample2x.apply(x)
    else:
        h = x.shape[2]
        y = _Upsample2x.apply(halo_rows(x, 2, 1, 1, edge=True)).narrow(
            2, 2, 2 * h)
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
