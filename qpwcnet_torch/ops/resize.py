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
    ``jax.image.resize`` does. x: (B, H, W, C) -> (B, H', W', C). At its
    own size x is returned as it is, as ``jax.image.resize`` skips the
    identity (its gradient is then the identity, also at a NaN).
    """
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    y = F.interpolate(nchw(x), size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return nhwc(y)


def spread_nonfinite(x: torch.Tensor, y: torch.Tensor,
                     dims: tuple[int, ...]) -> torch.Tensor:
    """y, a resampling of x along ``dims``, with the non-finite values of x
    spread as JAX's resampling spreads them.

    ``jax.image.resize`` and ``scale_and_translate`` contract each resized
    axis with a dense weight matrix, and 0 x NaN and 0 x inf are NaN: a
    NaN of x makes every output along those axes NaN (one NaN pixel of a
    sample's channel, both axes resized: the whole channel), and an inf
    makes every output it does not reach NaN. ``dims`` are the resized
    axes of x and y; the others must match."""
    if not dims:
        return y
    nan = torch.isnan(x).any(dim=dims, keepdim=True)
    inf = torch.isinf(x).any(dim=dims, keepdim=True)
    return torch.where(nan | (inf & torch.isfinite(y)), torch.nan, y)


def _bilinear_taps(n_in: int, n_out: int, scale: torch.Tensor,
                   translation: torch.Tensor, flip=None):
    """The two input indices and weights of each output along one axis of
    :func:`scale_and_translate_bilinear`, per sample: ((i0, w0), (i1,
    w1)), each (B, n_out). JAX's weight matrix, column by column: the
    triangle kernel at sample f = (o + 0.5) / s - t / s - 0.5, the weights
    divided by their sum (an edge clamp), zero where f lies outside
    [-0.5, n_in - 0.5]. ``flip`` (B,) bool: the indices mirrored (n_in - 1
    - i) in those samples, which samples the flipped input."""
    inv = (1.0 / scale)[:, None]
    o = torch.arange(n_out, dtype=torch.float32, device=scale.device)
    f = (o + 0.5) * inv - translation[:, None] * inv - 0.5
    taps = []
    for i in (torch.floor(f), torch.floor(f) + 1.0):
        w = torch.clamp(1.0 - torch.abs(f - i), min=0.0)
        w = torch.where((i >= 0) & (i <= n_in - 1), w, 0.0)
        i = i.clamp(0, n_in - 1).long()
        if flip is not None:
            i = torch.where(flip[:, None], n_in - 1 - i, i)
        taps.append((i, w))
    total = taps[0][1] + taps[1][1]
    keep = (total.abs() > 1000.0 * torch.finfo(torch.float32).eps) \
        & (f >= -0.5) & (f <= n_in - 0.5)
    safe = torch.where(total != 0, total, 1.0)
    return [(i, torch.where(keep, w / safe, 0.0)) for i, w in taps]


def _unit(v: torch.Tensor) -> torch.Tensor:
    """Gathered values as float32: uint8 image values / 255."""
    return v.float() * (1.0 / 255.0) if v.dtype == torch.uint8 else v


def scale_and_translate_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                                 scale: torch.Tensor,
                                 translation: torch.Tensor,
                                 flip_h=None, flip_w=None) -> torch.Tensor:
    """``jax.image.scale_and_translate(x, (B, oh, ow, C), (1, 2), (s, s),
    (ty, tx), 'bilinear', antialias=False)`` with a scale and translation
    per sample: out[y, x] samples x at ((y + 0.5 - ty) / s - 0.5, (x + 0.5
    - tx) / s - 0.5) with a triangle kernel of width 1 (no antialias, also
    for s < 1), clamped at the border and 0 where the sample lies more
    than half a pixel outside the input.

    Two taps per axis gathered by index (rows, then columns) and summed
    in float32 (no matmul, so no TF32), with JAX's spreading of
    non-finite values (:func:`spread_nonfinite`). x: (B, H, W, C) float32,
    or uint8 image values read as x / 255 (converted after the gather:
    the same values); scale: (B,); translation: (B, 2) as (ty, tx);
    ``flip_h`` / ``flip_w`` (B,) bool: resample x flipped along H / W in
    those samples (folded into the taps: the values of flipping first)."""
    b, h, w, _ = x.shape
    oh, ow = out_hw
    bi = torch.arange(b, device=x.device)
    rows = [_unit(x[bi[:, None], i]) * wt[:, :, None, None] for i, wt in
            _bilinear_taps(h, oh, scale, translation[:, 0], flip_h)]
    y = rows[0] + rows[1]                           # (B, oh, W, C)
    r = torch.arange(oh, device=x.device)[None, :, None]
    cols = [y[bi[:, None, None], r, j[:, None, :]] * wt[:, None, :, None]
            for j, wt in _bilinear_taps(w, ow, scale, translation[:, 1],
                                        flip_w)]
    y = cols[0] + cols[1]                           # (B, oh, ow, C)
    if x.dtype == torch.uint8:
        return y
    return spread_nonfinite(x, y, (1, 2))


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
