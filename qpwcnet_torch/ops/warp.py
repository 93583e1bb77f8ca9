"""Backward bilinear warping (port of qpwcnet_tpu/ops/warp.py,
production semantics).

CONVENTION (identical to the JAX package):
  * Flow tensors are NHWC with 2 channels in ``(u, v) == (x, y)`` order.
  * ``backward_warp(img, flow)[b, i, j] == img[b, i + v, j + u]`` sampled
    bilinearly; out-of-bounds samples clamp to the border.

Semantics are those of ``qpwcnet_tpu.ops.warp._warp_coords``: the corner
origin (floor of the query) is clamped to ``[0, size-2]`` and the
interpolation weights to ``[0, 1]``. Coordinates are float32; the
interpolation runs in the image dtype (bf16 stays bf16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def warp_coords(flow: torch.Tensor, hp: int, wp: int):
    """Clamped corner origin and interpolation weights for a (B, H, W, 2)
    float32 flow sampling a source of size (hp, wp), hp, wp >= 2.

    Returns (x0, y0, ax, ay), each (B, H, W) float32.
    """
    _, h, w, _ = flow.shape
    gy = torch.arange(h, dtype=torch.float32, device=flow.device)[:, None]
    gx = torch.arange(w, dtype=torch.float32, device=flow.device)[None, :]
    qx = gx + flow[..., 0]
    qy = gy + flow[..., 1]
    x0 = torch.clamp(torch.floor(qx), 0.0, wp - 2.0)
    y0 = torch.clamp(torch.floor(qy), 0.0, hp - 2.0)
    ax = torch.clamp(qx - x0, 0.0, 1.0)
    ay = torch.clamp(qy - y0, 0.0, 1.0)
    return x0, y0, ax, ay


def backward_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward bilinear warp.

    Args:
      img: (B, H, W, C) source image/features.
      flow: (B, H, W, 2) flow in (x, y) channel order.

    Returns:
      (B, H, W, C) in img's dtype: ``out[b,i,j] = img[b, i + flow_y,
      j + flow_x]``, border-clamped and bilinearly interpolated.
    """
    b, hi, wi, c = img.shape
    _, h, w, _ = flow.shape
    flow = flow.float()
    # Degenerate 1-pixel dims: edge-pad so the 2x2 corner block fits;
    # border-clamped sampling is unchanged.
    if hi < 2 or wi < 2:
        img = F.pad(img.permute(0, 3, 1, 2),
                    (0, max(0, 2 - wi), 0, max(0, 2 - hi)),
                    mode="replicate").permute(0, 2, 3, 1)
    hp, wp = max(hi, 2), max(wi, 2)

    x0, y0, ax, ay = warp_coords(flow, hp, wp)
    lin = (y0.long() * wp + x0.long()).reshape(b, h * w)
    flat = img.reshape(b, hp * wp, c)
    bidx = torch.arange(b, device=img.device)[:, None]

    def corner(off):
        return flat[bidx, lin + off].reshape(b, h, w, c)

    ax = ax[..., None].to(img.dtype)
    ay = ay[..., None].to(img.dtype)
    g00, g01 = corner(0), corner(1)
    g10, g11 = corner(wp), corner(wp + 1)
    top = g00 + (g01 - g00) * ax
    bot = g10 + (g11 - g10) * ax
    return top + (bot - top) * ay
