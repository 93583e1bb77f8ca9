"""Occlusion-map estimation and naive flow inversion (port of
qpwcnet_tpu/ops/occlusion.py).

Flow convention: see qpwcnet_torch.ops.warp — (x, y) channel order,
``prv[i, j] == nxt[i + flow_y, j + flow_x]``.
"""

from __future__ import annotations

import torch

from qpwcnet_torch.ops.warp import backward_warp


def invert_flow(flow: torch.Tensor) -> torch.Tensor:
    """Naive inverse flow ``-warp(flow, flow)`` (assumption: the larger
    flow is the closer surface)."""
    return -backward_warp(flow, flow)


def estimate_occlusion_map(flow: torch.Tensor) -> torch.Tensor:
    """Which pixels of the *next* frame are unobservable from the previous
    frame under ``flow``.

    A pixel is occluded (1.0) when (a) its forward-advected position
    leaves the image, or (b) no inverse-flow-advected source cell lands on
    it (the holes left by writing zeros into a ones map at the
    inverse-warped integer positions). Those positions truncate toward
    zero before they are clipped into the image, in JAX's order.

    flow: (B, H, W, 2) -> (B, H, W) float32 in {0.0, 1.0}.
    """
    b, h, w, _ = flow.shape
    fx, fy = flow[..., 0].float(), flow[..., 1].float()
    gy = torch.arange(h, dtype=torch.float32, device=flow.device)[:, None]
    gx = torch.arange(w, dtype=torch.float32, device=flow.device)[None, :]

    i2, j2 = gy + fy, gx + fx
    oob = ((i2 < 0) | (i2 >= h) | (j2 < 0) | (j2 >= w)).float()

    inv = invert_flow(flow).float()
    i3 = (gy + inv[..., 1]).to(torch.int32).clamp(0, h - 1)
    j3 = (gx + inv[..., 0]).to(torch.int32).clamp(0, w - 1)
    bidx = torch.arange(b, device=flow.device)[:, None, None]
    lin = (bidx * (h * w) + i3 * w + j3).reshape(-1).long()
    # JAX's .at[lin].min(0) on a ones map: every hit cell becomes 0
    map3 = torch.ones(b * h * w, dtype=torch.float32, device=flow.device)
    map3.index_fill_(0, lin, 0.0)
    return torch.maximum(oob, map3.reshape(b, h, w))
