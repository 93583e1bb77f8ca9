"""Seeded synthetic inputs made on the card: frame pairs with their true
flow, and frame triplets.

A copy of the arithmetic of the measured package's synthetic generator
(random multi-octave texture, a random similarity flow plus a smooth
perturbation, prv = backward_warp(nxt, flow), frames quantized to uint8,
the margin cropped), written with perfbench/reference/ops.py, so the
inputs do not change when the program does. One departure: each sample's
contrast and motion are scaled by its own factor in [0.25, 1]
(:func:`_spread`). Everything is drawn from one
``torch.Generator`` on the card, in a fixed order.

Outputs are NHWC float32 as the measured steps take them: frames in
[-0.5, 0.5] (uint8 / 255 - 0.5), flows in pixels, (x, y) order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import ops


def _uniform(gen, shape, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                       device=gen.device)


def _up(x, hw):
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=False)


def texture(gen, b: int, h: int, w: int) -> torch.Tensor:
    """Value noise with octaves of 32/16/8/4 px and per-pixel detail,
    equal amplitudes, in [0, 1]: (B, 3, H, W)."""
    out = torch.zeros((b, 3, h, w), device=gen.device)
    for cell in (32, 16, 8, 4):
        gh, gw = max(h // cell, 1) + 1, max(w // cell, 1) + 1
        out = out + _up(_uniform(gen, (b, 3, gh, gw)), (h, w))
    return (out + _uniform(gen, (b, 3, h, w))) / 5.0


def flow_field(gen, b: int, h: int, w: int, max_disp: float = 24.0):
    """A rotation / scale / shear / shift about the centre plus an
    upsampled coarse perturbation of up to 3 px, clipped to +-max_disp:
    (B, 2, H, W)."""
    theta = _uniform(gen, (b,), -0.08, 0.08)
    scale = torch.exp(_uniform(gen, (b,), -0.08, 0.08))
    shear = _uniform(gen, (b,), -0.05, 0.05)
    shift = _uniform(gen, (b, 2), -10.0, 10.0)
    cos, sin = torch.cos(theta) * scale, torch.sin(theta) * scale
    m00, m01 = cos, cos * shear - sin
    m10, m11 = sin, sin * shear + cos
    dev = gen.device
    gy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] \
        - (h - 1) / 2.0
    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] \
        - (w - 1) / 2.0
    u = (m00[:, None, None] - 1.0) * gx + m01[:, None, None] * gy
    v = m10[:, None, None] * gx + (m11[:, None, None] - 1.0) * gy
    flo = torch.stack([u, v], dim=1) + shift[:, :, None, None]
    amp = _uniform(gen, (b, 2, 1, 1), 0.0, 3.0)
    coarse = _uniform(gen, (b, 2, h // 64 + 2, w // 64 + 2), -1.0, 1.0)
    return torch.clamp(flo + amp * _up(coarse, (h, w)), -max_disp, max_disp)


def _spread(gen, b: int, lo: float = 0.25) -> torch.Tensor:
    """A per-sample factor in [lo, 1]: the samples of a batch differ in
    contrast and in motion, as a dataset's scenes do, so that what each
    sample contributes to a batch's loss differs too."""
    return _uniform(gen, (b, 1, 1, 1), lo, 1.0)


def _u8(x: torch.Tensor) -> torch.Tensor:
    """Frames as the uint8 values they would be read as, back in
    [-0.5, 0.5]."""
    return torch.clamp(torch.round(x * 255.0), 0, 255) / 255.0 - 0.5


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


@torch.no_grad()
def flow_pairs(gen, b: int, h: int, w: int, max_disp: float = 24.0) -> dict:
    """{'ims': (B, H, W, 6) [prv, nxt], 'flo': (B, H, W, 2)} with prv =
    backward_warp(nxt, flo), made with a max_disp margin and cropped."""
    pad = int(max_disp + 1)
    nxt = texture(gen, b, h + 2 * pad, w + 2 * pad)
    nxt = 0.5 + _spread(gen, b) * (nxt - 0.5)
    flo = _spread(gen, b) * flow_field(gen, b, h + 2 * pad, w + 2 * pad,
                                       max_disp)
    prv = ops.backward_warp(nxt, flo)
    crop = (slice(None), slice(None), slice(pad, pad + h),
            slice(pad, pad + w))
    ims = torch.cat([_u8(prv[crop]), _u8(nxt[crop])], dim=1)
    return {"ims": _nhwc(ims), "flo": _nhwc(flo[crop])}


@torch.no_grad()
def triplets(gen, b: int, h: int, w: int, max_disp: float = 24.0) -> dict:
    """{'ims': (B, H, W, 6) [frame 0, frame 2], 'mid': (B, H, W, 3)} under
    constant velocity: frame 0 = warp(frame 2, flo), the middle frame =
    warp(frame 2, flo / 2)."""
    pad = int(max_disp + 1)
    nxt = texture(gen, b, h + 2 * pad, w + 2 * pad)
    nxt = 0.5 + _spread(gen, b) * (nxt - 0.5)
    flo = _spread(gen, b) * flow_field(gen, b, h + 2 * pad, w + 2 * pad,
                                       max_disp)
    prv = ops.backward_warp(nxt, flo)
    mid = ops.backward_warp(nxt, 0.5 * flo)
    crop = (slice(None), slice(None), slice(pad, pad + h),
            slice(pad, pad + w))
    return {"ims": _nhwc(torch.cat([_u8(prv[crop]), _u8(nxt[crop])], dim=1)),
            "mid": _nhwc(_u8(mid[crop]))}


MAKERS = {"pairs": flow_pairs, "triplets": triplets}
