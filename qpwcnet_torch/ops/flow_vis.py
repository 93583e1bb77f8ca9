"""Flow visualization and cost-volume decoding (port of
qpwcnet_tpu/ops/flow_vis.py). NHWC only."""

from __future__ import annotations

import math

import torch


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """HSV -> RGB, channels in the last axis, all in [0, 1]."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = i.long() % 6

    def select(choices):
        out = torch.zeros_like(h)
        for k, val in enumerate(choices):
            out = torch.where(i == k, val, out)
        return out

    return torch.stack([select([v, q, p, p, t, v]),
                        select([t, v, v, q, p, p]),
                        select([p, p, t, v, v, q])], dim=-1)


def flow_to_image(flow: torch.Tensor) -> torch.Tensor:
    """Colorize flow: angle -> hue, magnitude/max -> saturation, V = 1.

    flow: (..., H, W, 2) in (x, y) order -> (..., H, W, 3) RGB in [0, 1].
    """
    flow = flow.float()
    ang = torch.atan2(flow[..., 1], flow[..., 0])
    h = (ang + math.pi) / (2.0 * math.pi)
    mag = torch.linalg.vector_norm(flow, dim=-1)
    smax = torch.amax(mag, dim=(-2, -1), keepdim=True)
    s = mag / (smax + 1e-6)
    v = torch.ones_like(h)
    return hsv_to_rgb(torch.stack([h, s, v], dim=-1))


def cost_volume_to_flow(cvol: torch.Tensor) -> torch.Tensor:
    """Decode a displacement from a cost volume by its argmax over the
    d*d offsets (the first maximum wins, as in ``jnp.argmax``).

    cvol: (..., H, W, d*d) -> (..., H, W, 2) float32 in (di, dj) == (y, x)
    order, the reference's ``tf.stack([di, dj], axis)``, unlike the flow
    convention's (x, y).
    """
    dims = cvol.shape[-1]
    q = math.isqrt(dims)
    if q * q != dims:
        raise ValueError(f"cost volume has {dims} channels, not a square")
    imax = torch.argmax(cvol, dim=-1).float()
    di = torch.floor(imax / q)
    dj = imax - di * q
    return torch.stack([di - (q - 1) / 2.0, dj - (q - 1) / 2.0], dim=-1)
