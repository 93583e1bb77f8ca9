"""Synthetic optical-flow and frame-interpolation tasks with non-uniform
flow fields (port of qpwcnet_tpu/data/synthetic.py).

flow(p) = affine(p) + a low-frequency perturbation(p): a random
similarity transform (rotation, log-scale, shear, translation) about the
image center plus a bilinearly upsampled coarse noise grid. Frames are
exact by construction: ``prv = backward_warp(nxt, flow)`` realizes
``prv[p] == nxt[p + flow[p]]``. The texture is multi-octave value noise
with equal octave amplitudes, quantized to uint8.

Every draw comes from an explicit ``torch.Generator`` on the device that
builds the batch, so a seed fixes the stream. The JAX package draws from
``jax.random`` keys: the same seed gives other numbers, from the same
distributions.
"""

from __future__ import annotations

import torch

from qpwcnet_torch.ops.resize import resize_bilinear
from qpwcnet_torch.ops.warp import backward_warp


def _uniform(gen: torch.Generator, shape, lo: float = 0.0,
             hi: float = 1.0) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return lo + (hi - lo) * u


def random_texture(gen: torch.Generator, b: int, h: int,
                   w: int) -> torch.Tensor:
    """Multi-octave value noise in [0, 1]: (B, H, W, 3) float32.

    Octave cell sizes 32/16/8/4 px plus per-pixel detail, equal
    amplitudes: the cost volume learns from the correlation contrast
    between the true shift and its neighbours, which a
    low-frequency-dominant texture lacks.
    """
    out = torch.zeros((b, h, w, 3), device=gen.device)
    for cell in (32, 16, 8, 4):
        gh, gw = max(h // cell, 1) + 1, max(w // cell, 1) + 1
        out = out + resize_bilinear(_uniform(gen, (b, gh, gw, 3)), (h, w))
    out = out + _uniform(gen, (b, h, w, 3))
    return out / 5.0


def random_flow_field(gen: torch.Generator, b: int, h: int, w: int,
                      max_disp: float = 24.0, max_rot: float = 0.08,
                      max_log_scale: float = 0.08, max_shear: float = 0.05,
                      max_shift: float = 10.0,
                      pert_amp: float = 3.0) -> torch.Tensor:
    """Smooth per-pixel flow (B, H, W, 2) float32 in (x, y) order.

    affine: p' = M (p - c) + c + t with M = R(θ)·S(e^s)·Shear(k);
    perturbation: a coarse noise grid, bilinearly upsampled, up to
    ±pert_amp px per axis. Each component clipped to ±max_disp.
    """
    theta = _uniform(gen, (b,), -max_rot, max_rot)
    scale = torch.exp(_uniform(gen, (b,), -max_log_scale, max_log_scale))
    shear = _uniform(gen, (b,), -max_shear, max_shear)
    shift = _uniform(gen, (b, 2), -max_shift, max_shift)

    cos, sin = torch.cos(theta) * scale, torch.sin(theta) * scale
    # M = R·S·Shear: [[cos, cos*k - sin], [sin, sin*k + cos]]
    m00, m01 = cos, cos * shear - sin
    m10, m11 = sin, sin * shear + cos

    dev = gen.device
    gy = (torch.arange(h, dtype=torch.float32, device=dev)[:, None]
          - (h - 1) / 2.0)
    gx = (torch.arange(w, dtype=torch.float32, device=dev)[None, :]
          - (w - 1) / 2.0)
    # flow = (M - I)(p - c) + t
    u = (m00[:, None, None] - 1.0) * gx + m01[:, None, None] * gy
    v = m10[:, None, None] * gx + (m11[:, None, None] - 1.0) * gy
    flo = torch.stack([u, v], dim=-1) + shift[:, None, None, :]

    amp = _uniform(gen, (b, 1, 1, 2), 0.0, pert_amp)
    coarse = _uniform(gen, (b, h // 64 + 2, w // 64 + 2, 2), -1.0, 1.0)
    flo = flo + amp * resize_bilinear(coarse, (h, w))
    return torch.clamp(flo, -max_disp, max_disp)


@torch.no_grad()
def synthetic_flow_batch(gen: torch.Generator, b: int, h: int, w: int,
                         max_disp: float = 24.0):
    """One training batch on ``gen``'s device.

    Returns (ims_u8 (B, H, W, 6) uint8, flo (B, H, W, 2) float32):
    channels 0-2 = prv, 3-5 = nxt, with prv = backward_warp(nxt, flo).
    Texture and flow are made with a max_disp margin on every side and
    center-cropped, so every kept prv pixel samples real texture rather
    than the border clamp.
    """
    pad = int(max_disp + 1)
    hp, wp = h + 2 * pad, w + 2 * pad
    nxt_p = random_texture(gen, b, hp, wp)
    flo_p = random_flow_field(gen, b, hp, wp, max_disp=max_disp)
    prv_p = backward_warp(nxt_p, flo_p)
    sl = (slice(None), slice(pad, pad + h), slice(pad, pad + w))
    ims = torch.cat([prv_p[sl], nxt_p[sl]], dim=-1)
    ims_u8 = torch.clamp(torch.round(ims * 255.0), 0, 255).to(torch.uint8)
    return ims_u8, flo_p[sl].contiguous()


def stream_seed(*parts: int) -> int:
    """A generator seed for one batch of one stream, so that batch i of a
    stream is the same whatever came before it."""
    s = 0
    for p in parts:
        s = (s * 1_000_003 + p) % (2 ** 63 - 1)
    return s


def triplet_frames(nxt_p: torch.Tensor, flo_p: torch.Tensor, h: int,
                   w: int, pad: int):
    """The deterministic part of :func:`synthetic_triplet_batch`: from a
    padded texture nxt_p (B, h+2pad, w+2pad, 3) and flow flo_p, the
    uint8 frames (prv, mid, nxt), each (B, h, w, 3), with
    prv = backward_warp(nxt, flo) and mid = backward_warp(nxt, flo / 2),
    center-cropped by ``pad``."""
    prv_p = backward_warp(nxt_p, flo_p)
    mid_p = backward_warp(nxt_p, flo_p * 0.5)
    sl = (slice(None), slice(pad, pad + h), slice(pad, pad + w))

    def u8(x):
        return torch.clamp(torch.round(x[sl] * 255.0), 0, 255).to(
            torch.uint8)

    return u8(prv_p), u8(mid_p), u8(nxt_p)


@torch.no_grad()
def synthetic_triplet_batch(gen: torch.Generator, b: int, h: int, w: int,
                            max_disp: float = 24.0):
    """One frame-interpolation pretraining triplet batch on ``gen``'s
    device: (prv, mid, nxt) uint8 (B, H, W, 3) each, under
    constant-velocity motion (flo the forward flow prv -> nxt, mid the
    half-flow warp), with the same pad-and-crop as
    :func:`synthetic_flow_batch`."""
    pad = int(max_disp + 1)
    hp, wp = h + 2 * pad, w + 2 * pad
    nxt_p = random_texture(gen, b, hp, wp)
    flo_p = random_flow_field(gen, b, hp, wp, max_disp=max_disp)
    return triplet_frames(nxt_p, flo_p, h, w, pad)


def zero_baseline_epe(flo: torch.Tensor) -> torch.Tensor:
    """EPE of the predict-zero-flow baseline on this batch."""
    return torch.mean(torch.linalg.vector_norm(flo, dim=-1))
