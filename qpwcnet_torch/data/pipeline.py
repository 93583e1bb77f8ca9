"""Batch preprocessing (port of qpwcnet_tpu/data/pipeline.py:
``preprocess_flow_batch`` without augmentation, and
``preprocess_triplet_batch``).

The flow augmentation (flips, scale-and-crop, colour) waits for ROADMAP
queue 1, data; the triplet augmentation is ``data/augment.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from qpwcnet_torch.data.augment import augment_triplet_batch
from qpwcnet_torch.ops.resize import resize_bilinear


def _nan_scrub(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(x), torch.zeros_like(x), x)


def _resize_pair(ims: torch.Tensor, flo: torch.Tensor, out_hw):
    """Resize images and flow to out_hw, rescaling the flow per axis."""
    h, w = ims.shape[1], ims.shape[2]
    oh, ow = out_hw
    ims_r = resize_bilinear(ims, out_hw)
    flo_r = resize_bilinear(flo, out_hw)
    scale = torch.tensor([ow / w, oh / h], dtype=flo_r.dtype,
                         device=flo_r.device)
    return ims_r, flo_r * scale


def preprocess_flow_batch(ims_u8: torch.Tensor, flo: torch.Tensor,
                          out_hw=(256, 512)) -> dict:
    """uint8 (B, H, W, 6) + flow (B, H, W, 2) -> {'ims': float32 in
    [-0.5, 0.5] at out_hw, 'flo': float32}: /255, resize, -0.5, NaN
    scrub (the JAX function with augment=False)."""
    ims = ims_u8.float() * (1.0 / 255.0)
    ims, flo = _resize_pair(ims, flo.float(), tuple(out_hw))
    ims = ims - 0.5
    return {"ims": _nan_scrub(ims), "flo": _nan_scrub(flo)}


def preprocess_triplet_batch(gen: Optional[torch.Generator],
                             a_u8: torch.Tensor, b_u8: torch.Tensor,
                             c_u8: torch.Tensor,
                             augment: bool = True) -> dict:
    """uint8 triplet (B, H, W, 3) x3 -> {'ims': concat[frame0, frame2] -
    0.5, 'mid': frame1 - 0.5}, with the triplet-consistent augmentation
    drawn from ``gen`` when ``augment`` (``gen`` may be None otherwise)."""
    a, b, c = (t.float() * (1.0 / 255.0) for t in (a_u8, b_u8, c_u8))
    if augment:
        a, b, c = augment_triplet_batch(gen, a, b, c)
    return {"ims": torch.cat([a, c], dim=-1) - 0.5, "mid": b - 0.5}
