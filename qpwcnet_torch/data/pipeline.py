"""Batch preprocessing (port of the no-augmentation path of
qpwcnet_tpu/data/pipeline.py:preprocess_flow_batch).

Augmentation (``data/augment.py``) waits for ROADMAP queue-1 item 8.
"""

from __future__ import annotations

import torch

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
