"""Adaptive Gradient Clipping and the NaN-gradient scrub (port of
qpwcnet_tpu/train/agc.py), applied in place to a model's ``.grad``.

Unit-wise norms follow the JAX package's rule, which reads Flax's HWIO
kernels: rank <= 1 takes the whole-tensor norm; a rank-4 kernel takes one
norm per output channel over its other axes. In the port's layouts the
output channel is dim 0 of an OIHW conv weight and of a (C, 1, kh, kw)
depthwise weight, but dim 1 of the (I, O, kh, kw) transpose-conv weight
(``conv_up``), so the norms run over dims (1, 2, 3) and (0, 2, 3).

grad' = grad * max_norm / max(||g||, 1e-6) where
max_norm = clip_factor * max(||p||, eps), applied only where
||g|| >= max_norm.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from qpwcnet_torch.quantize.qlayers import QConvTranspose


def _unitwise_norm(x: torch.Tensor, out_dim: int) -> torch.Tensor:
    x = x.float()
    if x.ndim <= 1:
        return torch.sqrt(torch.sum(torch.square(x)))
    if x.ndim == 4:
        dims = tuple(d for d in range(4) if d != out_dim)
        return torch.sqrt(torch.sum(torch.square(x), dim=dims, keepdim=True))
    raise ValueError(f"AGC: unsupported param rank {x.ndim}")


def _named_leaves(model: nn.Module):
    """(name, parameter, output-channel dim) of every parameter."""
    for mod_name, module in model.named_modules():
        for p_name, p in module.named_parameters(recurse=False):
            out_dim = (1 if isinstance(module, QConvTranspose)
                       and p_name == "weight" else 0)
            yield (f"{mod_name}.{p_name}" if mod_name else p_name), p, out_dim


@torch.no_grad()
def adaptive_clip_grads(model: nn.Module, clip_factor: float = 0.01,
                        eps: float = 1e-3, exclude: Sequence[str] = ()
                        ) -> None:
    """Unit-wise AGC of every parameter's ``.grad``, in place.

    exclude: names whose parameters are not clipped when one of them is a
    substring of a part of the parameter's name (the flow heads,
    'of_flow', under the default optimizer)."""
    for name, p, out_dim in _named_leaves(model):
        g = p.grad
        if g is None or any(e in part for e in exclude
                            for part in name.split(".")):
            continue
        p_norm = _unitwise_norm(p, out_dim)
        g_norm = _unitwise_norm(g, out_dim)
        max_norm = torch.clamp(p_norm, min=eps) * clip_factor
        clipped = g * (max_norm / torch.clamp(g_norm, min=1e-6)).to(g.dtype)
        g.copy_(torch.where(g_norm < max_norm, g, clipped))


@torch.no_grad()
def zero_nan_grads(model: nn.Module) -> None:
    """Replace NaN gradient entries with zeros, in place."""
    for p in model.parameters():
        if p.grad is not None:
            p.grad.masked_fill_(torch.isnan(p.grad), 0.0)
