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

Gradients are those of the JAX op's custom VJP (``warp.py:199-232``):
``d_img`` by four weighted scatter-adds over flattened HW, ``d_flow`` by
differentiating the forward with respect to the flow, where the weight
clip takes JAX's gradient at its bounds (:func:`clip_balanced`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class _ClipBalanced(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        inside = ((x > lo) & (x < hi)).to(g.dtype)
        tie = ((x == lo) | (x == hi)).to(g.dtype)
        return g * (inside + 0.5 * tie), None, None


def clip_balanced(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``torch.clamp(x, lo, hi)`` with the gradient of ``jnp.clip``: 1
    strictly inside (lo, hi), 0.5 at lo or hi, 0 outside.

    ``jnp.clip`` is a maximum then a minimum, and JAX splits the gradient
    of a tie between the two operands; ``torch.clamp`` passes all of it.
    The warp's weights sit exactly on a bound wherever the sample
    position is an integer, which is every pixel at zero flow.
    """
    return _ClipBalanced.apply(x, lo, hi)


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
    ax = clip_balanced(qx - x0, 0.0, 1.0)
    ay = clip_balanced(qy - y0, 0.0, 1.0)
    return x0, y0, ax, ay


def _edge_pad(img: torch.Tensor) -> torch.Tensor:
    """Degenerate 1-pixel dims: edge-pad so the 2x2 corner block fits;
    border-clamped sampling is unchanged."""
    _, hi, wi, _ = img.shape
    if hi >= 2 and wi >= 2:
        return img
    return F.pad(img.permute(0, 3, 1, 2),
                 (0, max(0, 2 - wi), 0, max(0, 2 - hi)),
                 mode="replicate").permute(0, 2, 3, 1)


def _warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    b, _, _, c = img.shape
    _, h, w, _ = flow.shape
    img = _edge_pad(img)
    hp, wp = img.shape[1], img.shape[2]

    x0, y0, ax, ay = warp_coords(flow.float(), hp, wp)
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


def _scatter_rows(n: int, idx: list, terms: list) -> torch.Tensor:
    """An (n, C) map in the terms' dtype whose row r sums every
    ``terms[k][i]`` with ``idx[k][i] == r``, the same from run to run on
    either device:
      * CPU tensors: ``index_add_`` of each list entry in turn, in the
        terms' dtype (bf16 adds for bf16), each summing in index order.
      * CUDA tensors: one ``index_put_(accumulate=True)`` of all the terms
        into a float32 map, rounded once to the terms' dtype. PyTorch runs
        it on the card as a stable sort by destination and a segmented
        sum, so each row's terms are added in one fixed order (list, then
        index). ``index_add_`` there is a scatter of atomics whose order,
        and so whose bf16 rounding, changes between runs.
    """
    dtype, device = terms[0].dtype, terms[0].device
    if device.type == "cuda":
        acc = torch.zeros((n, terms[0].shape[1]), dtype=torch.float32,
                          device=device)
        acc.index_put_((torch.cat(idx),), torch.cat(terms).float(),
                       accumulate=True)
        return acc.to(dtype)
    acc = torch.zeros((n, terms[0].shape[1]), dtype=dtype, device=device)
    for i, t in zip(idx, terms):
        acc.index_add_(0, i, t)
    return acc


def _warp_img_grad(img: torch.Tensor, flow: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """d_img of ``_warp_bwd_impl``: the four corner weights times g (each
    term rounded to g's dtype), scatter-added over flattened HW
    (:func:`_scatter_rows`), then the gradient of the 1-pixel edge padding
    folded back onto the edge pixels."""
    b, hi, wi, c = img.shape
    _, h, w, _ = flow.shape
    hp, wp = max(hi, 2), max(wi, 2)
    x0, y0, ax, ay = warp_coords(flow.float(), hp, wp)
    base = (torch.arange(b, device=g.device)[:, None] * (hp * wp)
            + (y0.long() * wp + x0.long()).reshape(b, h * w))
    gf = g.reshape(b, h * w, c)
    ax = ax.reshape(b, h * w, 1).to(g.dtype)
    ay = ay.reshape(b, h * w, 1).to(g.dtype)
    idx, terms = [], []
    for dy in (0, 1):
        wy = ay if dy else 1.0 - ay
        for dx in (0, 1):
            wgt = wy * (ax if dx else 1.0 - ax)
            idx.append((base + dy * wp + dx).reshape(-1))
            terms.append((wgt * gf).reshape(-1, c))
    d_img = _scatter_rows(b * hp * wp, idx, terms).reshape(b, hp, wp, c)
    if hp != hi:
        d_img = torch.cat([d_img[:, :hi - 1],
                           d_img[:, hi - 1:].sum(1, keepdim=True)], 1)
    if wp != wi:
        d_img = torch.cat([d_img[:, :, :wi - 1],
                           d_img[:, :, wi - 1:].sum(2, keepdim=True)], 2)
    return d_img.to(img.dtype)


class _BackwardWarp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, flow):
        ctx.save_for_backward(img, flow)
        return _warp(img, flow)

    @staticmethod
    def backward(ctx, g):
        img, flow = ctx.saved_tensors
        d_img = d_flow = None
        if ctx.needs_input_grad[1]:
            with torch.enable_grad():
                f = flow.detach().requires_grad_()
                (d_flow,) = torch.autograd.grad(_warp(img.detach(), f), f, g)
        if ctx.needs_input_grad[0]:
            d_img = _warp_img_grad(img, flow, g)
        return d_img, d_flow


def backward_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward bilinear warp.

    Args:
      img: (B, H, W, C) source image/features.
      flow: (B, H, W, 2) flow in (x, y) channel order.

    Returns:
      (B, H, W, C) in img's dtype: ``out[b,i,j] = img[b, i + flow_y,
      j + flow_x]``, border-clamped and bilinearly interpolated.
    """
    return _BackwardWarp.apply(img, flow)
