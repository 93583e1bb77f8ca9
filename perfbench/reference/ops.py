"""The plain operations of the PWC-Net family in float32 PyTorch, NCHW.

A frozen copy of what the measured package's plain paths compute, kept
apart from it so that a change to the program cannot move the yardstick:
XLA 'SAME' convolutions, the 4x4/s2 transpose convolution, Mish, Flax's
BatchNorm, the 81-offset cost volume, the border-clamped backward warp,
the half-pixel bilinear resizes and the 2x2 average pool.

Every function takes float32 NCHW tensors (flows as (B, 2, H, W) in
(x, y) order) and is differentiated by autograd. Nothing here imports
the measured package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA 'SAME' padding (before, after) of one spatial dim: the output
    is ceil(size / s) and an odd total puts the extra pixel after."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                groups: int = 1) -> torch.Tensor:
    """Convolution with 'SAME' padding; w is OIHW."""
    kh, kw = w.shape[-2:]
    pt, pb = same_pads(x.shape[2], kh, stride)
    pl, pr = same_pads(x.shape[3], kw, stride)
    return F.conv2d(F.pad(x, (pl, pr, pt, pb)), w, stride=stride,
                    groups=groups)


def conv_transpose_up2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 4x4/s2 'SAME' transpose convolution (output 2H x 2W); w is the
    stored (I, O, 4, 4) kernel."""
    return F.conv_transpose2d(x, w, stride=2, padding=1)


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)) in its single-exp form, t = e^x:
    tanh(ln(1 + t)) = (t^2 + 2t) / (t^2 + 2t + 2), exactly 1 above 20."""
    t = torch.exp(torch.clamp(x, max=20.0))
    tt = t * t + 2.0 * t
    return x * torch.where(x > 20.0, 1.0, tt / (tt + 2.0))


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor,
               training: bool, momentum: float = 0.99,
               eps: float = 1e-3) -> torch.Tensor:
    """Flax BatchNorm: in training the batch mean and the biased variance
    E[x^2] - E[x]^2 clipped at 0, and the running statistics updated in
    place as momentum * running + (1 - momentum) * batch."""
    if training:
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            running_mean.mul_(momentum).add_((1.0 - momentum) * mean)
            running_var.mul_(momentum).add_((1.0 - momentum) * var)
    else:
        mean, var = running_mean, running_var
    mul = torch.rsqrt(var + eps) * weight
    return (x - mean[:, None, None]) * mul[:, None, None] \
        + bias[:, None, None]


def cost_volume(prv: torch.Tensor, nxt: torch.Tensor,
                r: int = 4) -> torch.Tensor:
    """out[:, k, i, j] = leaky_relu_0.1(mean_c prv[:, c, i, j] *
    nxt[:, c, i + di, j + dj]), k = (di + r)(2r + 1) + (dj + r), nxt zero
    outside the image. (B, C, H, W) twice -> (B, (2r+1)^2, H, W)."""
    d = 2 * r + 1
    _, c, h, w = prv.shape
    pad = F.pad(nxt, (r, r, r, r))
    costs = [torch.sum(prv * pad[:, :, i:i + h, j:j + w], dim=1) / c
             for i in range(d) for j in range(d)]
    return F.leaky_relu(torch.stack(costs, dim=1), 0.1)


class _ClipBalanced(torch.autograd.Function):
    """clamp with jnp.clip's gradient: 1 inside, 0.5 on a bound, 0
    outside."""

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


def backward_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """out[:, :, i, j] = img[:, :, i + flow_y, j + flow_x], bilinear, the
    corner origin clamped to [0, size - 2] and the weights to [0, 1].
    img (B, C, Hi, Wi) with Hi, Wi >= 2; flow (B, 2, H, W)."""
    b, c, hi, wi = img.shape
    _, _, h, w = flow.shape
    if hi < 2 or wi < 2:
        raise ValueError(f"warp source {hi}x{wi} is under 2x2")
    gy = torch.arange(h, dtype=flow.dtype, device=flow.device)[:, None]
    gx = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, :]
    qx = gx + flow[:, 0]
    qy = gy + flow[:, 1]
    x0 = torch.clamp(torch.floor(qx), 0.0, wi - 2.0).nan_to_num(nan=0.0)
    y0 = torch.clamp(torch.floor(qy), 0.0, hi - 2.0).nan_to_num(nan=0.0)
    ax = _ClipBalanced.apply(qx - x0, 0.0, 1.0)[:, None]
    ay = _ClipBalanced.apply(qy - y0, 0.0, 1.0)[:, None]
    base = (y0.long() * wi + x0.long()).reshape(b, 1, h * w)
    flat = img.reshape(b, c, hi * wi)

    def corner(off):
        idx = (base + off).expand(b, c, h * w)
        return torch.gather(flat, 2, idx).reshape(b, c, h, w)

    g00, g01, g10, g11 = corner(0), corner(1), corner(wi), corner(wi + 1)
    top = g00 + (g01 - g00) * ax
    bot = g10 + (g11 - g10) * ax
    return top + (bot - top) * ay


def upsample2x(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """2x bilinear upsampling, half-pixel centres, times ``scale``."""
    y = F.interpolate(x, scale_factor=2.0, mode="bilinear",
                      align_corners=False)
    return y * scale if scale != 1.0 else y


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean pool of even-sized maps."""
    b, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"avg_pool_2x takes even sizes, got {h}x{w}")
    return x.reshape(b, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Half-pixel bilinear resize, antialiased when downsampling
    (jax.image.resize); the identity at the input's own size."""
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False, antialias=True)


def block_mean(x: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """Block-mean pooling by integer factors."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h // sh, sh, w // sw, sw).mean(dim=(3, 5))


class _RoundFP8(torch.autograd.Function):
    """Per-tensor scaled float8 e4m3 rounding (scale = absmax / 448) in
    the forward; the gradient passes through unchanged."""

    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax()
        scale = torch.where(amax > 0, amax / 448.0, 1.0)
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x as a float8 e4m3 tensor with one scale would hold it."""
    return _RoundFP8.apply(x)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, in float32."""
    return x.to(torch.bfloat16).to(x.dtype)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


# what each precision rounds the operands of a convolution or a cost
# volume to, before the float32 arithmetic
ROUNDINGS = {"float32": identity, "bf16": round_bf16, "fp8": round_fp8}
