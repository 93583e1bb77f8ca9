"""True int8 inference (port of qpwcnet_tpu/quantize/int8.py): the conv
arithmetic runs int8 x int8 -> int32 and is dequantized by (input scale x
per-output-channel weight scale); :func:`convert_to_int8` and the
``.npz`` bundle are the deployment artifact.

The int32 accumulation is exact, so any exact formulation gives JAX's
int32 result. Here a dense or transpose conv is an im2col of the int8
input (NHWC, taps then channels) times the int8 (kh·kw·Ci, Co) kernel:
``torch._int_mm`` (cuBLASLt's int8 GEMM) on the card, an int32 matmul on
the CPU. A depthwise conv is kh·kw shifted int32 multiply-adds. The
transpose conv is JAX's input-dilated conv with the un-flipped HWIO
kernel and SAME's dilated padding.

Under an H-sharded mesh (qpwcnet_torch.parallel) the input is one
shard's rows: H takes the SAME padding of the whole image, filled with
the neighbouring shards' int8 codes (``parallel/transport.py:halo_rows``)
and with zeros only at the global ends, as the float convs do
(``ops/conv.py:conv2d_same``), so each shard's int32 rows are the
unsharded conv's. The scales are replicated, so nothing else crosses
shards.

The bundle keeps JAX's ``.npz`` layout: one entry per conv and field,
``<flax path>::kernel_i8`` (int8 HWIO, the per-input-channel scales
folded in), ``::w_scale`` (float32 (1, 1, 1, Co)), ``::in_amax`` (float64
0-d, or a float32 per-input-channel vector) and ``::bias``, in the Flax
tree's order, so either package reads what the other wrote.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from qpwcnet_torch.layout import nchw, nhwc
from qpwcnet_torch.ops.conv import same_pads
from qpwcnet_torch.parallel.transport import active_shards, halo_rows
from qpwcnet_torch.quantize.qtensor import QTensor

# torch._int_mm on the card takes more than 16 rows and inner and output
# dims that are multiples of 8. With both operands row-major (cuBLASLt's
# NN int8 GEMM) cuBLASLt refused every row count from 17 to 129 that is
# no multiple of 32 at N >= 32 (CUBLAS_STATUS_NOT_SUPPORTED, H100, torch
# 2.11); with the second one column-major (the TN GEMM) it took them all,
# so the kernel matrix goes column-major
INT_MM_MIN_ROWS = 17
INT_MM_ALIGN = 8


def quantize_tensor(x: torch.Tensor, scale: torch.Tensor,
                    qmax: float = 127.0) -> torch.Tensor:
    """float32 -> int8 with a symmetric scale (0-d or broadcastable); a
    zero scale quantizes with 1."""
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.clamp(torch.round(x / safe), -qmax - 1, qmax).to(torch.int8)


def hwio_kernel(weight: torch.Tensor, transpose: bool = False
                ) -> torch.Tensor:
    """The port's stored kernel in JAX's HWIO layout: OIHW and the
    depthwise (C, 1, kh, kw) permuted; the transpose conv's flipped
    (I, O, kh, kw) weight un-flipped (JAX's conv_transpose kernel)."""
    if transpose:
        return weight.flip(2, 3).permute(2, 3, 0, 1)
    return weight.permute(2, 3, 1, 0)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x int8 (K, N) -> the exact int32 (M, N) product:
    ``torch._int_mm`` on the card, with K and N padded with zeros to
    multiples of 8 and M to at least INT_MM_MIN_ROWS, b column-major; an
    int32 matmul on the CPU."""
    if a.device.type != "cuda":
        return a.int() @ b.int()
    m, k = a.shape
    n = b.shape[1]

    def up(v):
        return -(-v // INT_MM_ALIGN) * INT_MM_ALIGN

    kp, np_, mp = up(k), up(n), max(m, INT_MM_MIN_ROWS)
    if (mp, kp) != (m, k) or not a.is_contiguous():
        a = F.pad(a, (0, kp - k, 0, mp - m))
    b_cm = F.pad(b.t(), (0, kp - k, 0, np_ - n)).contiguous().t()
    out = torch._int_mm(a, b_cm)
    return out[:m, :n] if (mp, np_) != (m, n) else out


def _im2col_conv(xq: torch.Tensor, kq: torch.Tensor, stride: int,
                 pads: tuple) -> torch.Tensor:
    """int8 NHWC x int8 HWIO -> int32 NHWC, a correlation with ``pads``
    ((top, bottom), (left, right)) of zeros and ``stride``."""
    kh, kw, ci, co = kq.shape
    (pt, pb), (pl, pr) = pads
    if pt or pb or pl or pr:
        xq = F.pad(xq, (0, 0, pl, pr, pt, pb))
    b, hp, wp, _ = xq.shape
    ho, wo = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    if kh == kw == 1 and stride == 1:
        cols = xq.reshape(b * ho * wo, ci)
    else:
        taps = [xq[:, dy:dy + (ho - 1) * stride + 1:stride,
                   dx:dx + (wo - 1) * stride + 1:stride]
                for dy in range(kh) for dx in range(kw)]
        cols = torch.stack(taps, dim=3).reshape(b * ho * wo, kh * kw * ci)
    y = int8_matmul(cols, kq.reshape(kh * kw * ci, co).contiguous())
    return y.view(b, ho, wo, co)


def _depthwise_conv(xq: torch.Tensor, kq: torch.Tensor,
                    pads: tuple) -> torch.Tensor:
    """int8 NHWC x int8 (kh, kw, 1, C) -> int32 NHWC, stride 1, with
    ``pads`` ((top, bottom), (left, right)) of zeros: kh·kw shifted int32
    multiply-adds."""
    kh, kw = kq.shape[:2]
    (pt, pb), (pl, pr) = pads
    xp = F.pad(xq, (0, 0, pl, pr, pt, pb))
    h, w = xp.shape[1] - kh + 1, xp.shape[2] - kw + 1
    k32 = kq.int()
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            term = xp[:, dy:dy + h, dx:dx + w].int() * k32[dy, dx, 0]
            acc = term if acc is None else acc.add_(term)
    return acc


def int8_conv_apply(x: Union[torch.Tensor, QTensor], weight: torch.Tensor,
                    in_amax: Optional[torch.Tensor], stride: int = 1,
                    groups: int = 1, transpose: bool = False,
                    qmax: float = 127.0) -> torch.Tensor:
    """A conv in int8 x int8 -> int32, dequantized to float32 NCHW.

    x: an NCHW float tensor, quantized here with ``in_amax`` (the QAT
    input absmax: 0-d, or a per-input-channel vector for the convs that
    take a heterogeneous concat, whose channel scales fold into the
    float kernel before it is quantized: conv(q·s[c], w) = conv(q, w·s[c])),
    or a :class:`QTensor` from the producing conv (its scale is the input
    scale). weight: the stored float kernel (OIHW; depthwise (C, 1, kh,
    kw) with ``groups`` = C; transpose (I, O, 4, 4) flipped, stride 2).
    Bias and activation are the caller's.
    """
    kernel = hwio_kernel(weight.float(), transpose)
    if isinstance(x, QTensor):
        xq, s_in = nhwc(x.q), x.scale
    else:
        xf = nhwc(x).float()
        if in_amax is not None and in_amax.ndim == 1:
            s_vec = (in_amax / qmax).float()
            s_vec = torch.where(s_vec > 0, s_vec, torch.ones_like(s_vec))
            xq = quantize_tensor(xf, s_vec, qmax)
            if kernel.shape[2] == 1 and groups == xf.shape[-1]:
                kernel = kernel * s_vec  # depthwise: the last axis
            else:
                kernel = kernel * s_vec[:, None]
            s_in = torch.ones((), dtype=torch.float32, device=xf.device)
        else:
            s_in = (in_amax / qmax).float()
            xq = quantize_tensor(xf, s_in, qmax)
    w_amax = torch.amax(kernel.abs(), dim=(0, 1, 2), keepdim=True)
    s_w = (w_amax / qmax).float()
    kq = quantize_tensor(kernel, s_w, qmax)
    y = int8_conv_int32(xq, kq, stride, groups, transpose)
    return nchw(y.float() * (s_in * s_w.reshape(1, 1, 1, -1)))


def _shard_rows(xq: torch.Tensor, kh: int, stride: int) -> tuple:
    """Under an H-sharded mesh: xq (a shard's rows) with the whole image's
    SAME H padding taken from the neighbouring shards (zeros at the
    global ends; stride 2 on an even H: (0, 1)), and the H pads left to
    apply, (0, 0). Without one: xq and the shard's own SAME pads."""
    shards = active_shards()
    h = xq.shape[1]
    if shards is None:
        return xq, same_pads(h, kh, stride)
    if h % stride:
        raise ValueError(f"an H shard of {h} rows does not split by the "
                         f"conv's stride {stride}")
    pt, pb = same_pads(h * shards.n, kh, stride)
    return halo_rows(xq, 1, pt, pb), (0, 0)


def int8_conv_int32(xq: torch.Tensor, kq: torch.Tensor, stride: int = 1,
                    groups: int = 1, transpose: bool = False
                    ) -> torch.Tensor:
    """The exact int32 accumulation of an int8 NHWC input and an int8
    HWIO kernel, NHWC: JAX's ``conv_general_dilated(...,
    preferred_element_type=int32)`` with SAME padding (``groups`` = C:
    depthwise; ``transpose``: the input-dilated spelling of
    conv_transpose). Under an H-sharded mesh xq is a shard's rows and so
    is the result (module docstring)."""
    kh, kw = kq.shape[:2]
    if transpose:
        # conv_transpose as an input-dilated conv (JAX's SAME padding of
        # the dilated input; k = 4, s = 2: two rows/columns a side).
        # Sharded, output rows 2i - 2 .. 2i + 1 read input row i: the
        # shard takes one input row of each neighbour and keeps its 2h
        # output rows
        sharded = active_shards() is not None
        h = xq.shape[1]
        if sharded:
            xq = halo_rows(xq, 1, 1, 1)
        b, hi, w, c = xq.shape
        dil = xq.new_zeros((b, (hi - 1) * stride + 1, (w - 1) * stride + 1,
                            c))
        dil[:, ::stride, ::stride] = xq
        pads = []
        for k in (kh, kw):
            pad_len = k + stride - 2
            pad_a = k - 1 if stride > k - 1 else -(-pad_len // 2)
            pads.append((pad_a, pad_len - pad_a))
        y = _im2col_conv(dil, kq, 1, tuple(pads))
        return y.narrow(1, stride, stride * h) if sharded else y
    xq, h_pads = _shard_rows(xq, kh, stride)
    w_pads = same_pads(xq.shape[2], kw, stride)
    if groups > 1:
        if not (groups == xq.shape[-1] == kq.shape[-1] and kq.shape[2] == 1
                and stride == 1):
            raise ValueError("int8 grouped convs are depthwise, stride 1")
        return _depthwise_conv(xq, kq, (h_pads, w_pads))
    return _im2col_conv(xq, kq, stride, (h_pads, w_pads))


class Int8Conv:
    """A materialized int8 conv of the bundle: the int8 HWIO kernel, its
    per-output-channel scales, the float32 bias and the input range (a
    float, or a per-input-channel vector already folded into the kernel
    and scales)."""

    def __init__(self, kernel_i8: np.ndarray, w_scale: np.ndarray,
                 bias: Optional[np.ndarray], in_amax):
        self.kernel_i8 = kernel_i8
        self.w_scale = w_scale
        self.bias = bias
        self.in_amax = in_amax


def _conv_modules(model: nn.Module):
    """(Flax path, module) of every conv of ``model``, in the Flax
    tree's (sorted) order."""
    from qpwcnet_torch.models.from_flax import _flax_path
    from qpwcnet_torch.quantize.qlayers import QuantConv

    convs = [(_flax_path(model, f"{name}.weight")[:-1], m)
             for name, m in model.named_modules()
             if isinstance(m, QuantConv)]
    return sorted(convs, key=lambda c: c[0])


def convert_to_int8(model: nn.Module, qmax: float = 127.0) -> dict:
    """Every conv kernel of ``model`` as int8 with per-channel scales,
    paired with its QAT input range (0 where the model has none), in
    JAX's numpy arithmetic: ``{flax path: Int8Conv}``, serializable with
    :func:`save_int8_bundle`."""
    out = {}
    for path, m in _conv_modules(model):
        kernel = hwio_kernel(m.weight.detach().float().cpu(),
                             m.TRANSPOSE).numpy()
        amax = getattr(m, "amax_in", None)
        in_amax = (np.float32(0.0) if amax is None
                   else amax.detach().cpu().numpy())
        if np.ndim(in_amax) == 1:
            s_vec = np.where(in_amax > 0, in_amax / qmax, 1.0)
            if kernel.shape[2] == 1:  # depthwise
                kernel = kernel * s_vec[None, None, None, :]
            else:
                kernel = kernel * s_vec[None, None, :, None]
        w_amax = np.max(np.abs(kernel), axis=(0, 1, 2), keepdims=True)
        w_scale = np.where(w_amax > 0, w_amax / qmax, 1.0)
        k_q = np.clip(np.round(kernel / w_scale), -qmax - 1,
                      qmax).astype(np.int8)
        bias = None if m.bias is None else \
            m.bias.detach().float().cpu().numpy()
        out["/".join(path)] = Int8Conv(
            k_q, w_scale.astype(np.float32), bias,
            (np.asarray(in_amax, np.float32) if np.ndim(in_amax)
             else float(in_amax)))
    return out


def save_int8_bundle(path, bundle: dict) -> None:
    """Write an int8 bundle to one .npz (the deployment artifact)."""
    arrays = {}
    for name, conv in bundle.items():
        arrays[f"{name}::kernel_i8"] = conv.kernel_i8
        arrays[f"{name}::w_scale"] = conv.w_scale
        arrays[f"{name}::in_amax"] = np.asarray(conv.in_amax)
        if conv.bias is not None:
            arrays[f"{name}::bias"] = conv.bias
    np.savez_compressed(path, **arrays)


def load_int8_bundle(path) -> dict:
    """Read a bundle written by :func:`save_int8_bundle` or by the JAX
    package's: ``{flax path: Int8Conv}``, sorted by path."""
    with np.load(path) as data:
        names = sorted({k.split("::")[0] for k in data.files})
        out = {}
        for name in names:
            bias_key = f"{name}::bias"
            in_amax = data[f"{name}::in_amax"]
            out[name] = Int8Conv(
                data[f"{name}::kernel_i8"], data[f"{name}::w_scale"],
                data[bias_key] if bias_key in data.files else None,
                in_amax if in_amax.ndim else float(in_amax))
    return out
