"""The conv epilogue bias + Mish as hand-written CUDA kernels
(``csrc/bias_mish.cu``): one forward launch, and a backward that also
gives the bias gradient (two launches: the pass, and the sum of its
per-block bias sums).

Replaces no TPU kernel: XLA fuses the JAX package's bias add and Mish
into the conv. Eager PyTorch runs the composition (:func:`bias_mish_plain`)
as ~14 launches forward and ~22 backward, most of them on float32
copies, after every Mish conv that runs in PyTorch on the card
(``quantize/qlayers.py:QuantConv`` with ``act=mish``, and the plain
stages that K2's and K5's backwards recompute).

What bounds it on the H100: bytes, 4 an element forward and 6 backward
in bf16. Both kernels read and write each tensor once, 16 bytes a
thread. The forward equals the composition bit for bit; the backward
computes ``g * (f + y f')`` in float32 and rounds once to the input
dtype (:func:`bias_mish_backward_plain`), and the bias gradient is
summed in float32 in an order that depends on the shape alone.

The kernels take a logical NCHW tensor of float32 or bfloat16 with at
most ``MAX_CHANNELS`` channels in ``channels_last`` memory (``layout.py``;
the channel is the innermost index); the launchers copy one in another
layout to it first. The forward kernel is the op ``qpwcnet::bias_mish``
(``torch.library``, with a fake implementation) inside an autograd
Function, as K1 is, so ``torch.export`` keeps it in the program it
traces and the loaded program runs the kernel (a loaded program needs
this module imported first, to register the op). The op is defined with
``torch.library.Library``: the ``custom_op`` decorator costs ~10 us more
host time a call. Every caller reaches it through :func:`bias_mish_cuda`
looked up on this module (``mish_kernel.bias_mish_cuda``), so one
assignment there swaps the kernels for the composition everywhere.
"""

from __future__ import annotations

from typing import Optional

import torch

from qpwcnet_torch.ops.activations import mish
from qpwcnet_torch.ops.cuda import _build
from qpwcnet_torch.utils import tracing

MAX_CHANNELS = 1024
# csrc/bias_mish.cu:kMaxBwdBlocks: the backward's blocks, each writing C
# float32 bias sums into the wrapper's scratch
BWD_MAX_BLOCKS = 1024


def bias_mish_plain(x: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The composition: ``mish(x + bias.to(x.dtype)[:, None, None])`` on a
    logical NCHW x (``mish(x)`` without a bias)."""
    if bias is not None:
        x = x + bias.to(x.dtype)[:, None, None]
    return mish(x)


def bias_mish_backward_plain(x: torch.Tensor, bias: Optional[torch.Tensor],
                             g: torch.Tensor):
    """What the backward kernel computes, in PyTorch: from the pre-bias x,
    the bias and the incoming gradient g, ``(dx, dbias)``.

    y = x + bias rounded to x's dtype as the forward does; then in
    float32 ``v = g (f(y) + y f'(y))`` with ``f = tanh(softplus(y))``,
    ``f' = 4t(t + 1) / (t² + 2t + 2)²``, ``t = e^y``, and ``v = g`` above
    20 (where the composition's factor is the constant 1). dx is v rounded
    to x's dtype; dbias (float32, None without a bias) sums v over N, H
    and W.
    """
    y = x if bias is None else x + bias.to(x.dtype)[:, None, None]
    y, gf = y.float(), g.float()
    t = torch.exp(torch.clamp(y, max=20.0))
    tt = t * t + 2.0 * t
    d = tt + 2.0
    v = gf * (tt / d + y * (4.0 * t * (t + 1.0) / (d * d)))
    v = torch.where(y > 20.0, gf, v)
    return v.to(x.dtype), None if bias is None else v.sum((0, 2, 3))


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def _require(x: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    if not (x.is_cuda and x.dtype in (torch.float32, torch.bfloat16)
            and x.ndim == 4 and 0 < x.shape[1] <= MAX_CHANNELS
            and x.numel() > 0
            and (bias is None or (bias.shape == (x.shape[1],)
                                  and bias.device == x.device))):
        raise ValueError(
            f"the bias + Mish kernels take a float32 or bfloat16 (B, C, H, "
            f"W) card tensor with 1..{MAX_CHANNELS} channels and a (C,) "
            f"bias on its device; got {x.dtype} {tuple(x.shape)} on "
            f"{x.device}" + ("" if bias is None else
                              f", bias {tuple(bias.shape)} on {bias.device}"))


def _bias_f32(bias: Optional[torch.Tensor]):
    return None if bias is None else bias.float().contiguous()


def _launch_fwd(x: torch.Tensor, bias: Optional[torch.Tensor]
                ) -> torch.Tensor:
    _require(x, bias)
    x = _channels_last(x)
    out = torch.empty_like(x)
    b = _bias_f32(bias)
    lib = _build.library()
    with _build.on_device(x.device):
        err = lib.qpw_bias_mish(
            x.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), x.numel(), x.shape[1],
            _build.dtype_code(x.dtype), _build.stream_ptr(x.device))
    _build.check(err, "qpw_bias_mish")
    tracing.count("launches.bias_mish_cuda")
    return out


def _launch_bwd(x: torch.Tensor, bias: Optional[torch.Tensor],
                g: torch.Tensor, need_dbias: bool):
    """(dx, dbias) from the kernels; dbias float32, None unless
    ``need_dbias``."""
    _require(x, bias)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"g {g.dtype} {tuple(g.shape)} does not match x "
                         f"{x.dtype} {tuple(x.shape)}")
    x, g = _channels_last(x), _channels_last(g)
    c = x.shape[1]
    dx = torch.empty_like(x)
    b = _bias_f32(bias)
    need = need_dbias and b is not None
    dbias = x.new_empty((c,), dtype=torch.float32) if need else None
    partial = (x.new_empty((BWD_MAX_BLOCKS * c,), dtype=torch.float32)
               if need else None)
    lib = _build.library()
    with _build.on_device(x.device):
        err = lib.qpw_bias_mish_bwd(
            x.data_ptr(), None if b is None else b.data_ptr(), g.data_ptr(),
            dx.data_ptr(), None if partial is None else partial.data_ptr(),
            None if dbias is None else dbias.data_ptr(), x.numel() // c, c,
            _build.dtype_code(x.dtype), _build.stream_ptr(x.device))
    _build.check(err, "qpw_bias_mish_bwd")
    tracing.count("launches.bias_mish_bwd_cuda")
    return dx, dbias


# The forward kernel as the op qpwcnet::bias_mish, on every backend (the
# dispatch below sends only card tensors to it), with a fake
# implementation for tracing; counts the launch on bias_mish_cuda.
_LIB = torch.library.Library("qpwcnet", "FRAGMENT")
_LIB.define("bias_mish(Tensor x, Tensor? bias) -> Tensor")
_LIB.impl("bias_mish", lambda x, bias: _launch_fwd(x, bias),
          "CompositeExplicitAutograd")


@torch.library.register_fake("qpwcnet::bias_mish", lib=_LIB)
def _bias_mish_fake(x, bias):
    return torch.empty_like(x, memory_format=torch.channels_last)


class _BiasMish(torch.autograd.Function):
    """Forward: the op. Backward: the backward kernels, from the saved
    pre-bias x and the bias alone."""

    @staticmethod
    def forward(ctx, x, bias):
        ctx.save_for_backward(x, bias)
        return torch.ops.qpwcnet.bias_mish(x, bias)

    @staticmethod
    def backward(ctx, g):
        x, bias = ctx.saved_tensors
        need_dbias = bias is not None and ctx.needs_input_grad[1]
        dx, dbias = _launch_bwd(x, bias, g, need_dbias)
        return dx, dbias.to(bias.dtype) if need_dbias else None


def bias_mish_cuda(x: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``mish(x + bias.to(x.dtype)[:, None, None])`` on a logical NCHW x,
    trainable in x and the bias: the conv epilogue of every Mish conv.

    CPU tensors take :func:`bias_mish_plain` and its autograd; card
    tensors run the op ``qpwcnet::bias_mish`` (the forward kernel), and
    the backward kernels from the saved x and bias alone, or raise.
    """
    if not x.is_cuda:
        return bias_mish_plain(x, bias)
    return _BiasMish.apply(x, bias)


def bias_mish_bwd_cuda(x: torch.Tensor, bias: Optional[torch.Tensor],
                       g: torch.Tensor):
    """Backward: ``(dx, dbias)`` from the pre-bias x, the bias and g, as
    :func:`bias_mish_backward_plain` states it (dbias None without a
    bias).

    CPU tensors take :func:`bias_mish_backward_plain`; card tensors launch
    the kernels or raise.
    """
    if not x.is_cuda:
        return bias_mish_backward_plain(x, bias, g)
    return _launch_bwd(x, bias, g, bias is not None)
