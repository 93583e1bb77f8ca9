"""K5: one fused decoder UpConv stage as a CUDA kernel (``csrc/upconv.cu``).

Replaces: ``qpwcnet_tpu/ops/pallas/upconv_kernel.py:_upconv_kernel`` (via
``_upconv_impl`` / ``upconv_stage_pallas``).

Computes ConvTranspose 4x4/s2 'SAME' + bias + Mish in one launch, NHWC
in and out: (B, H, W, Ci) -> (B, 2H, 2W, Co), Co in {16, 32} (decoder
stages 2 and 3: 128 -> 32 and 64 -> 16 channels).

What bounds it on the H100: the work is 4·Ci multiply-adds per output
value (4 taps of each phase); the bytes are the input read once and the
output written once (17-117 MB at the training and headline shapes in
bf16). At bf16 tensor-core rates it would be bound by those bytes (5-35
µs); on CUDA cores (67 TFLOP/s float32) the FMAs bound it, several times
above that. Unfused, the transpose conv writes its
(B, 2H, 2W, Co) map, and the bias add and Mish's eight elementwise passes
read and write it again. The kernel computes only the 4 of 9 taps each
output phase reads (the TPU kernel's zero-padded 9-tap phase matrices
do 2.25x the work), keeps each lane's 4 positions x Co sums in
registers, stages the input with its 1-pixel halo and the weights (read
in their stored float32 (Ci, Co, 4, 4) layout, so a call launches nothing
but the kernel) in shared memory one 16-channel chunk at a time, and
writes each output
pixel once, straight to (2i+r, 2j+s): the TPU's phase-major output, its
interleave transpose, its lane padding and its validity masks are not
needed. Tensor cores are later work.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from qpwcnet_torch.layout import nchw, nhwc
from qpwcnet_torch.ops.activations import mish
from qpwcnet_torch.ops.cuda import _build

# Output channel counts the kernel is compiled for (decoder stages 2, 3).
UPCONV_CHANNELS = (16, 32)

Params = Sequence[tuple[torch.Tensor, torch.Tensor]]


def upconv_stage_plain(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The unfused composition, as ``QConvTranspose(act=mish)`` computes it:
    ``F.conv_transpose2d(stride=2, padding=1)`` + bias + Mish in ``dtype``.

    x: (B, H, W, Ci) NHWC; weight (Ci, Co, 4, 4) (the stored, spatially
    flipped transpose-conv weight) and bias (Co,), float32 parameters cast
    to ``dtype``. Returns (B, 2H, 2W, Co) NHWC.
    """
    y = F.conv_transpose2d(nchw(x.to(dtype)), weight.to(dtype), stride=2,
                           padding=1)
    y = mish(y + bias.to(dtype)[:, None, None])
    return nhwc(y).contiguous()


def upconv_stage_cuda(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Fused UpConv stage. x: (B, H, W, Ci) NHWC in ``dtype`` ->
    (B, 2H, 2W, Co) NHWC.

    CPU tensors take :func:`upconv_stage_plain`; CUDA tensors launch the
    kernel or raise.
    """
    if not x.is_cuda:
        return upconv_stage_plain(x, weight, bias, dtype)
    if x.ndim != 4:
        raise ValueError(f"x must be (B, H, W, Ci), got {tuple(x.shape)}")
    b, h, w, c_in = x.shape
    if weight.shape[0] != c_in or tuple(weight.shape[2:]) != (4, 4):
        raise ValueError(f"weight {tuple(weight.shape)} is not a (Ci={c_in},"
                         f" Co, 4, 4) transpose-conv weight")
    c_out = weight.shape[1]
    if c_out not in UPCONV_CHANNELS:
        raise ValueError(f"the CUDA upconv kernel is built for "
                         f"{UPCONV_CHANNELS} output channels, got {c_out}")
    _build.require(x, "x", dtype=dtype)
    # The kernel reads the stored layout in float32 and rounds to dtype
    # itself: no copy for float32 parameters.
    wt, bt = weight.float(), bias.float()
    _build.require(wt, "weight", device=x.device)
    _build.require(bt, "bias", (c_out,), device=x.device)
    out = torch.empty((b, 2 * h, 2 * w, c_out), dtype=dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.qpw_upconv_stage(
            x.data_ptr(), wt.data_ptr(), bt.data_ptr(), out.data_ptr(),
            b, h, w, c_in, c_out, _build.dtype_code(dtype),
            _build.stream_ptr(x.device))
    _build.check(err, "qpw_upconv_stage")
    upconv_stage_cuda.launches += 1
    return out


upconv_stage_cuda.launches = 0


class _TrainableUpConv(torch.autograd.Function):
    """Forward: K5 (:func:`upconv_stage_cuda`). Backward: the gradients of
    the unfused composition :func:`upconv_stage_plain`, recomputed from
    the saved inputs (``upconv_kernel.py:_trainable_upconv``); the JAX
    package has no backward kernel for K5."""

    @staticmethod
    def forward(ctx, x, weight, bias, dtype):
        ctx.dtype = dtype
        ctx.save_for_backward(x, weight, bias)
        return upconv_stage_cuda(x, weight, bias, dtype)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(saved, ctx.needs_input_grad[:3])]
            y = upconv_stage_plain(*leaves, ctx.dtype)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in leaves),
                None)


def upconv_stage_trainable(x: torch.Tensor, params: Params,
                           dtype: torch.dtype) -> torch.Tensor:
    """:func:`upconv_stage_cuda` with gradients for x and the parameters:
    the fused kernel forward, the unfused composition's backward
    (recomputed), as ``upconv_stage_trainable`` of the JAX package.

    params: [(weight, bias)] of the stage's conv_up, as
    ``UpConv.params()`` gives them (the argument form of
    ``downconv_stage_trainable``)."""
    ((weight, bias),) = params
    return _TrainableUpConv.apply(x, weight, bias, dtype)
