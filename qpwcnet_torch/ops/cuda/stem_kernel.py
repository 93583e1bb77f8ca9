"""K2: one fused encoder DownConv stage as a CUDA kernel (``csrc/stem.cu``).

Replaces: ``qpwcnet_tpu/ops/pallas/stem_kernel.py:_stem_kernel`` (via
``_stage_impl`` / ``downconv_stage_pallas``).

Computes Conv3x3/s2 SAME + bias + Mish -> Conv3x3 + bias + Mish ->
Conv3x3 + bias + Mish in one launch, NHWC in and out.

What bounds it on the H100: unfused, each of the three convs writes its
full-resolution map (C = 16 or 32 channels at 224x512 or 112x256 per
image at the headline) and the next conv and the Mish read it back, so the
stem is bounded by device-memory traffic of its intermediates. The kernel
keeps both intermediates in shared memory for a 16x16 output tile
(recomputing a 2- and 1-pixel halo), so it reads the input and writes the
output once; it is then bounded by its CUDA-core FMAs and shared-memory
reads (no tensor cores yet). The TPU kernel's space-to-depth phase input,
flat lane-padded layout and validity masks are not needed: a thread
indexes x[2i+dy, 2j+dx] directly and zeroes out-of-image halo positions.
"""

from __future__ import annotations

from typing import Sequence

import torch

from qpwcnet_torch.ops.activations import mish
from qpwcnet_torch.ops.cuda import _build
from qpwcnet_torch.quantize.qlayers import conv2d_same

# Output channel counts the kernel is compiled for (encoder stages 0, 1).
STEM_CHANNELS = (16, 32)

Params = Sequence[tuple[torch.Tensor, torch.Tensor]]


def _check_even(x: torch.Tensor) -> None:
    _, h, w, _ = x.shape
    if h % 2 or w % 2:
        raise ValueError(
            f"a fused DownConv stage needs even H and W, got {(h, w)}; with "
            f"stem_stages=n the model input needs H and W divisible by 2**n")


def downconv_stage_plain(x: torch.Tensor, params: Params,
                         dtype: torch.dtype) -> torch.Tensor:
    """The unfused composition: three QConv-equivalent convs in ``dtype``.

    x: (B, H, W, Cin) NHWC; params: [(weight OIHW, bias)] for conv_a,
    conv_aa, conv_b (float32 parameters, cast to ``dtype``).
    Returns (B, H/2, W/2, Cout) NHWC.
    """
    _check_even(x)
    y = x.to(dtype).permute(0, 3, 1, 2)
    for k, (weight, bias) in enumerate(params):
        y = conv2d_same(y, weight.to(dtype), stride=2 if k == 0 else 1)
        y = mish(y + bias.to(dtype)[:, None, None])
    return y.permute(0, 2, 3, 1).contiguous()


def downconv_stage_cuda(x: torch.Tensor, params: Params,
                        dtype: torch.dtype) -> torch.Tensor:
    """Fused DownConv stage. x: (B, H, W, Cin) NHWC in ``dtype``, H and W
    even -> (B, H/2, W/2, Cout) NHWC.

    CPU tensors take :func:`downconv_stage_plain`; CUDA tensors launch the
    kernel or raise.
    """
    if not x.is_cuda:
        return downconv_stage_plain(x, params, dtype)
    _check_even(x)
    b, h, w, c_in = x.shape
    c_out = params[0][0].shape[0]
    if c_out not in STEM_CHANNELS:
        raise ValueError(f"the CUDA stem kernel is built for {STEM_CHANNELS}"
                         f" output channels, got {c_out}")
    _build.require(x, "x", dtype=dtype)
    # Weights as [ci][ky][kx][co] in the compute dtype.
    args = []
    for weight, bias in params:
        args += [weight.to(dtype).permute(1, 2, 3, 0).contiguous(),
                 bias.to(dtype).contiguous()]
    for i, t in enumerate(args):
        _build.require(t, f"param {i}", device=x.device)
    out = torch.empty((b, h // 2, w // 2, c_out), dtype=dtype,
                      device=x.device)
    lib = _build.library()
    with _build.on_device(x.device):
        err = lib.qpw_downconv_stage(
            x.data_ptr(), *(t.data_ptr() for t in args), out.data_ptr(),
            b, h, w, c_in, c_out, _build.dtype_code(dtype),
            _build.stream_ptr(x.device))
    _build.check(err, "qpw_downconv_stage")
    downconv_stage_cuda.launches += 1
    return out


downconv_stage_cuda.launches = 0


class _TrainableStage(torch.autograd.Function):
    """Forward: K2 (:func:`downconv_stage_cuda`). Backward: the gradients
    of the unfused composition :func:`downconv_stage_plain`, recomputed
    from the saved inputs (``stem_kernel.py:_trainable_stage``)."""

    @staticmethod
    def forward(ctx, x, dtype, *flat_params):
        ctx.dtype = dtype
        ctx.save_for_backward(x, *flat_params)
        return downconv_stage_cuda(x, _pairs(flat_params), dtype)

    @staticmethod
    def backward(ctx, g):
        x, *flat = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in
                      zip([x, *flat], [ctx.needs_input_grad[0],
                                       *ctx.needs_input_grad[2:]])]
            y = downconv_stage_plain(leaves[0], _pairs(leaves[1:]),
                                     ctx.dtype)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g))
        return (next(grads) if leaves[0].requires_grad else None, None,
                *(next(grads) if t.requires_grad else None
                  for t in leaves[1:]))


def _pairs(flat):
    return [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]


def downconv_stage_trainable(x: torch.Tensor, params: Params,
                             dtype: torch.dtype) -> torch.Tensor:
    """:func:`downconv_stage_cuda` with gradients for x and the
    parameters: the fused kernel forward, the unfused composition's
    backward (recomputed), as ``downconv_stage_trainable`` of the JAX
    package."""
    return _TrainableStage.apply(x, dtype, *(t for p in params for t in p))
