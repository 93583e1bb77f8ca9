"""K2: one fused encoder DownConv stage as a CUDA kernel (``csrc/stem.cu``).

Replaces: ``qpwcnet_tpu/ops/pallas/stem_kernel.py:_stem_kernel`` (via
``_stage_impl`` / ``downconv_stage_pallas``).

Computes Conv3x3/s2 SAME + bias + Mish -> Conv3x3 + bias + Mish ->
Conv3x3 + bias + Mish in one launch, NHWC in and out.

What bounds it on the H100: unfused, each of the three convs writes its
full-resolution map and the bias add and Mish's elementwise passes read
and write it again. The kernel keeps both intermediates in shared memory
for an output tile (recomputing a 2- and a 1-pixel halo), so it reads the
input and writes the output once: the bytes bound it. As built, the
three convs' Mish epilogues (halos included), the products and the
staging each take a quarter to a half of its time, and they add up
(PERF.md).
Both bodies read the weights and biases in their stored float32 layout
(so a call launches nothing but the kernel); the TPU kernel's
space-to-depth phase input, flat lane-padded layout and validity masks
are not needed.

- bfloat16: an implicit GEMM per conv on the tensor cores (mma.sync
  m16n8k16, bf16 operands, float32 sums, ldmatrix operands), the input
  tile staged with cp.async and the intermediates in shared memory as
  [y][x][c]; a persistent grid whose blocks keep the weights. Built for
  Co 16 and 32; the staged input tile caps Ci (``STEM_MAX_CI_BF16``)
  except for Ci <= 4, the RGB input, whose three taps of a kernel row are
  one k16 step.
- float32: CUDA-core multiply-adds (TF32 would break the 1e-5 equality
  with the plain version), one thread all Co sums of a position, built
  for Co 16 and 32.
- The wide stages (Co 64, 128 and 256, encoder stages 2-4, both
  dtypes): one conv's weights outgrow a block's shared memory (1.2 MB in
  bf16 at 256 -> 256), and a fused tile small enough to keep both
  intermediates would recompute conv_a on 4x and conv_aa on 2.25x its
  outputs (at Co 64 it restaged each conv's 83 KB of weights for every
  tile). So each conv is one implicit GEMM launch (``csrc/conv_gemm.cuh``:
  wgmma fed by TMA in bf16, CUDA cores in float32) with bias + Mish in
  its epilogue, the weights streamed through shared memory in channel
  slices of a tap, and the two intermediates in device memory (a
  wrapper-allocated scratch map and the output itself; at stage 4 they
  stay in L2). The weights are rounded into the GEMM's layout by a small
  kernel first, in a second scratch buffer. One wrapper call is one
  launch of K2, as the TPU's stage is one ``pallas_call``; on the card it
  is four device kernels. The bf16 GEMM reads inputs of a multiple of 32
  channels at a 16-byte-aligned address; for any other input the
  wrapper first makes an aligned, channel-padded copy of x and pads
  conv_a's weight with zeros to match (two more device kernels:
  ``conv_gemm.tma_padded``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from qpwcnet_torch.ops.conv import conv2d_same
from qpwcnet_torch.ops.cuda import _build, conv_gemm, mish_kernel
from qpwcnet_torch.utils import tracing

# Output channel counts each dtype is compiled for: every width of the
# encoder (models/pwcnet.py:ENCODER_FILTERS).
STEM_CHANNELS = {torch.float32: (16, 32, 64, 128, 256),
                 torch.bfloat16: (16, 32, 64, 128, 256)}
# Of those, the widths run as one implicit GEMM a conv (csrc/conv_gemm.cuh).
STEM_GEMM_CHANNELS = {torch.float32: (64, 128, 256),
                      torch.bfloat16: (64, 128, 256)}
# The largest Ci > 4 of the bf16 body by Co: the fused tile's staged
# input, the two intermediates and the weights fill the block's 227 KB of
# shared memory (csrc/stem.cu:StemCfg::smem); Ci <= 4 always fits. None:
# the GEMM streams any Ci.
STEM_MAX_CI_BF16 = {16: 32, 32: 16, 64: None, 128: None, 256: None}

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
        y = mish_kernel.bias_mish_cuda(y, bias)
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
    built = STEM_CHANNELS.get(dtype, ())
    if c_out not in built:
        raise ValueError(f"the {dtype} CUDA stem kernel is built for {built}"
                         f" output channels, got {c_out}")
    cap = STEM_MAX_CI_BF16[c_out]
    if dtype == torch.bfloat16 and cap is not None and c_in > cap:
        raise ValueError(f"the bf16 stem kernel takes at most "
                         f"{STEM_MAX_CI_BF16[c_out]} input channels (or at "
                         f"most 4) at Co={c_out}, got {c_in}")
    _build.require(x, "x", dtype=dtype)
    # The kernel reads the stored float32 layout (OIHW weights) and rounds
    # to dtype itself: no copy for float32 parameters.
    args = []
    for k, (weight, bias) in enumerate(params):
        wt, bt = weight.float(), bias.float()
        _build.require(wt, f"weight {k}", (c_out, c_in if k == 0 else c_out,
                                           3, 3), device=x.device)
        _build.require(bt, f"bias {k}", (c_out,), device=x.device)
        args += [wt, bt]
    gemm = c_out in STEM_GEMM_CHANNELS[dtype]
    if gemm and dtype == torch.bfloat16:
        x, args[0] = conv_gemm.tma_input(x, args[0], 1)
        c_in = x.shape[-1]
    out = torch.empty((b, h // 2, w // 2, c_out), dtype=dtype,
                      device=x.device)
    wbuf = tmp = None
    if gemm:
        # the three convs' weights in the GEMM's layout, and conv_aa's
        # output (conv_a's goes into `out`, which conv_b overwrites)
        wbuf = torch.empty(9 * c_out * (_build.gemm_cip(c_in) + 2 * c_out),
                           dtype=dtype, device=x.device)
        tmp = torch.empty_like(out)
    lib = _build.library()
    with _build.on_device(x.device):
        err = lib.qpw_downconv_stage(
            x.data_ptr(), *(t.data_ptr() for t in args), out.data_ptr(),
            *(None if t is None else t.data_ptr() for t in (wbuf, tmp)),
            b, h, w, c_in, c_out, _build.dtype_code(dtype),
            _build.stream_ptr(x.device))
    _build.check(err, "qpw_downconv_stage")
    tracing.count("launches.downconv_stage_cuda")
    return out


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
