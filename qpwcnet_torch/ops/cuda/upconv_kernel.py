"""K5: one fused decoder UpConv stage as a CUDA kernel (``csrc/upconv.cu``).

Replaces: ``qpwcnet_tpu/ops/pallas/upconv_kernel.py:_upconv_kernel`` (via
``_upconv_impl`` / ``upconv_stage_pallas``).

Computes ConvTranspose 4x4/s2 'SAME' + bias + Mish in one launch, NHWC
in and out: (B, H, W, Ci) -> (B, 2H, 2W, Co), Co in {16, 32, 64, 128}
(decoder stages 3, 2, 1 and 0: 64 -> 16, 128 -> 32, 256 -> 64 and
256 -> 128 channels).

What bounds it on the H100: per input position, 4 phases x 4 taps x Ci
x Co multiply-adds against 2·Ci bytes in and 8·Co bytes out (256
operations a byte at 128 -> 32, 128 at 64 -> 16). On the bf16 tensor
cores that is below the card's ridge point (~295), so the bytes bound it
(the input read once and the output written once: 5-35 µs at the
training and headline shapes); on the CUDA cores the multiply-adds
would, over ten times higher. Unfused, the transpose conv writes its
(B, 2H, 2W, Co) map, and the bias add and Mish's eight elementwise
passes read and write it again.

Both bodies compute only the 4 of 9 taps each output phase reads (the
TPU kernel's zero-padded 9-tap phase matrices do 2.25x the work), read
the weight and bias in their stored float32 layout (so a call launches
nothing but the kernel) and write each output pixel once: the TPU's
phase-major output, its interleave transpose, its lane padding and its
validity masks are not needed.

- bfloat16: an implicit GEMM per output phase on the tensor cores
  (mma.sync m16n8k16, bf16 operands, float32 sums). Each block rounds
  its phases' weights to bf16 into shared memory once ([tap][co][ci],
  136 KB at 128 -> 32; the two blocks of a cluster stage them together)
  and walks tiles of 4 x 16 input positions (8 x 16 at Co = 16) with a
  persistent grid. Its 16 warps form two groups that take turns on the
  tensor cores: while one computes its tile's products, the other
  copies its next haloed tile with cp.async and runs its epilogue,
  storing straight from registers. At batch 1 a block takes two phases,
  so the tiles cover the SMs. The resident weights and the two groups'
  tiles must fit in 227 KB of shared memory: Ci <= 144 at Co = 32 and
  Ci <= 176 at Co = 16.
- float32: multiply-adds on the CUDA cores (TF32 would break the 1e-5
  equality with the plain version), each lane 4 positions x Co sums in
  registers, input and weights through shared memory 16 channels at a
  time.
- The wide stages (Co 64 and 128 at Ci 256, decoder stages 0-1, both
  dtypes): the resident bf16 weights would be 0.5-1.1 MB, two to five
  times a block's shared memory, and a lane's Co sums no longer fit in
  registers. They run the implicit GEMM of ``csrc/conv_gemm.cuh``
  (wgmma fed by TMA in bf16, CUDA cores in float32), the four output
  phases' tiles in one persistent launch, M = input positions, N = Co, K
  = the phase's 4 taps x Ci streamed through shared memory in channel
  slices, bias + Mish in the epilogue. A small kernel first rounds the
  weight into the GEMM's per-phase layout, in a scratch buffer the
  wrapper allocates: two device kernels a launch. The bf16 GEMM reads
  inputs of a multiple of 32 channels at a 16-byte-aligned address; for
  any other input the wrapper first makes an aligned, channel-padded copy
  of x and pads the weight with zeros to match (two more device kernels:
  ``conv_gemm.tma_padded``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from qpwcnet_torch.layout import nchw, nhwc
from qpwcnet_torch.ops.cuda import _build, conv_gemm, mish_kernel
from qpwcnet_torch.utils import tracing

# Output channel counts the kernel is compiled for: every stage of the
# decoder (models/pwcnet.py:DECODER_FILTERS).
UPCONV_CHANNELS = (16, 32, 64, 128)
# Of those, the widths run as the implicit GEMM of csrc/conv_gemm.cuh.
UPCONV_GEMM_CHANNELS = (64, 128)
# The largest Ci of the bf16 body by Co: its resident weights and its two
# warp groups' input tiles fill the block's 227 KB of shared memory
# (csrc/upconv.cu:um_smem_bytes). None: the GEMM streams any Ci.
UPCONV_MAX_CI_BF16 = {16: 176, 32: 144, 64: None, 128: None}

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
    return nhwc(mish_kernel.bias_mish_cuda(y, bias)).contiguous()


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
    cap = UPCONV_MAX_CI_BF16[c_out]
    if dtype == torch.bfloat16 and cap is not None and c_in > cap:
        raise ValueError(f"the bf16 upconv kernel takes at most "
                         f"{UPCONV_MAX_CI_BF16[c_out]} input channels at "
                         f"Co={c_out}, got {c_in}")
    _build.require(x, "x", dtype=dtype)
    # The kernel reads the stored layout in float32 and rounds to dtype
    # itself: no copy for float32 parameters.
    wt, bt = weight.float(), bias.float()
    _build.require(wt, "weight", device=x.device)
    _build.require(bt, "bias", (c_out,), device=x.device)
    gemm = c_out in UPCONV_GEMM_CHANNELS
    if gemm and dtype == torch.bfloat16:
        x, wt = conv_gemm.tma_input(x, wt, 0)
        c_in = x.shape[-1]
    out = x.new_empty((b, 2 * h, 2 * w, c_out))
    # the wide stages' weights in the GEMM's layout: 4 phases x 4 taps
    wbuf = x.new_empty(16 * c_out * _build.gemm_cip(c_in)) if gemm else None
    lib = _build.library()
    with _build.on_device(x.device):
        err = lib.qpw_upconv_stage(
            x.data_ptr(), wt.data_ptr(), bt.data_ptr(), out.data_ptr(),
            None if wbuf is None else wbuf.data_ptr(),
            b, h, w, c_in, c_out, _build.dtype_code(dtype),
            _build.stream_ptr(x.device))
    _build.check(err, "qpw_upconv_stage")
    tracing.count("launches.upconv_stage_cuda")
    return out


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
