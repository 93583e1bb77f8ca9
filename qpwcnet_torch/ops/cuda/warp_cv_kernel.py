"""K3: fused warp + correlate as a CUDA kernel (``csrc/warp_cv.cu``;
bf16 on the tensor cores with ``csrc/cv_mma.cuh``, float32 on the CUDA
cores with ``csrc/correlate.cuh``).

Replaces: ``qpwcnet_tpu/ops/pallas/warp_cv_kernel.py:_wcv_kernel`` (via
``warp_cost_volume_pallas``).

Computes ``cost_volume(prv, backward_warp(nxt, clamp(flow, ±ww)))``
without writing the warped map: the identity of the JAX kernel
(``warp_cv_kernel.py:27-31``), with the flow clamp to ``±warp_window``
kept.

What bounds it on the H100: bytes, as the cost volume's (K1); the
unfused pair writes and re-reads the warped (B, H, W, C) map. The bf16
body is K1's banded tensor-core body with the haloed window built by a
gather: per window pixel the corner origin and weights from the flow at
that pixel, then per 8-channel segment the four corners' 16-byte loads
and the bilinear interpolation at the plain version's bf16 rounding
points, stored into the window's shared-memory rows (true per-pixel
addressing; the TPU's (2w+2)² masked taps are not needed on a GPU). The
float32 body is the CUDA-core ``correlate_kernel<float, true>``.

The launch is the custom op ``qpwcnet::warp_cost_volume`` (CUDA only),
with a fake implementation and a flop formula, as K1's
``qpwcnet::cost_volume``.
"""

from __future__ import annotations

import torch

from qpwcnet_torch.ops.cost_volume import cost_volume_plain
from qpwcnet_torch.ops.cuda import _build
from qpwcnet_torch.ops.cuda.cost_volume_kernel import N_DISP, SEARCH_RANGE
from qpwcnet_torch.ops.warp import backward_warp, clip_balanced
from qpwcnet_torch.utils import tracing
from torch.utils.flop_counter import register_flop_formula

# Window of the model's cv_impl='fused' inference path
# (models/blocks.py:UpFlowBlock), as in the JAX package.
FUSED_WARP_WINDOW = 4


def warp_cost_volume_plain(prv: torch.Tensor, nxt: torch.Tensor,
                           flow: torch.Tensor, search_range: int = 4,
                           warp_window: int = FUSED_WARP_WINDOW
                           ) -> torch.Tensor:
    """The unfused composition the kernel computes."""
    ww = float(warp_window)
    nxt_w = backward_warp(nxt, clip_balanced(flow.float(), -ww, ww))
    return cost_volume_plain(prv, nxt_w, search_range=search_range)


@torch.library.custom_op("qpwcnet::warp_cost_volume", mutates_args=(),
                         device_types="cuda")
def warp_cost_volume_op(prv: torch.Tensor, nxt: torch.Tensor,
                        flow: torch.Tensor, warp_window: float
                        ) -> torch.Tensor:
    """K3 on card tensors, search range 4; counts the launch on
    :func:`warp_cost_volume_cuda`."""
    b, h, w, c = prv.shape
    _build.require(prv, "prv")
    _build.require(nxt, "nxt", prv.shape, prv.dtype, prv.device)
    _build.require(flow, "flow", (b, h, w, 2), torch.float32, prv.device)
    out = torch.empty((b, h, w, N_DISP), dtype=prv.dtype, device=prv.device)
    lib = _build.library()
    with _build.on_device(prv.device):
        err = lib.qpw_warp_cost_volume(
            prv.data_ptr(), nxt.data_ptr(), flow.data_ptr(), out.data_ptr(),
            b, h, w, c, float(warp_window), _build.dtype_code(prv.dtype),
            _build.stream_ptr(prv.device))
    _build.check(err, "qpw_warp_cost_volume")
    tracing.count("launches.warp_cost_volume_cuda")
    return out


@warp_cost_volume_op.register_fake
def _warp_cost_volume_fake(prv, nxt, flow, warp_window):
    b, h, w, _ = prv.shape
    return prv.new_empty((b, h, w, N_DISP))


@register_flop_formula(torch.ops.qpwcnet.warp_cost_volume)
def warp_cost_volume_flops(prv_shape, nxt_shape, flow_shape, *args,
                           out_shape=None, **kwargs) -> int:
    """The correlation's products and sums, K1's 2·81·C·B·H·W (the
    counter counts products, not the warp's elementwise lerp)."""
    b, h, w, c = prv_shape
    return 2 * N_DISP * c * b * h * w


def warp_cost_volume_cuda(prv: torch.Tensor, nxt: torch.Tensor,
                          flow: torch.Tensor, search_range: int = 4,
                          warp_window: int = FUSED_WARP_WINDOW
                          ) -> torch.Tensor:
    """Fused warp + cost volume. prv, nxt: (B, H, W, C); flow: (B, H, W, 2)
    float32 in (x, y) order -> (B, H, W, 81) in prv's dtype.

    CPU tensors take :func:`warp_cost_volume_plain`; CUDA tensors launch
    the kernel (the op ``qpwcnet::warp_cost_volume``) or raise.
    """
    if not prv.is_cuda:
        return warp_cost_volume_plain(prv, nxt, flow, search_range,
                                      warp_window)
    if search_range != SEARCH_RANGE:
        raise ValueError(f"the CUDA warp+cost volume is built for "
                         f"search_range={SEARCH_RANGE}, got {search_range}")
    h, w = prv.shape[1:3]
    if h < 2 or w < 2:
        raise ValueError(f"warp+cost volume needs H, W >= 2, got {(h, w)}")
    return torch.ops.qpwcnet.warp_cost_volume(prv, nxt, flow,
                                              float(warp_window))


class _TrainableWarpCostVolume(torch.autograd.Function):
    """Forward: K3 (:func:`warp_cost_volume_cuda`). Backward: recompute
    ``CostVolumeFunction(prv, backward_warp(nxt, clip(flow, ±ww)))`` and
    differentiate it (``warp_cv_kernel.py:_trainable_fused``): on CUDA
    tensors that launches K1 once, then K4a and K4b."""

    @staticmethod
    def forward(ctx, prv, nxt, flow, warp_window):
        ctx.warp_window = warp_window
        ctx.save_for_backward(prv, nxt, flow)
        return warp_cost_volume_cuda(prv, nxt, flow,
                                     warp_window=warp_window)

    @staticmethod
    def backward(ctx, g):
        from qpwcnet_torch.ops.cost_volume import CostVolumeFunction

        ww = float(ctx.warp_window)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in
                      zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
            prv, nxt, flow = leaves
            cost = CostVolumeFunction.apply(
                prv, backward_warp(nxt, clip_balanced(flow, -ww, ww)))
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(cost, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in leaves),
                None)


def warp_cost_volume_trainable(prv: torch.Tensor, nxt: torch.Tensor,
                               flow: torch.Tensor,
                               warp_window: int = FUSED_WARP_WINDOW
                               ) -> torch.Tensor:
    """:func:`warp_cost_volume_cuda` with gradients for prv, nxt and flow:
    the fused kernel forward, the unfused composition's backward
    (recomputed), as ``warp_cost_volume_trainable`` of the JAX package."""
    return _TrainableWarpCostVolume.apply(prv, nxt, flow, warp_window)
