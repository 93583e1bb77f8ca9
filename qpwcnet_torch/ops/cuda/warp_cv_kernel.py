"""K3: fused warp + correlate as a CUDA kernel (``csrc/warp_cv.cu``,
``csrc/correlate.cuh``).

Replaces: ``qpwcnet_tpu/ops/pallas/warp_cv_kernel.py:_wcv_kernel`` (via
``warp_cost_volume_pallas``).

Computes ``cost_volume(prv, backward_warp(nxt, clamp(flow, ±ww)))``
without writing the warped map: the identity of the JAX kernel
(``warp_cv_kernel.py:27-31``), with the flow clamp to ``±warp_window``
kept.

What bounds it on the H100: the unfused pair writes and re-reads the
warped (B, H, W, C) map and pays the plain cost volume's 81 passes. The
kernel gathers each window position's four corners from nxt into shared
memory (true per-pixel addressing; the TPU's (2w+2)² masked taps are not
needed on a GPU) and correlates as K1 does. Its cost is the gather,
repeated for the 8-row/8-column halo of each 8x32 tile (2.5x), plus
K1's shared-memory-bound correlation loop.
"""

from __future__ import annotations

import torch

from qpwcnet_torch.ops.cost_volume import cost_volume_plain
from qpwcnet_torch.ops.cuda import _build
from qpwcnet_torch.ops.cuda.cost_volume_kernel import SEARCH_RANGE
from qpwcnet_torch.ops.warp import backward_warp, clip_balanced

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


def warp_cost_volume_cuda(prv: torch.Tensor, nxt: torch.Tensor,
                          flow: torch.Tensor, search_range: int = 4,
                          warp_window: int = FUSED_WARP_WINDOW
                          ) -> torch.Tensor:
    """Fused warp + cost volume. prv, nxt: (B, H, W, C); flow: (B, H, W, 2)
    float32 in (x, y) order -> (B, H, W, 81) in prv's dtype.

    CPU tensors take :func:`warp_cost_volume_plain`; CUDA tensors launch
    the kernel or raise.
    """
    if not prv.is_cuda:
        return warp_cost_volume_plain(prv, nxt, flow, search_range,
                                      warp_window)
    if search_range != SEARCH_RANGE:
        raise ValueError(f"the CUDA warp+cost volume is built for "
                         f"search_range={SEARCH_RANGE}, got {search_range}")
    b, h, w, c = prv.shape
    if h < 2 or w < 2:
        raise ValueError(f"warp+cost volume needs H, W >= 2, got {(h, w)}")
    _build.require(prv, "prv")
    _build.require(nxt, "nxt", prv.shape, prv.dtype, prv.device)
    _build.require(flow, "flow", (b, h, w, 2), torch.float32, prv.device)
    d = 2 * search_range + 1
    out = torch.empty((b, h, w, d * d), dtype=prv.dtype, device=prv.device)
    lib = _build.library()
    with _build.on_device(prv.device):
        err = lib.qpw_warp_cost_volume(
            prv.data_ptr(), nxt.data_ptr(), flow.data_ptr(), out.data_ptr(),
            b, h, w, c, float(warp_window), _build.dtype_code(prv.dtype),
            _build.stream_ptr(prv.device))
    _build.check(err, "qpw_warp_cost_volume")
    warp_cost_volume_cuda.launches += 1
    return out


warp_cost_volume_cuda.launches = 0


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
