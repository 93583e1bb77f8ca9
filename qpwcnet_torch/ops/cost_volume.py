"""Cost-volume correlation (port of qpwcnet_tpu/ops/cost_volume.py).

With search range ``r`` (default 4) and ``d = 2r+1``::

    out[b, i, j, k] = leaky_relu_{0.1}(
        mean_c( prv[b, i, j, c] * nxt[b, i + di, j + dj, c] ) )

where ``k = (di + r) * d + (dj + r)`` and ``nxt`` is zero-padded outside
its bounds. Inputs and output are NHWC; sums are float32 (float64 for
float64 inputs).

Implementations behind one API:
  * :func:`cost_volume_plain` — the port of ``cost_volume_xla``: pad and
    81 static shifts in plain PyTorch, differentiated by autograd.
  * :class:`CostVolumeFunction` — the custom VJP of
    ``cost_volume_pallas``: the forward is the CUDA kernel K1, the
    backward the CUDA kernels K4a and K4b
    (``qpwcnet_torch.ops.cuda.cost_volume_kernel``); CPU tensors take
    :func:`cost_volume_plain` and the plain backward versions below.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from qpwcnet_torch.ops.activations import leaky_relu


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """float32, or float64 for float64 inputs (gradient checks)."""
    return torch.promote_types(x.dtype, torch.float32)


def cost_volume_plain(prv: torch.Tensor, nxt: torch.Tensor,
                      search_range: int = 4) -> torch.Tensor:
    """Plain formulation: zero-pad nxt by r, 81 shifted channel means.

    prv, nxt: (B, H, W, C) -> (B, H, W, (2r+1)**2) in prv's dtype.
    """
    r = search_range
    d = 2 * r + 1
    _, h, w, c = prv.shape
    ct = _compute_dtype(prv)
    prv32 = prv.to(ct)
    pad_nxt = F.pad(nxt.to(ct), (0, 0, r, r, r, r))
    inv_c = 1.0 / c
    costs = []
    for i0 in range(d):
        for j0 in range(d):
            roi = pad_nxt[:, i0:i0 + h, j0:j0 + w, :]
            costs.append(torch.sum(prv32 * roi, dim=-1) * inv_c)
    cvol = torch.stack(costs, dim=-1)
    return leaky_relu(cvol, 0.1).to(prv.dtype)


def _search_range(dacc: torch.Tensor) -> int:
    d = int(round(dacc.shape[-1] ** 0.5))
    if d * d != dacc.shape[-1] or d % 2 == 0:
        raise ValueError(f"dacc has {dacc.shape[-1]} channels, not (2r+1)^2")
    return d // 2


def cost_volume_bwd_prv_plain(dacc: torch.Tensor,
                              nxt: torch.Tensor) -> torch.Tensor:
    """d(cost)/d(prv) from the pre-activation gradient dacc (K4a's plain
    version, ``cost_volume_kernel.py:264-290``)::

        dprv[b,y,x,c] = (1/C) sum_k dacc[b,y,x,k] * nxt_pad[b,y+di,x+dj,c]

    dacc: (B, H, W, (2r+1)^2); nxt: (B, H, W, C) -> (B, H, W, C) in
    nxt's dtype. Products and sums in float32 (float64 for float64).
    """
    r = _search_range(dacc)
    d = 2 * r + 1
    _, h, w, c = nxt.shape
    ct = _compute_dtype(nxt)
    pad_nxt = F.pad(nxt.to(ct), (0, 0, r, r, r, r))
    dacc32 = dacc.to(ct)
    acc = torch.zeros(nxt.shape, dtype=ct, device=nxt.device)
    for i in range(d):
        for j in range(d):
            roi = pad_nxt[:, i:i + h, j:j + w, :]
            acc += dacc32[..., i * d + j, None] * roi
    return (acc * (1.0 / c)).to(nxt.dtype)


def cost_volume_bwd_nxt_plain(dacc: torch.Tensor,
                              prv: torch.Tensor) -> torch.Tensor:
    """d(cost)/d(nxt) from the pre-activation gradient dacc (K4b's plain
    version, ``cost_volume_kernel.py:293-328``), in gather form::

        dnxt[b,u,v,c] = (1/C) sum_k dacc[b,u-di,v-dj,k] * prv[b,u-di,v-dj,c]

    over source pixels (u-di, v-dj) inside the image. dacc: (B, H, W,
    (2r+1)^2); prv: (B, H, W, C) -> (B, H, W, C) in prv's dtype.
    Products and sums in float32 (float64 for float64).
    """
    r = _search_range(dacc)
    d = 2 * r + 1
    _, h, w, c = prv.shape
    pad = (0, 0, r, r, r, r)
    ct = _compute_dtype(prv)
    pad_prv = F.pad(prv.to(ct), pad)
    pad_dacc = F.pad(dacc.to(ct), pad)
    acc = torch.zeros(prv.shape, dtype=ct, device=prv.device)
    for i in range(d):
        for j in range(d):
            # source (u - di, v - dj) is row u + 2r - i of the padded maps
            si, sj = 2 * r - i, 2 * r - j
            acc += (pad_dacc[:, si:si + h, sj:sj + w, i * d + j, None]
                    * pad_prv[:, si:si + h, sj:sj + w, :])
    return (acc * (1.0 / c)).to(prv.dtype)


class CostVolumeFunction(torch.autograd.Function):
    """Cost volume with the custom VJP of ``cost_volume_pallas``
    (``cost_volume_kernel.py:152-213``).

    Forward: K1 on CUDA tensors, :func:`cost_volume_plain` on CPU ones;
    it saves (prv, nxt, out). Backward: dacc = g * (out > 0 ? 1 : 0.1) in
    g's dtype, then dprv by K4a and dnxt by K4b on CUDA tensors, or their
    plain versions on CPU ones.
    """

    @staticmethod
    def forward(ctx, prv, nxt, search_range=4):
        from qpwcnet_torch.ops.cuda.cost_volume_kernel import (
            cost_volume_cuda)

        out = cost_volume_cuda(prv, nxt, search_range=search_range)
        ctx.save_for_backward(prv, nxt, out)
        return out

    @staticmethod
    def backward(ctx, g):
        from qpwcnet_torch.ops.cuda.cost_volume_kernel import (
            cost_volume_bwd_nxt_cuda, cost_volume_bwd_prv_cuda)

        prv, nxt, out = ctx.saved_tensors
        # the leaky-relu derivative from the saved output's sign
        dacc = (g * torch.where(out > 0, 1.0, 0.1).to(g.dtype)).contiguous()
        dprv = dnxt = None
        if ctx.needs_input_grad[0]:
            dprv = cost_volume_bwd_prv_cuda(dacc, nxt).to(prv.dtype)
        if ctx.needs_input_grad[1]:
            dnxt = cost_volume_bwd_nxt_cuda(dacc, prv).to(nxt.dtype)
        return dprv, dnxt, None


def cost_volume(prv: torch.Tensor, nxt: torch.Tensor, search_range: int = 4,
                impl: str = "auto") -> torch.Tensor:
    """Cost volume with implementation dispatch.

    impl: 'auto' runs :class:`CostVolumeFunction` (the CUDA kernels K1,
    K4a, K4b on CUDA tensors, their plain versions on CPU tensors);
    'plain' runs :func:`cost_volume_plain` on any device. 'fused' selects
    the fused warp+correlate kernel at the warp sites
    (models.blocks.UpFlowBlock); warp-free cost volumes under it are
    'auto'.
    """
    if impl in ("auto", "fused"):
        return CostVolumeFunction.apply(prv, nxt, search_range)
    if impl == "plain":
        return cost_volume_plain(prv, nxt, search_range=search_range)
    raise ValueError(f"unknown cost_volume impl: {impl!r}")
