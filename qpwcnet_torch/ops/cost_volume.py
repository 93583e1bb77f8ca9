"""Cost-volume correlation (port of qpwcnet_tpu/ops/cost_volume.py).

With search range ``r`` (default 4) and ``d = 2r+1``::

    out[b, i, j, k] = leaky_relu_{0.1}(
        mean_c( prv[b, i, j, c] * nxt[b, i + di, j + dj, c] ) )

where ``k = (di + r) * d + (dj + r)`` and ``nxt`` is zero-padded outside
its bounds. Inputs and output are NHWC; sums are float32.

Two implementations behind one API:
  * :func:`cost_volume_plain` — the port of ``cost_volume_xla``: pad and
    81 static shifts in plain PyTorch.
  * The CUDA kernel ``qpwcnet_torch.ops.cuda.cost_volume_kernel``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from qpwcnet_torch.ops.activations import leaky_relu


def cost_volume_plain(prv: torch.Tensor, nxt: torch.Tensor,
                      search_range: int = 4) -> torch.Tensor:
    """Plain formulation: zero-pad nxt by r, 81 shifted channel means.

    prv, nxt: (B, H, W, C) -> (B, H, W, (2r+1)**2) in prv's dtype.
    """
    r = search_range
    d = 2 * r + 1
    _, h, w, c = prv.shape
    prv32 = prv.float()
    pad_nxt = F.pad(nxt.float(), (0, 0, r, r, r, r))
    inv_c = 1.0 / c
    costs = []
    for i0 in range(d):
        for j0 in range(d):
            roi = pad_nxt[:, i0:i0 + h, j0:j0 + w, :]
            costs.append(torch.sum(prv32 * roi, dim=-1) * inv_c)
    cvol = torch.stack(costs, dim=-1)
    return leaky_relu(cvol, 0.1).to(prv.dtype)


def cost_volume(prv: torch.Tensor, nxt: torch.Tensor, search_range: int = 4,
                impl: str = "auto") -> torch.Tensor:
    """Cost volume with implementation dispatch.

    impl: 'auto' launches the CUDA kernel on CUDA tensors (the kernel
    wrapper takes the plain version for CPU tensors); 'plain' runs
    :func:`cost_volume_plain` on any device. 'fused' selects the fused
    warp+correlate kernel at the warp sites (models.blocks.UpFlowBlock);
    warp-free cost volumes under it are 'auto'.
    """
    if impl in ("auto", "fused"):
        from qpwcnet_torch.ops.cuda.cost_volume_kernel import (
            cost_volume_cuda)

        return cost_volume_cuda(prv, nxt, search_range=search_range)
    if impl == "plain":
        return cost_volume_plain(prv, nxt, search_range=search_range)
    raise ValueError(f"unknown cost_volume impl: {impl!r}")
