"""K1: the cost-volume forward as a CUDA kernel (``csrc/cost_volume.cu``,
``csrc/correlate.cuh``).

Replaces: ``qpwcnet_tpu/ops/pallas/cost_volume_kernel.py:_cv_kernel``
(via ``_cost_volume_pallas_impl``).

What bounds it on the H100: the plain version reads the padded nxt map
once per displacement (81 times) and writes 81 float32 planes before the
stack; the work itself is 81·C multiply-adds per pixel. The kernel reads
prv and nxt once per tile (the 9-row, 8-column halo re-read hits L2) and
writes the 81 outputs once, so it is bounded by shared-memory loads in
the correlation loop (81 loads per 81 FMAs per channel), not by device
memory. Tensor cores are not used: the correlation is a banded product,
and making it a dense one is later work.
"""

from __future__ import annotations

import torch

from qpwcnet_torch.ops.cost_volume import cost_volume_plain
from qpwcnet_torch.ops.cuda import _build

SEARCH_RANGE = 4  # the kernel's compiled search range (81 outputs)


def cost_volume_cuda(prv: torch.Tensor, nxt: torch.Tensor,
                     search_range: int = 4) -> torch.Tensor:
    """Cost volume, NHWC (B, H, W, C) x2 -> (B, H, W, 81).

    CPU tensors take :func:`cost_volume_plain`; CUDA tensors launch the
    kernel or raise.
    """
    if not prv.is_cuda:
        return cost_volume_plain(prv, nxt, search_range=search_range)
    if search_range != SEARCH_RANGE:
        raise ValueError(f"the CUDA cost volume is built for search_range="
                         f"{SEARCH_RANGE}, got {search_range}")
    b, h, w, c = prv.shape
    _build.require(prv, "prv")
    _build.require(nxt, "nxt", prv.shape, prv.dtype, prv.device)
    d = 2 * search_range + 1
    out = torch.empty((b, h, w, d * d), dtype=prv.dtype, device=prv.device)
    lib = _build.library()
    with torch.cuda.device(prv.device):
        err = lib.qpw_cost_volume(
            prv.data_ptr(), nxt.data_ptr(), out.data_ptr(), b, h, w, c,
            _build.dtype_code(prv.dtype), _build.stream_ptr(prv.device))
    _build.check(err, "qpw_cost_volume")
    cost_volume_cuda.launches += 1
    return out


cost_volume_cuda.launches = 0
