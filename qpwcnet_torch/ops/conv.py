"""NCHW convs with XLA's 'SAME' padding, H-sharding aware."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from qpwcnet_torch.parallel.transport import active_shards, halo_rows


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA 'SAME' padding (before, after) of one spatial dim: the output
    is ceil(size / s), and an odd total pad puts the extra pixel AFTER —
    so a 3x3/s2 conv on an even size pads (0, 1), not (1, 1)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
                groups: int = 1) -> torch.Tensor:
    """NCHW conv with XLA 'SAME' padding; weight OIHW in x's dtype.

    Under an H-sharded mesh the H padding is that of the whole image
    (stride 2 on an even H: (0, 1), one row of the next shard and none of
    the previous one), filled with the neighbours' rows."""
    kh, kw = weight.shape[-2:]
    shards = active_shards()
    if shards is None:
        pt, pb = same_pads(x.shape[2], kh, stride)
    else:
        if x.shape[2] % stride:
            raise ValueError(f"an H shard of {x.shape[2]} rows does not "
                             f"split by the conv's stride {stride}")
        pt, pb = same_pads(x.shape[2] * shards.n, kh, stride)
        x = halo_rows(x, 2, pt, pb)
        pt = pb = 0
    pl, pr = same_pads(x.shape[3], kw, stride)
    if pt == pb and pl == pr:
        return F.conv2d(x, weight, stride=stride, padding=(pt, pl),
                        groups=groups)
    return F.conv2d(F.pad(x, (pl, pr, pt, pb)), weight, stride=stride,
                    groups=groups)
