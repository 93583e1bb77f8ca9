"""The port's tensor layout, in one place.

Public functions take and return NHWC, as the JAX package's do. Inside
the model tensors are logical NCHW in ``torch.channels_last`` memory, so
``nhwc(x)`` is a contiguous NHWC view that the NHWC kernels take without
a copy, and cuDNN runs the convs on the same memory.
"""

from __future__ import annotations

from typing import Sequence

import torch

CHANNELS_LAST = torch.channels_last


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last) -> NHWC view."""
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW (channels_last) view."""
    return x.permute(0, 3, 1, 2)


def cat_channels(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenate NCHW tensors along C into a channels_last tensor."""
    return torch.cat(list(xs), dim=1).contiguous(memory_format=CHANNELS_LAST)
