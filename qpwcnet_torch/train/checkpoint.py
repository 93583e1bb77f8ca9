"""The pretrain -> supervised weight handover (port of
``transfer_params`` of qpwcnet_tpu/train/checkpoint.py).

Saving and restoring checkpoints wait for ROADMAP queue-1 item 9.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

# The subtrees PWCFlowNet and PWCInterpolator share.
TRANSFER_SUBTREES = ("encoder", "decoder", "flower")


def transfer_params(src_model: nn.Module, dst_model: nn.Module,
                    subtrees: Sequence[str] = TRANSFER_SUBTREES
                    ) -> nn.Module:
    """Copy the parameters of the shared subtrees of ``src_model`` into
    ``dst_model``, in place, and return it. The BatchNorm running
    statistics stay ``dst_model``'s, as the JAX function replaces only
    the 'params' collection.

    Raises KeyError for a subtree either model lacks and ValueError when
    a subtree's names or shapes differ; nothing is copied then.
    """
    pairs = []
    for name in subtrees:
        if not hasattr(src_model, name) or not hasattr(dst_model, name):
            raise KeyError(f"transfer subtree {name!r} missing")
        src = dict(getattr(src_model, name).named_parameters())
        dst = dict(getattr(dst_model, name).named_parameters())
        if ({k: tuple(v.shape) for k, v in src.items()}
                != {k: tuple(v.shape) for k, v in dst.items()}):
            raise ValueError(f"shape mismatch in subtree {name!r}")
        pairs += [(dst[k], src[k]) for k in dst]
    with torch.no_grad():
        for d, s in pairs:
            d.copy_(s)
    return dst_model
