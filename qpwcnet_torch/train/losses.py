"""Training losses (port of the flow and pretraining losses of
qpwcnet_tpu/train/losses.py).

All NHWC, flow in (x, y) channel order:

  * :func:`multiscale_flow_loss` — FlowMseLossV2: block-mean downsample
    of the GT flow by exact integer factors, magnitude scaled by
    pred_h/true_h, then Huber(delta=0.1) on flow scaled by 2/(w+h), summed
    over the multiscale predictions except the final bilinear-only one.
  * :func:`multiscale_interp_loss` — AutoResizeMseLoss (bilinear resize
    of the GT image to each prediction's scale, plain MSE), summed over
    ALL interpolator outputs, with the per-scale img_i_loss values.
  * :func:`flow_mse_loss` — FlowMseLoss: the GT flow resized bilinearly
    to the prediction's scale (magnitude scaled by pred_h/true_h), then
    the mean L2 norm of the residual.
  * :func:`flow_finetune_loss` — FlowMseLossFineTune: mean((|d|_1 +
    eps)^q) of the same residual.
  * :func:`epe_error` — the end-point-error metric.
  * :func:`l2_regularization` — gamma * sum(kernel**2) over the DownConv
    and UpConv kernels (the Keras l2 regularizers).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from qpwcnet_torch.ops.resize import block_mean_downsample, resize_bilinear
from qpwcnet_torch.parallel.transport import (
    global_mean,
    n_shards,
    replicated,
)

# Modules whose kernels carry the Keras l2 regularizer (DownConv, UpConv).
L2_MODULES = ("conv_a", "conv_aa", "conv_b", "conv_up")


def _huber(err: torch.Tensor, delta: float) -> torch.Tensor:
    """Elementwise Huber loss: 0.5*e² below delta, delta*(|e| - 0.5*delta)
    above."""
    abs_e = torch.abs(err)
    quad = 0.5 * torch.square(err)
    lin = delta * (abs_e - 0.5 * delta)
    return torch.where(abs_e <= delta, quad, lin)


def flow_loss_v2(flo_true: torch.Tensor, flo_pred: torch.Tensor,
                 delta: float = 0.1) -> torch.Tensor:
    """FlowMseLossV2 for one scale. Under an H-sharded mesh both flows
    are a shard's rows: the scale reads the image's H and the mean is
    over the image's pixels."""
    th, tw = flo_true.shape[1], flo_true.shape[2]
    ph, pw = flo_pred.shape[1], flo_pred.shape[2]
    flow_scale = ph / th
    loss_scale = 2.0 / (pw + ph * n_shards())
    true_down = flow_scale * block_mean_downsample(flo_true, th // ph,
                                                   tw // pw)
    err = loss_scale * true_down - loss_scale * flo_pred
    return global_mean(_huber(err, delta))


def multiscale_flow_loss(flo_true: torch.Tensor,
                         flo_preds: Sequence[torch.Tensor],
                         delta: float = 0.1) -> torch.Tensor:
    """Sum of FlowMseLossV2 over all scales except the final
    bilinear-only output."""
    return sum(flow_loss_v2(flo_true, p, delta) for p in flo_preds[:-1])


def _norm_mirroring_jax(d: torch.Tensor) -> torch.Tensor:
    """The L2 norm over the last axis as ``sqrt(sum(d²))``, whose gradient
    at an exactly zero residual is NaN (0/0), as ``jnp.linalg.norm``'s is
    under ``jax.grad``; ``torch.linalg.vector_norm``'s is 0 there."""
    return torch.sqrt(torch.sum(torch.square(d), dim=-1))


def _resized_true(flo_true: torch.Tensor,
                  flo_pred: torch.Tensor) -> torch.Tensor:
    """The GT flow resized bilinearly to the prediction's (H, W), its
    magnitude scaled by pred_h / true_h."""
    ph, pw = flo_pred.shape[1], flo_pred.shape[2]
    return resize_bilinear(flo_true, (ph, pw)) * (ph / flo_true.shape[1])


def flow_mse_loss(flo_true: torch.Tensor,
                  flo_pred: torch.Tensor) -> torch.Tensor:
    """FlowMseLoss: the mean channel-axis L2 norm of the residual between
    the resized GT flow and the prediction."""
    return torch.mean(_norm_mirroring_jax(_resized_true(flo_true, flo_pred)
                                          - flo_pred))


def flow_finetune_loss(flo_true: torch.Tensor, flo_pred: torch.Tensor,
                       q: float = 0.4, eps: float = 0.01) -> torch.Tensor:
    """FlowMseLossFineTune: mean((||d||_1 + eps)^q) of the residual
    between the resized GT flow and the prediction."""
    err = torch.sum(torch.abs(_resized_true(flo_true, flo_pred) - flo_pred),
                    dim=-1)
    return torch.mean(torch.pow(err + eps, q))


def auto_resize_mse_loss(img_true: torch.Tensor,
                         img_pred: torch.Tensor) -> torch.Tensor:
    """AutoResizeMseLoss: resize the GT image to the prediction's scale
    (bilinear, antialiased when downsampling), plain MSE."""
    ph, pw = img_pred.shape[1], img_pred.shape[2]
    true_down = resize_bilinear(img_true, (ph, pw))
    return torch.mean(torch.square(true_down - img_pred))


def multiscale_interp_loss(img_true: torch.Tensor,
                           img_preds: Sequence[torch.Tensor]
                           ) -> tuple[torch.Tensor, dict]:
    """Sum of :func:`auto_resize_mse_loss` over ALL interpolator outputs,
    and the per-scale values as {'img_i_loss': ...}."""
    per_scale = {f"img_{i}_loss": auto_resize_mse_loss(img_true, p)
                 for i, p in enumerate(img_preds)}
    return sum(per_scale.values()), per_scale


def epe_error(flo_true: torch.Tensor, flo_pred: torch.Tensor) -> torch.Tensor:
    """End-point error: mean L2 norm of the flow residual (over the
    image's pixels under an H-sharded mesh)."""
    return global_mean(torch.linalg.vector_norm(flo_true - flo_pred, dim=-1))


def l2_regularization(model: nn.Module, gamma: float = 4e-6) -> torch.Tensor:
    """gamma * sum(weight**2) over the ``.weight`` of every module named
    conv_a, conv_aa, conv_b or conv_up (Keras l2 sums, it does not
    average)."""
    total = torch.zeros((), dtype=torch.float32,
                        device=next(model.parameters()).device)
    for name, module in model.named_modules():
        if name.rsplit(".", 1)[-1] in L2_MODULES:
            total = total + torch.sum(torch.square(module.weight.float()))
    # every process of a mesh's model axis computes it whole
    return gamma * replicated(total)
