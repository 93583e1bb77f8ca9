"""The training harness (port of qpwcnet_tpu/train/): losses, the
learning-rate schedules, AGC and the NaN scrub, both optimizer chains,
both train steps, BatchNorm recalibration, checkpoints and the weight
handover, and metrics."""

from qpwcnet_torch.train.agc import adaptive_clip_grads, zero_nan_grads
from qpwcnet_torch.train.checkpoint import CheckpointManager, transfer_params
from qpwcnet_torch.train.losses import (
    auto_resize_mse_loss,
    epe_error,
    flow_finetune_loss,
    flow_loss_v2,
    flow_mse_loss,
    l2_regularization,
    multiscale_flow_loss,
    multiscale_interp_loss,
)
from qpwcnet_torch.train.metrics import MetricWriter
from qpwcnet_torch.train.schedules import (
    piecewise_halving_schedule,
    triangular2_cyclic_schedule,
)
from qpwcnet_torch.train.train_state import (
    GradientChain,
    create_interp_train_state,
    default_optimizer,
    make_flow_train_step,
    make_interp_train_step,
    plain_optimizer,
    recalibrate_batch_stats,
)

__all__ = [
    "CheckpointManager",
    "MetricWriter",
    "adaptive_clip_grads",
    "zero_nan_grads",
    "auto_resize_mse_loss",
    "epe_error",
    "flow_loss_v2",
    "flow_mse_loss",
    "flow_finetune_loss",
    "l2_regularization",
    "multiscale_flow_loss",
    "multiscale_interp_loss",
    "GradientChain",
    "default_optimizer",
    "plain_optimizer",
    "create_interp_train_state",
    "make_flow_train_step",
    "make_interp_train_step",
    "recalibrate_batch_stats",
    "transfer_params",
    "piecewise_halving_schedule",
    "triangular2_cyclic_schedule",
]
