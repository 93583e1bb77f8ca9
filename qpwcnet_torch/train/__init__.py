from qpwcnet_torch.train.agc import adaptive_clip_grads, zero_nan_grads
from qpwcnet_torch.train.losses import (
    epe_error,
    flow_loss_v2,
    l2_regularization,
    multiscale_flow_loss,
)
from qpwcnet_torch.train.train_state import (
    GradientChain,
    default_optimizer,
    make_flow_train_step,
    plain_optimizer,
    recalibrate_batch_stats,
)

__all__ = [
    "adaptive_clip_grads",
    "zero_nan_grads",
    "epe_error",
    "flow_loss_v2",
    "l2_regularization",
    "multiscale_flow_loss",
    "GradientChain",
    "default_optimizer",
    "plain_optimizer",
    "make_flow_train_step",
    "recalibrate_batch_stats",
]
