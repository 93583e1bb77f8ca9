from qpwcnet_torch.ops.activations import leaky_relu, mish
from qpwcnet_torch.ops.cost_volume import cost_volume, cost_volume_plain
from qpwcnet_torch.ops.flow_vis import flow_to_image
from qpwcnet_torch.ops.resize import (
    avg_pool_2x,
    resize_bilinear,
    upsample2x_bilinear,
)
from qpwcnet_torch.ops.warp import backward_warp

__all__ = [
    "mish",
    "leaky_relu",
    "backward_warp",
    "cost_volume",
    "cost_volume_plain",
    "upsample2x_bilinear",
    "avg_pool_2x",
    "resize_bilinear",
    "flow_to_image",
]
