from qpwcnet_torch.ops.activations import leaky_relu, mish
from qpwcnet_torch.ops.cost_volume import cost_volume, cost_volume_plain
from qpwcnet_torch.ops.flow_vis import cost_volume_to_flow, flow_to_image
from qpwcnet_torch.ops.occlusion import estimate_occlusion_map, invert_flow
from qpwcnet_torch.ops.resize import (
    avg_pool_2x,
    block_mean_downsample,
    resize_bilinear,
    upsample2x_bilinear,
)
from qpwcnet_torch.ops.warp import backward_warp, backward_warp_manual

__all__ = [
    "mish",
    "leaky_relu",
    "backward_warp",
    "backward_warp_manual",
    "cost_volume",
    "cost_volume_plain",
    "upsample2x_bilinear",
    "avg_pool_2x",
    "block_mean_downsample",
    "resize_bilinear",
    "flow_to_image",
    "cost_volume_to_flow",
    "estimate_occlusion_map",
    "invert_flow",
]
