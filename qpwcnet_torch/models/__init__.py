from qpwcnet_torch.models.blocks import (
    BatchNorm,
    DownConv,
    FlowBlock,
    FrameInterpolate,
    OptFlow,
    SepConv,
    UpConv,
    UpFlowBlock,
)
from qpwcnet_torch.models.from_flax import load_flax_variables
from qpwcnet_torch.models.pwcnet import (
    Decoder,
    Encoder,
    Flower,
    PWCFlowNet,
    PWCInterpolator,
    build_flow_net,
    build_interpolator,
)

__all__ = [
    "BatchNorm",
    "SepConv",
    "DownConv",
    "UpConv",
    "OptFlow",
    "FlowBlock",
    "FrameInterpolate",
    "UpFlowBlock",
    "Encoder",
    "Decoder",
    "Flower",
    "PWCFlowNet",
    "PWCInterpolator",
    "build_flow_net",
    "build_interpolator",
    "load_flax_variables",
]
