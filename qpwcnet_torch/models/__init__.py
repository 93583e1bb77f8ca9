from qpwcnet_torch.models.blocks import (
    BatchNorm,
    DownConv,
    FlowBlock,
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
    build_flow_net,
)

__all__ = [
    "BatchNorm",
    "SepConv",
    "DownConv",
    "UpConv",
    "OptFlow",
    "FlowBlock",
    "UpFlowBlock",
    "Encoder",
    "Decoder",
    "Flower",
    "PWCFlowNet",
    "build_flow_net",
    "load_flax_variables",
]
