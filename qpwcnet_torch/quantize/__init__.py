from qpwcnet_torch.quantize.fake_quant import (
    QuantConfig,
    fake_quant,
    quantize_weight_scales,
)
from qpwcnet_torch.quantize.int8 import (
    Int8Conv,
    convert_to_int8,
    int8_conv_apply,
    load_int8_bundle,
    save_int8_bundle,
)
from qpwcnet_torch.quantize.qlayers import (
    ActQuant,
    QConv,
    QConvTranspose,
    conv2d_same,
)
from qpwcnet_torch.quantize.qtensor import QTensor, dequantize, quantize_to

__all__ = [
    "QuantConfig",
    "fake_quant",
    "quantize_weight_scales",
    "QConv",
    "QConvTranspose",
    "ActQuant",
    "conv2d_same",
    "QTensor",
    "dequantize",
    "quantize_to",
    "convert_to_int8",
    "int8_conv_apply",
    "Int8Conv",
    "load_int8_bundle",
    "save_int8_bundle",
]
