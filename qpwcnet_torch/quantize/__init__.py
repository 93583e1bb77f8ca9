from qpwcnet_torch.quantize.qlayers import QConv, QConvTranspose, conv2d_same

__all__ = ["QConv", "QConvTranspose", "conv2d_same"]
