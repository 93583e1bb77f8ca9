"""Activation functions (port of qpwcnet_tpu/ops/activations.py)."""

import torch
import torch.nn.functional as F


def mish(x: torch.Tensor) -> torch.Tensor:
    """Mish activation: ``x * tanh(softplus(x))``.

    The single-exp form of the JAX package (with ``t = e^x``)::

        tanh(ln(1 + t)) = (t² + 2t) / (t² + 2t + 2)

    The factor is computed in float32 with the exp argument clamped at 20
    (above it the factor is exactly 1 in float32), rounded to the input
    dtype, and multiplied in the input dtype — the same rounding points
    as ``jnp`` under bf16 compute.
    """
    xf = x.float()
    t = torch.exp(torch.clamp(xf, max=20.0))
    tt = t * t + 2.0 * t
    y = tt / (tt + 2.0)
    return x * torch.where(xf > 20.0, 1.0, y).to(x.dtype)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    """Leaky ReLU with the reference's default slope of 0.1."""
    return F.leaky_relu(x, negative_slope)
