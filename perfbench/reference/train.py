"""The two training steps, written plainly: the multiscale flow loss
(FlowMseLossV2) and the multiscale interpolation loss, the Keras l2 term,
then the optimizer chain NaN scrub -> AGC (the flow heads 'of_flow'
exempt) -> Adam, by hand.

Tensors are NHWC at the boundary, as the measured steps take them:
batch = {'ims': (B, H, W, 6), 'flo': (B, H, W, 2)} for the flow step,
{'ims': (B, H, W, 6), 'mid': (B, H, W, 3)} for the pretraining step.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from perfbench.reference import ops
from perfbench.reference.models import nchw

L2_MODULES = ("conv_a", "conv_aa", "conv_b", "conv_up")


def huber(err: torch.Tensor, delta: float) -> torch.Tensor:
    a = torch.abs(err)
    return torch.where(a <= delta, 0.5 * err * err, delta * (a - 0.5 * delta))


def multiscale_flow_loss(flo_true, flo_preds, delta: float = 0.1):
    """Sum over all outputs but the last of the Huber loss between the
    block-mean-downsampled true flow (scaled by pred_h / true_h) and the
    prediction, both times 2 / (w + h) of the prediction."""
    t = nchw(flo_true)
    th, tw = t.shape[2:]
    total = 0.0
    for p in flo_preds[:-1]:
        p = nchw(p)
        ph, pw = p.shape[2:]
        k = 2.0 / (pw + ph)
        down = (ph / th) * ops.block_mean(t, th // ph, tw // pw)
        total = total + huber(k * down - k * p, delta).mean()
    return total


def multiscale_interp_loss(img_true, img_preds):
    """Sum over all outputs of the MSE against the true middle frame
    resized to the output's size."""
    t = nchw(img_true)
    total = 0.0
    for p in img_preds:
        p = nchw(p)
        total = total + torch.mean(
            torch.square(ops.resize_bilinear(t, p.shape[2:]) - p))
    return total


def l2_term(model: nn.Module, gamma: float) -> torch.Tensor:
    total = 0.0
    for name, m in model.named_modules():
        if name.rsplit(".", 1)[-1] in L2_MODULES:
            total = total + torch.sum(torch.square(m.weight))
    return gamma * total


def _out_dim(model: nn.Module) -> dict[str, int]:
    """Each parameter's output-channel dim: 1 for the transpose convs'
    (I, O, 4, 4) weights, 0 otherwise."""
    dims = {}
    for mod_name, m in model.named_modules():
        for p_name, _ in m.named_parameters(recurse=False):
            key = f"{mod_name}.{p_name}" if mod_name else p_name
            dims[key] = 1 if (mod_name.endswith("conv_up")
                              and p_name == "weight") else 0
    return dims


def unitwise_norm(x: torch.Tensor, out_dim: int) -> torch.Tensor:
    if x.ndim <= 1:
        return torch.sqrt(torch.sum(x * x))
    dims = tuple(d for d in range(x.ndim) if d != out_dim)
    return torch.sqrt(torch.sum(x * x, dim=dims, keepdim=True))


class Chain:
    """NaN scrub -> AGC (clip 0.01, eps 1e-3; leaves with a name part
    containing 'of_flow' exempt) -> Adam (betas .9/.999, eps 1e-8, bias
    corrected), over every parameter of ``model``."""

    def __init__(self, model: nn.Module, lr: float = 1e-4,
                 clip: float = 0.01, eps: float = 1e-3):
        self.params = dict(model.named_parameters())
        self.dims = _out_dim(model)
        self.lr, self.clip, self.eps = lr, clip, eps
        self.m = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.t = 0
        self.seen: dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        b1, b2 = 0.9, 0.999
        self.seen = {}
        for k, p in self.params.items():
            g = torch.nan_to_num(p.grad, nan=0.0, posinf=float("inf"),
                                 neginf=float("-inf"))
            if not any("of_flow" in part for part in k.split(".")):
                pn = unitwise_norm(p, self.dims[k])
                gn = unitwise_norm(g, self.dims[k])
                mx = torch.clamp(pn, min=self.eps) * self.clip
                g = torch.where(gn < mx, g,
                                g * (mx / torch.clamp(gn, min=1e-6)))
            self.seen[k] = g.clone()
            self.m[k].mul_(b1).add_((1 - b1) * g)
            self.v[k].mul_(b2).add_((1 - b2) * g * g)
            mh = self.m[k] / (1 - b1 ** self.t)
            vh = self.v[k] / (1 - b2 ** self.t)
            p.sub_(self.lr * mh / (torch.sqrt(vh) + 1e-8))
            p.grad = None


def step(model: nn.Module, chain: Chain, batch: dict,
         l2_gamma: float = 4e-6) -> float:
    """One train step of ``model`` (a FlowNet or an Interpolator) in train
    mode; returns the loss."""
    model.train()
    outs = model(batch["ims"], multiscale=True)
    if "flo" in batch:
        loss = multiscale_flow_loss(batch["flo"], outs)
    else:
        loss = multiscale_interp_loss(batch["mid"], outs)
    loss = loss + l2_term(model, l2_gamma)
    loss.backward()
    chain.step()
    return float(loss.detach())
