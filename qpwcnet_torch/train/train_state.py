"""The training steps (port of qpwcnet_tpu/train/train_state.py): the
supervised flow step and the frame-interpolation pretraining step.

The JAX TrainState pytree becomes the model itself (parameters,
BatchNorm running statistics and, for a QAT model, the activation ranges
of its 'quant_stats') and a :class:`GradientChain`, the optax chain over
the model's ``.grad``: NaN scrub -> [AGC] -> Adam. A QAT model's train
steps update its ranges in the forward, before they are used (JAX's
mutable 'quant_stats').

Each step is the span ``train_step`` of ``utils/tracing.py``, with the
phases ``step.zero_grad``, ``step.forward``, ``step.loss``,
``step.backward``, ``step.optimizer`` (``opt.allreduce``,
``opt.nan_scrub``, ``opt.agc``, ``opt.adam``) and, in the flow step,
``step.epe``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable, Optional, Sequence

import torch
import torch.nn as nn

from qpwcnet_torch.parallel.mesh import reduce_active_grads
from qpwcnet_torch.quantize.qlayers import quant_ranges
from qpwcnet_torch.train.agc import adaptive_clip_grads, zero_nan_grads
from qpwcnet_torch.train.losses import (
    epe_error,
    l2_regularization,
    multiscale_flow_loss,
    multiscale_interp_loss,
)
from qpwcnet_torch.utils import tracing


class GradientChain:
    """zero_nan_grads -> adaptive_clip_grads (when ``clip_factor`` is
    set) -> ``torch.optim.Adam(lr)`` (optax.adam's defaults: betas .9 /
    .999, eps 1e-8) over all of ``model``'s parameters; under a mesh of
    several processes (``parallel.make_parallel_step``) the gradients are
    first all-reduced over it.

    ``global_step`` counts the steps taken, JAX's ``TrainState.step``:
    :meth:`step` adds one, and a caller that replaces the chain mid-run
    (the train app's curriculum) carries it over, as JAX's
    ``state.replace(tx=..., opt_state=...)`` keeps the step."""

    def __init__(self, model: nn.Module, learning_rate: float,
                 clip_factor: Optional[float] = None, eps: float = 1e-3,
                 exclude: Sequence[str] = ()):
        self.model = model
        self.clip_factor = clip_factor
        self.eps = eps
        self.exclude = tuple(exclude)
        self.adam = torch.optim.Adam(model.parameters(), lr=learning_rate)
        self.global_step = 0

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        with tracing.span("step.optimizer"):
            with tracing.span("opt.allreduce"):
                reduce_active_grads(self.model)
            with tracing.span("opt.nan_scrub"):
                zero_nan_grads(self.model)
            if self.clip_factor is not None:
                with tracing.span("opt.agc"):
                    adaptive_clip_grads(self.model, self.clip_factor,
                                        self.eps, self.exclude)
            with tracing.span("opt.adam"):
                self.adam.step()
        self.global_step += 1

    def state_dict(self) -> dict:
        """The Adam state (each parameter's ``step``, ``exp_avg``,
        ``exp_avg_sq``, by its index in ``model.parameters()``) and the
        hyperparameters. ``global_step`` is the checkpoint's own."""
        return self.adam.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state)
        # Adam keeps its per-parameter step counts on the host unless it
        # is fused or capturable; a checkpoint loaded onto the card would
        # leave them there
        for s in self.adam.state.values():
            if torch.is_tensor(s.get("step")):
                s["step"] = s["step"].cpu()


def default_optimizer(model: nn.Module, learning_rate: float = 1e-4,
                      clip_factor: float = 0.01,
                      eps: float = 1e-3) -> GradientChain:
    """NaN-grad scrub -> AGC -> Adam, with the flow heads ('of_flow')
    exempt from AGC, as the JAX package's default_optimizer."""
    return GradientChain(model, learning_rate, clip_factor, eps,
                         exclude=("of_flow",))


def plain_optimizer(model: nn.Module, learning_rate: float) -> GradientChain:
    """NaN-grad scrub -> Adam: the 'plain' chain of the train app."""
    return GradientChain(model, learning_rate)


# The JAX package's state constructor for the pretraining step: here the
# model holds the parameters and BatchNorm statistics, and the default
# chain over it is the rest of the state.
create_interp_train_state = default_optimizer


def make_flow_train_step(l2_gamma: float = 4e-6) -> Callable:
    """Supervised-flow train step ``step(model, optimizer, batch)``.

    batch = {'ims': (B, H, W, 6) float32 in [-0.5, 0.5], 'flo': (B, H, W,
    2)}. Runs the model in train mode (BatchNorm on batch statistics,
    updating its running statistics), backpropagates the multiscale loss
    plus the kernel l2 term, and steps the optimizer. Returns {'loss',
    'epe'} as 0-d tensors on the model's device.
    """

    def train_step(model: nn.Module, optimizer: GradientChain,
                   batch: dict) -> dict:
        with tracing.span("train_step"):
            model.train()
            with tracing.span("step.zero_grad"):
                optimizer.zero_grad()
            with tracing.span("step.forward"):
                outs = model(batch["ims"], multiscale=True)
            with tracing.span("step.loss"):
                loss = (multiscale_flow_loss(batch["flo"], outs)
                        + l2_regularization(model, l2_gamma))
            with tracing.span("step.backward"):
                loss.backward()
            optimizer.step()
            with tracing.span("step.epe"), torch.no_grad():
                epe = epe_error(batch["flo"], outs[-1])
        return {"loss": loss.detach(), "epe": epe}

    return train_step


def _raise_on_nan(what: str, tensors) -> None:
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_floating_point() and bool(
                torch.isnan(t).any()):
            raise FloatingPointError(f"NaN in {what} (shape "
                                     f"{tuple(t.shape)})")


@contextlib.contextmanager
def _debug_nans(model: nn.Module):
    """Autograd's anomaly mode, and a forward hook on every module of
    ``model`` raising FloatingPointError at the first output that holds a
    NaN (JAX's debug_nans stops at the first primitive that makes one);
    a NaN that anomaly mode finds in the backward is raised as
    FloatingPointError too."""
    from torch.utils._pytree import tree_leaves

    def check(name):
        return lambda mod, inp, out: _raise_on_nan(
            f"forward output of {name or 'the model'}", tree_leaves(out))

    hooks = [m.register_forward_hook(check(n))
             for n, m in model.named_modules()]
    try:
        with torch.autograd.set_detect_anomaly(True):
            yield
    except RuntimeError as e:
        if "nan" not in str(e).lower():
            raise
        raise FloatingPointError(str(e)) from e
    finally:
        for h in hooks:
            h.remove()


def make_interp_train_step(l2_gamma: float = 4e-6,
                           debug_nan: bool = False) -> Callable:
    """Frame-interpolation pretraining step ``step(model, optimizer,
    batch)``.

    batch = {'ims': (B, H, W, 6) frames 0 and 2, 'mid': (B, H, W, 3)
    frame 1}, both in [-0.5, 0.5]. Runs the model in train mode,
    backpropagates the multiscale interpolation loss over ALL 6 outputs
    plus the kernel l2 term, and steps the optimizer. Returns {'loss',
    'img_0_loss', ..., 'img_5_loss'} as 0-d tensors on the model's
    device.

    debug_nan: the counterpart of JAX's ``jax_debug_nans``. The step runs
    under ``torch.autograd.set_detect_anomaly(True)`` (which names the
    forward op of a backward that made a NaN) and raises
    FloatingPointError at the first NaN (not inf) in the output of any of
    the model's modules, in the loss or in a gradient, before the NaN
    scrub of the optimizer. It reads each of them back to the host, so it
    costs a synchronization a check; off, the step is unchanged.
    """

    def train_step(model: nn.Module, optimizer: GradientChain,
                   batch: dict) -> dict:
        with tracing.span("train_step"):
            model.train()
            with tracing.span("step.zero_grad"):
                optimizer.zero_grad()
            with _debug_nans(model) if debug_nan else \
                    contextlib.nullcontext():
                with tracing.span("step.forward"):
                    outs = model(batch["ims"], multiscale=True)
                with tracing.span("step.loss"):
                    loss, per_scale = multiscale_interp_loss(batch["mid"],
                                                             outs)
                    loss = loss + l2_regularization(model, l2_gamma)
                if debug_nan:
                    _raise_on_nan("the loss", [loss])
                with tracing.span("step.backward"):
                    loss.backward()
            if debug_nan:
                _raise_on_nan("a gradient",
                              (p.grad for p in model.parameters()))
            optimizer.step()
        return {"loss": loss.detach(),
                **{k: v.detach() for k, v in per_scale.items()}}

    return train_step


@torch.no_grad()
def recalibrate_batch_stats(model: nn.Module,
                            batches: Iterable[torch.Tensor],
                            n_passes: int = 200) -> nn.Module:
    """Re-estimate the BatchNorm running statistics with train-mode
    forwards over up to ``n_passes`` input batches; the parameters and a
    QAT model's ranges are untouched and the model's train/eval mode is
    restored. As in JAX, which discards the mutated 'quant_stats', each
    pass's forward quantizes with the ranges its own update gives, and
    the ranges are then put back."""
    ranges = quant_ranges(model)
    saved = {k: b.clone() for k, b in ranges.items()}
    was_training = model.training
    model.train()
    for i, ims in enumerate(batches):
        if i >= n_passes:
            break
        model(ims)
        for k, b in ranges.items():
            b.copy_(saved[k])
    model.train(was_training)
    return model
