"""Checkpoints and the pretrain -> supervised weight handover (port of
qpwcnet_tpu/train/checkpoint.py).

:class:`CheckpointManager` keeps ``dir/<step>/state.pt``: the step, the
model's ``state_dict()`` (float32 parameters and the BatchNorm running
statistics, and a QAT model's activation ranges, JAX's 'quant_stats')
and the optimizer chain's Adam state; at most ``max_to_keep`` of them, the
oldest deleted. JAX keeps the same parts in an Orbax checkpoint. A float
checkpoint restores into a QAT model (a QAT fine-tune of a float run):
the model keeps its own ranges, zero on a fresh model, as JAX's restore
keeps its template's. :func:`transfer_params` copies the subtrees
PWCFlowNet and PWCInterpolator share.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.nn as nn

from qpwcnet_torch.quantize.qlayers import quant_ranges

STATE_FILE = "state.pt"


def load_model_state(model: nn.Module, state: dict) -> None:
    """``model.load_state_dict(state)``, strict, except that a float
    state (no ranges) loads into a QAT model, whose ranges stay as they
    are."""
    ranges = quant_ranges(model)
    if not ranges or any(k in state for k in ranges):
        model.load_state_dict(state)
        return
    missing, unexpected = model.load_state_dict(state, strict=False)
    if unexpected or set(missing) != set(ranges):
        raise RuntimeError(
            f"checkpoint does not match the model: missing "
            f"{sorted(set(missing) - set(ranges))[:4]}, unexpected "
            f"{sorted(unexpected)[:4]}")


class CheckpointManager:
    """Save and restore (model, GradientChain) pairs under ``directory``.

    Orbax's rules, which the JAX package's runs rely on: a save at a
    step at or below the latest is a no-op (it returns False and the
    first checkpoint stays), and a restore from a directory with no
    checkpoint returns None and touches nothing.
    """

    def __init__(self, directory, max_to_keep: int = 8):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def all_steps(self) -> list[int]:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit()
                      and (p / STATE_FILE).is_file())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, model: nn.Module, optimizer) -> bool:
        """Write checkpoint ``step``: ``optimizer.global_step`` (which
        may differ from the label ``step``), the model's state_dict and
        the chain's Adam state. The files go to a temporary directory
        first and move into place with one rename, so a run killed
        mid-save leaves the previous checkpoints readable. Returns False,
        writing nothing, when ``step`` is not above the latest step."""
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        final = self.directory / str(int(step))
        tmp = Path(tempfile.mkdtemp(prefix=f".{int(step)}-",
                                    dir=self.directory))
        try:
            torch.save({"step": int(optimizer.global_step),
                        "model": model.state_dict(),
                        "optimizer": optimizer.state_dict()},
                       tmp / STATE_FILE)
            os.replace(tmp, final)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(old))
        return True

    def _load(self, step: Optional[int], device) -> Optional[dict]:
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        return torch.load(self.directory / str(int(step)) / STATE_FILE,
                          map_location=device, weights_only=True)

    def restore(self, model: nn.Module, optimizer,
                step: Optional[int] = None) -> Optional[int]:
        """Load checkpoint ``step`` (default: the latest) into ``model``
        and ``optimizer`` in place, on the model's device; returns its
        stored step, which also becomes ``optimizer.global_step``, or
        None when there is no checkpoint."""
        state = self._load(step, _device_of(model))
        if state is None:
            return None
        load_model_state(model, state["model"])
        optimizer.load_state_dict(state["optimizer"])
        optimizer.global_step = int(state["step"])
        return optimizer.global_step

    def restore_params(self, model: nn.Module,
                       step: Optional[int] = None) -> Optional[int]:
        """Load only the parameters and BatchNorm statistics, ignoring
        the checkpoint's optimizer state (for a caller without a chain,
        or with another chain than the saving run's); returns the stored
        step, or None when there is no checkpoint."""
        state = self._load(step, _device_of(model))
        if state is None:
            return None
        load_model_state(model, state["model"])
        return int(state["step"])

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for (Orbax's may run
        in the background)."""

    def close(self) -> None:
        """Nothing is held open between calls."""


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


# The subtrees PWCFlowNet and PWCInterpolator share.
TRANSFER_SUBTREES = ("encoder", "decoder", "flower")


def transfer_params(src_model: nn.Module, dst_model: nn.Module,
                    subtrees: Sequence[str] = TRANSFER_SUBTREES
                    ) -> nn.Module:
    """Copy the parameters of the shared subtrees of ``src_model`` into
    ``dst_model``, in place, and return it. The BatchNorm running
    statistics stay ``dst_model``'s, as the JAX function replaces only
    the 'params' collection.

    Raises KeyError for a subtree either model lacks and ValueError when
    a subtree's names or shapes differ; nothing is copied then.
    """
    pairs = []
    for name in subtrees:
        if not hasattr(src_model, name) or not hasattr(dst_model, name):
            raise KeyError(f"transfer subtree {name!r} missing")
        src = dict(getattr(src_model, name).named_parameters())
        dst = dict(getattr(dst_model, name).named_parameters())
        if ({k: tuple(v.shape) for k, v in src.items()}
                != {k: tuple(v.shape) for k, v in dst.items()}):
            raise ValueError(f"shape mismatch in subtree {name!r}")
        pairs += [(dst[k], src[k]) for k in dst]
    with torch.no_grad():
        for d, s in pairs:
            d.copy_(s)
    return dst_model
