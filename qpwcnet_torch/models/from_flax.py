"""Load the JAX package's Flax variables into a PWCFlowNet or a
PWCInterpolator.

``load_flax_variables(model, variables)`` takes the ``{'params',
'batch_stats'}`` tree of ``qpwcnet_tpu.models.build_flow_net`` or
``build_interpolator`` as nested dicts of numpy arrays
(``jax.device_get`` of it) and copies every leaf into the model by name:

  * ``stage_i`` / ``upflow_i`` / ``of_feat_i`` / ``img_i`` ->
    ``stages.i`` / ``upflows.i`` / ``of_feats.i`` / ``imgs.i``; every
    other name is the same;
  * conv kernels HWIO -> OIHW, depthwise (3, 3, 1, C) -> (C, 1, 3, 3)
    (the same permutation), transpose-conv kernels (``conv_up``) flipped
    spatially and HWIO -> (I, O, kh, kw);
  * BatchNorm scale / bias / mean / var -> weight / bias / running_mean /
    running_var.

A leaf with no counterpart, a model tensor left unset, or a shape that
does not match raises ValueError.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn

_INDEXED = re.compile(r"^(stage|upflow|of_feat|img)_(\d+)$")
_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight",
         "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def torch_key(path: tuple[str, ...]) -> str:
    """Flax path (without the collection) -> the model's state_dict key."""
    parts = []
    for p in path[:-1]:
        m = _INDEXED.match(p)
        parts.append(f"{m.group(1)}s.{m.group(2)}" if m else p)
    if path[-1] not in _LEAF:
        raise ValueError(f"unmapped Flax leaf: {'/'.join(path)}")
    return ".".join(parts + [_LEAF[path[-1]]])


def _convert(path: tuple[str, ...], value: np.ndarray) -> np.ndarray:
    if path[-1] != "kernel":
        return value
    if "conv_up" in path:
        return np.flip(value, (0, 1)).transpose(2, 3, 0, 1)
    return value.transpose(3, 2, 0, 1)


def load_flax_variables(model: nn.Module,
                        variables: Mapping[str, Any]) -> nn.Module:
    """Copy a Flax ``{'params', 'batch_stats'}`` tree into ``model`` (in
    place, on the model's device; parameters stay float32)."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unexpected collections: {sorted(unknown)}")
    state = model.state_dict()
    seen = set()
    with torch.no_grad():
        for coll in ("params", "batch_stats"):
            for path, value in _flatten(variables.get(coll, {})):
                key = torch_key(path)
                if key not in state:
                    raise ValueError(f"no model tensor for {coll}/"
                                     f"{'/'.join(path)} (key {key})")
                arr = _convert(path, np.asarray(value, np.float32))
                if tuple(arr.shape) != tuple(state[key].shape):
                    raise ValueError(
                        f"{key}: Flax shape {np.shape(value)} maps to "
                        f"{tuple(arr.shape)}, model has "
                        f"{tuple(state[key].shape)}")
                state[key].copy_(torch.from_numpy(np.ascontiguousarray(arr)))
                seen.add(key)
    missing = set(state) - seen
    if missing:
        raise ValueError(f"model tensors not set by the Flax tree: "
                         f"{sorted(missing)}")
    return model


def _flax_path(model: nn.Module, key: str) -> tuple[str, ...]:
    """A parameter's state_dict key -> its Flax path (inverse of
    :func:`torch_key`)."""
    *mods, leaf = key.split(".")
    path = []
    for p in mods:
        if p.isdigit() and path and path[-1] in ("stages", "upflows",
                                                 "of_feats", "imgs"):
            path[-1] = f"{path[-1][:-1]}_{p}"
        else:
            path.append(p)
    is_norm = "running_mean" in dict(
        model.get_submodule(".".join(mods)).named_buffers(recurse=False))
    names = {"weight": "scale" if is_norm else "kernel", "bias": "bias"}
    return tuple(path) + (names[leaf],)


def _unconvert(path: tuple[str, ...], value: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_convert`."""
    if path[-1] != "kernel":
        return value
    if "conv_up" in path:
        return np.flip(value.transpose(2, 3, 0, 1), (0, 1))
    return value.transpose(2, 3, 1, 0)


def to_flax_tree(model: nn.Module, what: str = "params") -> dict:
    """The model's parameters (``what='params'``) or their ``.grad``
    (``what='grads'``) as a Flax-shaped nested dict of float32 numpy
    arrays, in the Flax layouts: the inverse of
    :func:`load_flax_variables` for the 'params' collection."""
    if what not in ("params", "grads"):
        raise ValueError(f"what must be 'params' or 'grads', got {what!r}")
    tree: dict = {}
    for key, p in model.named_parameters():
        t = p if what == "params" else p.grad
        if t is None:
            raise ValueError(f"{key} has no gradient")
        path = _flax_path(model, key)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(
            _unconvert(path, t.detach().float().cpu().numpy()))
    return tree
