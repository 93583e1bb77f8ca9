"""Load the JAX package's Flax variables into a PWCFlowNet or a
PWCInterpolator.

``load_flax_variables(model, variables)`` takes the ``{'params',
'batch_stats'}`` tree of ``qpwcnet_tpu.models.build_flow_net`` or
``build_interpolator`` (with ``'quant_stats'`` for a quantized model) as
nested dicts of numpy arrays (``jax.device_get`` of it) and copies every
leaf into the model by name:

  * ``stage_i`` / ``upflow_i`` / ``of_feat_i`` / ``img_i`` ->
    ``stages.i`` / ``upflows.i`` / ``of_feats.i`` / ``imgs.i``; every
    other name is the same;
  * conv kernels HWIO -> OIHW, depthwise (3, 3, 1, C) -> (C, 1, 3, 3)
    (the same permutation), transpose-conv kernels (``conv_up``) flipped
    spatially and HWIO -> (I, O, kh, kw);
  * BatchNorm scale / bias / mean / var -> weight / bias / running_mean /
    running_var;
  * the QAT ranges: ``.../conv_a/amax_in`` -> ``....conv_a.amax_in`` (0-d,
    or a per-input-channel vector) and ``.../act_quant/amax`` ->
    ``....act_quant.amax``.

A leaf with no counterpart, a model tensor left unset, or a shape that
does not match raises ValueError.

``load_flax_opt_state(optimizer, opt_state)`` carries the Adam state of
either optax chain of qpwcnet_tpu/train/train_state.py (NaN scrub ->
Adam, or NaN scrub -> AGC -> Adam) into a ``GradientChain``: ``mu`` and
``nu`` by the parameters' names and layouts, ``count`` as each
parameter's Adam ``step``; ``to_flax_opt_state`` is its inverse.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn

_INDEXED = re.compile(r"^(stage|upflow|of_feat|img)_(\d+)$")
_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight",
         "mean": "running_mean", "var": "running_var",
         "amax_in": "amax_in", "amax": "amax"}
COLLECTIONS = ("params", "batch_stats", "quant_stats")


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
    """Copy a Flax ``{'params', 'batch_stats'[, 'quant_stats']}`` tree
    into ``model`` (in place, on the model's device; parameters stay
    float32)."""
    unknown = set(variables) - set(COLLECTIONS)
    if unknown:
        raise ValueError(f"unexpected collections: {sorted(unknown)}")
    state = model.state_dict()
    seen = set()
    with torch.no_grad():
        for coll in COLLECTIONS:
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
                state[key].copy_(torch.from_numpy(arr.copy()))
                seen.add(key)
    missing = set(state) - seen
    if missing:
        raise ValueError(f"model tensors not set by the Flax tree: "
                         f"{sorted(missing)}")
    return model


def _module_path(mods: list[str]) -> list[str]:
    """A module's state_dict key parts -> its Flax scope names."""
    path = []
    for p in mods:
        if p.isdigit() and path and path[-1] in ("stages", "upflows",
                                                 "of_feats", "imgs"):
            path[-1] = f"{path[-1][:-1]}_{p}"
        else:
            path.append(p)
    return path


def _flax_path(model: nn.Module, key: str) -> tuple[str, ...]:
    """A parameter's state_dict key -> its Flax path (inverse of
    :func:`torch_key`)."""
    *mods, leaf = key.split(".")
    path = _module_path(mods)
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


def _to_tree(model: nn.Module, tensor_of) -> dict:
    """A Flax-shaped nested dict of float32 numpy arrays, one leaf per
    parameter, ``tensor_of(key, param)`` in the Flax layout."""
    tree: dict = {}
    for key, p in model.named_parameters():
        path = _flax_path(model, key)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(_unconvert(
            path, tensor_of(key, p).detach().float().cpu().numpy()))
    return tree


def to_flax_tree(model: nn.Module, what: str = "params") -> dict:
    """The model's parameters (``what='params'``) or their ``.grad``
    (``what='grads'``) as a Flax-shaped nested dict of float32 numpy
    arrays, in the Flax layouts: the inverse of
    :func:`load_flax_variables` for the 'params' collection."""
    if what not in ("params", "grads"):
        raise ValueError(f"what must be 'params' or 'grads', got {what!r}")

    def tensor_of(key, p):
        t = p if what == "params" else p.grad
        if t is None:
            raise ValueError(f"{key} has no gradient")
        return t

    return _to_tree(model, tensor_of)


def to_flax_quant_stats(model: nn.Module) -> dict:
    """The model's QAT ranges as JAX's 'quant_stats' collection: a
    Flax-shaped nested dict of float32 numpy arrays (empty for a float
    model); the inverse of :func:`load_flax_variables` for it."""
    tree: dict = {}
    for key, buf in model.named_buffers():
        *mods, leaf = key.split(".")
        if leaf not in ("amax_in", "amax"):
            continue
        node = tree
        for part in _module_path(mods):
            node = node.setdefault(part, {})
        node[leaf] = buf.detach().float().cpu().numpy().copy()
    return tree


def _is_adam(node) -> bool:
    """optax's ScaleByAdamState (a namedtuple of count, mu, nu)."""
    return {"count", "mu", "nu"} <= set(getattr(node, "_fields", ()))


def _find_adam(opt_state):
    if _is_adam(opt_state):
        return opt_state
    if isinstance(opt_state, tuple) and not hasattr(opt_state, "_fields"):
        for node in opt_state:
            found = _find_adam(node)
            if found is not None:
                return found
    return None


def load_flax_opt_state(optimizer, opt_state):
    """Set a GradientChain's Adam state, in place, from an optax chain
    state (``jax.device_get`` of ``TrainState.opt_state``, either
    chain): ``mu`` -> ``exp_avg`` and ``nu`` -> ``exp_avg_sq`` with the
    parameters' name and layout mapping, ``count`` -> every parameter's
    ``step``. Returns the chain. Its ``global_step`` (JAX's
    ``TrainState.step``, which counts the curriculum's steps too) is the
    caller's."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optax state")
    params = dict(optimizer.model.named_parameters())
    moments: dict = {}
    for name, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        for path, value in _flatten(tree):
            key = torch_key(path)
            if key not in params:
                raise ValueError(f"no parameter for Adam {name} "
                                 f"{'/'.join(path)} (key {key})")
            arr = _convert(path, np.asarray(value, np.float32))
            if tuple(arr.shape) != tuple(params[key].shape):
                raise ValueError(f"{key}: Adam {name} shape "
                                 f"{tuple(arr.shape)}, parameter "
                                 f"{tuple(params[key].shape)}")
            # a copy: Adam updates its moments in place
            moments.setdefault(key, {})[name] = torch.tensor(
                arr.copy(), device=params[key].device)
    for key, p in params.items():
        if len(moments.get(key, ())) != 2:
            raise ValueError(f"{key}: no Adam mu/nu in the optax state")
        optimizer.adam.state[p] = {
            "step": torch.tensor(float(np.asarray(adam.count)),
                                 dtype=torch.float32),
            **moments[key]}
    return optimizer


def to_flax_opt_state(optimizer, template):
    """The inverse of :func:`load_flax_opt_state`: ``template`` (an
    optax chain state of either chain, e.g. ``tx.init(params)``) with its
    Adam ``count``, ``mu`` and ``nu`` from the GradientChain. A parameter
    without Adam state (never stepped) gets zero moments; the steps of
    those with state must agree."""
    adam = _find_adam(template)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the template")
    state = optimizer.adam.state
    counts = {float(s["step"]) for s in state.values()}
    if len(counts) > 1:
        raise ValueError(f"the parameters' Adam steps differ: {counts}")

    def moment(name):
        return lambda key, p: (state[p][name] if p in state
                               else torch.zeros_like(p))

    new = adam._replace(
        count=np.asarray(counts.pop() if counts else 0,
                         np.asarray(adam.count).dtype),
        mu=_to_tree(optimizer.model, moment("exp_avg")),
        nu=_to_tree(optimizer.model, moment("exp_avg_sq")))

    def rebuild(node):
        if _is_adam(node):
            return new
        if isinstance(node, tuple) and not hasattr(node, "_fields"):
            return tuple(rebuild(n) for n in node)
        return node

    return rebuild(template)
