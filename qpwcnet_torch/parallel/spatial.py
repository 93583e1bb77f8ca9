"""Spatial (height) sharding: the entry points of the H-sharded flow
forward and train step (port of qpwcnet_tpu/parallel/spatial.py).

The JAX package annotates the batch with H sharded over the 'model' mesh
axis and lets XLA partition the model. The port runs the model on the
shards themselves, with the active mesh (``parallel/transport.py``)
supplying each op's halo: the convs (QConv, QConvTranspose) pad H with
the neighbours' rows and with zeros only at the global ends, the 2x
bilinear upsampling takes one edge-aware halo row each way, BatchNorm
reduces its train-mode sums over every shard and data rank, OptFlow's
sqrt(h² + w²) scale and the loss's read the global H, and the cost
volume and the warp exchange their halos (``parallel/spatial_ops.py``).

Usage:
    mesh = make_mesh(n_data=1, n_model=2)
    model = build_flow_net(..., spatial=SpatialConfig(mesh))
    fwd = make_spatial_forward(lambda m, x: m(x), mesh)
    flow = unshard_batch_spatial(fwd(model, shard_batch_spatial(ims, mesh)),
                                 mesh)
"""

from __future__ import annotations

from typing import Callable

import torch

from qpwcnet_torch.parallel.mesh import Mesh, _data_slice, make_parallel_step
from qpwcnet_torch.parallel.transport import use_mesh

# the pyramid's depth: every encoder stage halves a shard's rows
PYRAMID = 32


def batch_spatial_spec() -> tuple:
    """(batch, H, W, C): batch over 'data', H over 'model'."""
    return ("data", "model")


def _check_height(h: int, mesh: Mesh) -> None:
    if h % (PYRAMID * mesh.n_model):
        raise ValueError(
            f"spatial sharding needs H divisible by 32 x the model axis "
            f"({PYRAMID} x {mesh.n_model} = {PYRAMID * mesh.n_model}): "
            f"every shard must keep whole rows down the 5-stage pyramid; "
            f"got H = {h}")


def shard_batch_spatial(x, mesh: Mesh, device=None) -> torch.Tensor:
    """An NHWC batch (B, H, W, C) sharded: batch over 'data', H over
    'model'. A local mesh folds the model axis's n shards into the batch,
    shard-minor ((B·n, H/n, W, C), a view); a process holds its data
    slice's rows of its shard. H must be divisible by 32 x the model
    axis (the pyramid's depth)."""
    x = torch.as_tensor(x)
    _check_height(x.shape[1], mesh)
    if device is not None:
        x = x.to(device)
    n = mesh.n_model
    if mesh.group is None:
        return x.reshape(x.shape[0] * n, x.shape[1] // n, *x.shape[2:])
    x = _data_slice(x, mesh)
    h = x.shape[1] // n
    return x[:, mesh.model.index * h:(mesh.model.index + 1) * h]


def unshard_batch_spatial(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The inverse of :func:`shard_batch_spatial`: the whole NHWC batch,
    on every process (across processes, gathered over both axes)."""
    if mesh.group is None:
        return mesh.model.gather(x, 1)
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.n_data * mesh.n_model)]
    dist.all_gather(parts, x, group=mesh.group)
    n = mesh.n_model
    rows = [torch.cat(parts[d * n:(d + 1) * n], 1)
            for d in range(mesh.n_data)]
    return torch.cat(rows, 0)


def make_spatial_forward(apply_fn: Callable, mesh: Mesh) -> Callable:
    """A ``fwd(model, ims)`` running ``apply_fn(model, ims)`` with H
    sharded over the mesh's 'model' axis: ``ims`` from
    :func:`shard_batch_spatial`, the model built with
    ``spatial=SpatialConfig(mesh)``; the output is sharded as the input.
    """
    def fwd(model, ims):
        with use_mesh(mesh):
            return apply_fn(model, ims)

    return fwd


def make_spatial_train_step(step_fn: Callable, mesh: Mesh) -> Callable:
    """A train ``step(model, optimizer, batch)`` (``make_flow_train_step``)
    with the batch sharded (batch over 'data', H over 'model', every leaf
    by :func:`shard_batch_spatial`) and the parameters replicated.

    Under the mesh the multiscale loss is the mean over the global pixel
    count and its scale reads the global H; BatchNorm's batch statistics
    and running-stat updates are over every shard and data rank; the
    optimizer sums the parameter gradients over the model axis and
    averages them over the data axis before the NaN scrub, AGC and Adam,
    so every process's AGC norms and Adam see the same gradients. The
    metrics are averaged over the data axis."""
    return make_parallel_step(step_fn, mesh)
