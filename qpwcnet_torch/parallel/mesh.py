"""The ('data', 'model') mesh and data parallelism (port of
qpwcnet_tpu/parallel/mesh.py).

The JAX package's mesh is an array of devices whose shardings XLA turns
into collectives. The port's :class:`Mesh` is the same two axes as
transports: the 'model' axis carries the H shards of the spatial path
(``parallel/transport.py``), the 'data' axis the batch.

  * In one process (``torch.distributed`` not initialized) the mesh is
    local: the whole batch stays in the process, and the model axis's n
    H shards are folded into the batch (:class:`LocalShards`). This is
    what one card runs, and the counterpart of the JAX tests' virtual
    CPU devices.
  * Across processes it is a pair of process groups: the ranks
    ``d * n_model + m``, a model group for each data index d and a data
    group for each shard m. Each process holds one H shard of one slice
    of the batch.

:func:`make_parallel_step` all-reduces the gradients over the mesh
before the NaN scrub, AGC and Adam (summed over the model axis, averaged
over the data axis), and BatchNorm takes its batch statistics over every
process of the mesh, so the step equals the unsharded step on the whole
batch, as JAX's jit over a sharded batch does.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, Optional

import torch
import torch.distributed as dist

from qpwcnet_torch.parallel.transport import (
    AllSum,
    GroupShards,
    LocalShards,
    active_mesh,
    use_mesh,
)


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


class Mesh:
    """A ('data', 'model') mesh: ``n_data`` x ``n_model``.

    ``model``: the H-shard transport (:class:`LocalShards` or
    :class:`GroupShards`). ``data_group`` / ``group``: the process groups
    of the data axis and of the whole mesh, None for a local mesh.
    """

    def __init__(self, n_data: int, n_model: int, model,
                 data_group=None, group=None, data_index: int = 0):
        self.n_data = n_data
        self.n_model = n_model
        self.model = model
        self.data_group = data_group
        self.group = group
        self.data_index = data_index

    @property
    def procs(self) -> int:
        """The processes the mesh spans (1 for a local mesh)."""
        return 1 if self.group is None else self.n_data * self.n_model

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over every process of the mesh (differentiable:
        BatchNorm's batch sums)."""
        return t if self.group is None else AllSum.apply(t, self.group)

    @torch.no_grad()
    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """t's elementwise maximum over every process of the mesh (the
        QAT ranges' batch absmax), a new tensor."""
        t = t.clone()
        if self.group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    @torch.no_grad()
    def reduce_grads(self, model: torch.nn.Module) -> None:
        """Every parameter's ``.grad`` summed over the model axis and
        averaged over the data axis, in one all-reduce, in place."""
        if self.group is None:
            return
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        dist.all_reduce(flat, group=self.group)
        flat /= self.n_data
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def mean_over_data(self, metrics: dict) -> dict:
        """Scalar metrics averaged over the data axis (each data slice's
        own value: the JAX step's metric over the whole batch)."""
        if self.data_group is None or self.n_data == 1:
            return metrics
        out = {}
        for k, v in metrics.items():
            v = v.detach().float().clone()
            dist.all_reduce(v, group=self.data_group)
            out[k] = v / self.n_data
        return out


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """Create a ('data', 'model') mesh.

    Local (torch.distributed not initialized): n_data defaults to 1 and
    only names the batch's split (the batch stays whole). Across
    processes: n_data defaults to the world size // n_model, and
    n_data * n_model must be the world size; every process must call
    this, in the same order, since it creates the process groups.
    """
    if not _distributed():
        return Mesh(1 if n_data is None else n_data, n_model,
                    LocalShards(n_model))
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(
            f"make_mesh: data {n_data} x model {n_model} must be the world "
            f"size {world}: every process of a torch.distributed program "
            f"runs the step")
    model_ranks = [[d * n_model + m for m in range(n_model)]
                   for d in range(n_data)]
    data_ranks = [[d * n_model + m for d in range(n_data)]
                  for m in range(n_model)]
    # every rank creates every group, in one order
    model_groups = [dist.new_group(r) for r in model_ranks]
    data_groups = [dist.new_group(r) for r in data_ranks]
    d, m = divmod(rank, n_model)
    return Mesh(n_data, n_model,
                GroupShards(model_groups[d], model_ranks[d], m),
                data_group=data_groups[m], group=dist.group.WORLD,
                data_index=d)


def make_mesh_for_batch(batch_size: int,
                        devices: Optional[int] = None) -> Mesh:
    """Mesh whose data axis is the largest process count that divides
    ``batch_size`` (``devices``: the processes available, the world size
    by default; 1 without torch.distributed), warning when that leaves
    processes out. Across processes a mesh must span every process, so
    :func:`make_mesh` then refuses it."""
    if devices is None:
        devices = dist.get_world_size() if _distributed() else 1
    n_data = math.gcd(batch_size, devices)
    if n_data < devices:
        warnings.warn(
            f"make_mesh_for_batch: batch_size={batch_size} is not "
            f"divisible by the {devices} available devices; using "
            f"only {n_data} device(s). Pick a batch size divisible by "
            f"the device count to use all of them.",
            stacklevel=2,
        )
    return make_mesh(n_data=n_data)


def _data_slice(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if mesh.group is None:
        return x
    if x.shape[0] % mesh.n_data:
        raise ValueError(f"batch of {x.shape[0]} does not split over "
                         f"{mesh.n_data} data ranks")
    n = x.shape[0] // mesh.n_data
    return x[mesh.data_index * n:(mesh.data_index + 1) * n]


def shard_batch(batch, mesh: Mesh, device=None):
    """A whole batch (a dict of tensors or arrays, or one) split on axis
    0 over the data axis: this process's slice (the whole batch on a
    local mesh), on ``device``."""
    def put(x):
        x = torch.as_tensor(x)
        return _data_slice(x, mesh).to(device) if device is not None \
            else _data_slice(x, mesh)
    if isinstance(batch, dict):
        return {k: put(v) for k, v in batch.items()}
    return put(batch)


def put_batch(batch, mesh: Mesh, device=None):
    """A per-process batch on the mesh: across processes each process
    loaded its own slice (``make_global_batch``); locally the batch is
    whole (``shard_batch``)."""
    if mesh.group is not None:
        from qpwcnet_torch.parallel.multihost import make_global_batch

        return make_global_batch(batch, mesh, device)
    return shard_batch(batch, mesh, device)


@torch.no_grad()
def replicate(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """The model's parameters and buffers made equal on every process of
    the mesh (broadcast from its first process); a local mesh's model is
    returned as it is."""
    if mesh.group is not None:
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src=0, group=mesh.group)
    return model


def make_parallel_step(step_fn: Callable, mesh: Mesh) -> Callable:
    """A ``step(model, optimizer, batch) -> metrics`` (the train steps of
    ``qpwcnet_torch.train``) run on the mesh: with the mesh active,
    BatchNorm takes its statistics over every process, the optimizer
    all-reduces the gradients before the NaN scrub, AGC and Adam
    (``GradientChain.step``), and the metrics are averaged over the data
    axis. The model and optimizer are updated in place (JAX's
    ``donate_state`` has no counterpart)."""

    def step(model, optimizer, batch):
        with use_mesh(mesh):
            metrics = step_fn(model, optimizer, batch)
        return mesh.mean_over_data(metrics)

    return step


def reduce_active_grads(model: torch.nn.Module) -> None:
    """The active mesh's gradient all-reduce (a no-op without one):
    ``GradientChain.step`` calls it before the NaN scrub."""
    mesh = active_mesh()
    if mesh is not None:
        mesh.reduce_grads(model)
