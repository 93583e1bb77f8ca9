"""Multi-process utilities (port of qpwcnet_tpu/parallel/multihost.py).

``torch.distributed`` in place of ``jax.distributed``: initialize the
process group (from the torchrun environment, or from arguments that
override it), then build the mesh over every process
(``parallel.mesh.make_mesh``); each process loads its own slice of the
batch.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout_s: float = 600.0) -> None:
    """``torch.distributed.init_process_group``. Without arguments it
    reads the environment torchrun sets (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK); ``coordinator_address`` ('host:port'),
    ``num_processes`` and ``process_id`` override it. The backend is NCCL
    where CUDA is available, else gloo, unless ``backend`` names one."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        return
    world = (num_processes if num_processes is not None
             else int(os.environ["WORLD_SIZE"]))
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank, timeout=timeout)


def make_global_batch(batch, mesh, device=None):
    """This process's slice of the global batch, as it loaded it: the
    port's data-sharded batch is the per-process tensors (the global
    batch is their concatenation over the data axis, in data-rank
    order). Every leaf must have the same leading size."""
    def put(x):
        x = torch.as_tensor(x)
        return x.to(device) if device is not None else x
    leaves = batch if isinstance(batch, dict) else {"x": batch}
    sizes = {torch.as_tensor(v).shape[0] for v in leaves.values()}
    if len(sizes) != 1:
        raise ValueError(f"batch leaves differ in leading size: {sizes}")
    if isinstance(batch, dict):
        return {k: put(v) for k, v in batch.items()}
    return put(batch)


def process_shard() -> tuple[int, int]:
    """(this process's rank, the world size) of the process group, (0, 1)
    without one: a loader's shard_index and shard_count (JAX's
    process_index() and process_count())."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary() -> bool:
    """True on the process that should write checkpoints and logs."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0
