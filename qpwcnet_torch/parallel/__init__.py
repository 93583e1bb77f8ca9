"""Data and spatial (H-sharded) parallelism (port of
qpwcnet_tpu/parallel/): the mesh and its two transports, the multi-process
helpers, and the H-sharded flow forward and train step."""

from qpwcnet_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    make_mesh_for_batch,
    make_parallel_step,
    put_batch,
    replicate,
    shard_batch,
)
from qpwcnet_torch.parallel.multihost import (
    initialize_distributed,
    is_primary,
    make_global_batch,
    process_shard,
)
from qpwcnet_torch.parallel.spatial import (
    batch_spatial_spec,
    make_spatial_forward,
    make_spatial_train_step,
    shard_batch_spatial,
    unshard_batch_spatial,
)
from qpwcnet_torch.parallel.spatial_ops import (
    SpatialConfig,
    backward_warp_spatial,
    cost_volume_spatial,
)
from qpwcnet_torch.parallel.transport import use_mesh

__all__ = [
    "SpatialConfig",
    "backward_warp_spatial",
    "cost_volume_spatial",
    "make_mesh",
    "make_mesh_for_batch",
    "process_shard",
    "put_batch",
    "shard_batch",
    "replicate",
    "make_parallel_step",
    "make_spatial_forward",
    "make_spatial_train_step",
    "shard_batch_spatial",
    "initialize_distributed",
    "make_global_batch",
    "is_primary",
    "Mesh",
    "batch_spatial_spec",
    "unshard_batch_spatial",
    "use_mesh",
]
