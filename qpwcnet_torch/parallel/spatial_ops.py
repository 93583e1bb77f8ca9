"""The spatial (H-sharded) path's cost volume and warp (port of
qpwcnet_tpu/parallel/spatial_ops.py).

  * :func:`cost_volume_spatial`: each H shard receives the r edge rows of
    its neighbours' ``nxt`` (zeros at the global ends, the cost volume's
    zero padding) and runs the cost volume on its haloed tile: the
    kernels' haloed modes (K1 ``nxt_h_haloed``, and in the backward K4a
    ``nxt_h_haloed`` and K4b ``h_haloed_out``, whose halo rows' gradient
    the exchange returns to the shards that own them).
  * :func:`backward_warp_spatial`: exchanges ``warp_halo`` rows each way
    and samples from the local window (flow_y is in effect clamped to
    ±warp_halo, JAX's documented approximation beyond the halo); at the
    global ends the halo replicates the edge row, so the window's clamp
    there is the global warp's border clamp.

Both fall back, as JAX's do, at levels too coarse for a one-hop halo
(local rows < halo): the level is gathered, computed whole and each shard
keeps its rows. The exchanges go through the mesh's transport
(``parallel/transport.py``), in one process or across processes.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from qpwcnet_torch.ops.cost_volume import cost_volume
from qpwcnet_torch.ops.warp import backward_warp, backward_warp_window


@dataclasses.dataclass(frozen=True, eq=False)
class SpatialConfig:
    """Static config of the H-sharded model (``build_flow_net(spatial=
    ...)``, the JAX module attribute's counterpart).

    mesh: the ``parallel.mesh.Mesh`` whose 'model' axis carries H.
    warp_halo: rows exchanged for the window warp.
    cv_impl: the per-shard cost volume, 'auto' (the CUDA kernels' haloed
    modes on CUDA tensors, their plain versions on CPU ones: JAX's
    'pallas') or 'plain' (the plain PyTorch formulation: JAX's 'xla').
    """

    mesh: Any
    warp_halo: int = 16
    cv_impl: str = "auto"

    def __post_init__(self):
        if self.cv_impl not in ("auto", "plain"):
            raise ValueError(f"SpatialConfig.cv_impl must be 'auto' or "
                             f"'plain', got {self.cv_impl!r}")


def cost_volume_spatial(prv: torch.Tensor, nxt: torch.Tensor,
                        spatial: SpatialConfig,
                        search_range: int = 4) -> torch.Tensor:
    """Cost volume of H-sharded NHWC features (a shard each, or the
    folded shards of a local mesh): exchanges r rows of ``nxt`` with the
    neighbouring shards and correlates each shard's haloed tile."""
    r = search_range
    shards = spatial.mesh.model
    if shards.n == 1 or prv.shape[1] < r:
        # too coarse for a one-hop halo: the level whole, own rows kept
        whole = cost_volume(shards.gather(prv, 1), shards.gather(nxt, 1),
                            r, impl=spatial.cv_impl)
        return shards.keep(whole, 1)
    top, bot = shards.exchange(nxt, 1, r, r)
    nxt_h = torch.cat([top, nxt, bot], 1)
    return cost_volume(prv, nxt_h, r, impl=spatial.cv_impl,
                       nxt_h_haloed=True)


def backward_warp_spatial(img: torch.Tensor, flow: torch.Tensor,
                          spatial: SpatialConfig) -> torch.Tensor:
    """Backward warp of H-sharded NHWC inputs through a ±warp_halo row
    window: exact against the global warp wherever |flow_y| <= warp_halo;
    beyond it the sample clamps to the window's edge."""
    halo = spatial.warp_halo
    shards = spatial.mesh.model
    if shards.n == 1 or img.shape[1] < halo:
        whole = backward_warp(shards.gather(img, 1), shards.gather(flow, 1))
        return shards.keep(whole, 1)
    top, bot = shards.exchange(img, 1, halo, halo, edge=True)
    return backward_warp_window(torch.cat([top, img, bot], 1), flow, halo)
