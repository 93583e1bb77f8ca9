"""The spatial (H-sharded) path's ops on CPU against the JAX package: the
haloed plain versions of K1, K4a and K4b against the Pallas kernels'
haloed modes in interpret mode and against ``cost_volume_xla_haloed``,
the trainable cost volume's haloed gradients, the window warp, and
``cost_volume_spatial`` / ``backward_warp_spatial`` on the port's local
transport (n shards folded into the batch) against JAX's on meshes of
conftest's virtual CPU devices (the cases of tests/test_spatial.py).

Tolerances (float32 throughout): outputs 1e-5 (JAX's own for these ops:
sums in another order), gradients 1e-4 (tests/test_spatial.py's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpwcnet_tpu.ops.cost_volume import cost_volume_xla, cost_volume_xla_haloed
from qpwcnet_tpu.ops.pallas.cost_volume_kernel import (
    _cv_bwd_nxt_impl,
    _cv_bwd_prv_impl,
    cost_volume_pallas,
)
from qpwcnet_tpu.ops.warp import backward_warp as j_backward_warp
from qpwcnet_tpu.ops.warp import backward_warp_window as j_warp_window
from qpwcnet_tpu.parallel import make_mesh as j_make_mesh
from qpwcnet_tpu.parallel.spatial_ops import (
    SpatialConfig as JSpatialConfig,
    backward_warp_spatial as j_warp_spatial,
    cost_volume_spatial as j_cv_spatial,
)
from qpwcnet_torch.models import build_flow_net
from qpwcnet_torch.ops import cuda as kernels
from qpwcnet_torch.ops.cost_volume import (
    CostVolumeFunction,
    cost_volume_bwd_nxt_plain,
    cost_volume_bwd_prv_plain,
    cost_volume_plain,
    cost_volume_plain_haloed,
)
from qpwcnet_torch.ops.cuda.cost_volume_kernel import (
    cost_volume_bwd_nxt_haloed_cuda,
    cost_volume_bwd_prv_haloed_cuda,
    cost_volume_haloed_cuda,
)
from qpwcnet_torch.ops.warp import backward_warp, backward_warp_window
from qpwcnet_torch.parallel import (
    SpatialConfig,
    backward_warp_spatial,
    cost_volume_spatial,
    make_mesh,
    shard_batch_spatial,
)
from tests.test_torch_model import one_torch_thread  # noqa: F401

R = 4
ATOL = 1e-5
GTOL = 1e-4


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, tol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [(2, 8, 16, 8), (1, 16, 16, 8)])
def test_haloed_plain_versions_match_pallas(shape):
    """cost_volume_plain_haloed, and the backward plain versions with a
    haloed nxt / a haloed dnxt, against the Pallas kernels' haloed modes
    (interpret mode) and the XLA haloed formulation."""
    b, h, w, c = shape
    rng = np.random.RandomState(h)
    prv = _rand(rng, shape)
    nxt_h = _rand(rng, (b, h + 2 * R, w, c))
    dacc = _rand(rng, (b, h, w, 81))
    got = cost_volume_plain_haloed(_t(prv), _t(nxt_h))
    _close(got, cost_volume_pallas(jnp.asarray(prv), jnp.asarray(nxt_h),
                                   interpret=True, nxt_h_haloed=True))
    _close(got, cost_volume_xla_haloed(jnp.asarray(prv),
                                       jnp.asarray(nxt_h)))
    _close(cost_volume_bwd_prv_plain(_t(dacc), _t(nxt_h),
                                     nxt_h_haloed=True),
           _cv_bwd_prv_impl(jnp.asarray(dacc), jnp.asarray(nxt_h),
                            interpret=True, nxt_h_haloed=True))
    dnxt = cost_volume_bwd_nxt_plain(_t(dacc), _t(prv), h_haloed_out=True)
    assert dnxt.shape == (b, h + 2 * R, w, c)
    _close(dnxt, _cv_bwd_nxt_impl(jnp.asarray(dacc), jnp.asarray(prv),
                                  interpret=True, h_haloed_out=True))


def test_haloed_mode_with_zero_halo_is_the_plain_mode():
    """A zero halo is the zero padding: the haloed forward on the
    zero-padded nxt equals the plain one bit for bit, and the haloed dnxt
    holds the plain dnxt in its middle rows."""
    rng = np.random.RandomState(1)
    prv, nxt = _t(_rand(rng, (2, 11, 13, 20))), _t(_rand(rng, (2, 11, 13, 20)))
    dacc = _t(_rand(rng, (2, 11, 13, 81)))
    nxt_h = torch.nn.functional.pad(nxt, (0, 0, 0, 0, R, R))
    assert torch.equal(cost_volume_plain_haloed(prv, nxt_h),
                       cost_volume_plain(prv, nxt))
    assert torch.equal(cost_volume_bwd_prv_plain(dacc, nxt_h, True),
                       cost_volume_bwd_prv_plain(dacc, nxt))
    _close(cost_volume_bwd_nxt_plain(dacc, prv, True)[:, R:-R],
           cost_volume_bwd_nxt_plain(dacc, prv).numpy())


def test_haloed_wrappers_take_the_plain_versions_on_cpu():
    kernels.reset_launch_counts()
    rng = np.random.RandomState(2)
    prv = _t(_rand(rng, (1, 8, 12, 16)))
    nxt_h = _t(_rand(rng, (1, 16, 12, 16)))
    dacc = _t(_rand(rng, (1, 8, 12, 81)))
    assert torch.equal(cost_volume_haloed_cuda(prv, nxt_h),
                       cost_volume_plain_haloed(prv, nxt_h))
    assert torch.equal(cost_volume_bwd_prv_haloed_cuda(dacc, nxt_h),
                       cost_volume_bwd_prv_plain(dacc, nxt_h, True))
    assert torch.equal(cost_volume_bwd_nxt_haloed_cuda(dacc, prv),
                       cost_volume_bwd_nxt_plain(dacc, prv, True))
    assert not any(kernels.launch_counts().values())
    with pytest.raises(ValueError):
        cost_volume_plain_haloed(prv, nxt_h[:, 1:])


def test_cost_volume_function_haloed_grads_match_jax():
    """CostVolumeFunction(nxt_h_haloed=True): values and both gradients
    (d(nxt) in the haloed shape) against jax.vjp of
    cost_volume_xla_haloed."""
    rng = np.random.RandomState(3)
    prv = _rand(rng, (2, 8, 12, 8))
    nxt_h = _rand(rng, (2, 16, 12, 8))
    g = _rand(rng, (2, 8, 12, 81))
    out_j, vjp = jax.vjp(cost_volume_xla_haloed, jnp.asarray(prv),
                         jnp.asarray(nxt_h))
    gp_j, gn_j = vjp(jnp.asarray(g))
    p, n = _t(prv).requires_grad_(), _t(nxt_h).requires_grad_()
    out = CostVolumeFunction.apply(p, n, 4, True)
    out.backward(_t(g))
    _close(out, out_j)
    _close(p.grad, gp_j, GTOL)
    assert n.grad.shape == nxt_h.shape
    _close(n.grad, gn_j, GTOL)


@pytest.mark.parametrize("fy", [3.5, 10.0])
def test_backward_warp_window_matches_jax(fy):
    """Values and both gradients of the window warp (y_offset 4 over a
    source of 8 + 2 x 4 rows), with flows inside the halo and beyond it
    (where both clamp to the window)."""
    rng = np.random.RandomState(4)
    img = _rand(rng, (2, 16, 12, 5))
    flow = np.stack([rng.uniform(-3.0, 3.0, (2, 8, 12)),
                     rng.uniform(-fy, fy, (2, 8, 12))], -1).astype(np.float32)
    g = _rand(rng, (2, 8, 12, 5))
    out_j, vjp = jax.vjp(lambda x, f: j_warp_window(x, f, R),
                         jnp.asarray(img), jnp.asarray(flow))
    gi_j, gf_j = vjp(jnp.asarray(g))
    x, f = _t(img).requires_grad_(), _t(flow).requires_grad_()
    out = backward_warp_window(x, f, R)
    out.backward(_t(g))
    _close(out, out_j)
    _close(x.grad, gi_j, GTOL)
    _close(f.grad, gf_j, GTOL)


def _unshard(x, n):
    return x.unflatten(0, (-1, n)).flatten(1, 2)


def _jax_mesh(n):
    return j_make_mesh(n_data=2, n_model=n) if n == 4 else \
        j_make_mesh(n_data=1, n_model=n)


@pytest.mark.parametrize("n,h", [(2, 16), (4, 16), (4, 8)])
def test_cost_volume_spatial_matches_jax(n, h):
    """The local transport's halo-exchanged cost volume against JAX's
    shard_map version (and so against the global one): values and both
    gradients. (4, 8) has 2 rows a shard, under r: both fall back to the
    whole level."""
    rng = np.random.RandomState(5 + n + h)
    prv = _rand(rng, (2, h, 12, 8))
    nxt = _rand(rng, (2, h, 12, 8))
    g = _rand(rng, (2, h, 12, 81))
    cfg_j = JSpatialConfig(mesh=_jax_mesh(n), cv_impl="xla")
    out_j, vjp = jax.vjp(jax.jit(lambda p, q: j_cv_spatial(p, q, cfg_j)),
                         jnp.asarray(prv), jnp.asarray(nxt))
    gp_j, gn_j = vjp(jnp.asarray(g))
    mesh = make_mesh(n_data=1, n_model=n)
    cfg = SpatialConfig(mesh)
    p = _t(prv).reshape(2 * n, h // n, 12, 8).requires_grad_()
    q = _t(nxt).reshape(2 * n, h // n, 12, 8).requires_grad_()
    kernels.reset_launch_counts()
    out = cost_volume_spatial(p, q, cfg)
    out.backward(_t(g).reshape(2 * n, h // n, 12, 81))
    _close(_unshard(out, n), out_j)
    _close(_unshard(p.grad, n), gp_j, GTOL)
    _close(_unshard(q.grad, n), gn_j, GTOL)
    _close(_unshard(out, n), cost_volume_xla(jnp.asarray(prv),
                                             jnp.asarray(nxt)))
    # the 'plain' per-shard formulation gives the same
    _close(cost_volume_spatial(p, q, SpatialConfig(mesh, cv_impl="plain")),
           out.detach().numpy())


@pytest.mark.parametrize("n", [2, 4])
def test_backward_warp_spatial_matches_jax(n):
    """Window warp == global warp for |flow_y| <= warp_halo, including at
    the global ends (edge-replicated halo); gradients too."""
    rng = np.random.RandomState(6 + n)
    img = _rand(rng, (2, 16, 12, 5))
    flow = rng.uniform(-3.5, 3.5, (2, 16, 12, 2)).astype(np.float32)
    g = _rand(rng, (2, 16, 12, 5))
    cfg_j = JSpatialConfig(mesh=_jax_mesh(n), cv_impl="xla", warp_halo=4)
    out_j, vjp = jax.vjp(jax.jit(lambda x, f: j_warp_spatial(x, f, cfg_j)),
                         jnp.asarray(img), jnp.asarray(flow))
    gi_j, gf_j = vjp(jnp.asarray(g))
    cfg = SpatialConfig(make_mesh(n_data=1, n_model=n), warp_halo=4)
    x = _t(img).reshape(2 * n, 16 // n, 12, 5).requires_grad_()
    f = _t(flow).reshape(2 * n, 16 // n, 12, 2).requires_grad_()
    out = backward_warp_spatial(x, f, cfg)
    out.backward(_t(g).reshape(2 * n, 16 // n, 12, 5))
    _close(_unshard(out, n), out_j)
    _close(_unshard(x.grad, n), gi_j, GTOL)
    _close(_unshard(f.grad, n), gf_j, GTOL)
    _close(_unshard(out, n), j_backward_warp(jnp.asarray(img),
                                             jnp.asarray(flow)))


def test_backward_warp_spatial_large_flow_at_the_ends():
    """Flows far outside the image beyond the halo at the global ends:
    the border clamp equals the window clamp onto the replicated edge
    rows, as JAX's (tests/test_spatial.py's case)."""
    rng = np.random.RandomState(4)
    img = _rand(rng, (1, 16, 8, 3))
    flow = np.zeros((1, 16, 8, 2), np.float32)
    flow[:, :4, :, 1] = -20.0
    flow[:, 12:, :, 1] = 20.0
    cfg = SpatialConfig(make_mesh(n_data=1, n_model=4), warp_halo=4)
    out = backward_warp_spatial(_t(img).reshape(4, 4, 8, 3),
                                _t(flow).reshape(4, 4, 8, 2), cfg)
    _close(_unshard(out, 4), j_backward_warp(jnp.asarray(img),
                                             jnp.asarray(flow)))
    # inside the image beyond the halo the window clamps (JAX's
    # documented approximation): not the global warp
    flow[:, 4:8, :, 1] = 7.0
    out = backward_warp_spatial(_t(img).reshape(4, 4, 8, 3),
                                _t(flow).reshape(4, 4, 8, 2), cfg)
    ref = backward_warp(_t(img), _t(flow))
    assert float((_unshard(out, 4) - ref).abs().max()) > 0.1


def test_refusals():
    mesh = make_mesh(n_data=1, n_model=2)
    with pytest.raises(ValueError, match="32"):
        shard_batch_spatial(torch.zeros(1, 96, 64, 6), mesh)
    with pytest.raises(ValueError, match="stem_stages"):
        build_flow_net(0, "cpu", stem_stages=2, spatial=SpatialConfig(mesh))
    with pytest.raises(ValueError, match="upconv_stages"):
        build_flow_net(0, "cpu", upconv_stages=2,
                       spatial=SpatialConfig(mesh))
    with pytest.raises(ValueError, match="cv_impl"):
        SpatialConfig(mesh, cv_impl="pallas")
    assert shard_batch_spatial(torch.zeros(1, 128, 64, 6),
                               mesh).shape == (2, 64, 64, 6)
