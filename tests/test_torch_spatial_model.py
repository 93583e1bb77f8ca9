"""The H-sharded flow model on CPU against the JAX package: the port's
sharded forward and train step on the local transport (the n H shards
folded into the batch) against JAX's unsharded forward and step on the
same Flax variables, at 128x64 (tests/test_spatial.py's shape).

Tolerances: the forward at JAX's own 2e-3 (tests/test_spatial.py); the
train step's loss and BatchNorm statistics at 1e-5, its gradients and
parameters by tests/test_torch_train.py's rules (``_grad_tol``,
``_check_params``: 1e-4 of a leaf's max|g|, and what that moves one Adam
step by).
"""

import jax
import numpy as np
import pytest
import torch

from qpwcnet_torch.models import build_flow_net, load_flax_variables
from qpwcnet_torch.models.from_flax import to_flax_tree
from qpwcnet_torch.parallel import (
    SpatialConfig,
    make_mesh,
    make_mesh_for_batch,
    make_parallel_step,
    make_spatial_forward,
    make_spatial_train_step,
    shard_batch_spatial,
    unshard_batch_spatial,
)
from qpwcnet_torch.train import (
    default_optimizer,
    make_flow_train_step,
    plain_optimizer,
)
from tests.test_torch_model import _seeded, one_torch_thread  # noqa: F401
from tests.test_torch_train import (
    LR,
    _check_params,
    _grad_tol,
    _jax_step,
    _leaves,
)

H, W = 128, 64


def _batch(seed=7):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-0.5, 0.5, (2, H, W, 6)).astype(np.float32),
            rng.uniform(-3.0, 3.0, (2, H, W, 2)).astype(np.float32))


def _sharded(v, n, warp_halo=16, **kw):
    mesh = make_mesh(n_data=1, n_model=n)
    cfg = SpatialConfig(mesh, warp_halo=warp_halo)
    return mesh, load_flax_variables(
        build_flow_net(0, "cpu", spatial=cfg, **kw), v)


def test_spatial_model_has_the_same_parameters(flow_setup):
    """The spatial model's parameters and buffers are the unsharded one's,
    so the Flax bridge loads it with no new mapping."""
    _, variables = flow_setup
    v = _seeded(variables, "diag", hw=(H, W))
    plain = load_flax_variables(build_flow_net(0, "cpu"), v)
    _, sharded = _sharded(v, 4)
    a, b = plain.state_dict(), sharded.state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_forward_matches_jax(flow_setup, n):
    """The sharded eval forward against JAX's unsharded forward on the
    same variables (JAX's tolerance, 2e-3), with flows of a few px."""
    model_j, variables = flow_setup
    v = _seeded(variables, "diag", hw=(H, W))
    ims, _ = _batch(0)
    want = np.asarray(model_j.apply(v, jax.numpy.asarray(ims), train=False))
    mesh, model = _sharded(v, n)
    fwd = make_spatial_forward(lambda m, x: m(x), mesh)
    with torch.no_grad():
        out = fwd(model, shard_batch_spatial(torch.from_numpy(ims), mesh))
    assert out.shape == (2 * n, H // n, W, 2)
    got = unshard_batch_spatial(out, mesh).numpy()
    assert float(np.abs(want).max()) > 0.5
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)


def test_spatial_train_step_matches_jax(flow_setup):
    """One sharded train step (n = 4, warp_halo 8: the three coarsest
    levels fall back) against JAX's unsharded step: the loss, every
    gradient, the BatchNorm running statistics, and the parameters after
    the plain and the default (AGC) chains. k = 0.1 keeps the flows the
    windowed warps read (twice the 1/8 and 1/4 levels' outputs, up to
    ~6 px here) inside the halo; beyond it the window clamps, JAX's own
    approximation, and the step is not JAX's unsharded one."""
    model_j, variables = flow_setup
    model_j = model_j.clone(head_scale="unit", residual=True)
    v = _seeded(variables, "unit", k=0.1, hw=(H, W))
    ims, flo = _batch()
    loss_j, grads_j, stats_j, plain_j, ref_j = _jax_step(model_j, v, ims,
                                                          flo)
    for chain, want_params in ((plain_optimizer, plain_j),
                               (default_optimizer, ref_j)):
        mesh, model = _sharded(v, 4, warp_halo=8, head_scale="unit",
                               residual=True)
        step = make_spatial_train_step(make_flow_train_step(), mesh)
        batch = {"ims": shard_batch_spatial(torch.from_numpy(ims), mesh),
                 "flo": shard_batch_spatial(torch.from_numpy(flo), mesh)}
        m = step(model, chain(model, LR), batch)
        assert abs(float(m["loss"]) - loss_j) <= 1e-5 * max(1.0, abs(loss_j))
        if chain is plain_optimizer:
            got = _leaves(to_flax_tree(model, "grads"))
            want = _leaves(grads_j)
            assert got.keys() == want.keys()
            for k in want:
                err = float(np.max(np.abs(got[k] - want[k])))
                assert err <= _grad_tol(k, want) or err == 0.0, (k, err)
        modules = dict(model.named_modules())
        for name, node in stats_j["flower"].items():
            bn = modules["flower." + name.replace("upflow_", "upflows.")
                         + ".flow.norm"]
            for key, buf in (("mean", bn.running_mean),
                             ("var", bn.running_var)):
                err = np.abs(buf.numpy() - node["flow"]["norm"][key])
                assert float(np.max(err)) <= 1e-5, (name, key)
        _check_params(to_flax_tree(model), want_params, grads_j)


def test_local_parallel_step_is_the_unsharded_step():
    """make_parallel_step on a local mesh (the batch stays whole) takes
    the very step of the unsharded model."""
    rng = np.random.RandomState(3)
    batch = {"ims": torch.from_numpy(rng.uniform(
        -0.5, 0.5, (2, 64, 64, 6)).astype(np.float32)),
        "flo": torch.from_numpy(rng.uniform(
            -2, 2, (2, 64, 64, 2)).astype(np.float32))}
    models = [build_flow_net(0, "cpu", head_scale="unit") for _ in range(2)]
    step = make_flow_train_step()
    m_a = step(models[0], default_optimizer(models[0]), batch)
    par = make_parallel_step(make_flow_train_step(),
                             make_mesh(n_data=2, n_model=1))
    m_b = par(models[1], default_optimizer(models[1]), batch)
    assert float(m_a["loss"]) == float(m_b["loss"])
    a, b = models[0].state_dict(), models[1].state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_mesh_for_batch_divisibility():
    """make_mesh_for_batch's data axis divides the batch, warning when it
    leaves devices out (JAX's rule); one process alone is one device."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert make_mesh_for_batch(12).n_data == 1
        assert make_mesh_for_batch(16, devices=8).n_data == 8
    with pytest.warns(UserWarning, match="divisible"):
        assert make_mesh_for_batch(12, devices=8).n_data == 4
