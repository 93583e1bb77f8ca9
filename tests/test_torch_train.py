"""The PyTorch port's supervised flow training step on CPU against the
JAX package, and the optimizer state carried between the two (the loss
over several steps, synthetic data and the train app are in
tests/test_torch_train_app.py).

One Flax tree is loaded into both models; gradients and parameters come
back to the Flax layout through ``to_flax_tree``. Tolerances: the loss
and the BatchNorm statistics to 1e-5; every gradient to 1e-4 of its
leaf's max|g| (the port's model bound: five levels of float32 convs
summed in another order feed the warp coordinates; for the leaves that
feed a train-mode BatchNorm, of the largest in their flow head, see
``_grad_tol``); the parameters after
one Adam step to 1e-3 of the learning rate plus what the gradient
tolerance moves the step by (stated at the checks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qpwcnet_tpu.train import create_flow_train_state
from qpwcnet_tpu.train import make_flow_train_step as j_make_step
from qpwcnet_tpu.train.agc import zero_nan_grads as j_zero_nan_grads
from qpwcnet_tpu.train.train_state import default_optimizer as j_default_opt
from qpwcnet_torch.models import build_flow_net, load_flax_variables
from qpwcnet_torch.models.from_flax import (
    load_flax_opt_state,
    to_flax_opt_state,
    to_flax_tree,
)
from qpwcnet_torch.train import (
    default_optimizer,
    make_flow_train_step,
    plain_optimizer,
)
from tests.conftest import TEST_HW
from tests.test_torch_model import (
    _seeded,
    one_torch_thread,  # noqa: F401
)

H, W = TEST_HW
LR = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  jax.device_get(tree))


def _recording():
    """An optax transform that keeps the raw gradients as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(seed):
    rng = np.random.RandomState(seed)
    ims = rng.uniform(-0.5, 0.5, (2, H, W, 6)).astype(np.float32)
    flo = rng.uniform(-3.0, 3.0, (2, H, W, 2)).astype(np.float32)
    return ims, flo


def _jax_step(model_j, v, ims, flo):
    """JAX make_flow_train_step under the plain chain, with the raw
    gradients recorded; then the reference chain (default_optimizer) on
    the same gradients. Returns (loss, grads, batch_stats, params after
    the plain chain, params after the reference chain)."""
    tx = optax.chain(_recording(), j_zero_nan_grads(), optax.adam(LR))
    state = create_flow_train_state(model_j, v, tx=tx)
    new, metrics = jax.jit(j_make_step())(
        state, {"ims": jnp.asarray(ims), "flo": jnp.asarray(flo)})
    grads = new.opt_state[0]
    ref = j_default_opt(LR)
    upd, _ = jax.jit(ref.update)(grads, ref.init(v["params"]), v["params"])
    return (float(metrics["loss"]), _np_tree(grads),
            _np_tree(new.batch_stats), _np_tree(new.params),
            _np_tree(optax.apply_updates(v["params"], upd)))


def _port_step(v, chain, ims, flo, **kw):
    model = load_flax_variables(build_flow_net(0, "cpu", **kw), v)
    opt = chain(model, LR)
    m = make_flow_train_step()(model, opt, {"ims": torch.from_numpy(ims),
                                             "flo": torch.from_numpy(flo)})
    return model, m


# Leaves whose gradient is the small remainder of a near-total
# cancellation: they feed a flow head's train-mode BatchNorm, directly or
# through its 1x1 conv, and BatchNorm removes any per-channel shift.
CANCELLING = ("['conv1x1']['bias']", "['of_feat_3']['pointwise']['bias']")


def _grad_tol(key, grads):
    """The gradient tolerance of a leaf: 1e-4 of its max|g|, or for a
    cancelling leaf of the largest max|g| in its flow head (the size of
    the terms that cancel)."""
    if not key.endswith(CANCELLING):
        return 1e-4 * float(np.max(np.abs(grads[key])))
    head = key.split("['flow']")[0] + "['flow']"
    return 1e-4 * max(float(np.max(np.abs(g))) for k, g in grads.items()
                      if k.startswith(head))


def _check_params(got, want, grads, eps=1e-8):
    """One Adam step moves each parameter by -lr * g / (|g| + eps). With
    dg the gradient tolerance, that is exact to 1e-3 of lr, plus the
    float32 rounding of both results (2^-23 |p| each), plus dg times the
    step's slope lr * eps / (|g| + eps)^2 (steep where |g| is near eps);
    where |g| <= dg the sign of g is not determined and the two steps
    may differ by up to 2 lr."""
    g, w, gr = _leaves(got), _leaves(want), _leaves(grads)
    assert g.keys() == w.keys()
    for k in w:
        err = np.abs(g[k] - w[k])
        dg = _grad_tol(k, gr)
        slope = LR * eps / (np.abs(gr[k]) + eps) ** 2
        tol = 1e-3 * LR + 2.0 ** -22 * np.abs(w[k]) + slope * dg
        assert not np.any((err > tol) & (np.abs(gr[k]) > dg)), k
        assert float(np.max(err)) <= 2.0 * LR * (1 + 1e-3), k


@pytest.mark.parametrize("head_scale,residual", [("diag", False),
                                                 ("unit", True)])
def test_train_step_matches_jax(flow_setup, head_scale, residual):
    """Fresh 'diag' heads output 0 at every level, so every warp samples
    integer positions, where the warp's flow gradient takes JAX's clip
    tie rule; the zero heads also pass no gradient upstream, so that
    gradient is multiplied by 0 here, and the warp tests hold the rule.
    Seeded 'unit' heads with residual=True give flows of a few px."""
    model_j, variables = flow_setup
    model_j = model_j.clone(head_scale=head_scale, residual=residual)
    v = (_np_tree(variables) if head_scale == "diag"
         else _seeded(variables, head_scale, k=0.5, hw=TEST_HW))
    ims, flo = _batch(1)
    loss_j, grads_j, stats_j, plain_j, ref_j = _jax_step(model_j, v, ims,
                                                          flo)
    kw = dict(head_scale=head_scale, residual=residual)

    model, m = _port_step(v, plain_optimizer, ims, flo, **kw)
    assert abs(float(m["loss"]) - loss_j) <= 1e-5 * max(1.0, abs(loss_j))
    assert np.isfinite(float(m["epe"]))
    got = _leaves(to_flax_tree(model, "grads"))
    want = _leaves(grads_j)
    assert got.keys() == want.keys()
    nonzero = 0
    for k in want:
        scale = float(np.max(np.abs(want[k])))
        nonzero += scale > 0
        err = float(np.max(np.abs(got[k] - want[k])))
        assert err <= _grad_tol(k, want) or err == 0.0, (k, err, scale)
    # a zero head passes no gradient upstream: fresh 'diag' gives one to
    # the five head kernels and, through the l2 term, to the 19 DownConv
    # and UpConv kernels only
    assert nonzero == (5 + 19 if head_scale == "diag" else len(want))
    for name, node in stats_j["flower"].items():
        bn = dict(model.named_modules())[
            ("flower." + name.replace("upflow_", "upflows.")
             + ".flow.norm")]
        for key, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
            assert float(np.max(np.abs(buf.numpy()
                                       - node["flow"]["norm"][key]))) <= 1e-5
    _check_params(to_flax_tree(model), plain_j, grads_j)

    model, m = _port_step(v, default_optimizer, ims, flo, **kw)
    assert abs(float(m["loss"]) - loss_j) <= 1e-5 * max(1.0, abs(loss_j))
    _check_params(to_flax_tree(model), ref_j, grads_j)


def _adam_of(opt_state):
    """The ScaleByAdamState inside an optax chain state."""
    nodes = jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
    return next(n for n in nodes if isinstance(n, optax.ScaleByAdamState))


def _as_grads(model, tree, stats):
    """Set each parameter's .grad to a Flax-layout gradient tree's leaf."""
    scratch = load_flax_variables(build_flow_net(0, "cpu"),
                                  {"params": tree, "batch_stats": stats})
    for p, g in zip(model.parameters(), scratch.parameters()):
        p.grad = g.detach().clone()


@pytest.mark.parametrize("kind", ["plain", "reference"])
def test_optimizer_state_carried_from_jax(flow_setup, kind):
    """A JAX TrainState after 2 steps (the plain chain: NaN scrub ->
    Adam; the reference chain: NaN scrub -> AGC -> Adam) carried into the
    port (load_flax_variables, load_flax_opt_state), then one more step
    in each on the same batch. The port's full step holds
    test_train_step_matches_jax's tolerances for the loss, every
    gradient (plain chain), the BatchNorm statistics and the 2 lr bound
    on every parameter; the port's chain stepped with JAX's own gradient
    holds the
    parameters to 1e-3 lr plus both results' float32 rounding (2^-22
    |p|), and the new Adam moments to 1e-5 of each leaf's max (AGC's
    norms are summed in another order)."""
    model_j, variables = flow_setup
    model_j = model_j.clone(head_scale="unit", residual=True)
    v = _seeded(variables, "unit", k=0.5, hw=TEST_HW)
    inner = (optax.chain(j_zero_nan_grads(), optax.adam(LR))
             if kind == "plain" else j_default_opt(LR))
    state = create_flow_train_state(model_j, v,
                                    tx=optax.chain(_recording(), inner))
    step_j = jax.jit(j_make_step())
    for seed in (1, 2):
        ims, flo = _batch(seed)
        state, _ = step_j(state, {"ims": jnp.asarray(ims),
                                  "flo": jnp.asarray(flo)})
    v2 = {"params": _np_tree(state.params),
          "batch_stats": _np_tree(state.batch_stats)}
    opt2 = jax.device_get(state.opt_state)
    ims, flo = _batch(3)
    new, metrics = step_j(state, {"ims": jnp.asarray(ims),
                                  "flo": jnp.asarray(flo)})
    grads_j = _np_tree(new.opt_state[0])
    chain = plain_optimizer if kind == "plain" else default_optimizer
    kw = dict(head_scale="unit", residual=True)

    def carried():
        model = load_flax_variables(build_flow_net(0, "cpu", **kw), v2)
        return model, load_flax_opt_state(chain(model, LR), opt2)

    model, opt = carried()
    assert {float(s["step"]) for s in opt.adam.state.values()} == {2.0}
    m = make_flow_train_step()(model, opt, {"ims": torch.from_numpy(ims),
                                           "flo": torch.from_numpy(flo)})
    loss_j = float(metrics["loss"])
    assert abs(float(m["loss"]) - loss_j) <= 1e-5 * max(1.0, abs(loss_j))
    if kind == "plain":
        # the reference chain's AGC scales .grad in place
        got, want = _leaves(to_flax_tree(model, "grads")), _leaves(grads_j)
        assert got.keys() == want.keys()
        for k in want:
            err = float(np.max(np.abs(got[k] - want[k])))
            assert err <= _grad_tol(k, want) or err == 0.0, (k, err)
    for k, w in _leaves(new.batch_stats).items():
        parts = [p.strip("[]'") for p in k.split("][")]
        name = ".".join(parts[:-1]).replace("upflow_", "upflows.")
        mod = dict(model.named_modules())[name]
        buf = mod.running_mean if parts[-1] == "mean" else mod.running_var
        assert float(np.max(np.abs(buf.numpy() - w))) <= 1e-5, k
    params_j = _leaves(_np_tree(new.params))
    full = _leaves(to_flax_tree(model))
    for k in params_j:
        assert float(np.max(np.abs(full[k] - params_j[k]))) <= \
            2.0 * LR * (1 + 1e-3), k

    model, opt = carried()
    _as_grads(model, grads_j, v2["batch_stats"])
    opt.step()
    got = _leaves(to_flax_tree(model))
    for k, w in params_j.items():
        tol = 1e-3 * LR + 2.0 ** -22 * np.abs(w)
        assert np.all(np.abs(got[k] - w) <= tol), k
    got_adam = _adam_of(to_flax_opt_state(opt, opt2))
    want_adam = _adam_of(jax.device_get(new.opt_state))
    assert int(got_adam.count) == int(want_adam.count) == 3
    for moment in ("mu", "nu"):
        g, w = (_leaves(getattr(got_adam, moment)),
                _leaves(getattr(want_adam, moment)))
        assert g.keys() == w.keys()
        for k in w:
            err = float(np.max(np.abs(g[k] - w[k])))
            assert err <= 1e-5 * float(np.max(np.abs(w[k]))), (moment, k)


def test_optimizer_state_round_trip():
    """load_flax_opt_state inverts to_flax_opt_state, bit for bit, for
    both chains' state structures."""
    model = build_flow_net(0, "cpu", head_scale="unit", residual=True)
    opt = plain_optimizer(model, LR)
    ims, flo = _batch(4)
    make_flow_train_step()(model, opt, {"ims": torch.from_numpy(ims),
                                        "flo": torch.from_numpy(flo)})
    params = to_flax_tree(model)
    for tx in (optax.chain(j_zero_nan_grads(), optax.adam(LR)),
               j_default_opt(LR)):
        template = jax.device_get(tx.init(params))
        tree = to_flax_opt_state(opt, template)
        assert (jax.tree_util.tree_structure(tree)
                == jax.tree_util.tree_structure(template))
        back = load_flax_opt_state(plain_optimizer(model, LR), tree)
        for p in model.parameters():
            a, b = opt.adam.state[p], back.adam.state[p]
            assert a.keys() == b.keys()
            for name in a:
                assert torch.equal(a[name], b[name]), name
