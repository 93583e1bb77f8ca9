"""Gradients of the PyTorch port's ops against the JAX package on CPU:
the warp's custom VJP, the cost volume's (the plain versions of the
backward kernels K4a and K4b), the trainable fused-stem (K2) and fused
warp+correlate (K3) Functions, the losses, AGC and the NaN scrub.

Inputs come from numpy seeds and go through both packages. Tolerances:
float32 results that sum in another order than XLA agree to 1e-5 of the
magnitude; bf16 ones to a few bf16 roundoffs (2^-8, half an ulp) of it,
stated at each check with its reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpwcnet_tpu.models.blocks import DownConv
from qpwcnet_tpu.ops import resize as jresize
from qpwcnet_tpu.ops import warp as jwarp
from qpwcnet_tpu.ops.cost_volume import cost_volume_xla
from qpwcnet_tpu.train.agc import adaptive_clip_grads as jax_agc
from qpwcnet_tpu.train import losses as jlosses
from qpwcnet_torch.models import build_flow_net, load_flax_variables
from qpwcnet_torch.models.from_flax import to_flax_tree
from qpwcnet_torch.ops import resize as tresize
from qpwcnet_torch.ops.cost_volume import (
    CostVolumeFunction,
    cost_volume,
    cost_volume_bwd_nxt_plain,
    cost_volume_bwd_prv_plain,
)
from qpwcnet_torch.ops.cuda.stem_kernel import downconv_stage_trainable
from qpwcnet_torch.ops.cuda.warp_cv_kernel import (
    FUSED_WARP_WINDOW,
    warp_cost_volume_trainable,
)
from qpwcnet_torch.ops.warp import backward_warp, clip_balanced
from qpwcnet_torch.train import agc as tagc
from qpwcnet_torch.train import losses as tlosses

BF16_ROUNDOFF = 2.0 ** -8  # half a bf16 ulp, relative


def _t(x, dtype=torch.float32, grad=False):
    t = torch.from_numpy(np.array(x, np.float32)).to(dtype)
    return t.requires_grad_() if grad else t


def _jax_vjp(fn, g, *args):
    """(fn(*args), the vjp of fn at args applied to g). float32 runs as
    one jitted program, much faster to compile than op by op; bf16 runs
    op by op, as the port does, because XLA's fusions keep bf16
    intermediates in float32 and so round at other points."""
    def run(g, *a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(g)
    if g.dtype == jnp.bfloat16:
        return run(g, *args)
    return jax.jit(run)(g, *args)


def _close(got, want, rel):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = rel * max(float(np.max(np.abs(want))), 1.0)
    err = float(np.max(np.abs(got - want)))
    assert err <= tol, (err, tol)


# ------------------------------------------------------------------ warp

def _warp_flow(kind, rng, shape):
    b, h, w = shape
    if kind == "zero":
        return np.zeros((b, h, w, 2), np.float32)
    if kind == "integer":
        return rng.randint(-3, 4, (b, h, w, 2)).astype(np.float32)
    if kind == "random":
        return rng.uniform(-3, 3, (b, h, w, 2)).astype(np.float32)
    # border-saturated: most samples beyond the image, some on its edge
    return rng.choice([-40.0, -7.5, 0.0, 7.0, 40.0],
                      (b, h, w, 2)).astype(np.float32)


@pytest.mark.parametrize("kind,shape,dtype", [
    *((kind, shape, "float32") for kind, shape in (
        ("zero", (2, 7, 9)), ("integer", (2, 7, 9)), ("random", (2, 7, 9)),
        ("border", (2, 7, 9)), ("random", (2, 1, 9)), ("zero", (1, 5, 1)),
        ("random", (1, 1, 1)))),
    ("zero", (2, 7, 9), "bfloat16"), ("random", (2, 7, 9), "bfloat16"),
    ("border", (2, 7, 9), "bfloat16")])
def test_backward_warp_grads_match_jax(kind, shape, dtype):
    """d_img and d_flow of the JAX op's custom VJP. At zero and integer
    flow every weight sits on its clip bound: JAX's clip passes half the
    gradient there, torch.clamp would pass all of it (2x d_flow)."""
    rng = np.random.RandomState(len(kind) * 100 + sum(shape))
    b, h, w = shape
    img = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    flow = _warp_flow(kind, rng, shape)
    g = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out_j, (d_img_j, d_flow_j) = _jax_vjp(
        jwarp.backward_warp, jnp.asarray(g, jdt), jnp.asarray(img, jdt),
        jnp.asarray(flow))

    img_t, flow_t = _t(img, tdt, grad=True), _t(flow, grad=True)
    out_t = backward_warp(img_t, flow_t)
    out_t.backward(_t(g, tdt))
    assert img_t.grad.dtype == tdt and flow_t.grad.dtype == torch.float32
    # float32: rounding-level (the scatter-adds sum in another order);
    # bf16: the interpolation and the scatter-adds round in bf16 at the
    # same points, a few adds in another order
    rel = 1e-5 if dtype == "float32" else 4 * BF16_ROUNDOFF
    _close(out_t, out_j, rel)
    _close(img_t.grad, d_img_j, rel)
    _close(flow_t.grad, d_flow_j, rel)
    if kind == "zero" and h > 1:
        assert float(np.max(np.abs(np.asarray(d_flow_j)))) > 0.1


def test_clip_balanced_takes_jax_gradient_at_ties():
    x = np.array([-1.0, 0.0, 0.25, 1.0, 2.0, -4.0, 4.0], np.float32)
    lo_hi = [(0.0, 1.0)] * 5 + [(-4.0, 4.0)] * 2
    for (lo, hi), xi in zip(lo_hi, x):
        want = float(jax.grad(lambda v: jnp.clip(v, lo, hi))(xi))
        t = _t(xi, grad=True)
        clip_balanced(t, lo, hi).backward()
        assert float(t.grad) == want, (xi, lo, hi, float(t.grad), want)


def test_block_mean_downsample_matches_jax():
    x = np.random.RandomState(0).standard_normal((2, 12, 16, 2))
    _close(tresize.block_mean_downsample(_t(x), 4, 2),
           jresize.block_mean_downsample(jnp.asarray(x, jnp.float32), 4, 2),
           1e-6)
    with pytest.raises(ValueError):
        tresize.block_mean_downsample(_t(x), 5, 2)


# ---------------------------------------------------------- cost volume

def _cv_inputs(seed, shape):
    rng = np.random.RandomState(seed)
    prv = rng.standard_normal(shape).astype(np.float32)
    nxt = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape[:3] + (81,)).astype(np.float32)
    return prv, nxt, g


@pytest.mark.parametrize("shape,dtype", [
    ((2, 8, 16, 8), "float32"), ((1, 5, 11, 3), "float32"),
    ((2, 13, 10, 20), "float32"), ((1, 5, 11, 3), "bfloat16"),
    ((2, 13, 10, 20), "bfloat16")])
def test_cost_volume_function_grads_match_jax(shape, dtype):
    """CostVolumeFunction's backward (dacc, then K4a's and K4b's plain
    versions) against jax.vjp of cost_volume_xla, the oracle of the JAX
    package's own Pallas-VJP tests. (1, 5, 11, 3) is smaller than the
    9x9 window."""
    prv, nxt, g = _cv_inputs(sum(shape), shape)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out_j, (dprv_j, dnxt_j) = _jax_vjp(
        cost_volume_xla, jnp.asarray(g, jdt), jnp.asarray(prv, jdt),
        jnp.asarray(nxt, jdt))

    prv_t, nxt_t = _t(prv, tdt, grad=True), _t(nxt, tdt, grad=True)
    out_t = cost_volume(prv_t, nxt_t)
    assert type(out_t.grad_fn).__name__ == "CostVolumeFunctionBackward"
    out_t.backward(_t(g, tdt))
    assert prv_t.grad.dtype == nxt_t.grad.dtype == tdt
    # float32: 81-term float32 sums in another order. bf16: the products
    # are exact in float32 on both sides after dacc = g * 0.1 is rounded
    # to bf16 at the same point; the two sums (81 terms here, 81 per
    # channel in XLA's transpose) differ in order, and the results round
    # once to bf16: 2 roundoffs.
    rel = 1e-5 if dtype == "float32" else 2 * BF16_ROUNDOFF
    _close(out_t, out_j, rel)
    _close(prv_t.grad, dprv_j, rel)
    _close(nxt_t.grad, dnxt_j, rel)


def test_cost_volume_bwd_plain_versions_match_jax():
    """K4a's and K4b's plain versions from dacc directly."""
    prv, nxt, g = _cv_inputs(1, (2, 9, 12, 5))
    out_j, (dprv_j, dnxt_j) = _jax_vjp(
        cost_volume_xla, jnp.asarray(g), jnp.asarray(prv), jnp.asarray(nxt))
    dacc = (g * np.where(np.asarray(out_j) > 0, 1.0, 0.1)).astype(np.float32)
    _close(cost_volume_bwd_prv_plain(_t(dacc), _t(nxt)), dprv_j, 1e-5)
    _close(cost_volume_bwd_nxt_plain(_t(dacc), _t(prv)), dnxt_j, 1e-5)
    with pytest.raises(ValueError):
        cost_volume_bwd_prv_plain(_t(dacc)[..., :80], _t(nxt))


def test_cost_volume_function_gradcheck_float64():
    rng = np.random.RandomState(2)
    prv = torch.from_numpy(rng.standard_normal((1, 6, 9, 3))
                           ).requires_grad_()
    nxt = torch.from_numpy(rng.standard_normal((1, 6, 9, 3))
                           ).requires_grad_()
    assert torch.autograd.gradcheck(CostVolumeFunction.apply, (prv, nxt),
                                    eps=1e-6, atol=1e-8, rtol=1e-6,
                                    fast_mode=True)


def test_cost_volume_function_matches_plain_autograd():
    """'auto' (the Function) and 'plain' (autograd of the shifts) agree on
    CPU, values and gradients."""
    prv, nxt, g = _cv_inputs(3, (2, 6, 7, 4))
    grads = []
    for impl in ("auto", "plain"):
        p, n = _t(prv, grad=True), _t(nxt, grad=True)
        cost_volume(p, n, impl=impl).backward(_t(g))
        grads.append((p.grad, n.grad))
    for a, b in zip(*grads):
        _close(a, b.numpy(), 1e-6)


# ------------------------------------------------------ trainable K2, K3

@pytest.mark.parametrize("cin,cout", [(3, 16), (16, 32)])
def test_downconv_stage_trainable_grads_match_jax(cin, cout):
    """The fused stem's Function on CPU against jax.vjp of the Flax
    DownConv module, for the input and all six parameters."""
    rng = np.random.RandomState(cin)
    x = rng.standard_normal((2, 12, 16, cin)).astype(np.float32)
    m = DownConv(cout, use_normalizer=False, dtype=jnp.float32)
    v = jax.device_get(m.init(jax.random.key(cin), jnp.asarray(x)))
    names = ("conv_a", "conv_aa", "conv_b")
    for n in names:
        v["params"][n]["bias"] = (0.1 * rng.randn(cout)).astype(np.float32)
    g = rng.standard_normal((2, 6, 8, cout)).astype(np.float32)
    out_j, (dp_j, dx_j) = _jax_vjp(
        lambda p, xx: m.apply({"params": p}, xx), jnp.asarray(g),
        v["params"], jnp.asarray(x))

    params = [(_t(v["params"][n]["kernel"].transpose(3, 2, 0, 1),
                  grad=True), _t(v["params"][n]["bias"], grad=True))
              for n in names]
    x_t = _t(x, grad=True)
    out_t = downconv_stage_trainable(x_t, params, torch.float32)
    out_t.backward(_t(g))
    # three float32 convs and their transposes summed in another order
    _close(out_t, out_j, 1e-5)
    _close(x_t.grad, dx_j, 1e-5)
    for n, (w, bias) in zip(names, params):
        _close(w.grad.numpy().transpose(2, 3, 1, 0), dp_j[n]["kernel"], 1e-5)
        _close(bias.grad, dp_j[n]["bias"], 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["zero", "random"])
def test_warp_cost_volume_trainable_grads_match_jax(kind, dtype):
    """The fused warp+correlate Function on CPU against jax.vjp of
    cost_volume_xla(prv, backward_warp(nxt, clip(flow, ±4))). The random
    flows reach ±7 and include entries exactly on ±4, where the clip's
    gradient is JAX's half."""
    rng = np.random.RandomState(11)
    shape = (2, 9, 12, 6)
    prv = rng.standard_normal(shape).astype(np.float32)
    nxt = rng.standard_normal(shape).astype(np.float32)
    if kind == "zero":
        flow = np.zeros(shape[:3] + (2,), np.float32)
    else:
        flow = rng.uniform(-7, 7, shape[:3] + (2,)).astype(np.float32)
        flow.reshape(-1)[::5] = 4.0
        flow.reshape(-1)[1::7] = -4.0
    g = rng.standard_normal(shape[:3] + (81,)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    ww = float(FUSED_WARP_WINDOW)

    def composition(p, n, f):
        return cost_volume_xla(p, jwarp.backward_warp(n, jnp.clip(f, -ww,
                                                                  ww)))

    out_j, grads_j = _jax_vjp(composition, jnp.asarray(g, jdt),
                              jnp.asarray(prv, jdt), jnp.asarray(nxt, jdt),
                              jnp.asarray(flow))
    leaves = [_t(prv, tdt, True), _t(nxt, tdt, True), _t(flow, grad=True)]
    out_t = warp_cost_volume_trainable(*leaves)
    out_t.backward(_t(g, tdt))
    # float32: rounding-level; bf16: the warp's bf16 interpolation and
    # scatter-adds, then the correlation sums, in other orders: d_flow
    # sums 81 * C such terms, 8 roundoffs of its magnitude
    rel = 1e-5 if dtype == "float32" else 8 * BF16_ROUNDOFF
    _close(out_t, out_j, rel)
    for t, want in zip(leaves, grads_j):
        _close(t.grad, want, rel)


# --------------------------------------------------------- losses, AGC

def test_losses_match_jax():
    rng = np.random.RandomState(4)
    err = rng.uniform(-0.3, 0.3, 400).astype(np.float32)
    err[:3] = [0.1, -0.1, 0.0]
    _close(tlosses._huber(_t(err), 0.1), jlosses._huber(jnp.asarray(err),
                                                        0.1), 1e-7)
    true = rng.uniform(-8, 8, (2, 32, 64, 2)).astype(np.float32)
    preds = [rng.uniform(-4, 4, (2, 32 >> s, 64 >> s, 2)).astype(np.float32)
             for s in (5, 4, 3, 2, 1, 0)]
    _close(tlosses.flow_loss_v2(_t(true), _t(preds[2])),
           jlosses.flow_loss_v2(jnp.asarray(true), jnp.asarray(preds[2])),
           1e-6)
    _close(tlosses.multiscale_flow_loss(_t(true), [_t(p) for p in preds]),
           jlosses.multiscale_flow_loss(jnp.asarray(true),
                                        [jnp.asarray(p) for p in preds]),
           1e-6)
    _close(tlosses.epe_error(_t(true), _t(preds[-1])),
           jlosses.epe_error(jnp.asarray(true), jnp.asarray(preds[-1])),
           1e-6)


def _tree_err(got, want):
    """Max over leaves of max|got - want| / max(1, max|want|)."""
    worst = 0.0
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for p in path:
            g = g[p.key]
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        worst = max(worst, float(np.max(np.abs(g - w)))
                    / max(1.0, float(np.max(np.abs(w)))))
    return worst


def test_to_flax_tree_inverts_the_loader(flow_setup):
    _, variables = flow_setup
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                               jax.device_get(variables))
    model = load_flax_variables(build_flow_net(0, "cpu"), v)
    assert _tree_err(to_flax_tree(model), v["params"]) == 0.0
    with pytest.raises(ValueError):
        to_flax_tree(model, "grads")  # no .grad yet


def test_l2_agc_and_nan_scrub_match_jax(flow_setup):
    """On the whole flow-net tree: the l2 term, AGC with the of_flow
    exemption (conv_up's (I, O, kh, kw) and the depthwise (C, 1, kh, kw)
    layouts included) and the NaN scrub."""
    _, variables = flow_setup
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                               jax.device_get(variables))
    params = v["params"]
    rng = np.random.RandomState(5)
    # per-leaf gradient scales from far below to far above the AGC bound
    grads = jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 10.0 ** rng.uniform(-6, 1)
                   ).astype(np.float32), params)
    grads["flower"]["upflow_1"]["flow"]["of_feat_0"]["pointwise"][
        "kernel"][0, 0, 3, 5] = np.nan
    # the layout-trap leaves, far above the bound: clipped per channel
    trap = [("decoder", "stage_0", "conv_up", "kernel"),
            ("flower", "upflow_2", "flow", "of_feat_1", "depthwise",
             "kernel")]

    def leaf(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    for path in trap:
        g0 = leaf(grads, path)
        g0[...] = rng.uniform(0.1, 1.0, g0.shape[-1]) * \
            rng.standard_normal(g0.shape)
    model = load_flax_variables(build_flow_net(0, "cpu"), v)
    grads_t = load_flax_variables(build_flow_net(0, "cpu"), {
        "params": grads, "batch_stats": v["batch_stats"]})
    for p, gp in zip(model.parameters(), grads_t.parameters()):
        p.grad = gp.detach().clone()

    _close(tlosses.l2_regularization(model, 4e-6),
           jlosses.l2_regularization(params, 4e-6), 1e-6)

    scrubbed = jax.tree_util.tree_map(
        lambda g: np.where(np.isnan(g), 0.0, g), grads)
    tagc.zero_nan_grads(model)
    assert _tree_err(to_flax_tree(model, "grads"), scrubbed) == 0.0

    want = jax.jit(lambda p, g: jax_agc(p, g, 0.01, 1e-3,
                                        exclude=("of_flow",)))(
        params, scrubbed)
    tagc.adaptive_clip_grads(model, 0.01, 1e-3, exclude=("of_flow",))
    got = to_flax_tree(model, "grads")
    # unit-wise norms summed in another order: 1e-6 of each leaf
    assert _tree_err(got, want) <= 1e-6
    # both branches are taken, and the layout-trap leaves are clipped
    clipped = [not np.array_equal(a, np.asarray(b)) for a, b in zip(
        jax.tree_util.tree_leaves(scrubbed), jax.tree_util.tree_leaves(want))]
    assert 0 < sum(clipped) < len(clipped)
    for path in trap:
        assert leaf(grads, path).ndim == 4
        assert not np.allclose(leaf(got, path), leaf(scrubbed, path))
    head = ("flower", "flow_0", "flow", "of_flow", "kernel")
    np.testing.assert_array_equal(leaf(got, head), leaf(scrubbed, head))
