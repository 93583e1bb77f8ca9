"""The port's last small ops and losses against the JAX package's, on CPU:
the two learning-rate schedules, flow_mse_loss and flow_finetune_loss
(values and gradients, the NaN gradient of a zero residual included),
backward_warp_manual and invert_flow (values and gradients, with flows
that cross every border), estimate_occlusion_map and cost_volume_to_flow
(exactly).

The same numpy-seeded inputs go to both; float32 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpwcnet_torch.ops import (
    backward_warp_manual,
    cost_volume_to_flow,
    estimate_occlusion_map,
    invert_flow,
)
from qpwcnet_torch.train import (
    flow_finetune_loss,
    flow_mse_loss,
    piecewise_halving_schedule,
    triangular2_cyclic_schedule,
)
from qpwcnet_tpu.ops import backward_warp_manual as j_warp_manual
from qpwcnet_tpu.ops import cost_volume_to_flow as j_cv_to_flow
from qpwcnet_tpu.ops import estimate_occlusion_map as j_occlusion
from qpwcnet_tpu.ops import invert_flow as j_invert_flow
from qpwcnet_tpu.train import flow_finetune_loss as j_finetune_loss
from qpwcnet_tpu.train import flow_mse_loss as j_mse_loss
from qpwcnet_tpu.train.schedules import (
    piecewise_halving_schedule as j_piecewise,
)
from qpwcnet_tpu.train.schedules import (
    triangular2_cyclic_schedule as j_triangular,
)

# float32 values and gradients summed in another order than XLA's
RTOL, ATOL = 1e-5, 1e-6


# ---------------------------------------------------------------- schedules

@pytest.mark.parametrize("batch_size", [8, 16, 3])
def test_piecewise_halving_schedule_matches_optax(batch_size):
    """The rate at counts 0 and 1 and at each boundary -1 / 0 / +1 (optax
    halves AT the boundary), within float32 rounding (rtol 1e-6)."""
    got, want = (piecewise_halving_schedule(batch_size),
                 j_piecewise(batch_size))
    counts = [0, 1]
    for x in (400_000, 600_000, 800_000, 1_000_000):
        b = int(x * 8 / batch_size)
        counts += [b - 1, b, b + 1]
    for c in counts:
        np.testing.assert_allclose(got(c), float(want(jnp.int32(c))),
                                   rtol=1e-6, err_msg=str(c))
    b0 = int(400_000 * 8 / batch_size)
    assert got(b0) == 0.5 * got(b0 - 1) and got(b0 + 1) == got(b0)


@pytest.mark.parametrize("kw", [dict(batch_size=8),
                                dict(batch_size=16, step_size=7.0),
                                dict(batch_size=4, initial_learning_rate=1e-3,
                                     maximal_learning_rate=2e-3,
                                     step_size=13.0)])
def test_triangular2_cyclic_schedule_matches_jax(kw):
    """The triangle wave over several cycles (its amplitude halved each
    one), at counts 0, 1, every step_size -1 / 0 / +1 and mid-slope, in
    float32 as JAX's jnp arithmetic on an int32 count (rtol 1e-6)."""
    got, want = triangular2_cyclic_schedule(**kw), j_triangular(**kw)
    step = kw.get("step_size", 10e3 * (8 / kw["batch_size"]))
    counts = {0, 1}
    for k in range(1, 9):
        counts |= {int(k * step) - 1, int(k * step), int(k * step) + 1,
                   int((k - 0.5) * step)}
    vals = []
    for c in sorted(counts):
        vals.append(got(c))
        np.testing.assert_allclose(vals[-1], float(want(jnp.int32(c))),
                                   rtol=1e-6, err_msg=str(c))
    assert len(set(vals)) > 10  # the wave moves


# ------------------------------------------------------------------- losses

def _flows(seed, true_hw, pred_hw, b=2):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-6, 6, (b, *true_hw, 2)).astype(np.float32),
            rng.uniform(-2, 2, (b, *pred_hw, 2)).astype(np.float32))


def _loss_and_grads_jax(fn, t, p):
    val, grads = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(t),
                                                        jnp.asarray(p))
    return float(val), [np.asarray(g) for g in grads]


def _loss_and_grads_torch(fn, t, p):
    tt, pp = (torch.from_numpy(a).requires_grad_() for a in (t, p))
    val = fn(tt, pp)
    val.backward()
    return float(val.detach()), [tt.grad.numpy(), pp.grad.numpy()]


@pytest.mark.parametrize("loss", ["mse", "finetune"])
@pytest.mark.parametrize("pred_hw", [(8, 16), (32, 64)])
def test_flow_losses_match_jax(loss, pred_hw):
    """flow_mse_loss / flow_finetune_loss, their values and both inputs'
    gradients, with the GT resized (antialiased) to a coarser prediction
    and at the same size: rtol 1e-5, atol 1e-6."""
    fn, jfn = {"mse": (flow_mse_loss, j_mse_loss),
               "finetune": (flow_finetune_loss, j_finetune_loss)}[loss]
    t, p = _flows(0, (32, 64), pred_hw)
    v_j, g_j = _loss_and_grads_jax(jfn, t, p)
    v_t, g_t = _loss_and_grads_torch(fn, t, p)
    np.testing.assert_allclose(v_t, v_j, rtol=RTOL)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_flow_mse_loss_zero_residual_gradient_is_nan_like_jax():
    """At an exactly zero residual ``jnp.linalg.norm``'s gradient is NaN
    (0/0); the port mirrors it (sqrt of the sum of squares, not
    ``vector_norm``, whose gradient there is 0): the same pixels are NaN
    in both gradients, and the others agree."""
    t, p = _flows(1, (16, 32), (16, 32))
    p[:, 3:5, 7:11] = t[:, 3:5, 7:11]  # same size: the resize is exact
    v_j, g_j = _loss_and_grads_jax(j_mse_loss, t, p)
    v_t, g_t = _loss_and_grads_torch(flow_mse_loss, t, p)
    np.testing.assert_allclose(v_t, v_j, rtol=RTOL)
    for a, b in zip(g_t, g_j):
        assert np.isnan(b).any()
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)],
                                   rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------- warp

def _warp_inputs(seed, b=2, h=9, w=12, c=3):
    rng = np.random.RandomState(seed)
    img = rng.standard_normal((b, h, w, c)).astype(np.float32)
    # flows past every border, with fractional parts away from ties
    flow = rng.uniform(-7.0, 7.0, (b, h, w, 2)).astype(np.float32)
    return img, flow


def test_backward_warp_manual_matches_jax():
    """backward_warp_manual's values and the gradients of a random
    cotangent with respect to the image and the flow (truncation toward
    zero, independent corner clamps, extrapolating weights at the
    borders): rtol 1e-5, atol 1e-6."""
    img, flow = _warp_inputs(2)
    g = np.random.RandomState(3).standard_normal(img.shape).astype(
        np.float32)
    want, vjp = jax.vjp(j_warp_manual, jnp.asarray(img), jnp.asarray(flow))
    d_img_j, d_flow_j = vjp(jnp.asarray(g))
    ti, tf = (torch.from_numpy(a).requires_grad_() for a in (img, flow))
    got = backward_warp_manual(ti, tf)
    got.backward(torch.from_numpy(g))
    assert (np.abs(flow) > 5).any()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(d_img_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(d_flow_j),
                               rtol=RTOL, atol=ATOL)


def test_invert_flow_matches_jax():
    """invert_flow = -warp(flow, flow): values and the flow's gradient of
    a random cotangent, rtol 1e-5, atol 1e-6."""
    _, flow = _warp_inputs(4)
    g = np.random.RandomState(5).standard_normal(flow.shape).astype(
        np.float32)
    want, vjp = jax.vjp(j_invert_flow, jnp.asarray(flow))
    (d_j,) = vjp(jnp.asarray(g))
    tf = torch.from_numpy(flow).requires_grad_()
    got = invert_flow(tf)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(d_j),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("scale", [0.5, 3.0, 12.0])
def test_estimate_occlusion_map_matches_jax(scale):
    """The occlusion mask, exactly: flows inside the image, past it, and
    negative positions truncated toward zero before the clip (JAX's
    order)."""
    rng = np.random.RandomState(int(scale * 10))
    flow = (scale * rng.standard_normal((2, 16, 24, 2))).astype(np.float32)
    want = np.asarray(j_occlusion(jnp.asarray(flow)))
    got = estimate_occlusion_map(torch.from_numpy(flow)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 16, 24)
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [3, 9])
def test_cost_volume_to_flow_matches_jax(d):
    """The argmax decoding, exactly, on a cost volume of small integers
    (many ties: the first maximum wins in both), in (di, dj) order."""
    cvol = np.random.RandomState(d).randint(0, 4, (2, 5, 7, d * d)).astype(
        np.float32)
    want = np.asarray(j_cv_to_flow(jnp.asarray(cvol)))
    got = cost_volume_to_flow(torch.from_numpy(cvol)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 5, 7, 2)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        cost_volume_to_flow(torch.zeros(1, 2, 2, 8))
