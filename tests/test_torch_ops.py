"""Parity of the PyTorch port's ops (qpwcnet_torch.ops, quantize.qlayers)
with the JAX package, on CPU.

Inputs come from numpy with fixed seeds and go through both the JAX
function and its port. Tolerances: float32 elementwise ops and gathers
agree to rounding (1e-6 relative to the values' magnitude); reductions
and convs sum in another order than XLA, so 1e-5 of max|ref| (the JAX
conftest sets matmul precision "highest"); bf16 is compared at small
multiples of the bf16 unit roundoff (2^-8, half an ulp) of the magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from qpwcnet_tpu.ops import activations as jact
from qpwcnet_tpu.ops import flow_vis as jvis
from qpwcnet_tpu.ops import resize as jresize
from qpwcnet_tpu.ops import warp as jwarp
from qpwcnet_tpu.ops.cost_volume import cost_volume_xla
from qpwcnet_torch.ops import activations as tact
from qpwcnet_torch.ops import flow_vis as tvis
from qpwcnet_torch.ops import resize as tresize
from qpwcnet_torch.ops import warp as twarp
from qpwcnet_torch.ops.cost_volume import cost_volume_plain
from qpwcnet_torch.quantize.qlayers import QConv, QConvTranspose

BF16_ROUNDOFF = 2.0 ** -8  # half a bf16 ulp, relative


def _j(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _close(got, want, rel):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = rel * max(float(np.max(np.abs(want))), 1.0)
    err = float(np.max(np.abs(got - want)))
    assert err <= tol, (err, tol)


def test_mish_matches_jax_f32():
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.uniform(-30, 30, 4000),
                        [-100.0, -20.0, 0.0, 19.99, 20.0, 20.01, 50.0]])
    x = x.astype(np.float32)
    # float32 elementwise: rounding-level agreement
    _close(tact.mish(_t(x)), jact.mish(_j(x)), 1e-6)
    # above the cutoff the factor is exactly 1
    big = np.array([20.5, 40.0, 1e4], np.float32)
    np.testing.assert_array_equal(tact.mish(_t(big)).numpy(), big)


def test_mish_matches_jax_bf16():
    rng = np.random.RandomState(1)
    x = rng.uniform(-10, 30, 4000).astype(np.float32)
    got = tact.mish(_t(x, torch.bfloat16))
    want = jact.mish(_j(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    # same rounding points (factor in f32 -> bf16, product in bf16): at
    # most a rounding flip apart where exp differs in its last bit
    _close(got, np.asarray(want, np.float32), BF16_ROUNDOFF)


def test_leaky_relu_matches_jax():
    x = np.random.RandomState(2).standard_normal(1000).astype(np.float32)
    np.testing.assert_array_equal(tact.leaky_relu(_t(x)).numpy(),
                                  np.asarray(jact.leaky_relu(_j(x))))


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_upsample2x_bilinear_matches_jax(scale):
    x = np.random.RandomState(3).standard_normal((2, 5, 7, 3))
    _close(tresize.upsample2x_bilinear(_t(x), scale),
           jresize.upsample2x_bilinear(_j(x), scale), 1e-6)


@pytest.mark.parametrize("out_hw", [(12, 20), (3, 5)])
def test_resize_bilinear_matches_jax(out_hw):
    """Up (half-pixel bilinear) and down (antialiased) resizes."""
    x = np.random.RandomState(4).standard_normal((1, 6, 10, 2))
    _close(tresize.resize_bilinear(_t(x), out_hw),
           jresize.resize_bilinear(_j(x), out_hw), 1e-5)


@pytest.mark.parametrize("hw", [(6, 8), (5, 7)])
def test_avg_pool_2x_matches_jax(hw):
    x = np.random.RandomState(5).standard_normal((2, *hw, 3))
    _close(tresize.avg_pool_2x(_t(x)), jresize.avg_pool_2x(_j(x)), 1e-6)


@pytest.mark.parametrize("hw", [(16, 24), (1, 9), (9, 1)])
def test_backward_warp_matches_jax(hw):
    """Flows up to ±6 px send samples off the border (border clamp);
    1-pixel dims take the edge-pad branch of warp.py:116-124."""
    rng = np.random.RandomState(6)
    img = rng.standard_normal((2, *hw, 5))
    flow = rng.uniform(-6, 6, (2, *hw, 2))
    got = twarp.backward_warp(_t(img), _t(flow))
    want = jwarp.backward_warp(_j(img), _j(flow))
    _close(got, want, 1e-6)


def test_backward_warp_matches_jax_bf16():
    rng = np.random.RandomState(7)
    img = rng.standard_normal((1, 12, 16, 4))
    flow = rng.uniform(-3, 3, (1, 12, 16, 2))
    got = twarp.backward_warp(_t(img, torch.bfloat16), _t(flow))
    want = jwarp.backward_warp(_j(img, jnp.bfloat16), _j(flow))
    assert got.dtype == torch.bfloat16
    # the same per-op bf16 rounding; weights are rounded identically
    _close(got, np.asarray(want, np.float32), 2 * BF16_ROUNDOFF)


def test_backward_warp_matches_grid_sample():
    """The semantics equal grid_sample(align_corners=True, border) when
    both dims are >= 2 — an independent check of the convention."""
    rng = np.random.RandomState(8)
    img = _t(rng.standard_normal((2, 7, 9, 3)))
    flow = _t(rng.uniform(-5, 5, (2, 7, 9, 2)))
    h, w = 7, 9
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32),
                            indexing="ij")
    qx = (gx + flow[..., 0]) / (w - 1) * 2 - 1
    qy = (gy + flow[..., 1]) / (h - 1) * 2 - 1
    ref = F.grid_sample(img.permute(0, 3, 1, 2),
                        torch.stack([qx, qy], -1), mode="bilinear",
                        padding_mode="border", align_corners=True)
    _close(twarp.backward_warp(img, flow), ref.permute(0, 2, 3, 1), 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cost_volume_plain_matches_xla(dtype):
    rng = np.random.RandomState(9)
    prv = rng.standard_normal((2, 9, 13, 12))
    nxt = rng.standard_normal((2, 9, 13, 12))
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    got = cost_volume_plain(_t(prv, tdt), _t(nxt, tdt))
    want = cost_volume_xla(_j(prv, jdt), _j(nxt, jdt))
    assert got.dtype == tdt and got.shape == (2, 9, 13, 81)
    # f32 channel sums in another order; bf16 output rounding
    _close(got, np.asarray(want, np.float32),
           1e-5 if dtype == "float32" else BF16_ROUNDOFF)


def _lax_conv(x, k, stride, groups=1):
    return jax.lax.conv_general_dilated(
        _j(x), _j(k), (stride, stride), "SAME", feature_group_count=groups,
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


def _qconv(k_hwio, stride=1, groups=1):
    kh, kw, i, o = k_hwio.shape
    m = QConv(i * groups, o, kh, stride=stride, groups=groups,
              use_bias=False)
    with torch.no_grad():
        m.weight.copy_(_t(k_hwio.transpose(3, 2, 0, 1)))
    return m


@pytest.mark.parametrize("hw", [(8, 12), (7, 9)])
def test_qconv_stride2_same_matches_lax(hw):
    """XLA 'SAME' for a 3x3/s2 conv pads (0, 1) on even sizes (1, 1 on
    odd); Conv2d(padding=1) would shift the even-size output."""
    rng = np.random.RandomState(10)
    x = rng.standard_normal((2, *hw, 4))
    k = rng.standard_normal((3, 3, 4, 6))
    want = _lax_conv(x, k, 2)
    got = _qconv(k, stride=2)(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, want, 1e-5)
    if hw[0] % 2 == 0:
        naive = F.conv2d(_t(x).permute(0, 3, 1, 2),
                         _t(k.transpose(3, 2, 0, 1)), stride=2, padding=1)
        assert np.max(np.abs(naive.permute(0, 2, 3, 1).numpy()
                             - np.asarray(want))) > 0.1


def test_qconv_depthwise_matches_lax():
    rng = np.random.RandomState(11)
    x = rng.standard_normal((2, 6, 10, 5))
    k = rng.standard_normal((3, 3, 1, 5))
    want = _lax_conv(x, k, 1, groups=5)
    got = _qconv(k, groups=5)(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, want, 1e-5)


def test_qconv_transpose_matches_lax():
    """lax.conv_transpose(x, k, (2, 2), 'SAME') == conv_transpose2d with
    the spatially FLIPPED (I, O, 4, 4) kernel and padding=1; unflipped it
    is wrong."""
    rng = np.random.RandomState(12)
    x = rng.standard_normal((1, 5, 7, 4))
    k = rng.standard_normal((4, 4, 4, 6))
    want = jax.lax.conv_transpose(_j(x), _j(k), (2, 2), "SAME",
                                  dimension_numbers=("NHWC", "HWIO", "NHWC"))
    m = QConvTranspose(4, 6, use_bias=False)
    with torch.no_grad():
        m.weight.copy_(_t(np.flip(k, (0, 1)).transpose(2, 3, 0, 1)))
    got = m(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, want, 1e-5)
    unflipped = F.conv_transpose2d(_t(x).permute(0, 3, 1, 2),
                                   _t(k.transpose(2, 3, 0, 1)),
                                   stride=2, padding=1)
    assert np.max(np.abs(unflipped.permute(0, 2, 3, 1).numpy()
                         - np.asarray(want))) > 0.1


def test_flow_to_image_matches_jax():
    flow = np.random.RandomState(13).uniform(-5, 5, (2, 6, 8, 2))
    _close(tvis.flow_to_image(_t(flow)), jvis.flow_to_image(_j(flow)), 1e-5)
