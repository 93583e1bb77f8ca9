"""The port's quantization layer (qpwcnet_torch/quantize/) on CPU against
the JAX package's (qpwcnet_tpu/quantize/): fake quant and its
straight-through gradient, the per-channel weight scales in every kernel
layout, round-half-to-even ties, QConv and QConvTranspose in QAT mode
(float32 and bf16) and in int8 mode (dense, depthwise, per-input-channel
ranges, the transpose conv, a QTensor input and output), and the int8
convs' int32 accumulations.

The same numpy inputs and Flax parameters go to both sides. Tolerances:
the quantization arithmetic (fake quant, scales, int8 codes, the int32
accumulations) is compared bit for bit: both sides do the same float32
or bf16 operations in the same order; the ranges as _check_ranges
states. A conv's float output
sums in another order than XLA's, so it is held to 1e-5 of its magnitude
(float32) or two bf16 ulps (bf16), plus at most a handful of outputs one
quantum apart where a float32 rounding difference moved a value across a
rounding boundary of the output fake quant (counted and bounded at each
check).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpwcnet_torch.layout import CHANNELS_LAST
from qpwcnet_torch.quantize import (
    QConv,
    QConvTranspose,
    QTensor,
    QuantConfig,
    fake_quant,
    quantize_to,
)
from qpwcnet_torch.quantize.fake_quant import weight_scale
from qpwcnet_torch.quantize.int8 import (
    int8_conv_int32,
    int8_matmul,
    quantize_tensor,
)
from qpwcnet_tpu.quantize import QConv as JQConv
from qpwcnet_tpu.quantize import QConvTranspose as JQConvTranspose
from qpwcnet_tpu.quantize.fake_quant import QuantConfig as JQuantConfig
from qpwcnet_tpu.quantize.fake_quant import fake_quant as j_fake_quant
from qpwcnet_tpu.quantize.fake_quant import weight_scale as j_weight_scale
from qpwcnet_tpu.quantize.int8 import quantize_tensor as j_quantize_tensor
from qpwcnet_tpu.quantize.qtensor import QTensor as JQTensor
from qpwcnet_tpu.quantize.qtensor import quantize_to as j_quantize_to
from tests.test_torch_model import one_torch_thread  # noqa: F401

BF16 = {"float32": (torch.float32, jnp.float32),
        "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) \
        else np.asarray(t, np.float32)


def _nchw(a):
    """numpy NHWC -> channels_last NCHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2) \
        .contiguous(memory_format=CHANNELS_LAST)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().float().numpy()


# ---------------------------------------------------------------- fake quant

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_matches_jax_bit_for_bit(dtype):
    """Values in float32 and bf16 (the scale cast to x's dtype first, as
    QConv does), with zero scales passing x through; the gradient is the
    identity (straight through)."""
    td, jd = BF16[dtype]
    rng = np.random.RandomState(0)
    x = rng.uniform(-3, 3, (4, 64)).astype(np.float32)
    scale = np.where(rng.uniform(size=(4, 1)) < 0.25, 0.0,
                     rng.uniform(0.01, 0.05, (4, 1))).astype(np.float32)
    scale[0] = 0.0
    want = j_fake_quant(jnp.asarray(x, jd), jnp.asarray(scale, jd))
    xt = torch.from_numpy(x).to(td).requires_grad_()
    got = fake_quant(xt, torch.from_numpy(scale).to(td))
    assert got.dtype == td
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    np.testing.assert_array_equal(_np(got[0]), _np(xt[0]))
    w = rng.standard_normal(x.shape).astype(np.float32)
    (got.float() * torch.from_numpy(w)).sum().backward()
    g_j = jax.grad(lambda v: jnp.sum(j_fake_quant(
        v, jnp.asarray(scale, jd)).astype(jnp.float32) * w))(
            jnp.asarray(x, jd))
    np.testing.assert_array_equal(_np(xt.grad), np.asarray(g_j, np.float32))
    np.testing.assert_array_equal(_np(xt.grad), _np(torch.from_numpy(w)
                                                    .to(td)))


def test_round_half_even_ties():
    """x / scale exactly on a .5: both packages round half to even (and
    clip to [-128, 127]) in fake quant, quantize_tensor and quantize_to."""
    x = np.asarray([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.5, -127.5,
                    -128.5, 3.0, 200.0], np.float32) * 0.25
    want = [0, 2, 2, 0, -2, -2, 126, 127, -128, -128, 3, 127]
    scale = np.float32(0.25)
    codes = quantize_tensor(torch.from_numpy(x), torch.tensor(scale))
    assert codes.tolist() == want
    np.testing.assert_array_equal(codes.numpy(), np.asarray(
        j_quantize_tensor(jnp.asarray(x), jnp.asarray(scale))))
    np.testing.assert_array_equal(
        _np(fake_quant(torch.from_numpy(x), torch.tensor(scale))),
        np.asarray(want, np.float32) * scale)
    qt = quantize_to(torch.from_numpy(x), torch.tensor(scale * 127.0))
    jq = j_quantize_to(jnp.asarray(x), jnp.asarray(scale * 127.0))
    assert qt.q.tolist() == want
    np.testing.assert_array_equal(qt.q.numpy(), np.asarray(jq.q))
    assert float(qt.scale) == float(jq.scale) == scale


@pytest.mark.parametrize("layout", ["dense", "depthwise", "transpose"])
def test_weight_scale_every_layout(layout):
    """Per output channel: dim 0 of OIHW and of the depthwise (C, 1, 3,
    3) kernel, dim 1 of the flipped (I, O, 4, 4) transpose kernel; each
    equal to JAX's over the HWIO kernel's last axis."""
    rng = np.random.RandomState(1)
    shape = {"dense": (3, 3, 5, 7), "depthwise": (3, 3, 1, 6),
             "transpose": (4, 4, 5, 3)}[layout]
    k = rng.standard_normal(shape).astype(np.float32)
    k[..., 0] *= 10.0
    want = np.asarray(j_weight_scale(jnp.asarray(k))).ravel()
    if layout == "transpose":
        w = torch.from_numpy(np.ascontiguousarray(
            np.flip(k, (0, 1)).transpose(2, 3, 0, 1)))
        got = weight_scale(w, 1)
        assert got.shape == (1, shape[3], 1, 1)
    else:
        w = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        got = weight_scale(w, 0)
        assert got.shape == (shape[3], 1, 1, 1)
    np.testing.assert_array_equal(got.numpy().ravel(), want)


# ------------------------------------------------------------ int8 products

@pytest.mark.parametrize("kind", ["dense_s1", "dense_s2", "pointwise",
                                  "depthwise", "transpose"])
def test_int32_accumulations_equal_jax(kind):
    """int8 x int8 -> int32 exactly equal to JAX's conv_general_dilated
    with preferred_element_type=int32 (the transpose conv as its
    input-dilated spelling), at full-range codes."""
    rng = np.random.RandomState(2)
    ci = 24
    kh, stride, groups, transpose, co = {
        "dense_s1": (3, 1, 1, False, 20), "dense_s2": (3, 2, 1, False, 16),
        "pointwise": (1, 1, 1, False, 3), "depthwise": (3, 1, ci, False, ci),
        "transpose": (4, 2, 1, True, 16)}[kind]
    x = rng.randint(-128, 128, (2, 10, 14, ci)).astype(np.int8)
    k = rng.randint(-128, 128, (kh, kh, ci // groups, co)).astype(np.int8)
    got = int8_conv_int32(torch.from_numpy(x), torch.from_numpy(k), stride,
                          groups, transpose)
    assert got.dtype == torch.int32
    if transpose:
        want = jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(k), (1, 1), [(2, 2), (2, 2)],
            lhs_dilation=(2, 2), dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
    else:
        want = jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(k), (stride, stride), "SAME",
            feature_group_count=groups,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_matmul_cpu_is_exact():
    rng = np.random.RandomState(3)
    a = rng.randint(-128, 128, (19, 40)).astype(np.int8)
    b = rng.randint(-128, 128, (40, 5)).astype(np.int8)
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


# ------------------------------------------------------------------ modules

CASES = {
    # name: (jax module kwargs, port constructor, input channels)
    "dense": (dict(features=12, kernel_size=(3, 3)), 8),
    "dense_s2": (dict(features=12, kernel_size=(3, 3), strides=(2, 2)), 8),
    "pointwise": (dict(features=3, kernel_size=(1, 1)), 8),
    "depthwise": (dict(features=8, kernel_size=(3, 3),
                       feature_group_count=8, use_bias=False), 8),
    "per_channel": (dict(features=12, kernel_size=(3, 3),
                         per_channel_in=True), 8),
    "dw_per_channel": (dict(features=8, kernel_size=(3, 3),
                            feature_group_count=8, use_bias=False,
                            per_channel_in=True), 8),
    "transpose": (None, 8),
}


def _modules(name, quant_t, quant_j, dtype):
    """(jax module, port module, flax params): the port holds the Flax
    kernel in its layout. Mish on the dense convs, as the blocks'."""
    from qpwcnet_tpu.ops.activations import mish as j_mish
    from qpwcnet_torch.ops.activations import mish

    kw, ci = CASES[name]
    td, jd = BF16[dtype]
    if name == "transpose":
        jm = JQConvTranspose(features=6, dtype=jd, act=j_mish, quant=quant_j)
        pm = QConvTranspose(ci, 6, dtype=td, act=mish, quant=quant_t)
    else:
        act = None if kw.get("feature_group_count") else j_mish
        jm = JQConv(dtype=jd, act=act, quant=quant_j, **kw)
        k = kw["kernel_size"][0]
        pm = QConv(ci, kw["features"], k, stride=kw.get("strides", (1,))[0],
                   groups=kw.get("feature_group_count", 1),
                   use_bias=kw.get("use_bias", True), dtype=td,
                   act=None if act is None else mish, quant=quant_t,
                   per_channel_in=kw.get("per_channel_in", False))
    return jm, pm, ci


def _load(pm, params, transpose):
    k = np.asarray(params["kernel"], np.float32)
    k = np.flip(k, (0, 1)).transpose(2, 3, 0, 1) if transpose \
        else k.transpose(3, 2, 0, 1)
    with torch.no_grad():
        pm.weight.copy_(torch.from_numpy(np.ascontiguousarray(k)))
        if "bias" in params:
            pm.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))


def _setup(name, mode, dtype, seed=0):
    """Both modules with the same random kernel and bias and the input:
    channels 0-1 twenty times larger than the rest (the flow channels of
    a concat)."""
    qt, qj = QuantConfig(mode=mode), JQuantConfig(mode=mode)
    jm, pm, ci = _modules(name, qt, qj, dtype)
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (2, 12, 16, ci)).astype(np.float32)
    x[..., :2] *= 20.0
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(
        jm.init(jax.random.key(seed), jnp.asarray(x))))
    params = dict(variables["params"])
    if "bias" in params:
        params["bias"] = rng.normal(0, 0.1, params["bias"].shape).astype(
            np.float32)
    _load(pm, params, name == "transpose")
    return jm, pm, x, params


def _ranges_j(stats):
    return {"amax_in": np.asarray(stats["amax_in"]),
            **({"amax": np.asarray(stats["act_quant"]["amax"])}
               if "act_quant" in stats else {})}


def _ranges_t(pm):
    out = {"amax_in": pm.amax_in.numpy()}
    if hasattr(pm, "act_quant"):
        out["amax"] = pm.act_quant.amax.numpy()
    return out


def _check_ranges(rt, rj, dtype):
    """The input ranges to one float32 ulp (the batch absmax of the same
    input is exact; XLA contracts the EMA's multiply-add into an FMA);
    the output range to that and the rounding of the conv output whose
    maximum it is: 4e-7 of it in float32, one bf16 ulp (2^-7) in
    bf16."""
    assert rt.keys() == rj.keys()
    assert np.all(np.abs(rt["amax_in"] - rj["amax_in"])
                  <= 2.5e-7 * rj["amax_in"])
    if "amax" in rj:
        rel = 4e-7 if dtype == "float32" else 2.0 ** -7
        assert abs(float(rt["amax"]) - float(rj["amax"])) <= \
            rel * float(rj["amax"]), (rt["amax"], rj["amax"])


def _quanta(got, want, scale):
    """Outputs that differ by more than 2e-5 of the magnitude (float32) /
    2 bf16 ulps: each must be one quantum (scale) off; returns their
    count."""
    diff = np.abs(got - want)
    tol = max(float(np.abs(want).max()), 1.0) * 2e-5
    off = diff > tol
    assert np.all(diff[off] <= scale * (1 + 1e-2) + tol), float(diff.max())
    return int(off.sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_qconv_qat_matches_jax(name, dtype):
    """QAT, two train-mode forwards (the first range update takes the
    batch absmax, the second the EMA, each before its use) and one
    eval-mode forward: outputs, ranges after each, and (float32) the
    gradients of x and the kernel. Ranges as _check_ranges states;
    outputs within the module docstring's bound, at most 4 outputs a
    quantum apart."""
    jm, pm, x, params = _setup(name, "qat", dtype)
    td, jd = BF16[dtype]
    stats = jax.device_get(jm.init(jax.random.key(0),
                                   jnp.asarray(x))["quant_stats"])
    xs = [x, 1.3 * x]
    for xi in xs:
        want, mut = jm.apply({"params": params, "quant_stats": stats},
                             jnp.asarray(xi, jd), update_stats=True,
                             mutable=["quant_stats"])
        stats = jax.device_get(mut["quant_stats"])
        pm.train()
        got = pm(_nchw(xi).to(td))
        rj, rt = _ranges_j(stats), _ranges_t(pm)
        _check_ranges(rt, rj, dtype)
        scale = float(rj.get("amax", 0.0)) / 127.0
        assert _quanta(_nhwc(got), np.asarray(want, np.float32), scale) <= 4
    assert float(np.max(rj["amax_in"])) > 0.0
    pm.eval()
    want = jm.apply({"params": params, "quant_stats": stats},
                    jnp.asarray(x, jd))
    xt = _nchw(x).to(td).requires_grad_()
    got = pm(xt)
    assert _quanta(_nhwc(got), np.asarray(want, np.float32), scale) <= 4
    if dtype == "bfloat16":
        return
    g = np.random.RandomState(5).standard_normal(got.shape).astype(
        np.float32)
    (got * torch.from_numpy(g).contiguous(memory_format=CHANNELS_LAST)) \
        .sum().backward()
    g_nhwc = g.transpose(0, 2, 3, 1)

    def loss(p, xi):
        return jnp.sum(jm.apply({"params": p, "quant_stats": stats}, xi)
                       * g_nhwc)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    gk = np.asarray(gp["kernel"])
    gk = (np.flip(gk, (0, 1)).transpose(2, 3, 0, 1) if name == "transpose"
          else gk.transpose(3, 2, 0, 1))
    for a, b in ((pm.weight.grad.numpy(), gk), (_nhwc(xt.grad), gx)):
        b = np.asarray(b)
        assert np.max(np.abs(a - b)) <= 1e-4 * np.max(np.abs(b)) + 1e-6


@pytest.mark.parametrize("name", list(CASES))
def test_qconv_int8_matches_jax(name):
    """int8 mode with QAT-calibrated ranges: the float output and the
    emitted QTensor (int8 codes and scale). The int8 products are exact
    and the dequantization is the same float32 arithmetic, so the
    outputs agree to float32 rounding of the bias and Mish, with at most
    2 codes a quantum apart."""
    jm, pm, x, params = _setup(name, "qat", "float32", seed=1)
    stats = jm.init(jax.random.key(1), jnp.asarray(x))["quant_stats"]
    _, mut = jm.apply({"params": params, "quant_stats": stats},
                      jnp.asarray(x), update_stats=True,
                      mutable=["quant_stats"])
    stats = jax.device_get(mut["quant_stats"])
    jm8, pm8, _, _ = _setup(name, "int8", "float32", seed=1)
    pm.train()
    pm(_nchw(x))  # the same range update on the port's side
    _check_ranges(_ranges_t(pm), _ranges_j(stats), "float32")
    pm8.load_state_dict(pm.state_dict())
    pm8.eval()
    v = {"params": params, "quant_stats": stats}
    want = np.asarray(jm8.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(pm8(_nchw(x)))
    scale = float(_ranges_j(stats).get("amax", 0.0)) / 127.0
    assert _quanta(got, want, scale) <= 2
    if "amax" not in _ranges_j(stats):
        return  # the depthwise halves emit no QTensor
    wq = jm8.apply(v, jnp.asarray(x), emit_qtensor=True)
    with torch.no_grad():
        gq = pm8(_nchw(x), emit_qtensor=True)
    assert isinstance(gq, QTensor) and gq.q.dtype == torch.int8
    # the output range's scale, to its float32 rounding (_check_ranges)
    assert abs(float(gq.scale) - float(wq.scale)) <= 4e-7 * float(wq.scale)
    d = np.abs(_nhwc(gq.q) - np.asarray(wq.q, np.float32))
    assert d.max() <= 1 and int((d > 0).sum()) <= 2


@pytest.mark.parametrize("name", ["dense", "depthwise", "pointwise"])
def test_qconv_int8_takes_a_qtensor(name):
    """A QTensor input (the chained fast path): its int8 codes go to the
    product as they are and its scale is the input scale; the ranges of
    both modules are set by hand."""
    jm, pm, x, params = _setup(name, "int8", "float32", seed=2)
    stats = jax.device_get(jm.init(jax.random.key(2), jnp.asarray(x))
                           ["quant_stats"])
    stats = jax.tree_util.tree_map(lambda a: np.full_like(a, 3.0), stats)
    with torch.no_grad():
        for b in pm.buffers():
            b.fill_(3.0)
    rng = np.random.RandomState(4)
    q = rng.randint(-128, 128, x.shape).astype(np.int8)
    s = np.float32(0.02)
    want = np.asarray(jm.apply({"params": params, "quant_stats": stats},
                               JQTensor(jnp.asarray(q), jnp.asarray(s))))
    with torch.no_grad():
        got = _nhwc(pm(QTensor(_nchw(q), torch.tensor(s))))
    assert _quanta(got, want, 3.0 / 127.0) <= 2
    pm.quant = QuantConfig()  # QAT takes floats only
    with pytest.raises(TypeError):
        pm(QTensor(_nchw(q), torch.tensor(s)))


def test_float_qconv_state_dict_unchanged():
    """Without quant a conv registers no range buffers: a float model's
    state_dict (and every existing checkpoint) is unchanged."""
    assert list(QConv(4, 8).state_dict()) == ["weight", "bias"]
    assert list(QConvTranspose(4, 8).state_dict()) == ["weight", "bias"]
    q = QConv(4, 8, quant=QuantConfig(), per_channel_in=True)
    assert q.amax_in.shape == (4,) and q.act_quant.amax.shape == ()
    dw = QConv(4, 4, groups=4, use_bias=False,
               quant=dataclasses.replace(QuantConfig(),
                                         quantize_activations=False))
    assert sorted(dw.state_dict()) == ["amax_in", "weight"]
    with pytest.raises(ValueError):
        QConv(4, 8, per_channel_in=True)
    with pytest.raises(ValueError):
        QuantConfig(mode="int4")


def test_quantize_weight_scales_matches_jax(flow_setup):
    """Every conv kernel's per-channel scale, keyed by the port's weight
    and in its layout, equal to JAX's over the Flax params (the transpose
    convs' along dim 1)."""
    from qpwcnet_torch.models import build_flow_net, load_flax_variables
    from qpwcnet_torch.models.from_flax import _flax_path
    from qpwcnet_torch.quantize import quantize_weight_scales
    from qpwcnet_tpu.quantize import quantize_weight_scales as j_scales

    _, variables = flow_setup
    model = load_flax_variables(build_flow_net(0, "cpu"),
                                jax.device_get(variables))
    want = jax.device_get(j_scales(variables["params"]))
    got = quantize_weight_scales(model)
    assert len(got) == 69
    for key, scale in got.items():
        node = want
        for part in _flax_path(model, key):
            node = node[part]
        np.testing.assert_array_equal(scale.numpy().ravel(),
                                      np.asarray(node).ravel(), key)
