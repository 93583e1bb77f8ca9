"""The bias + Mish epilogue (``ops/cuda/mish_kernel.py``) on the CPU.

The kernels themselves run only on the card (tests/test_torch_cuda*.py). Here: CPU tensors take the composition the port ran
before the kernels, bit for bit and with the same gradients; the
backward kernel's plain statement is no less accurate than the
composition's autograd against float64; the blocks built on it equal a
hand-built composition; the custom op around the kernels, with its
launchers swapped for their plain versions, gives the plain values and
gradients and traces into ``torch.export``; every caller reaches the
epilogue through the one name ``mish_kernel.bias_mish_cuda``; and the
kernels' device names fall in no category of K1-K5 or the elementwise
ops.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from qpwcnet_torch.models import build_flow_net
from qpwcnet_torch.models.blocks import DownConv, SepConv, UpConv
from qpwcnet_torch.ops import cuda as kernels
from qpwcnet_torch.ops.activations import mish
from qpwcnet_torch.ops.conv import conv2d_same
from qpwcnet_torch.ops.cuda import conv_gemm, mish_kernel
from qpwcnet_torch.ops.cuda.mish_kernel import (
    bias_mish_backward_plain,
    bias_mish_bwd_cuda,
    bias_mish_cuda,
    bias_mish_plain,
)
from qpwcnet_torch.ops.cuda.stem_kernel import downconv_stage_plain
from qpwcnet_torch.ops.cuda.upconv_kernel import upconv_stage_plain
from qpwcnet_torch.quantize.qlayers import QConv, QuantConv
from qpwcnet_torch.utils import profiling, tracing
from tests.test_torch_model import one_torch_thread  # noqa: F401

DTYPES = [torch.float32, torch.bfloat16]


def _input(seed, shape, dtype, specials=True):
    """(B, C, H, W) in channels_last memory: normal values of scale 6, a
    uniform draw over [-30, 30] in every eighth element and, with
    ``specials``, 20, its neighbours, -87, NaN, -inf and +inf first."""
    rng = np.random.RandomState(seed)
    v = 6.0 * rng.standard_normal(shape)
    v.flat[::8] = rng.uniform(-30, 30, v.flat[::8].shape)
    if specials:
        v.flat[:7] = [20.0, np.nextafter(np.float32(20), 30),
                      np.nextafter(np.float32(20), 0), -87.0, np.nan,
                      -np.inf, np.inf]
    x = torch.from_numpy(v.astype(np.float32)).to(dtype)
    return x.contiguous(memory_format=torch.channels_last)


def _old_composition(x, bias):
    """What QuantConv computed after a Mish conv before the kernels."""
    if bias is not None:
        x = x + bias.to(x.dtype)[:, None, None]
    return mish(x)


def _same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.int16 if got.dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if want.dtype == torch.bfloat16
                                 else torch.int32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("shape", [(2, 16, 9, 12), (1, 20, 5, 7)])
def test_cpu_is_the_old_composition(dtype, with_bias, shape):
    """CPU tensors take the composition: bias_mish_cuda equals it bit for
    bit (NaNs included), and its gradients are the composition's
    autograd's, over values across ±30 with 20, -87, NaN and ±inf."""
    x = _input(shape[1], shape, dtype)
    bias = (torch.from_numpy(np.random.RandomState(1).uniform(
        -3, 3, shape[1]).astype(np.float32)) if with_bias else None)
    want = _old_composition(x, bias)
    _same_bits(bias_mish_cuda(x, bias), want)
    _same_bits(bias_mish_plain(x, bias), want)

    x = _input(shape[1] + 1, shape, dtype, specials=False)
    g = torch.from_numpy(np.random.RandomState(2).standard_normal(
        shape).astype(np.float32)).to(dtype)
    grads = []
    for fn in (bias_mish_cuda, _old_composition):
        xl = x.clone().requires_grad_()
        bl = None if bias is None else bias.clone().requires_grad_()
        fn(xl, bl).backward(g)
        grads.append((xl.grad, None if bl is None else bl.grad))
    _same_bits(grads[0][0], grads[1][0])
    if with_bias:
        _same_bits(grads[0][1], grads[1][1])


def _grads64(x, bias, g):
    """dx and dbias of mish(x + bias rounded to x's dtype) in float64."""
    y = (x.double() + bias.to(x.dtype).double()[:, None, None]
         ).requires_grad_()
    (y * torch.tanh(F.softplus(y))).backward(g.double())
    return y.grad, y.grad.sum((0, 2, 3))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(4, 32, 12, 20), (2, 16, 9, 11)])
def test_backward_plain_no_worse_than_composition(dtype, shape):
    """The backward kernel's statement (one float32 expression, one
    rounding) against float64 autograd: dx and dbias no further off, in
    max and in mean, than the composition's autograd in the same dtype;
    and bias_mish_bwd_cuda on CPU tensors is that statement."""
    x = _input(shape[1] + 3, shape, dtype, specials=False)
    rng = np.random.RandomState(4)
    bias = torch.from_numpy(rng.uniform(-3, 3, shape[1]).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                         ).to(dtype)
    dx, db = bias_mish_backward_plain(x, bias, g)
    assert dx.dtype == dtype and db.dtype == torch.float32
    xl, bl = x.clone().requires_grad_(), bias.clone().requires_grad_()
    _old_composition(xl, bl).backward(g)
    dx64, db64 = _grads64(x, bias, g)
    for got, comp, want in ((dx, xl.grad, dx64), (db, bl.grad, db64)):
        e_k = (got.double() - want).abs()
        e_c = (comp.double() - want).abs()
        assert float(e_k.max()) <= float(e_c.max())
        assert float(e_k.mean()) <= float(e_c.mean())
    got = bias_mish_bwd_cuda(x, bias, g)
    assert torch.equal(got[0], dx) and torch.equal(got[1], db)
    dx0, none = bias_mish_backward_plain(x, None, g)
    assert none is None
    assert torch.equal(dx0, bias_mish_backward_plain(
        x, torch.zeros(shape[1]), g)[0])


def test_backward_plain_above_20_and_at_nan():
    """Above 20 the gradient is g (the factor is the constant 1), +inf
    included; NaN stays NaN."""
    x = torch.tensor([20.0, 20.5, 30.0, float("inf"), float("nan"),
                      -5.0]).view(1, 6, 1, 1)
    g = torch.full_like(x, 0.75)
    dx, _ = bias_mish_backward_plain(x, None, g)
    assert dx.flatten()[1:4].tolist() == [0.75] * 3
    assert torch.isnan(dx.flatten()[4])
    xl = x[:, [0, 5]].clone().requires_grad_()
    _old_composition(xl, None).backward(g[:, [0, 5]])
    assert torch.allclose(dx.flatten()[[0, 5]], xl.grad.flatten(),
                          rtol=1e-6)


def _hand_sep(m, x, dt):
    y = conv2d_same(x.to(dt), m.depthwise.weight.to(dt), 1,
                    groups=m.depthwise.groups)
    y = conv2d_same(y, m.pointwise.weight.to(dt))
    return mish(y + m.pointwise.bias.to(dt)[:, None, None])


def _hand_down(m, x, dt):
    y = x.to(dt)
    for c in (m.conv_a, m.conv_aa, m.conv_b):
        y = conv2d_same(y, c.weight.to(dt), c.stride)
        y = mish(y + c.bias.to(dt)[:, None, None])
    return y


def _hand_up(m, x, dt):
    c = m.conv_up
    y = F.conv_transpose2d(x.to(dt), c.weight.to(dt), stride=2, padding=1)
    return mish(y + c.bias.to(dt)[:, None, None])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", ["SepConv", "DownConv", "UpConv"])
def test_blocks_equal_a_hand_built_composition(dtype, block):
    """SepConv, DownConv and UpConv give the outputs and the gradients
    (input and every parameter) of their convs + bias + mish written out
    by hand, bit for bit."""
    torch.manual_seed(3)
    make, hand = {"SepConv": (SepConv, _hand_sep),
                  "DownConv": (DownConv, _hand_down),
                  "UpConv": (UpConv, _hand_up)}[block]
    m = make(12, 16, dtype=dtype)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(0.3 * torch.randn_like(p))
    x = torch.randn(2, 12, 10, 14).contiguous(
        memory_format=torch.channels_last)
    outs, grads = [], []
    for fn in (m, lambda t: hand(m, t, dtype)):
        m.zero_grad()
        xl = x.clone().requires_grad_()
        y = fn(xl)
        y.float().square().mean().backward()
        outs.append(y)
        grads.append([xl.grad] + [p.grad for p in m.parameters()])
    _same_bits(outs[0], outs[1])
    for a, b in zip(*grads):
        _same_bits(a, b)


def _plain_launchers(monkeypatch):
    """The op's launchers swapped for the plain versions (and counted as
    the launchers count), so its wiring runs on the CPU."""
    def fwd(x, bias):
        tracing.count("launches.bias_mish_cuda")
        return bias_mish_plain(x, bias)

    def bwd(x, bias, g, need_dbias):
        tracing.count("launches.bias_mish_bwd_cuda")
        dx, db = bias_mish_backward_plain(x, bias, g)
        return dx, db if need_dbias else None

    monkeypatch.setattr(mish_kernel, "_launch_fwd", fwd)
    monkeypatch.setattr(mish_kernel, "_launch_bwd", bwd)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("need", ["x", "bias", "both"])
def test_function_wiring(monkeypatch, dtype, need):
    """The autograd Function around the op ``qpwcnet::bias_mish`` and the
    backward kernels, launchers swapped for the plain versions: the
    forward's bits, dx and
    the float32 dbias of the backward's statement for the inputs that
    need them, one launch of each, and no graph under no_grad or
    inference_mode."""
    _plain_launchers(monkeypatch)
    x = _input(5, (2, 8, 6, 10), dtype, specials=False)
    bias = torch.linspace(-2, 2, 8)
    g = torch.from_numpy(np.random.RandomState(6).standard_normal(
        x.shape).astype(np.float32)).to(dtype)
    xl = x.clone().requires_grad_(need in ("x", "both"))
    bl = bias.clone().requires_grad_(need in ("bias", "both"))
    kernels.reset_launch_counts()
    y = mish_kernel._BiasMish.apply(xl, bl)
    _same_bits(y, bias_mish_plain(x, bias))
    y.backward(g)
    dx, db = bias_mish_backward_plain(x, bias, g)
    if xl.requires_grad:
        _same_bits(xl.grad, dx)
    else:
        assert xl.grad is None
    if bl.requires_grad:
        assert bl.grad.dtype == torch.float32
        _same_bits(bl.grad, db)
    else:
        assert bl.grad is None
    counts = kernels.launch_counts()
    assert (counts["bias_mish_cuda"], counts["bias_mish_bwd_cuda"]) == (1, 1)
    for ctx in (torch.no_grad(), torch.inference_mode()):
        with ctx:
            y = mish_kernel._BiasMish.apply(xl, bl)
        assert y.grad_fn is None
        _same_bits(y, bias_mish_plain(x, bias))
    xl = x.clone().requires_grad_()
    mish_kernel._BiasMish.apply(xl, None).backward(g)
    _same_bits(xl.grad, bias_mish_backward_plain(x, None, g)[0])


def test_op_registration(monkeypatch):
    """torch.library's own checks of the op (its schema, and its fake
    implementation against the real one), launchers swapped for the plain
    versions."""
    _plain_launchers(monkeypatch)
    for dtype in DTYPES:
        x = _input(7, (2, 8, 5, 6), dtype, specials=False)
        for bias in (torch.linspace(-1, 1, 8), None):
            torch.library.opcheck(torch.ops.qpwcnet.bias_mish.default,
                                  (x, bias),
                                  test_utils=("test_schema",
                                              "test_faketensor"))


class _Epilogue(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.bias = torch.nn.Parameter(torch.linspace(-1, 1, 8))

    def forward(self, x):
        return mish_kernel._BiasMish.apply(x, self.bias)


def test_op_traces_into_export(monkeypatch, tmp_path):
    """torch.export traces the Function into one node, the op (its fake
    implementation gives the shape and layout), and the loaded program
    runs it: the exported int8 programs launch the kernel on the card."""
    _plain_launchers(monkeypatch)
    x = _input(8, (2, 8, 5, 6), torch.bfloat16, specials=False)
    m = _Epilogue()
    path = tmp_path / "epilogue.pt2"
    torch.export.save(torch.export.export(m, (x,)), str(path))
    prog = torch.export.load(str(path))
    ops = [n.target for n in prog.graph.nodes if n.op == "call_function"]
    assert ops == [torch.ops.qpwcnet.bias_mish.default]
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = prog.module()(x)
    _same_bits(got, bias_mish_plain(x, m.bias.detach()))
    assert kernels.launch_counts()["bias_mish_cuda"] == 1


@pytest.mark.parametrize("caller", ["QConv", "downconv_stage_plain",
                                    "upconv_stage_plain", "conv_gemm_plain"])
def test_one_name_reaches_every_caller(monkeypatch, caller):
    """Every caller of the epilogue looks up mish_kernel.bias_mish_cuda
    when it runs, so one assignment there swaps it everywhere (the plain
    reference models of tests/test_torch_cuda_models.py rest on this)."""
    calls = []

    def counted(x, bias=None):
        calls.append(tuple(x.shape))
        return bias_mish_plain(x, bias)

    monkeypatch.setattr(mish_kernel, "bias_mish_cuda", counted)
    torch.manual_seed(0)
    f32 = torch.float32
    x = torch.randn(1, 4, 6, 8)
    if caller == "QConv":
        QConv(8, 16, 3, act=mish)(x.permute(0, 3, 1, 2))
        want = 1
    elif caller == "downconv_stage_plain":
        params = [(0.3 * torch.randn(16, ci, 3, 3), torch.randn(16))
                  for ci in (8, 16, 16)]
        downconv_stage_plain(x, params, f32)
        want = 3
    elif caller == "upconv_stage_plain":
        upconv_stage_plain(x, 0.3 * torch.randn(8, 16, 4, 4),
                           torch.randn(16), f32)
        want = 1
    else:
        w = conv_gemm.prep_w33_plain(0.3 * torch.randn(16, 8, 3, 3),
                                     conv_gemm.gemm_cip(8), f32)
        conv_gemm.conv_gemm_plain(conv_gemm.CONV_S1, x, w, torch.randn(16),
                                  f32)
        want = 1
    assert len(calls) == want


@pytest.mark.parametrize("stem_stages,convs", [(2, 38), (0, 44)])
def test_flow_net_calls_the_epilogue_once_a_mish_conv(monkeypatch,
                                                      stem_stages, convs):
    """The Mish convs that run as modules (25 in the flower, 4 decoder
    UpConvs, 3 in each encoder stage the stem kernel does not take: 38 at
    stem_stages=2, 44 at 0) each call the epilogue once a forward, and on
    the CPU the stem's plain stages call it for the other 6 (on the card
    the stem kernel fuses theirs): the launch counts on the card rest on
    this."""
    calls = []

    def counted(x, bias=None):
        calls.append(tuple(x.shape))
        return bias_mish_plain(x, bias)

    monkeypatch.setattr(mish_kernel, "bias_mish_cuda", counted)
    model = build_flow_net(0, "cpu", stem_stages=stem_stages)
    ran = []
    for mod in model.modules():
        if isinstance(mod, QuantConv) and mod.act is mish:
            mod.register_forward_hook(lambda *a: ran.append(1))
    with torch.no_grad():
        model(torch.zeros(1, 64, 128, 6))
    assert len(ran) == convs
    assert len(calls) == 44


@pytest.mark.parametrize("name", [
    "void qpw::bias_mish_fwd<__nv_bfloat16, 8>(__nv_bfloat16 const*, "
    "float const*, __nv_bfloat16*, long, int)",
    "void qpw::bias_mish_bwd<float, 4>(float const*, float const*, float "
    "const*, float*, float*, long, int, long)",
    "qpw::bias_mish_dbias(float const*, float*, int, int)"])
def test_kernel_names_land_in_other(name):
    """The kernels' device names match none of K1-K5's categories nor
    ATen's elementwise or reduce ones in the program's profiler: their
    time is 'other'."""
    assert profiling.category(name) == "other"
