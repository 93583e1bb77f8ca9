"""The port's fused UpConv stage (K5's plain version and its CPU path,
``upconv_stage_trainable``'s gradients) and the Decoder with
``upconv_stages=2`` against the JAX package on CPU, float32.

The JAX side runs its Pallas kernel in interpret mode, as
tests/test_upconv_kernel.py does, at that file's shapes. Tolerances:
1e-5 for the outputs and for d_x, 1e-4 for the parameter gradients (the
JAX test's bounds: float32 sums in other orders; for the parameter
gradients, which reach a few hundred, also 1e-5 of the value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpwcnet_torch.layout import CHANNELS_LAST, nchw, nhwc
from qpwcnet_torch.models import build_flow_net, load_flax_variables
from qpwcnet_torch.models.pwcnet import Decoder
from qpwcnet_torch.ops.cuda import upconv_kernel
from qpwcnet_torch.ops.cuda.upconv_kernel import (
    UPCONV_CHANNELS,
    UPCONV_GEMM_CHANNELS,
    upconv_stage_cuda,
    upconv_stage_plain,
    upconv_stage_trainable,
)
from qpwcnet_tpu.models.blocks import UpConv as JUpConv
from qpwcnet_tpu.ops.pallas.upconv_kernel import (
    upconv_stage_pallas,
    upconv_stage_trainable as j_upconv_stage_trainable,
)
from tests.conftest import TEST_HW


def _stage(h, w, ci, co, seed=0):
    """A JAX UpConv's variables (with a non-zero bias) and an input."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, h, w, ci).astype(np.float32)
    v = JUpConv(co, dtype=jnp.float32).init(jax.random.key(seed + 1),
                                             jnp.asarray(x))
    p = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                               jax.device_get(v["params"]))
    p["conv_up"]["bias"] = (0.1 * rng.randn(co)).astype(np.float32)
    return p, x


def _torch_params(p):
    """The Flax HWIO kernel flipped and permuted to the port's stored
    (I, O, 4, 4) transpose-conv weight, and the bias."""
    k = p["conv_up"]["kernel"]
    w = np.ascontiguousarray(np.flip(k, (0, 1)).transpose(2, 3, 0, 1))
    return torch.from_numpy(w), torch.from_numpy(p["conv_up"]["bias"])


@pytest.mark.parametrize("fn", [upconv_stage_plain, upconv_stage_cuda])
@pytest.mark.parametrize("h,w,ci,co,tr", [(8, 12, 6, 4, 8),
                                          (14, 32, 64, 16, 8),
                                          (16, 24, 3, 16, 16)])
def test_upconv_stage_matches_jax_kernel(fn, h, w, ci, co, tr):
    """The phase formula of the JAX kernel pins the port's weight flip:
    y[2i+r, 2j+s] = sum_{a,b} x[i+a-(1-r), j+b-(1-s)] * k[2a+r, 2b+s]."""
    p, x = _stage(h, w, ci, co)
    want = np.asarray(upconv_stage_pallas(jnp.asarray(x), p,
                                          dtype=jnp.float32, tile_rows=tr,
                                          interpret=True))
    wt, b = _torch_params(p)
    got = fn(torch.from_numpy(x), wt, b, torch.float32)
    assert got.shape == want.shape == (2, 2 * h, 2 * w, co)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_upconv_trainable_gradients_match_jax():
    p, x = _stage(8, 12, 6, 4, seed=3)

    def loss_j(p, x):
        return jnp.sum(jnp.sin(j_upconv_stage_trainable(
            x, p, dtype=jnp.float32, tile_rows=8, interpret=True)))

    gp, gx = jax.grad(loss_j, (0, 1))(p, jnp.asarray(x))
    wt, b = _torch_params(p)
    leaves = [t.clone().requires_grad_() for t in
              (torch.from_numpy(x), wt, b)]
    y = upconv_stage_trainable(leaves[0], [tuple(leaves[1:])],
                               torch.float32)
    torch.sin(y).sum().backward()
    np.testing.assert_allclose(leaves[0].grad.numpy(), np.asarray(gx),
                               atol=1e-5)
    # The parameter gradients sum 768 output terms each and reach a few
    # hundred: beside the 1e-4 bound, 1e-5 of the value (float32 sums of
    # that length in another order differ by ~1e-6 of it).
    gw = np.flip(leaves[1].grad.numpy().transpose(2, 3, 0, 1), (0, 1))
    np.testing.assert_allclose(gw, np.asarray(gp["conv_up"]["kernel"]),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(leaves[2].grad.numpy(),
                               np.asarray(gp["conv_up"]["bias"]), atol=1e-4,
                               rtol=1e-5)


def test_upconv_trainable_takes_only_needed_gradients():
    """A frozen weight and bias get no gradient; x still does."""
    p, x = _stage(8, 12, 6, 16, seed=4)
    wt, b = _torch_params(p)
    xt = torch.from_numpy(x).requires_grad_()
    upconv_stage_trainable(xt, [(wt, b)], torch.float32).sum().backward()
    assert xt.grad is not None and wt.grad is None and b.grad is None


def test_decoder_upconv_stages_match_jax_reference(flow_setup):
    """The port's Decoder with the last two stages through the
    upconv-stage path against the JAX Decoder's reference composition
    (upconv_stages=0, which tests/test_upconv_kernel.py holds equal to the
    kernel), on the JAX encoder's features."""
    model_j, variables = flow_setup
    rng = np.random.RandomState(0)
    x3 = jnp.asarray(rng.uniform(-0.5, 0.5, (1, *TEST_HW, 3)), jnp.float32)

    def encs_decs(m, img):
        encs = m.encoder(img, train=False)
        return encs, m.decoder(encs, train=False)

    encs_j, decs_j = model_j.apply(variables, x3, method=encs_decs)
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                               jax.device_get(variables))
    port = load_flax_variables(build_flow_net(0, "cpu", upconv_stages=2), v)
    assert port.decoder.upconv_stages == 2
    encs = [nchw(torch.from_numpy(np.array(e))).contiguous(
        memory_format=CHANNELS_LAST) for e in encs_j]
    calls = []
    orig = upconv_kernel.upconv_stage_cuda

    def counting(*a, **k):
        calls.append(a[0].shape)
        return orig(*a, **k)

    upconv_kernel.upconv_stage_cuda = counting
    try:
        with torch.no_grad():
            decs = port.decoder(encs)
    finally:
        upconv_kernel.upconv_stage_cuda = orig
    assert [c[-1] for c in calls] == [128, 64]
    assert len(decs) == len(decs_j) == 4
    for a, b in zip(decs, decs_j):
        np.testing.assert_allclose(nhwc(a).numpy(), np.asarray(b),
                                   atol=1e-5)


@pytest.mark.parametrize("n,narrow", [(2, True), (3, False)])
def test_decoder_upconv_stages_need_kernel_widths(n, narrow):
    """Any stage count builds, as in JAX, and runs on CPU tensors; every
    fused stage's width has a kernel. The 32- and 16-channel stages (the
    last two) run the resident-weight body (``narrow``), the 64- and
    128-channel ones the implicit GEMM."""
    dec = Decoder(upconv_stages=n)
    assert dec.upconv_stages == n
    widths = [st.params()[0][0].shape[1] for st in dec.stages[4 - n:]]
    assert all(w in UPCONV_CHANNELS for w in widths)
    assert all(w not in UPCONV_GEMM_CHANNELS for w in widths) == narrow
    encs = [torch.randn(1, c, 32 >> i, 64 >> i).contiguous(
        memory_format=CHANNELS_LAST)
        for i, c in enumerate((3, 16, 32, 64, 128, 256))]
    with torch.no_grad():
        decs = dec(encs)
    assert [tuple(d.shape[1:]) for d in decs] == [
        (256, 2, 4), (128, 4, 8), (64, 8, 16), (32, 16, 32)]
