"""The wide stages' implicit GEMM as its bf16 body decomposes a conv
(``qpwcnet_torch/ops/cuda/conv_gemm.py``: the 5D stride-2 view, the
per-tap box origins with zeros out of bounds, ``prep_w33`` /
``prep_wt``'s weight layouts and slot order), on CPU, against the stages'
plain versions and against the JAX package's stage kernels.

The JAX side runs its stem and upconv Pallas kernels in interpret mode,
as tests/test_torch_wide_stages.py does. Inputs come from numpy seeds.
Shapes are ragged (no multiple of the 16-column box) and at most 64 x 128
positions. Tolerance: float32 sums in another order, 1e-5 of the output
magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpwcnet_torch.ops.activations import mish
from qpwcnet_torch.ops.cuda import conv_gemm
from qpwcnet_torch.ops.cuda._build import gemm_cip
from qpwcnet_torch.ops.cuda.conv_gemm import (
    CONV_S1,
    CONV_S2,
    conv_gemm_plain,
    downconv_stage_gemm_plain,
    prep_w33_plain,
    prep_wt_plain,
    upconv_stage_gemm_plain,
)
from qpwcnet_torch.ops.cuda.stem_kernel import downconv_stage_plain
from qpwcnet_torch.ops.cuda.upconv_kernel import upconv_stage_plain
from qpwcnet_torch.quantize.qlayers import conv2d_same
from qpwcnet_tpu.ops.pallas.stem_kernel import downconv_stage_pallas
from qpwcnet_tpu.ops.pallas.upconv_kernel import upconv_stage_pallas
from tests.test_torch_kernels_plain import _stage as _down_stage
from tests.test_torch_model import one_torch_thread  # noqa: F401
from tests.test_torch_upconv import _stage as _up_stage
from tests.test_torch_upconv import _torch_params

REL = 1e-5


def _rel_err(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / max(
        1.0, float(np.max(np.abs(want))))


def _conv_plain(x, weight, bias, stride):
    """One QConv-equivalent conv + bias + Mish in float32, NHWC."""
    y = conv2d_same(x.permute(0, 3, 1, 2), weight, stride=stride)
    return mish(y + bias[:, None, None]).permute(0, 2, 3, 1)


@pytest.mark.parametrize("mode,shape,cout", [
    (CONV_S2, (2, 10, 14, 32), 64),   # encoder stage 2's conv_a
    (CONV_S2, (2, 10, 14, 20), 64),   # Ci 20: the decomposition pads to 32
    (CONV_S1, (2, 5, 7, 64), 128),    # a stride-1 conv, Cin != Co
])
def test_conv_gemm_plain_single_conv(mode, shape, cout):
    """One conv by the GEMM's decomposition against the conv itself."""
    rng = np.random.RandomState(sum(shape) + cout)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    ci = shape[-1]
    w = torch.from_numpy((rng.standard_normal((cout, ci, 3, 3))
                          * (9 * ci) ** -0.5).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(cout)).astype(np.float32))
    cip = gemm_cip(ci)
    got = conv_gemm_plain(mode, x, prep_w33_plain(w, cip, torch.float32), b,
                          torch.float32)
    want = _conv_plain(x, w, b, 2 if mode == CONV_S2 else 1)
    assert got.shape == want.shape
    assert _rel_err(got, want) <= REL


@pytest.mark.parametrize("cin", [32, 20])
def test_downconv_stage_gemm_plain_matches_plain_and_pallas(cin):
    """K2's wide stage as the card runs it (conv_a stride 2, conv_aa and
    conv_b stride 1, each one GEMM) on a (2, 10, 14, Ci) input -> 64
    channels, against the unfused composition and JAX's stage kernel."""
    _, v, x, params = _down_stage(10, 14, cin, 64, seed=40 + cin)
    got = downconv_stage_gemm_plain(torch.from_numpy(x), params,
                                    torch.float32)
    want = downconv_stage_plain(torch.from_numpy(x), params, torch.float32)
    ref = downconv_stage_pallas(jnp.asarray(x), v["params"],
                                dtype=jnp.float32, tile_rows=4,
                                interpret=True)
    assert got.shape == want.shape == ref.shape == (2, 5, 7, 64)
    assert _rel_err(got, want) <= REL
    assert _rel_err(got, ref) <= REL


@pytest.mark.parametrize("shape,cout", [((2, 4, 6, 256), 128),
                                        ((2, 3, 5, 20), 64)])
def test_upconv_stage_gemm_plain_matches_plain_and_pallas(shape, cout):
    """K5's wide stage as one GEMM over the four phases (prep_wt's slot
    order, each phase's 4 shifted taps, the phase-interleaved output)
    against the unfused composition and JAX's stage kernel."""
    b, h, w, ci = shape
    p, x = _up_stage(h, w, ci, cout, seed=ci + cout)
    wt, bias = _torch_params(p)
    got = upconv_stage_gemm_plain(torch.from_numpy(x), wt, bias,
                                  torch.float32)
    want = upconv_stage_plain(torch.from_numpy(x), wt, bias, torch.float32)
    ref = upconv_stage_pallas(jnp.asarray(x), p, dtype=jnp.float32,
                              tile_rows=4, interpret=True)
    assert got.shape == want.shape == ref.shape == (b, 2 * h, 2 * w, cout)
    assert _rel_err(got, want) <= REL
    assert _rel_err(got, ref) <= REL


def test_prep_wt_plain_slot_order():
    """Slot (2r + s) 4 + 2a + b holds Wt[:, :, 3 - 2a - r, 3 - 2b - s]
    transposed to (Co, cip), zeros past Ci: upconv.cu:prep_wt's layout."""
    wt = torch.arange(3 * 2 * 16, dtype=torch.float32).reshape(3, 2, 4, 4)
    prep = prep_wt_plain(wt, 32, torch.float32)
    assert prep.shape == (16, 2, 32)
    for r in (0, 1):
        for s in (0, 1):
            for a in (0, 1):
                for b in (0, 1):
                    slot = (2 * r + s) * 4 + 2 * a + b
                    torch.testing.assert_close(
                        prep[slot, :, :3],
                        wt[:, :, 3 - 2 * a - r, 3 - 2 * b - s].t())
    assert not prep[:, :, 3:].any()


def test_tma_padded_makes_an_aligned_padded_copy():
    """Ci 20 is padded to 32 with zeros; a view at a 2-element offset is
    copied to an aligned buffer; an input the GEMM reads as it is
    passes tma_ready."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.standard_normal((1, 3, 5, 20)).astype(
        np.float32)).bfloat16()
    assert not conv_gemm.tma_ready(x)
    p = conv_gemm.tma_padded(x)
    assert p.shape == (1, 3, 5, 32) and conv_gemm.tma_ready(p)
    assert torch.equal(p[..., :20], x) and not p[..., 20:].any()
    buf = torch.zeros(3 * 5 * 32 + 2, dtype=torch.bfloat16)
    v = buf[2:].view(1, 3, 5, 32)
    assert v.data_ptr() % 16 and not conv_gemm.tma_ready(v)
    c = conv_gemm.tma_padded(v)
    assert conv_gemm.tma_ready(c) and torch.equal(c, v)
