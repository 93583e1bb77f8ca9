"""Fused-stage counts beyond the kernels' widths: the port's PWCFlowNet
with ``stem_stages=3`` and ``upconv_stages=4`` against the JAX model with
the same options and the same Flax variables, on CPU, float32.

The JAX side runs its stem and upconv Pallas kernels in interpret mode
(its Encoder and Decoder do so off the TPU), as tests/test_stem_kernel.py
and tests/test_upconv_kernel.py do; the port's wrappers take their plain
versions on CPU tensors. Tolerance: the whole-model parity bound of
tests/test_torch_model.py, 1e-4 of the flow magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpwcnet_torch.models import build_flow_net, load_flax_variables
from qpwcnet_torch.models.pwcnet import Encoder, init_weights
from qpwcnet_torch.ops.cuda import stem_kernel, upconv_kernel
from tests.conftest import TEST_HW
from tests.test_torch_model import (
    _err,
    _inputs,
    _seeded,
    one_torch_thread,  # noqa: F401
)


def _counting(module, name, calls):
    orig = getattr(module, name)

    def counting(*a, **k):
        calls.append(a[0].shape[-1])
        return orig(*a, **k)

    return orig, counting


def test_stem3_upconv4_match_jax(flow_setup):
    model_j, variables = flow_setup
    v = _seeded(variables, "diag", seed=4, hw=TEST_HW)
    x = _inputs(5, hw=TEST_HW)
    kw = dict(stem_stages=3, upconv_stages=4)
    want = np.asarray(model_j.clone(**kw).apply(v, jnp.asarray(x),
                                                train=False))
    port = load_flax_variables(build_flow_net(0, "cpu", **kw), v)
    stem_calls, up_calls = [], []
    patches = [(stem_kernel, "downconv_stage_cuda", stem_calls),
               (upconv_kernel, "upconv_stage_cuda", up_calls)]
    saved = []
    for module, name, calls in patches:
        orig, fn = _counting(module, name, calls)
        saved.append((module, name, orig))
        setattr(module, name, fn)
    try:
        with torch.no_grad():
            got = port(torch.from_numpy(x))
    finally:
        for module, name, orig in saved:
            setattr(module, name, orig)
    # the encoder on the stacked pair once (fuse_batch): input widths of
    # the three fused stem stages and of the four fused upconv stages
    assert stem_calls == [3, 16, 32]
    assert up_calls == [256, 256, 128, 64]
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(np.mean(np.abs(want))) > 0.1
    assert _err(got, want) <= 1e-4 * max(1.0, float(np.max(np.abs(want))))


@pytest.mark.parametrize("n", [3, 4, 5])
def test_encoder_builds_any_stem_stages(n):
    """Every stage count builds, and on CPU tensors each fused stage is
    the plain composition of its DownConv's parameters."""
    torch.manual_seed(n)
    enc = Encoder(stem_stages=n)
    init_weights(enc, n, "diag")
    ref = Encoder(stem_stages=0)
    ref.load_state_dict(enc.state_dict())
    img = torch.rand(1, 3, 32, 64) - 0.5
    with torch.no_grad():
        for a, b in zip(enc(img), ref(img)):
            assert a.shape == b.shape
            assert float((a - b).abs().max()) <= 1e-5
