"""The port's CUDA kernels against their plain PyTorch versions on a CUDA
card. Every test here is marked ``cuda`` and skips without a card.

This file imports neither jax nor the JAX package, so it also runs where
only PyTorch is installed (tests/conftest.py imports jax, hence
--noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Shapes are small and not multiples of the kernels' tiles; chip_smoke.py
checks the headline shapes. Tolerances: float32 sums in another order,
1e-5 of the output magnitude; bf16 outputs, one bf16 ulp (2^-7) of it,
four for the stem, where an early rounding flip propagates.
"""

import numpy as np
import pytest
import torch

from qpwcnet_torch.ops import cuda as kernels
from qpwcnet_torch.ops.cost_volume import cost_volume_plain
from qpwcnet_torch.ops.cuda.cost_volume_kernel import cost_volume_cuda
from qpwcnet_torch.ops.cuda.stem_kernel import (
    downconv_stage_cuda,
    downconv_stage_plain,
)
from qpwcnet_torch.ops.cuda.warp_cv_kernel import (
    warp_cost_volume_cuda,
    warp_cost_volume_plain,
)

REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


@pytest.fixture
def dev():
    """The first CUDA device, with TF32 off so float32 convs are full
    float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _rand(rng, shape, dev, dtype=torch.float32, scale=1.0):
    return torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32)
    ).to(dev, dtype)


def _assert_close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float((got.float() - want.float()).abs().max())
    tol = REL[want.dtype] * max(1.0, float(want.float().abs().max()))
    assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cost_volume_kernel(dev, dtype):
    rng = np.random.RandomState(0)
    prv = _rand(rng, (2, 13, 37, 20), dev, dtype)
    nxt = _rand(rng, (2, 13, 37, 20), dev, dtype)
    kernels.reset_launch_counts()
    _assert_close(cost_volume_cuda(prv, nxt), cost_volume_plain(prv, nxt))
    assert cost_volume_cuda.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_cost_volume_kernel(dev, dtype):
    rng = np.random.RandomState(1)
    prv = _rand(rng, (2, 13, 37, 24), dev, dtype)
    nxt = _rand(rng, (2, 13, 37, 24), dev, dtype)
    flow = _rand(rng, (2, 13, 37, 2), dev, scale=4.0)
    kernels.reset_launch_counts()
    _assert_close(warp_cost_volume_cuda(prv, nxt, flow),
                  warp_cost_volume_plain(prv, nxt, flow))
    assert warp_cost_volume_cuda.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout", [(3, 16), (16, 32)])
def test_downconv_stage_kernel(dev, dtype, cin, cout):
    rng = np.random.RandomState(2)
    x = _rand(rng, (2, 38, 70, cin), dev, dtype)
    params = []
    for c in (cin, cout, cout):
        params.append((_rand(rng, (cout, c, 3, 3), dev,
                             scale=(9 * c) ** -0.5),
                       _rand(rng, (cout,), dev, scale=0.1)))
    kernels.reset_launch_counts()
    got = downconv_stage_cuda(x, params, dtype)
    want = downconv_stage_plain(x, params, dtype)
    if dtype == torch.bfloat16:
        # a one-ulp flip in conv_a or conv_aa propagates: 4 ulps
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        assert err <= 4 * REL[dtype] * max(1.0,
                                           float(want.float().abs().max()))
    else:
        _assert_close(got, want)
    assert downconv_stage_cuda.launches == 1


@pytest.mark.cuda
def test_wrappers_validate_inputs(dev):
    rng = np.random.RandomState(3)
    prv = _rand(rng, (1, 8, 16, 8), dev)
    with pytest.raises(ValueError):
        cost_volume_cuda(prv, prv.transpose(1, 2))
    with pytest.raises(ValueError):
        cost_volume_cuda(prv, prv, search_range=3)
    with pytest.raises(ValueError):
        warp_cost_volume_cuda(prv, prv, torch.zeros(1, 8, 16, 2,
                                                    device=dev).double())
