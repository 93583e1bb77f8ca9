"""The port's CUDA kernels against their plain PyTorch versions on a CUDA
card. Every test here is marked ``cuda`` and skips without a card.

This file imports neither jax nor the JAX package, so it also runs where
only PyTorch is installed (tests/conftest.py imports jax, hence
--noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Shapes are small and not multiples of the kernels' tiles; chip_smoke.py
checks the headline shapes. Tolerances: float32 sums in another order,
1e-5 of the output magnitude; bf16 outputs, one bf16 ulp (2^-7) of it,
four for the stem, where an early rounding flip propagates, and two for
the upconv stage, where it moves the bias add's and Mish's roundings.
"""

import numpy as np
import pytest
import torch

from qpwcnet_torch.models import build_flow_net, build_interpolator
from qpwcnet_torch.ops import cuda as kernels
from qpwcnet_torch.ops.cost_volume import (
    CostVolumeFunction,
    cost_volume,
    cost_volume_bwd_nxt_plain,
    cost_volume_bwd_prv_plain,
    cost_volume_plain,
)
from qpwcnet_torch.ops.cuda.cost_volume_kernel import (
    cost_volume_bwd_nxt_cuda,
    cost_volume_bwd_prv_cuda,
    cost_volume_cuda,
)
from qpwcnet_torch.ops.cuda.stem_kernel import (
    downconv_stage_cuda,
    downconv_stage_plain,
    downconv_stage_trainable,
)
from qpwcnet_torch.ops.cuda.upconv_kernel import (
    upconv_stage_cuda,
    upconv_stage_plain,
    upconv_stage_trainable,
)
from qpwcnet_torch.ops.warp import backward_warp
from qpwcnet_torch.ops.cuda.warp_cv_kernel import (
    warp_cost_volume_cuda,
    warp_cost_volume_plain,
    warp_cost_volume_trainable,
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


def _device_kernels(fn, tries=3):
    """The names of the device kernels of one fn() call (torch.profiler),
    with the launch counts reset before it. The profiler now and then
    drops a short window's device records: a window that recorded none is
    profiled again, up to ``tries`` windows."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


def _assert_close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float((got.float() - want.float()).abs().max())
    tol = REL[want.dtype] * max(1.0, float(want.float().abs().max()))
    assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cost_volume_kernel(dev, dtype):
    _check_cost_volume(dev, (2, 13, 37, 20), dtype)


def _check_cost_volume(dev, shape, dtype=torch.bfloat16, seed=0):
    rng = np.random.RandomState(seed)
    prv = _rand(rng, shape, dev, dtype)
    nxt = _rand(rng, shape, dev, dtype)
    kernels.reset_launch_counts()
    _assert_close(cost_volume_cuda(prv, nxt), cost_volume_plain(prv, nxt))
    assert cost_volume_cuda.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("c", [20, 24, 32, 64, 128, 256])
def test_cost_volume_kernel_bf16_widths(dev, c):
    """The tensor-core body at every channel count the models use and at
    C % 8 != 0 (element-wise staging) and C % 32 != 0 (a zero-filled
    channel tail), on a map that is no tile multiple."""
    _check_cost_volume(dev, (2, 13, 37, c), seed=c)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 30, 70, 32),     # batch 1
    (1, 5, 7, 32),       # smaller than one tile
    (3, 5, 7, 20),       # smaller than one tile, element-wise staging
    (16, 64, 128, 64),   # more tiles than resident blocks: blocks loop
    (40, 13, 37, 40),    # a ring across tiles of two chunks, one partial
])
def test_cost_volume_kernel_bf16_grid(dev, shape):
    _check_cost_volume(dev, shape, seed=sum(shape))


@pytest.mark.cuda
def test_cost_volume_kernel_bf16_unaligned_views(dev):
    """Inputs that start off a 16-byte boundary take the element-wise
    staging; an output row that does so is stored around its ends."""
    rng = np.random.RandomState(3)
    n = 2 * 13 * 37 * 24
    flat = _rand(rng, (n + 4,), dev, torch.bfloat16)
    prv, nxt = flat[4:].view(2, 13, 37, 24), flat[:-4].view(2, 13, 37, 24)
    _assert_close(cost_volume_cuda(prv, nxt), cost_volume_plain(prv, nxt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cost_volume_launches_one_kernel(dev, dtype):
    """A call launches one device kernel: the tensor-core body in bf16,
    the CUDA-core correlate_kernel in float32."""
    rng = np.random.RandomState(18)
    prv = _rand(rng, (2, 56, 128, 128), dev, dtype)
    nxt = _rand(rng, (2, 56, 128, 128), dev, dtype)
    cost_volume_cuda(prv, nxt)  # builds the library
    torch.cuda.synchronize()
    names = _device_kernels(lambda: cost_volume_cuda(prv, nxt))
    body = ("cost_volume_mma_kernel" if dtype == torch.bfloat16
            else "correlate_kernel<float, false>")
    assert len(names) == 1 and body in names[0], names
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


def _check_warp_cv(dev, shape, seed, scale=6.0, views=None):
    """One K3 launch against its plain version; flows of std ``scale`` px
    (6: about half beyond the ±4 window, clamped)."""
    rng = np.random.RandomState(seed)
    if views is None:
        prv = _rand(rng, shape, dev, torch.bfloat16)
        nxt = _rand(rng, shape, dev, torch.bfloat16)
    else:
        prv, nxt = views
    flow = _rand(rng, shape[:3] + (2,), dev, scale=scale)
    kernels.reset_launch_counts()
    _assert_close(warp_cost_volume_cuda(prv, nxt, flow),
                  warp_cost_volume_plain(prv, nxt, flow))
    assert warp_cost_volume_cuda.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("c", [20, 32, 64, 256])
@pytest.mark.parametrize("scale", [2.0, 6.0])
def test_warp_cost_volume_kernel_bf16_widths(dev, c, scale):
    """The tensor-core body at C % 8 != 0 (element-wise gather and
    staging), the models' C = 32, and several chunks (64, 256), with flows
    inside the ±4 window and beyond it, on a map that is no tile
    multiple."""
    _check_warp_cv(dev, (2, 13, 37, c), seed=c, scale=scale)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 30, 70, 32),     # batch 1
    (1, 5, 7, 32),       # smaller than one tile
    (3, 5, 7, 20),       # smaller than one tile, element-wise gather
    (1, 2, 2, 8),        # the smallest map the warp takes
    (16, 64, 128, 32),   # more tiles than resident blocks
    (40, 13, 37, 40),    # many tiles, two chunks, the second partial
])
def test_warp_cost_volume_kernel_bf16_grid(dev, shape):
    _check_warp_cv(dev, shape, seed=sum(shape))


@pytest.mark.cuda
def test_warp_cost_volume_kernel_bf16_unaligned_views(dev):
    """Maps that start off a 16-byte boundary take the element-wise
    gather and staging; output rows that do are stored around their
    ends."""
    rng = np.random.RandomState(21)
    shape = (2, 13, 37, 24)
    n = 2 * 13 * 37 * 24
    flat = _rand(rng, (n + 4,), dev, torch.bfloat16)
    _check_warp_cv(dev, shape, seed=22,
                   views=(flat[4:].view(shape), flat[:-4].view(shape)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_cost_volume_launches_one_kernel(dev, dtype):
    """A call launches one device kernel: the tensor-core body in bf16,
    the CUDA-core correlate_kernel in float32."""
    rng = np.random.RandomState(23)
    prv = _rand(rng, (2, 56, 128, 32), dev, dtype)
    nxt = _rand(rng, (2, 56, 128, 32), dev, dtype)
    flow = _rand(rng, (2, 56, 128, 2), dev, scale=3.0)
    warp_cost_volume_cuda(prv, nxt, flow)  # builds the library
    torch.cuda.synchronize()
    names = _device_kernels(lambda: warp_cost_volume_cuda(prv, nxt, flow))
    body = ("warp_cv_mma_kernel" if dtype == torch.bfloat16
            else "correlate_kernel<float, true>")
    assert len(names) == 1 and body in names[0], names
    assert warp_cost_volume_cuda.launches == 1


@pytest.mark.cuda
def test_backward_warp_image_gradient_is_reproducible(dev):
    """The warp's d_img on the card (a sorted scatter, not atomics): two
    backward passes of bf16 backward_warp at the 'fast' train step's
    finest level give bit-equal gradients, within the bf16 tolerance of
    the CPU's (4 half-ulps of the magnitude: the card sums each
    destination's terms in float32, the CPU in bf16)."""
    rng = np.random.RandomState(24)
    shape = (16, 128, 256, 32)
    img = _rand(rng, shape, dev, torch.bfloat16)
    flow = _rand(rng, shape[:3] + (2,), dev, scale=3.0)
    g = _rand(rng, shape, dev, torch.bfloat16)

    def grads(device):
        leaves = [t.detach().to(device).clone().requires_grad_()
                  for t in (img, flow)]
        backward_warp(*leaves).backward(g.to(device))
        return [t.grad for t in leaves]

    (d_img, d_flow), (d_img2, d_flow2) = grads(dev), grads(dev)
    assert torch.equal(d_img, d_img2) and torch.equal(d_flow, d_flow2)
    want = grads("cpu")[0]
    err = float((d_img.cpu().float() - want.float()).abs().max())
    assert err <= 4 * 2.0 ** -8 * max(1.0, float(want.float().abs().max()))


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


def _stem_params(rng, dev, cin, cout):
    return [(_rand(rng, (cout, c, 3, 3), dev, scale=(9 * c) ** -0.5),
             _rand(rng, (cout,), dev, scale=0.1)) for c in (cin, cout, cout)]


def _check_stem(dev, dtype, shape, cout, seed):
    """One K2 launch against its plain version: float32 within 1e-5 of
    the magnitude, bf16 within four ulps (a one-ulp flip in conv_a or
    conv_aa propagates through the later convs)."""
    rng = np.random.RandomState(seed)
    x = _rand(rng, shape, dev, dtype, scale=0.5)
    params = _stem_params(rng, dev, shape[-1], cout)
    kernels.reset_launch_counts()
    got = downconv_stage_cuda(x, params, dtype)
    want = downconv_stage_plain(x, params, dtype)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (shape[0], shape[1] // 2,
                                       shape[2] // 2, cout)
    assert bool(torch.isfinite(got.float()).all())
    err = float((got.float() - want.float()).abs().max())
    ulps = 4 if dtype == torch.bfloat16 else 1
    assert err <= ulps * REL[dtype] * max(1.0,
                                          float(want.float().abs().max()))
    assert downconv_stage_cuda.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(3, 16), (16, 32), (32, 64),
                                      (3, 32), (3, 64)])
def test_downconv_stage_kernel_bf16_widths(dev, cin, cout):
    """The bf16 tensor-core body at the widths of encoder stages 0-2 (the
    RGB input's packed taps at Ci 3, then Ci 16 and 32 staged by
    cp.async), and the packed taps at the other two widths."""
    _check_stem(dev, torch.bfloat16, (2, 38, 70, cin), cout, seed=13)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout", [
    ((8, 256, 512, 3), 16),   # 512 tiles: more than the persistent grid
    ((4, 256, 256, 16), 32),  # holds, so each block walks several
    ((1, 64, 128, 3), 16),    # batch 1
    ((1, 64, 128, 16), 32),
    ((3, 38, 70, 16), 32),    # no tile multiple
    ((2, 30, 46, 20), 16),    # Ci 20: element loads, padded to 32
])
def test_downconv_stage_kernel_grid(dev, dtype, shape, cout):
    _check_stem(dev, dtype, shape, cout, seed=14)


@pytest.mark.cuda
def test_downconv_stage_kernel_co64_grid(dev):
    """bf16 at Co 64 with more 8 x 16 tiles than resident blocks; each
    block stages every conv's weights for every tile."""
    _check_stem(dev, torch.bfloat16, (4, 128, 256, 32), 64, seed=15)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_downconv_stage_launches_one_kernel(dev, dtype):
    """A call launches K2 and nothing else: the kernel reads the stored
    float32 weights and biases, so no cast or permute runs before it."""
    rng = np.random.RandomState(16)
    x = _rand(rng, (2, 64, 128, 16), dev, dtype, scale=0.5)
    params = _stem_params(rng, dev, 16, 32)
    downconv_stage_cuda(x, params, dtype)  # builds the library
    torch.cuda.synchronize()
    names = _device_kernels(lambda: downconv_stage_cuda(x, params, dtype))
    assert len(names) == 1 and "stem" in names[0], names
    assert downconv_stage_cuda.launches == 1


@pytest.mark.cuda
def test_downconv_stage_raises_for_unbuilt_widths(dev):
    rng = np.random.RandomState(17)
    kernels.reset_launch_counts()
    for dtype, cin, cout in ((torch.bfloat16, 64, 128),
                             (torch.float32, 32, 64),
                             (torch.bfloat16, 20, 32)):
        x = _rand(rng, (1, 8, 16, cin), dev, dtype)
        with pytest.raises(ValueError):
            downconv_stage_cuda(x, _stem_params(rng, dev, cin, cout), dtype)
    assert downconv_stage_cuda.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 13, 37, 20), (1, 9, 21, 72)])
def test_cost_volume_bwd_kernels(dev, dtype, shape):
    """K4a and K4b against their plain versions; C = 72 spans three
    channel groups of a block, the last one ragged."""
    rng = np.random.RandomState(4)
    dacc = _rand(rng, shape[:3] + (81,), dev, dtype)
    prv = _rand(rng, shape, dev, dtype)
    nxt = _rand(rng, shape, dev, dtype)
    kernels.reset_launch_counts()
    _assert_close(cost_volume_bwd_prv_cuda(dacc, nxt),
                  cost_volume_bwd_prv_plain(dacc, nxt))
    _assert_close(cost_volume_bwd_nxt_cuda(dacc, prv),
                  cost_volume_bwd_nxt_plain(dacc, prv))
    assert cost_volume_bwd_prv_cuda.launches == 1
    assert cost_volume_bwd_nxt_cuda.launches == 1


def _check_bwd(dev, shape, seed, dacc=None, src=None):
    rng = np.random.RandomState(seed)
    if dacc is None:
        dacc = _rand(rng, shape[:3] + (81,), dev, torch.bfloat16)
        src = _rand(rng, shape, dev, torch.bfloat16)
    kernels.reset_launch_counts()
    _assert_close(cost_volume_bwd_prv_cuda(dacc, src),
                  cost_volume_bwd_prv_plain(dacc, src))
    _assert_close(cost_volume_bwd_nxt_cuda(dacc, src),
                  cost_volume_bwd_nxt_plain(dacc, src))
    assert cost_volume_bwd_prv_cuda.launches == 1
    assert cost_volume_bwd_nxt_cuda.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 12, 20, 36, 64, 128])
def test_cost_volume_bwd_kernels_bf16_widths(dev, c):
    """The tensor-core body at C % 8 != 0 (element-wise staging and
    stores), C % 32 != 0 (a zero-filled channel tail) and the models'
    widths, on a map whose W is no multiple of 8."""
    _check_bwd(dev, (2, 13, 37, c), seed=c)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (4, 24, 40, 256),    # C = 256 in split channel groups
    (2, 8, 16, 256),     # the coarsest level at b2: 2-row tiles, 8 groups
    (16, 16, 32, 256),   # the training level (16, 32, 256) at b16
    (1, 5, 7, 32),       # smaller than one tile
    (1, 1, 1, 8),        # one pixel: every window pixel but one outside
    (40, 13, 37, 40),    # many tiles, two chunks, the second partial
])
def test_cost_volume_bwd_kernels_bf16_grid(dev, shape):
    _check_bwd(dev, shape, seed=sum(shape))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 4])
def test_cost_volume_bwd_kernels_bf16_unaligned_views(dev, offset):
    """dacc and the map start off a 16-byte boundary (dacc's runs shift;
    the map is staged and the output stored element-wise), and dacc's
    first run begins at the tensor's first element."""
    rng = np.random.RandomState(offset)
    shape = (2, 13, 37, 24)
    nd, ns = 2 * 13 * 37 * 81, 2 * 13 * 37 * 24
    flat = _rand(rng, (nd + ns + 8,), dev, torch.bfloat16)
    dacc = flat[offset:offset + nd].view(*shape[:3], 81)
    src = flat[nd + 3:nd + 3 + ns].view(shape)
    _check_bwd(dev, shape, seed=0, dacc=dacc, src=src)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cost_volume_bwd_launches_one_kernel(dev, dtype):
    """A call launches one device kernel: the tensor-core body in bf16,
    the CUDA-core cv_bwd_kernel in float32."""
    rng = np.random.RandomState(19)
    dacc = _rand(rng, (2, 32, 64, 81), dev, dtype)
    src = _rand(rng, (2, 32, 64, 128), dev, dtype)
    for kern, flag in ((cost_volume_bwd_prv_cuda, "false"),
                       (cost_volume_bwd_nxt_cuda, "true")):
        kern(dacc, src)  # builds the library
        torch.cuda.synchronize()
        names = _device_kernels(lambda: kern(dacc, src))
        body = (f"cv_bwd_mma_kernel<{flag}" if dtype == torch.bfloat16
                else f"cv_bwd_kernel<float, {flag}>")
        assert len(names) == 1 and body in names[0], names
        assert kern.launches == 1


@pytest.mark.cuda
def test_cost_volume_function_grads_match_plain_autograd(dev):
    rng = np.random.RandomState(5)
    prv, nxt = (_rand(rng, (2, 11, 19, 24), dev) for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (prv, nxt, prv, nxt)]
    g = _rand(rng, (2, 11, 19, 81), dev)
    kernels.reset_launch_counts()
    CostVolumeFunction.apply(leaves[0], leaves[1]).backward(g)
    cost_volume_plain(leaves[2], leaves[3]).backward(g)
    assert kernels.launch_counts() == {
        "cost_volume_cuda": 1, "downconv_stage_cuda": 0,
        "warp_cost_volume_cuda": 0, "cost_volume_bwd_prv_cuda": 1,
        "cost_volume_bwd_nxt_cuda": 1, "upconv_stage_cuda": 0}
    _assert_close(leaves[0].grad, leaves[2].grad)
    _assert_close(leaves[1].grad, leaves[3].grad)


@pytest.mark.cuda
def test_kernel_outputs_carry_gradients(dev):
    """The kernels' outputs stay in the autograd graph, and every
    parameter of a model with the fused stem and the fused warp+correlate
    gets a non-zero gradient (encoder stages 0 and 1 included)."""
    rng = np.random.RandomState(6)
    prv = _rand(rng, (1, 8, 16, 16), dev).requires_grad_()
    nxt = _rand(rng, (1, 8, 16, 16), dev).requires_grad_()
    flow = _rand(rng, (1, 8, 16, 2), dev, scale=2.0).requires_grad_()
    x = _rand(rng, (1, 8, 16, 3), dev).requires_grad_()
    params = [(_rand(rng, (16, c, 3, 3), dev, scale=0.2).requires_grad_(),
               _rand(rng, (16,), dev, scale=0.1).requires_grad_())
              for c in (3, 16, 16)]
    for out in (cost_volume(prv, nxt),
                warp_cost_volume_trainable(prv, nxt, flow),
                downconv_stage_trainable(x, params, torch.float32)):
        assert out.requires_grad and out.grad_fn is not None
    model = build_flow_net(0, dev, cv_impl="fast", stem_stages=2,
                           head_scale="unit").train()
    ims = _rand(rng, (2, 64, 128, 6), dev, scale=0.3)
    outs = model(ims, multiscale=True)
    sum(o.square().mean() for o in outs[:-1]).backward()
    zero = [n for n, p in model.named_parameters()
            if p.grad is None or not bool(p.grad.abs().max() > 0)]
    assert not zero, zero
    for i in (0, 1):
        assert float(model.encoder.stages[i].conv_a.weight.grad.abs()
                     .max()) > 0


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
    dacc = _rand(rng, (1, 8, 16, 81), dev)
    with pytest.raises(ValueError):
        cost_volume_bwd_prv_cuda(dacc[..., :49].contiguous(), prv)
    with pytest.raises(ValueError):
        cost_volume_bwd_nxt_cuda(dacc.bfloat16(), prv)


def _check_upconv(dev, dtype, shape, cout, seed):
    """One K5 launch against its plain version: float32 within 1e-5 of
    the magnitude, bf16 within two ulps (a one-ulp flip of the rounded
    sum moves the bias add's and Mish's roundings too)."""
    rng = np.random.RandomState(seed)
    x = _rand(rng, shape, dev, dtype)
    w = _rand(rng, (shape[-1], cout, 4, 4), dev, scale=(4 * shape[-1]) ** -0.5)
    b = _rand(rng, (cout,), dev, scale=0.1)
    kernels.reset_launch_counts()
    got = upconv_stage_cuda(x, w, b, dtype)
    want = upconv_stage_plain(x, w, b, dtype)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (shape[0], 2 * shape[1],
                                       2 * shape[2], cout)
    assert bool(torch.isfinite(got.float()).all())
    err = float((got.float() - want.float()).abs().max())
    ulps = 2 if dtype == torch.bfloat16 else 1
    assert err <= ulps * REL[dtype] * max(1.0,
                                          float(want.float().abs().max()))
    assert upconv_stage_cuda.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout", [((2, 13, 37, 128), 32),
                                        ((1, 9, 70, 20), 16)])
def test_upconv_stage_kernel(dev, dtype, shape, cout):
    """K5 against its plain version; Ci = 20 leaves a ragged channel
    chunk, W = 70 a ragged column tile."""
    _check_upconv(dev, dtype, shape, cout, seed=7)


@pytest.mark.cuda
@pytest.mark.parametrize("cout", [16, 32])
@pytest.mark.parametrize("cin", [16, 20, 64, 128])
def test_upconv_stage_kernel_bf16_widths(dev, cin, cout):
    """The bf16 tensor-core body at each input width: Ci = 20 is padded
    to two 16-channel steps with zeros and staged by element loads (no
    16-byte copies: Ci is no multiple of 8)."""
    _check_upconv(dev, torch.bfloat16, (2, 13, 37, cin), cout, seed=11)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout", [
    ((4, 64, 128, 128), 32),  # 512 tiles: more than the persistent grid
    ((8, 64, 128, 64), 16),   # holds, so each warp group walks several
    ((1, 32, 64, 128), 32),   # batch 1: fewer 4-phase tiles than SMs,
    ((1, 64, 128, 64), 16),   # so a block takes 2 phases
])
def test_upconv_stage_kernel_grid(dev, dtype, shape, cout):
    _check_upconv(dev, dtype, shape, cout, seed=12)


@pytest.mark.cuda
def test_upconv_trainable_grads_match_plain_autograd(dev):
    rng = np.random.RandomState(8)
    x = _rand(rng, (2, 11, 19, 64), dev)
    w = _rand(rng, (64, 16, 4, 4), dev, scale=1 / 16)
    b = _rand(rng, (16,), dev, scale=0.1)
    g = _rand(rng, (2, 22, 38, 16), dev)
    leaves = [t.clone().requires_grad_() for t in (x, w, b, x, w, b)]
    kernels.reset_launch_counts()
    upconv_stage_trainable(leaves[0], [tuple(leaves[1:3])],
                           torch.float32).backward(g)
    upconv_stage_plain(*leaves[3:], torch.float32).backward(g)
    assert upconv_stage_cuda.launches == 1
    for i in range(3):
        _assert_close(leaves[i].grad, leaves[i + 3].grad)


@pytest.mark.cuda
def test_interpolator_launches_each_kernel(dev):
    """One eval forward of the interpolator with the fused stem and
    upconv stages: 5 cost volumes (the 2B Flower pass), 2 stem stages,
    2 upconv stages; finite images of the input's size."""
    model = build_interpolator(0, dev, stem_stages=2, upconv_stages=2)
    rng = np.random.RandomState(9)
    ims = _rand(rng, (2, 64, 128, 6), dev, scale=0.3)
    kernels.reset_launch_counts()
    with torch.no_grad():
        img = model(ims)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["cost_volume_cuda"], counts["downconv_stage_cuda"],
            counts["upconv_stage_cuda"]) == (5, 2, 2), counts
    assert img.shape == (2, 64, 128, 3) and bool(torch.isfinite(img).all())


@pytest.mark.cuda
def test_upconv_wrapper_validates_inputs(dev):
    rng = np.random.RandomState(10)
    x = _rand(rng, (1, 8, 16, 24), dev)
    w = _rand(rng, (24, 16, 4, 4), dev)
    b = _rand(rng, (16,), dev)
    with pytest.raises(ValueError):
        upconv_stage_cuda(x, w[:, :8].contiguous(), b[:8].contiguous(),
                          torch.float32)
    with pytest.raises(ValueError):
        upconv_stage_cuda(x, w, b, torch.bfloat16)
    with pytest.raises(ValueError):
        upconv_stage_cuda(x.transpose(1, 2), w, b, torch.float32)
    with pytest.raises(ValueError):
        upconv_stage_cuda(x, w[:16].contiguous(), b, torch.float32)
    # more input channels than the bf16 body's shared memory holds
    wide = _rand(rng, (1, 4, 8, 160), dev, torch.bfloat16)
    with pytest.raises(ValueError):
        upconv_stage_cuda(wide, _rand(rng, (160, 32, 4, 4), dev),
                          _rand(rng, (32,), dev), torch.bfloat16)
