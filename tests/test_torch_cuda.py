"""The port's CUDA kernels against their plain PyTorch versions on a CUDA
card. Every test here is marked ``cuda`` and skips without a card.

This file imports neither jax nor the JAX package, so it also runs where
only PyTorch is installed (tests/conftest.py imports jax, hence
--noconftest). The card's whole suite, this file with the model and app
paths of tests/test_torch_cuda_models.py and tests/test_torch_cuda_apps.py
and the flow net's CUDA graph:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py \
        tests/test_torch_flow_graph.py -q

Each kernel is held at the models' own shapes (the 448x1024 b8 headline,
batch 1, the 256x512 b16 train step's levels, the H-sharded paths'
levels) and at small ones that are no multiple of its tiles. Tolerances:
float32 sums in another order, 1e-5 of the output magnitude; bf16
outputs, one bf16 ulp (2^-7) of it, four for the stem, where an early
rounding flip propagates, and two for the upconv stage, where it moves
the bias add's and Mish's roundings.
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
    cost_volume_plain_haloed,
)
from qpwcnet_torch.ops.cuda.cost_volume_kernel import (
    cost_volume_bwd_nxt_cuda,
    cost_volume_bwd_nxt_haloed_cuda,
    cost_volume_bwd_prv_cuda,
    cost_volume_bwd_prv_haloed_cuda,
    cost_volume_cuda,
    cost_volume_haloed_cuda,
)
from qpwcnet_torch.ops.cuda import _build, mish_kernel
from qpwcnet_torch.ops.cuda.conv_gemm import (
    downconv_stage_gemm_plain,
    upconv_stage_gemm_plain,
)
from qpwcnet_torch.ops.cuda.mish_kernel import (
    bias_mish_backward_plain,
    bias_mish_bwd_cuda,
    bias_mish_cuda,
    bias_mish_plain,
)
from qpwcnet_torch.ops.cuda.stem_kernel import (
    STEM_GEMM_CHANNELS,
    downconv_stage_cuda,
    downconv_stage_plain,
    downconv_stage_trainable,
)
from qpwcnet_torch.ops.cuda.upconv_kernel import (
    UPCONV_GEMM_CHANNELS,
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

# The flow headline (448x1024, batch 8) and the (h, w, C) of its five
# cost-volume levels, coarsest first
B, H, W = 8, 448, 1024
CV_LEVELS = [(14, 32, 256), (28, 64, 256), (56, 128, 128), (112, 256, 64),
             (224, 512, 32)]
# The flow train step (256x512, batch 16) and its levels
TRAIN_B, TRAIN_H, TRAIN_W = 16, 256, 512
TRAIN_LEVELS = [(8, 16, 256), (16, 32, 256), (32, 64, 128), (64, 128, 64),
                (128, 256, 32)]
# The H-sharded paths' kernel calls, (B, h, w, C): the headline's levels in
# 2 H shards folded into the batch, the train step's in 4
SPATIAL_N_FWD, SPATIAL_N_TRAIN = 2, 4
SPATIAL_LEVELS = ([(SPATIAL_N_FWD * B, h // SPATIAL_N_FWD, w, c)
                   for h, w, c in CV_LEVELS]
                  + [(SPATIAL_N_TRAIN * TRAIN_B, h // SPATIAL_N_TRAIN, w, c)
                     for h, w, c in TRAIN_LEVELS])
# K2, (B, H, W, Ci) -> Co: encoder stages 0 and 1 of the headline (2B =
# 16) and of batch 1, no tile multiple at Co 16 and 32, and stage 2 of the
# headline (Co 64: the implicit GEMM, as stages 3-4)
STEM_SHAPES = [((2 * B, H, W, 3), 16), ((2 * B, H // 2, W // 2, 16), 32),
               ((2, H, W, 3), 16), ((2, H // 2, W // 2, 16), 32),
               ((2, 70, 90, 3), 16), ((3, 38, 70, 16), 32),
               ((2 * B, H // 4, W // 4, 32), 64)]
# K2 at stage 2 of the train step (2B = 32), of batch 1 and no tile
# multiple; stages 3 and 4 at the headline, the train step, batch 1 and no
# tile multiple
STEM_WIDE_SHAPES = [
    ((2 * TRAIN_B, TRAIN_H // 4, TRAIN_W // 4, 32), 64),
    ((2, H // 4, W // 4, 32), 64), ((3, 38, 70, 32), 64),
    ((2 * B, H // 8, W // 8, 64), 128), ((2 * B, H // 16, W // 16, 128), 256),
    ((2 * TRAIN_B, TRAIN_H // 8, TRAIN_W // 8, 64), 128),
    ((2 * TRAIN_B, TRAIN_H // 16, TRAIN_W // 16, 128), 256),
    ((2, H // 8, W // 8, 64), 128), ((2, H // 16, W // 16, 128), 256),
    ((3, 26, 38, 64), 128), ((3, 14, 22, 128), 256)]
# K5, (B, H, W, Ci) -> Co: decoder stages 2 and 3 of the interpolator's
# pretraining step (2B = 16 at 256x512), of the headline, of batch 1, and
# no tile multiple
UPCONV_SHAPES = [((16, 32, 64, 128), 32), ((16, 64, 128, 64), 16),
                 ((16, 56, 128, 128), 32), ((16, 112, 256, 64), 16),
                 ((2, 32, 64, 128), 32), ((2, 64, 128, 64), 16),
                 ((3, 13, 37, 128), 32)]
# K5's wide stages 0 and 1 (the implicit GEMM): the pretraining step, the
# flow train step (2B = 32), the headline, batch 1, no tile multiple
UPCONV_WIDE_SHAPES = [((16, 8, 16, 256), 128), ((16, 16, 32, 256), 64),
                      ((32, 8, 16, 256), 128), ((32, 16, 32, 256), 64),
                      ((16, 14, 32, 256), 128), ((16, 28, 64, 256), 64),
                      ((2, 14, 32, 256), 128), ((2, 28, 64, 256), 64),
                      ((3, 7, 13, 256), 128), ((3, 9, 11, 256), 64)]
# bias + Mish, (B, C, H, W) channels_last: flower.l4's widest conv at the
# headline, encoder stage 1 of the train cell's step (2 x b32 frames at
# 384x768), and C % 8 != 0 (the element-wise body)
MISH_SHAPES = [(B, 128, H // 2, W // 2), (64, 16, 192, 384), (3, 20, 9, 11)]


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


def _assert_close(got, want, rel=None):
    """max|got - want| within ``rel`` (default: REL of want's dtype) of
    max(1, max|want|)."""
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float((got.float() - want.float()).abs().max())
    rel = REL[want.dtype] if rel is None else rel
    tol = rel * max(1.0, float(want.float().abs().max()))
    assert err <= tol, (err, tol)


def _sass_counts(lib_path, cuobjdump) -> dict:
    """HMMA (mma.sync), HGMMA (wgmma) and UTMALDG (TMA load) counts of
    each kernel in the built library's SASS, by mangled name."""
    import subprocess

    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    ops, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            ops[name] = dict(HMMA=0, HGMMA=0, UTMALDG=0)
        elif name:
            for op in ops[name]:
                ops[name][op] += op in line
    return ops


@pytest.mark.cuda
def test_sass_tensor_cores(dev):
    """Every bf16 mma.sync instantiation of K1, K2, K3, K4a/K4b and K5
    issues HMMA, their float32 bodies (CUDA-core FMAs) none; every bf16
    instantiation of the wide stages' GEMM (3 modes x 3 tiles) issues
    wgmma (HGMMA) fed by TMA loads (UTMALDG) and no HMMA, its float32 body
    none of the three; the old mma.sync GEMM is gone. cuobjdump ships
    beside nvcc, so its absence fails the test."""
    import re
    from pathlib import Path

    _build.library()
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    assert cuobjdump.exists(), f"{cuobjdump} not found"
    ops = _sass_counts(_build.build(), cuobjdump)
    found = {k: {} for k in ("K1", "K1 f32", "K3", "K3 f32", "K4", "K4 f32",
                             "K5", "K5 f32", "K2", "K2 f32", "gemm",
                             "gemm f32")}
    rules = (("K1", r"cost_volume_mma_kernelILi(\d+)ELi(\d+)E"),
             ("K1 f32", r"correlate_kernelIfLb0E()"),
             ("K3", r"warp_cv_mma_kernelILi(\d+)ELi(\d+)E"),
             ("K3 f32", r"correlate_kernelIfLb1E()"),
             ("K4", r"cv_bwd_mma_kernelILb([01])ELi(\d+)E"),
             ("K4 f32", r"cv_bwd_kernelI(\w+?)Lb([01])E"),
             ("K5", r"upconv_mma_kernelILi(\d+)ELi(\d+)E"),
             ("K5 f32", r"upconv_kernelILi(\d+)E"),
             ("K2", r"stem_mma_kernelILi(\d+)ELb([01])E"),
             ("K2 f32", r"stem_kernelILi(\d+)E"),
             ("gemm", r"conv_gemm_wgmma_kernelILi(\d)ELi(\d+)ELi(\d+)E"),
             ("gemm f32", r"conv_gemm_f32_kernelILi(\d)E"))
    for name, counts in ops.items():
        for key, pat in rules:
            m = re.search(pat, name)
            if m:
                found[key][m.groups()] = counts
    hmma = {k: {g: c["HMMA"] for g, c in v.items()} for k, v in found.items()}
    for key, n in (("K1", 3), ("K3", 3), ("K4", 6), ("K5", 4), ("K2", 4)):
        assert len(hmma[key]) == n and all(hmma[key].values()), (key, hmma)
    for key, n in (("K1 f32", 1), ("K3 f32", 1), ("K4 f32", 2)):
        assert len(hmma[key]) == n and not any(hmma[key].values()), (key,
                                                                      hmma)
    for key in ("K5 f32", "K2 f32"):
        assert hmma[key] and not any(hmma[key].values()), (key, hmma)
    assert sorted(found["K4 f32"]) == [("f", "0"), ("f", "1")], found
    assert len(found["gemm"]) == 9 and all(
        c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["HMMA"] == 0
        for c in found["gemm"].values()), found["gemm"]
    assert len(found["gemm f32"]) == 3 and not any(
        any(c.values()) for c in found["gemm f32"].values()), found
    old = [n for n in ops if "conv_gemm_mma_kernel" in n]
    assert not old, old


# torch.profiler loses the device records of short windows once a process
# has run much other card work (PERF.md §7), so the tests that read a
# call's device kernels run first, before the kernels' large shapes.


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
    assert kernels.launch_counts()["cost_volume_cuda"] == 1


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
    assert kernels.launch_counts()["warp_cost_volume_cuda"] == 1


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
    assert kernels.launch_counts()["downconv_stage_cuda"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout", [(64, 128), (32, 64)])
def test_downconv_stage_wide_launches(dev, dtype, cin, cout):
    """A wide stage (Co 64 too) is one wrapper launch: the weights'
    rounding into the GEMM's layout, then one GEMM a conv."""
    rng = np.random.RandomState(20)
    x = _rand(rng, (2, 16, 32, cin), dev, dtype, scale=0.5)
    params = _stem_params(rng, dev, cin, cout)
    downconv_stage_cuda(x, params, dtype)  # builds the library
    torch.cuda.synchronize()
    names = _device_kernels(lambda: downconv_stage_cuda(x, params, dtype))
    assert len(names) == 4, names
    assert "prep_w33" in names[0]
    assert all("conv_gemm" in n for n in names[1:]), names
    assert kernels.launch_counts()["downconv_stage_cuda"] == 1


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
        assert kernels.launch_counts()[kern.__name__] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upconv_stage_wide_launches(dev, dtype):
    """A wide stage: the weight's rounding into the GEMM's layout, then
    one GEMM for the four phases."""
    rng = np.random.RandomState(23)
    x = _rand(rng, (2, 8, 16, 256), dev, dtype)
    w = _rand(rng, (256, 128, 4, 4), dev, scale=1 / 32)
    b = _rand(rng, (128,), dev, scale=0.1)
    upconv_stage_cuda(x, w, b, dtype)
    torch.cuda.synchronize()
    names = _device_kernels(lambda: upconv_stage_cuda(x, w, b, dtype))
    assert len(names) == 2 and "prep_wt" in names[0], names
    assert "conv_gemm" in names[1], names
    assert kernels.launch_counts()["upconv_stage_cuda"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ci20", "offset"])
@pytest.mark.parametrize("cout", [64, 128])
def test_downconv_stage_wide_unaligned_input_is_copied(dev, case, cout):
    """The bf16 GEMM reads inputs of a multiple of 32 channels at a
    16-byte-aligned address; the wrapper gives it an aligned,
    channel-padded copy of any other (Ci 20; a view at a 2-element
    offset): visible device kernels (x's copy and, for Ci 20, conv_a's
    zero-padded weight) before the weights' rounding and the three
    GEMMs."""
    rng = np.random.RandomState(28)
    cin = 20 if case == "ci20" else 32
    x = _rand(rng, (2, 14, 22, cin), dev, torch.bfloat16, scale=0.5)
    if case == "offset":
        x = _misaligned(x)
    params = _stem_params(rng, dev, cin, cout)
    want = downconv_stage_plain(x, params, torch.bfloat16)
    got = downconv_stage_cuda(x, params, torch.bfloat16)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    assert err <= 4 * REL[torch.bfloat16] * max(
        1.0, float(want.float().abs().max()))
    names = _device_kernels(
        lambda: downconv_stage_cuda(x, params, torch.bfloat16))
    assert len(names) >= 5 and "prep_w33" in names[-4], names
    assert all("conv_gemm" in n for n in names[-3:]), names
    assert not any("prep" in n or "conv_gemm" in n for n in names[:-4])
    assert kernels.launch_counts()["downconv_stage_cuda"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ci20", "offset"])
def test_upconv_stage_wide_unaligned_input_is_copied(dev, case):
    """K5's wide stage likewise: x's aligned, channel-padded copy and the
    padded weight, then the weights' rounding and the GEMM."""
    rng = np.random.RandomState(29)
    cin = 20 if case == "ci20" else 256
    x = _rand(rng, (2, 7, 13, cin), dev, torch.bfloat16)
    if case == "offset":
        x = _misaligned(x)
    w = _rand(rng, (cin, 64, 4, 4), dev, scale=(4 * cin) ** -0.5)
    b = _rand(rng, (64,), dev, scale=0.1)
    want = upconv_stage_plain(x, w, b, torch.bfloat16)
    got = upconv_stage_cuda(x, w, b, torch.bfloat16)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2 * REL[torch.bfloat16] * max(
        1.0, float(want.float().abs().max()))
    names = _device_kernels(lambda: upconv_stage_cuda(x, w, b,
                                                      torch.bfloat16))
    assert len(names) >= 3, names
    assert "prep_wt" in names[-2] and "conv_gemm" in names[-1], names
    assert not any("prep" in n or "conv_gemm" in n for n in names[:-2])
    assert kernels.launch_counts()["upconv_stage_cuda"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 13, 37, 20),
    *((b, *lv) for b in (B, 1) for lv in CV_LEVELS),  # headline, batch 1
    *((TRAIN_B, *lv) for lv in TRAIN_LEVELS),          # the train step
    (3, 13, 37, 24), (1, 5, 7, 32),
])
def test_cost_volume_kernel(dev, dtype, shape):
    _check_cost_volume(dev, shape, dtype)


def _check_cost_volume(dev, shape, dtype=torch.bfloat16, seed=0):
    rng = np.random.RandomState(seed)
    prv = _rand(rng, shape, dev, dtype)
    nxt = _rand(rng, shape, dev, dtype)
    kernels.reset_launch_counts()
    _assert_close(cost_volume_cuda(prv, nxt), cost_volume_plain(prv, nxt))
    assert kernels.launch_counts()["cost_volume_cuda"] == 1


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


# Flows of std 2 clipped at 3.9 px, all inside the ±4 window, and of std
# 6, about half beyond it
INSIDE, BEYOND = (2.0, 3.9), (6.0, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,flow_std,clip", [
    ((2, 13, 37, 24), 4.0, None),
    ((B, 224, 512, 32), *INSIDE),   # the 'fast' forward's finest level
    ((B, 224, 512, 32), *BEYOND),
    ((1, 224, 512, 32), *BEYOND),   # batch 1
    ((2, 13, 37, 24), *BEYOND),     # C % 8 != 0: element-wise gather
    *((s, *f) for s in ((TRAIN_B, 128, 256, 32),  # the train step's level
                        (2, 13, 37, 20), (2, 24, 40, 64))  # C 64: 2 chunks
      for f in (INSIDE, BEYOND)),
])
def test_warp_cost_volume_kernel(dev, dtype, shape, flow_std, clip):
    rng = np.random.RandomState(1)
    prv = _rand(rng, shape, dev, dtype)
    nxt = _rand(rng, shape, dev, dtype)
    flow = _rand(rng, shape[:3] + (2,), dev, scale=flow_std)
    if clip is not None:
        flow = flow.clamp(-clip, clip)
    kernels.reset_launch_counts()
    _assert_close(warp_cost_volume_cuda(prv, nxt, flow),
                  warp_cost_volume_plain(prv, nxt, flow))
    assert kernels.launch_counts()["warp_cost_volume_cuda"] == 1


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
    assert kernels.launch_counts()["warp_cost_volume_cuda"] == 1


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
@pytest.mark.parametrize("shape,cout", [((2, 38, 70, 3), 16),
                                        ((2, 38, 70, 16), 32),
                                        *STEM_SHAPES])
def test_downconv_stage_kernel(dev, dtype, shape, cout):
    _check_stem(dev, dtype, shape, cout, seed=2)


def _stem_params(rng, dev, cin, cout):
    return [(_rand(rng, (cout, c, 3, 3), dev, scale=(9 * c) ** -0.5),
             _rand(rng, (cout,), dev, scale=0.1)) for c in (cin, cout, cout)]


def _check_stem(dev, dtype, shape, cout, seed):
    """One K2 launch against its plain version and, at the widths the
    implicit GEMM runs, against the GEMM's own decomposition in plain
    PyTorch (ops/cuda/conv_gemm.py): float32 within 1e-5 of the
    magnitude, bf16 within four ulps (a one-ulp flip in conv_a or conv_aa
    propagates through the later convs)."""
    rng = np.random.RandomState(seed)
    x = _rand(rng, shape, dev, dtype, scale=0.5)
    params = _stem_params(rng, dev, shape[-1], cout)
    kernels.reset_launch_counts()
    got = downconv_stage_cuda(x, params, dtype)
    assert kernels.launch_counts()["downconv_stage_cuda"] == 1
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, cout)
    wants = [downconv_stage_plain(x, params, dtype)]
    if cout in STEM_GEMM_CHANNELS[dtype]:
        wants.append(downconv_stage_gemm_plain(x, params, dtype))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    ulps = 4 if dtype == torch.bfloat16 else 1
    for want in wants:
        assert got.shape == want.shape
        err = float((got.float() - want.float()).abs().max())
        assert err <= ulps * REL[dtype] * max(
            1.0, float(want.float().abs().max())), err


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
    """bf16 at Co 64 (the GEMM, 64-channel tiles) with more 128-position
    tiles than the persistent grid's blocks, so each walks several."""
    _check_stem(dev, torch.bfloat16, (4, 128, 256, 32), 64, seed=15)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 30, 46, 32), (4, 128, 256, 32)])
def test_downconv_stage_kernel_bf16_co64_gemm(dev, shape):
    """bf16 at encoder stage 2 (Ci 32 -> Co 64) through the GEMM: 32-channel
    K steps in the 64-byte swizzle, 64-channel tiles."""
    _check_stem(dev, torch.bfloat16, shape, 64, seed=25)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout", [
    ((2, 20, 50, 64), 128),   # W/2 = 25: no multiple of the 16-column box
    ((1, 28, 64, 64), 128),   # batch 1
    ((1, 12, 20, 128), 256),  # fewer tiles than SMs: 64-row tiles
    ((2, 22, 34, 32), 64),    # Ci 32 with ragged rows and columns
])
def test_downconv_stage_kernel_bf16_tile_edges(dev, shape, cout):
    """The bf16 GEMM where its boxes run past the image: the stores of
    the positions outside it are masked, the reads there are zero."""
    _check_stem(dev, torch.bfloat16, shape, cout, seed=26)


@pytest.mark.cuda
def test_downconv_stage_raises_for_unbuilt_widths(dev):
    """Every encoder width is built in both dtypes; other widths, and a
    Ci above the fused bf16 tile's cap, raise."""
    rng = np.random.RandomState(17)
    kernels.reset_launch_counts()
    for dtype, cin, cout in ((torch.bfloat16, 64, 48),
                             (torch.float32, 32, 8),
                             (torch.bfloat16, 20, 32)):
        x = _rand(rng, (1, 8, 16, cin), dev, dtype)
        with pytest.raises(ValueError):
            downconv_stage_cuda(x, _stem_params(rng, dev, cin, cout), dtype)
    assert kernels.launch_counts()["downconv_stage_cuda"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout", [
    ((2, 26, 38, 64), 128),    # encoder stage 3, 64-row GEMM tiles
    ((2, 14, 22, 128), 256),   # stage 4: two 128-channel N tiles
    ((3, 18, 30, 64), 128),    # no tile multiple
    ((2, 14, 22, 20), 128),    # Ci 20: element loads, padded to 32
    ((12, 64, 128, 64), 128),  # 128-row tiles (they cover the SMs)
    ((16, 64, 64, 128), 256),
    *STEM_WIDE_SHAPES,
])
def test_downconv_stage_kernel_wide(dev, dtype, shape, cout):
    """The wide stages' implicit GEMM (one launch a conv) against the
    plain composition."""
    _check_stem(dev, dtype, shape, cout, seed=18)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 30, 46, 32), (4, 128, 256, 32)])
def test_downconv_stage_kernel_f32_co64(dev, shape):
    """float32 at encoder stage 2 (Co 64), the GEMM's CUDA-core body."""
    _check_stem(dev, torch.float32, shape, 64, seed=19)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(64, 128), (32, 64)])
def test_downconv_trainable_wide_grads_match_plain_autograd(dev, cin, cout):
    rng = np.random.RandomState(21)
    x = _rand(rng, (2, 12, 18, cin), dev, scale=0.5)
    params = _stem_params(rng, dev, cin, cout)
    g = _rand(rng, (2, 6, 9, cout), dev)
    leaves = [t.clone().requires_grad_()
              for t in [x, *(t for p in params for t in p)] * 2]
    n = len(leaves) // 2
    kernels.reset_launch_counts()
    downconv_stage_trainable(
        leaves[0], [(leaves[i], leaves[i + 1]) for i in range(1, n, 2)],
        torch.float32).backward(g)
    downconv_stage_plain(
        leaves[n], [(leaves[n + i], leaves[n + i + 1])
                    for i in range(1, n, 2)], torch.float32).backward(g)
    assert kernels.launch_counts()["downconv_stage_cuda"] == 1
    for i in range(n):
        _assert_close(leaves[i].grad, leaves[n + i].grad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 13, 37, 20), (1, 9, 21, 72),
    *((b, *lv) for b in (TRAIN_B, 1) for lv in TRAIN_LEVELS),
    (3, 13, 37, 24), (4, 24, 40, 256),
])
def test_cost_volume_bwd_kernels(dev, dtype, shape):
    """K4a and K4b against their plain versions at the train step's
    levels (b16 and b1) and odd shapes: C = 72 spans three channel groups
    of a block, the last one ragged; C % 8 != 0; C = 256 in split
    channel groups."""
    rng = np.random.RandomState(4)
    dacc = _rand(rng, shape[:3] + (81,), dev, dtype)
    prv = _rand(rng, shape, dev, dtype)
    nxt = _rand(rng, shape, dev, dtype)
    kernels.reset_launch_counts()
    _assert_close(cost_volume_bwd_prv_cuda(dacc, nxt),
                  cost_volume_bwd_prv_plain(dacc, nxt))
    _assert_close(cost_volume_bwd_nxt_cuda(dacc, prv),
                  cost_volume_bwd_nxt_plain(dacc, prv))
    assert kernels.launch_counts()["cost_volume_bwd_prv_cuda"] == 1
    assert kernels.launch_counts()["cost_volume_bwd_nxt_cuda"] == 1


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
    assert kernels.launch_counts()["cost_volume_bwd_prv_cuda"] == 1
    assert kernels.launch_counts()["cost_volume_bwd_nxt_cuda"] == 1


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
@pytest.mark.parametrize("shape", [(2, 11, 19, 24),
                                   (TRAIN_B, *TRAIN_LEVELS[-1])])
def test_cost_volume_function_grads_match_plain_autograd(dev, shape):
    """The Function (K1 forward, K4a + K4b backward) against autograd of
    the plain cost volume, float32, also at the train step's finest
    level. Where a correlation is within rounding of 0, K1 and the plain
    forward may round it to opposite signs and so take the other
    leaky-ReLU slope: the plain backward of that slope difference is
    added to autograd's gradient before the comparison."""
    rng = np.random.RandomState(5)
    prv, nxt = (_rand(rng, shape, dev) for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (prv, nxt, prv, nxt)]
    g = _rand(rng, shape[:3] + (81,), dev)
    kernels.reset_launch_counts()
    out_k = CostVolumeFunction.apply(leaves[0], leaves[1])
    out_k.backward(g)
    out_p = cost_volume_plain(leaves[2], leaves[3])
    out_p.backward(g)
    assert kernels.launch_counts() == {
        "cost_volume_cuda": 1, "downconv_stage_cuda": 0,
        "warp_cost_volume_cuda": 0, "cost_volume_bwd_prv_cuda": 1,
        "cost_volume_bwd_nxt_cuda": 1, "upconv_stage_cuda": 0,
        "cost_volume_haloed_cuda": 0, "cost_volume_bwd_prv_haloed_cuda": 0,
        "cost_volume_bwd_nxt_haloed_cuda": 0, "bias_mish_cuda": 0,
        "bias_mish_bwd_cuda": 0}
    with torch.no_grad():
        slope_k, slope_p = (torch.where(o > 0, 1.0, 0.1)
                            for o in (out_k, out_p))
        ddacc = (g * (slope_k - slope_p)).contiguous()
        want = (leaves[2].grad + cost_volume_bwd_prv_plain(ddacc, nxt),
                leaves[3].grad + cost_volume_bwd_nxt_plain(ddacc, prv))
    _assert_close(leaves[0].grad, want[0])
    _assert_close(leaves[1].grad, want[1])


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
    """One K5 launch against its plain version and, at the widths the
    implicit GEMM runs, against the GEMM's own decomposition: float32
    within 1e-5 of the magnitude, bf16 within two ulps (a one-ulp flip of
    the rounded sum moves the bias add's and Mish's roundings too)."""
    rng = np.random.RandomState(seed)
    x = _rand(rng, shape, dev, dtype)
    w = _rand(rng, (shape[-1], cout, 4, 4), dev, scale=(4 * shape[-1]) ** -0.5)
    b = _rand(rng, (cout,), dev, scale=0.1)
    kernels.reset_launch_counts()
    got = upconv_stage_cuda(x, w, b, dtype)
    assert kernels.launch_counts()["upconv_stage_cuda"] == 1
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], cout)
    wants = [upconv_stage_plain(x, w, b, dtype)]
    if cout in UPCONV_GEMM_CHANNELS:
        wants.append(upconv_stage_gemm_plain(x, w, b, dtype))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    ulps = 2 if dtype == torch.bfloat16 else 1
    for want in wants:
        assert got.shape == want.shape
        err = float((got.float() - want.float()).abs().max())
        assert err <= ulps * REL[dtype] * max(
            1.0, float(want.float().abs().max())), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout", [((2, 13, 37, 128), 32),
                                        ((1, 9, 70, 20), 16),
                                        *UPCONV_SHAPES])
def test_upconv_stage_kernel(dev, dtype, shape, cout):
    """K5 against its plain version at the decoder's stages 2-3; Ci = 20
    leaves a ragged channel chunk, W = 70 a ragged column tile."""
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout", [
    ((2, 7, 13, 256), 128),    # decoder stage 0, 64-row GEMM tiles
    ((2, 9, 11, 256), 64),     # stage 1, no tile multiple
    ((2, 7, 13, 20), 64),      # Ci 20: element loads, padded to 32
    ((16, 28, 64, 256), 64),   # 128-row tiles (they cover the SMs)
    ((16, 14, 32, 256), 128),
    *UPCONV_WIDE_SHAPES,
])
def test_upconv_stage_kernel_wide(dev, dtype, shape, cout):
    """The wide stages' implicit GEMM (one grid z a phase) against the
    plain composition."""
    _check_upconv(dev, dtype, shape, cout, seed=22)


@pytest.mark.cuda
@pytest.mark.parametrize("phase", [0, 1, 2, 3])
def test_upconv_stage_wide_phases(dev, phase):
    """Each of the four output phases (r, s) of the bf16 GEMM at a shape
    that is no tile multiple: the pixels (2i + r, 2j + s) against the
    plain version's, two ulps."""
    rng = np.random.RandomState(27)
    x = _rand(rng, (3, 9, 11, 256), dev, torch.bfloat16)
    w = _rand(rng, (256, 64, 4, 4), dev, scale=1 / 32)
    b = _rand(rng, (64,), dev, scale=0.1)
    r, s = phase >> 1, phase & 1
    got = upconv_stage_cuda(x, w, b, torch.bfloat16)[:, r::2, s::2]
    want = upconv_stage_plain(x, w, b, torch.bfloat16)[:, r::2, s::2]
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2 * REL[torch.bfloat16] * max(
        1.0, float(want.float().abs().max()))


def _misaligned(t):
    """t's values in a contiguous view 2 elements into a new buffer: a
    16-byte-unaligned address that TMA cannot read."""
    buf = torch.empty(t.numel() + 2, dtype=t.dtype, device=t.device)
    v = buf[2:].view(t.shape)
    v.copy_(t)
    assert v.data_ptr() % 16 != 0
    return v


@pytest.mark.cuda
def test_upconv_trainable_wide_grads_match_plain_autograd(dev):
    rng = np.random.RandomState(24)
    x = _rand(rng, (2, 5, 9, 256), dev)
    w = _rand(rng, (256, 64, 4, 4), dev, scale=1 / 32)
    b = _rand(rng, (64,), dev, scale=0.1)
    g = _rand(rng, (2, 10, 18, 64), dev)
    leaves = [t.clone().requires_grad_() for t in (x, w, b, x, w, b)]
    kernels.reset_launch_counts()
    upconv_stage_trainable(leaves[0], [tuple(leaves[1:3])],
                           torch.float32).backward(g)
    upconv_stage_plain(*leaves[3:], torch.float32).backward(g)
    assert kernels.launch_counts()["upconv_stage_cuda"] == 1
    for i in range(3):
        _assert_close(leaves[i].grad, leaves[i + 3].grad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fully_fused_flow_net_matches_plain(dev, dtype):
    """stem_stages=5, upconv_stages=4: every encoder and decoder stage
    through K2 and K5 (5 and 4 launches a forward), against the plain
    model (float32 within 1e-4 of the flow magnitude, bf16 within 5%).
    The flow heads are seeded, so that the flows are not 0: of_flow ~
    N(0, (10 / s)^2), s the level's diagonal (the 'diag' output scale),
    gives flows of 0.25 px on average and 1.5 px at most."""
    rng = np.random.RandomState(25)
    x = _rand(rng, (2, 64, 128, 6), dev, scale=0.3)
    flows = {}
    for name, kw in (("fused", dict(stem_stages=5, upconv_stages=4)),
                     ("plain", dict(cv_impl="plain"))):
        model = build_flow_net(0, dev, dtype=dtype, **kw)
        heads = np.random.RandomState(26)
        with torch.no_grad():
            for i, up in enumerate([model.flower.flow_0,
                                    *model.flower.upflows]):
                s = float(np.hypot(64 >> (5 - i), 128 >> (5 - i)))
                up.flow.of_flow.weight.copy_(_rand(
                    heads, up.flow.of_flow.weight.shape, dev, scale=10 / s))
        kernels.reset_launch_counts()
        with torch.no_grad():
            flows[name] = model(x)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        if name == "fused":
            assert (counts["downconv_stage_cuda"],
                    counts["upconv_stage_cuda"]) == (5, 4), counts
    got, want = flows["fused"], flows["plain"]
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float(want.abs().mean()) > 0.1
    rel = 1e-4 if dtype == torch.float32 else 5e-2
    err = float((got - want).abs().max())
    assert err <= rel * max(1.0, float(want.abs().max())), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 11, 19, 64), UPCONV_SHAPES[1][0]])
def test_upconv_trainable_grads_match_plain_autograd(dev, shape):
    """The trainable stage (K5 forward, the unfused composition's
    backward) against autograd of the plain version, float32, also at the
    pretraining step's decoder stage 3."""
    rng = np.random.RandomState(8)
    x = _rand(rng, shape, dev)
    w = _rand(rng, (64, 16, 4, 4), dev, scale=1 / 16)
    b = _rand(rng, (16,), dev, scale=0.1)
    g = _rand(rng, (shape[0], 2 * shape[1], 2 * shape[2], 16), dev)
    leaves = [t.clone().requires_grad_() for t in (x, w, b, x, w, b)]
    kernels.reset_launch_counts()
    upconv_stage_trainable(leaves[0], [tuple(leaves[1:3])],
                           torch.float32).backward(g)
    upconv_stage_plain(*leaves[3:], torch.float32).backward(g)
    assert kernels.launch_counts()["upconv_stage_cuda"] == 1
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


# ---- the haloed modes (the spatial H-sharded path's)

def _halo_shards(x, n, r=4):
    """The n H shards of x (B, H, W, C), each with r rows of its
    neighbours above and below (zeros at the ends), folded shard-minor
    into the batch: (B·n, H/n + 2r, W, C)."""
    b, h, w, c = x.shape
    pad = torch.nn.functional.pad(x, (0, 0, 0, 0, r, r))
    hl = h // n
    return torch.stack([pad[:, s * hl:s * hl + hl + 2 * r]
                        for s in range(n)], 1).flatten(0, 1).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 13, 37, 20), (1, 9, 21, 72),
                                   (3, 4, 19, 32), (2, 16, 40, 256),
                                   *SPATIAL_LEVELS, (3, 13, 37, 24)])
def test_haloed_kernels_match_plain(dev, dtype, shape):
    """K1, K4a and K4b in their haloed modes against the haloed plain
    versions at the H-sharded forward's and train step's levels and odd
    shapes: C % 8 != 0, three channel groups, fewer rows than r, and
    C = 256's split groups."""
    b, h, w, c = shape
    rng = np.random.RandomState(sum(shape))
    prv = _rand(rng, shape, dev, dtype)
    nxt_h = _rand(rng, (b, h + 8, w, c), dev, dtype)
    dacc = _rand(rng, (b, h, w, 81), dev, dtype)
    kernels.reset_launch_counts()
    _assert_close(cost_volume_haloed_cuda(prv, nxt_h),
                  cost_volume_plain_haloed(prv, nxt_h))
    _assert_close(cost_volume_bwd_prv_haloed_cuda(dacc, nxt_h),
                  cost_volume_bwd_prv_plain(dacc, nxt_h, True))
    _assert_close(cost_volume_bwd_nxt_haloed_cuda(dacc, prv),
                  cost_volume_bwd_nxt_plain(dacc, prv, True))
    counts = kernels.launch_counts()
    assert (counts["cost_volume_haloed_cuda"],
            counts["cost_volume_bwd_prv_haloed_cuda"],
            counts["cost_volume_bwd_nxt_haloed_cuda"],
            counts["cost_volume_cuda"]) == (1, 1, 1, 0), counts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("shape", [(2, 32, 40, 32), (B, *CV_LEVELS[-1])])
def test_haloed_shards_equal_the_whole(dev, dtype, n, shape):
    """Each shard's haloed K1, concatenated, is the unhaloed K1 on the
    whole map bit for bit (the same products in the same order); the
    shards' K4a outputs concatenated and their K4b outputs with the halo
    rows added back to their owners (float32 adds, as the exchange's
    backward sums them) equal the whole map's K4a / K4b; also at the
    headline's finest level."""
    rng = np.random.RandomState(n)
    (b, h, w, c), r = shape, 4
    prv = _rand(rng, (b, h, w, c), dev, dtype)
    nxt = _rand(rng, (b, h, w, c), dev, dtype)
    dacc = _rand(rng, (b, h, w, 81), dev, dtype)
    hl = h // n

    def fold(x):
        return x.reshape(b * n, hl, *x.shape[2:])

    def unfold(x):
        return x.reshape(b, n * x.shape[1], *x.shape[2:])

    got = unfold(cost_volume_haloed_cuda(fold(prv), _halo_shards(nxt, n)))
    assert torch.equal(got, cost_volume_cuda(prv, nxt))
    _assert_close(
        unfold(cost_volume_bwd_prv_haloed_cuda(fold(dacc),
                                               _halo_shards(nxt, n))),
        cost_volume_bwd_prv_cuda(dacc, nxt))
    parts = cost_volume_bwd_nxt_haloed_cuda(fold(dacc), fold(prv)).float()
    whole = torch.zeros((b, h + 2 * r, w, c), device=dev)
    parts = parts.unflatten(0, (b, n))
    for s in range(n):
        whole[:, s * hl:s * hl + hl + 2 * r] += parts[:, s]
    _assert_close(whole[:, r:-r], cost_volume_bwd_nxt_cuda(dacc, prv).float(),
                  REL[dtype])


@pytest.mark.cuda
def test_haloed_cost_volume_function_grads(dev):
    rng = np.random.RandomState(6)
    prv = _rand(rng, (2, 11, 19, 24), dev)
    nxt_h = _rand(rng, (2, 19, 19, 24), dev)
    g = _rand(rng, (2, 11, 19, 81), dev)
    leaves = [t.clone().requires_grad_() for t in (prv, nxt_h, prv, nxt_h)]
    CostVolumeFunction.apply(leaves[0], leaves[1], 4, True).backward(g)
    cost_volume_plain_haloed(leaves[2], leaves[3]).backward(g)
    _assert_close(leaves[0].grad, leaves[2].grad)
    _assert_close(leaves[1].grad, leaves[3].grad)


@pytest.mark.cuda
def test_haloed_wrappers_validate_shapes(dev):
    rng = np.random.RandomState(7)
    prv = _rand(rng, (1, 8, 16, 16), dev)
    dacc = _rand(rng, (1, 8, 16, 81), dev)
    with pytest.raises(ValueError):
        cost_volume_haloed_cuda(prv, prv)
    with pytest.raises(ValueError):
        cost_volume_bwd_prv_haloed_cuda(dacc, prv)
    with pytest.raises(ValueError):
        cost_volume_bwd_nxt_haloed_cuda(dacc, prv[:, :7].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense_s1", "dense_s2", "conv_a",
                                  "pointwise_co2", "pointwise_co3",
                                  "depthwise", "transpose"])
def test_int8_conv_card_equals_cpu(dev, kind):
    """The int8 convs' int32 accumulation on the card (im2col through
    torch._int_mm, K and N padded to multiples of 8; the depthwise's
    shifted int32 multiply-adds) equals the CPU's int32 product exactly,
    at full-range codes: the RGB conv_a (K = 27), the 2- and 3-channel
    outputs of of_flow and conv2, and batch 1 at a map of 3x5 (M = 15
    rows, padded to 17)."""
    from qpwcnet_torch.quantize.int8 import int8_conv_int32

    kh, stride, groups, transpose, ci, co, shape = {
        "dense_s1": (3, 1, 1, False, 24, 20, (2, 10, 14)),
        "dense_s2": (3, 2, 1, False, 16, 32, (2, 11, 14)),
        "conv_a": (3, 2, 1, False, 3, 16, (2, 32, 64)),
        "pointwise_co2": (3, 1, 1, False, 16, 2, (1, 3, 5)),
        "pointwise_co3": (1, 1, 1, False, 64, 3, (2, 9, 13)),
        "depthwise": (3, 1, 40, False, 40, 40, (2, 9, 13)),
        "transpose": (4, 2, 1, True, 48, 16, (2, 5, 7))}[kind]
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(-128, 128, (*shape, ci)).astype(np.int8))
    k = torch.from_numpy(rng.randint(
        -128, 128, (kh, kh, ci // groups, co)).astype(np.int8))
    want = int8_conv_int32(x, k, stride, groups, transpose)
    got = int8_conv_int32(x.to(dev), k.to(dev), stride, groups, transpose)
    assert got.dtype == torch.int32 and got.is_cuda
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 5, 15, 16, 17, 24, 31, 33, 100, 4097])
def test_int8_matmul_card_equals_cpu(dev, m):
    """int8_matmul (torch._int_mm, M, K and N padded, the kernel matrix
    column-major) at the row counts of small maps, at counts that are no
    multiple of 32 (which cuBLASLt's row-major int8 GEMM refuses) and at
    inner / output dims that are no multiple of 8 (the RGB conv_a's K 27,
    of_flow's N 2, conv2's N 3) equals the CPU's int32 product
    exactly."""
    from qpwcnet_torch.quantize.int8 import int8_matmul

    rng = np.random.RandomState(m)
    for k, n in ((27, 16), (64, 32), (144, 2), (576, 3), (1024, 128)):
        a = torch.from_numpy(rng.randint(-128, 128, (m, k)).astype(np.int8))
        b = torch.from_numpy(rng.randint(-128, 128, (k, n)).astype(np.int8))
        got = int8_matmul(a.to(dev), b.to(dev))
        assert tuple(got.shape) == (m, n) and got.dtype == torch.int32
        assert torch.equal(got.cpu(), int8_matmul(a, b)), (m, k, n)


@pytest.mark.cuda
def test_int8_model_card_matches_cpu(dev):
    """The int8 flow net ('unit' heads, non-zero flows; QAT ranges from
    two train-mode CPU forwards) on the card against the same model on
    the CPU, float32: the int8
    products are exact, so the flows agree to float32 rounding of the
    float ops around them, with a few codes flipped (1e-3 of the flow
    magnitude, relative L2)."""
    import dataclasses

    from qpwcnet_torch.quantize import QuantConfig

    torch.manual_seed(0)
    qat = build_flow_net(0, "cpu", head_scale="unit",
                         quant=QuantConfig()).train()
    x = torch.rand(2, 64, 128, 6) - 0.5
    with torch.no_grad():
        for _ in range(2):
            qat(x)
    int8 = dataclasses.replace(QuantConfig(), mode="int8")
    cpu = build_flow_net(0, "cpu", head_scale="unit", quant=int8)
    cpu.load_state_dict(qat.state_dict())
    card = build_flow_net(0, dev, head_scale="unit", quant=int8)
    card.load_state_dict(qat.state_dict())
    with torch.no_grad():
        want = cpu(x)
        got = card(x.to(dev)).cpu()
    assert float(want.abs().mean()) > 0.0
    assert float((got - want).norm()) <= 1e-3 * float(want.norm())


@pytest.mark.cuda
def test_kernel_ops_export_count_and_flops(dev, tmp_path):
    """K1 and K3 as the custom ops qpwcnet::cost_volume and
    qpwcnet::warp_cost_volume: a module calling both exports with
    torch.export (each op once in the graph), the loaded program runs the
    kernels (their launch counts move) bit-equal to the eager call, and
    cost_analysis counts each op's registered flops (2·81·C a pixel)."""
    from qpwcnet_torch.utils.profiling import cost_analysis

    rng = np.random.RandomState(0)
    prv = _rand(rng, (2, 9, 21, 24), dev, torch.bfloat16)
    nxt = _rand(rng, (2, 9, 21, 24), dev, torch.bfloat16)
    flow = _rand(rng, (2, 9, 21, 2), dev, scale=3.0)

    class Both(torch.nn.Module):
        def forward(self, p, n, f):
            return cost_volume_cuda(p, n) + warp_cost_volume_cuda(p, n, f)

    want = Both()(prv, nxt, flow)
    exported = torch.export.export(Both(), (prv, nxt, flow))
    targets = [str(n.target) for n in exported.graph.nodes
               if n.op == "call_function"]
    assert sum(t.startswith("qpwcnet.cost_volume.") for t in targets) == 1
    assert sum(t.startswith("qpwcnet.warp_cost_volume.")
               for t in targets) == 1
    torch.export.save(exported, str(tmp_path / "both.pt2"))
    prog = torch.export.load(str(tmp_path / "both.pt2")).module()
    kernels.reset_launch_counts()
    got = prog(prv, nxt, flow)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["cost_volume_cuda"] == counts["warp_cost_volume_cuda"] == 1
    assert torch.equal(got, want)
    flops = cost_analysis(Both(), prv, nxt, flow)["flops"]
    assert flops == 2 * (2 * 81 * 24 * 2 * 9 * 21)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_int8_sharded_forward_card(dev, n):
    """The int8 flow net in n local H shards on the card (its convs
    exchanging int8 halo rows, K1's haloed mode) against the unsharded
    int8 model on the card, float32: 1e-5 of the flow magnitude."""
    import dataclasses

    from qpwcnet_torch.parallel import (
        SpatialConfig,
        make_mesh,
        make_spatial_forward,
        shard_batch_spatial,
        unshard_batch_spatial,
    )
    from qpwcnet_torch.quantize import QuantConfig

    qat = build_flow_net(0, dev, head_scale="unit", residual=True,
                         quant=QuantConfig()).train()
    x = (torch.rand(2, 128, 64, 6, generator=torch.Generator().manual_seed(
        n)) - 0.5).to(dev)
    with torch.no_grad():
        qat(x)
    int8 = dataclasses.replace(QuantConfig(), mode="int8")
    ranges = {k: v for k, v in qat.state_dict().items() if "amax" in k}
    mesh = make_mesh(n_data=1, n_model=n)
    ref = build_flow_net(0, dev, head_scale="unit", residual=True,
                         quant=int8)
    sp = build_flow_net(0, dev, head_scale="unit", residual=True,
                        quant=int8, spatial=SpatialConfig(mesh, warp_halo=8))
    for m in (ref, sp):
        m.load_state_dict(ranges, strict=False)
    fwd = make_spatial_forward(lambda m, ims: m(ims), mesh)
    with torch.no_grad():
        want = ref(x)
        kernels.reset_launch_counts()
        got = unshard_batch_spatial(fwd(sp, shard_batch_spatial(x, mesh)),
                                    mesh)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["cost_volume_haloed_cuda"] > 0
    assert float(want.abs().max()) > 0.0
    err = float((got - want).abs().max())
    assert err <= 1e-5 * max(1.0, float(want.abs().max())), err


# ------------------------------------------------ bias + Mish (bias_mish.cu)

def _mish_input(rng, shape, dev, dtype, specials=True):
    """A channels_last (B, C, H, W) input: normal values of scale 6, and
    values across [-30, 30] in every eighth element; with ``specials`` the
    first elements hold 20, 20 +- an ulp, -87, NaN, -inf and +inf."""
    v = 6.0 * rng.standard_normal(shape)
    v.flat[::8] = rng.uniform(-30, 30, v.flat[::8].shape)
    if specials:
        v.flat[:7] = [20.0, np.nextafter(np.float32(20), 30),
                      np.nextafter(np.float32(20), 0), -87.0, np.nan,
                      -np.inf, np.inf]
    x = torch.from_numpy(v.astype(np.float32)).to(dev, dtype)
    return x.contiguous(memory_format=torch.channels_last)


def _same_bits(got, want):
    """Equal element for element, NaN where the other is NaN (the card's
    NaN need not carry PyTorch's payload)."""
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", [
    (torch.bfloat16, (8, 128, 224, 512)),   # flower.l4's widest conv, b8
    (torch.bfloat16, (64, 16, 192, 384)),   # encoder stage 1, train b32
    (torch.float32, (8, 32, 224, 512)),
    (torch.bfloat16, (2, 20, 9, 11)),       # C % 8 != 0: one at a time
    (torch.float32, (3, 6, 5, 7)),
    (torch.bfloat16, (1, 256, 7, 16)),
    (torch.float32, MISH_SHAPES[0]), (torch.float32, MISH_SHAPES[1]),
    (torch.bfloat16, MISH_SHAPES[2]), (torch.float32, MISH_SHAPES[2]),
])
def test_bias_mish_forward_is_the_composition(dev, dtype, shape):
    """The forward kernel equals bias add + mish bit for bit, with and
    without a bias, at the cells' shapes and ragged ones."""
    rng = np.random.RandomState(shape[1])
    x = _mish_input(rng, shape, dev, dtype)
    bias = _rand(rng, (shape[1],), dev, scale=2.0)
    kernels.reset_launch_counts()
    for b in (bias, None):
        _same_bits(bias_mish_cuda(x, b), bias_mish_plain(x, b))
    assert kernels.launch_counts()["bias_mish_cuda"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_mish_unaligned_view(dev, dtype):
    """A channels_last view at an odd element offset takes the
    element-wise body, with the same bits."""
    rng = np.random.RandomState(4)
    base = _mish_input(rng, (1, 2 * 4 * 6 * 32 + 1, 1, 1), dev, dtype,
                       specials=False).flatten()
    x = base[1:].view(2, 4, 6, 32).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    assert x.data_ptr() % 16
    bias = _rand(rng, (32,), dev)
    _same_bits(bias_mish_cuda(x, bias), bias_mish_plain(x, bias))
    g = _rand(rng, x.shape, dev, dtype).contiguous(
        memory_format=torch.channels_last)
    dx, db = bias_mish_bwd_cuda(x, bias, g)
    want = mish_kernel.bias_mish_backward_plain(x.cpu(), bias.cpu(), g.cpu())
    _assert_close(dx.cpu(), want[0])
    assert torch.allclose(db.cpu(), want[1], rtol=1e-5, atol=1e-5)


def _grads64(x, bias, g):
    """dx and dbias of mish(x + bias rounded to x's dtype) in float64."""
    y = (x.double() + bias.to(x.dtype).double()[:, None, None]
         ).requires_grad_()
    (y * torch.tanh(torch.nn.functional.softplus(y))).backward(g.double())
    return y.grad, y.grad.sum((0, 2, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 32, 24, 40), (2, 128, 28, 64),
                                   (3, 20, 9, 11)])
def test_bias_mish_backward_no_worse_than_composition(dev, dtype, shape):
    """The backward kernels' dx and dbias against float64 autograd of the
    composition: max and mean errors no larger than those of the
    composition's own autograd in the same dtype."""
    rng = np.random.RandomState(shape[1] + 1)
    x = _mish_input(rng, shape, dev, dtype, specials=False)
    bias = _rand(rng, (shape[1],), dev, scale=2.0)
    g = _rand(rng, shape, dev, dtype).contiguous(
        memory_format=torch.channels_last)
    dx, db = bias_mish_bwd_cuda(x, bias, g)
    xl, bl = x.clone().requires_grad_(), bias.clone().requires_grad_()
    bias_mish_plain(xl, bl).backward(g)
    dx64, db64 = _grads64(x, bias, g)
    for got, comp, want in ((dx, xl.grad, dx64), (db, bl.grad, db64)):
        e_k = (got.double() - want).abs()
        e_c = (comp.double() - want).abs()
        assert float(e_k.max()) <= float(e_c.max()), (e_k.max(), e_c.max())
        assert float(e_k.mean()) <= float(e_c.mean()), (e_k.mean(),
                                                         e_c.mean())
    # the trainable entry runs the same kernels
    xk, bk = x.clone().requires_grad_(), bias.clone().requires_grad_()
    kernels.reset_launch_counts()
    bias_mish_cuda(xk, bk).backward(g)
    assert kernels.launch_counts()["bias_mish_bwd_cuda"] == 1
    assert torch.equal(xk.grad, dx) and torch.equal(bk.grad, db)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 64, 112, 256), *MISH_SHAPES])
def test_bias_mish_dbias_repeats(dev, dtype, shape):
    """The backward against its plain statement (bias_mish_backward_plain,
    the same float32 operations): dx bit for bit in float32 and within one
    bf16 ulp of the magnitude in bf16, dbias within 1e-5 (another
    summation order); and dbias (and dx) repeat bit for bit: the block
    sums' order depends on the shape alone."""
    rng = np.random.RandomState(9)
    x = _mish_input(rng, shape, dev, dtype, specials=False)
    bias = _rand(rng, (shape[1],), dev)
    g = _rand(rng, shape, dev, dtype).contiguous(
        memory_format=torch.channels_last)
    first = bias_mish_bwd_cuda(x, bias, g)
    want = bias_mish_backward_plain(x, bias, g)
    _assert_close(first[0], want[0], 0.0 if dtype == torch.float32 else None)
    _assert_close(first[1], want[1], 1e-5)
    for _ in range(2):
        again = bias_mish_bwd_cuda(x, bias, g)
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])


@pytest.mark.cuda
def test_bias_mish_copies_and_validates(dev):
    """A card tensor in another layout is copied to channels_last first,
    with the composition's bits and gradients; other dtypes, widths and
    biases raise."""
    rng = np.random.RandomState(2)
    x = _rand(rng, (2, 16, 5, 7), dev)             # NCHW-contiguous
    bias = _rand(rng, (16,), dev)
    g = _rand(rng, x.shape, dev)
    kernels.reset_launch_counts()
    xl = x.clone().requires_grad_()
    y = bias_mish_cuda(xl, bias)
    _same_bits(y, bias_mish_plain(x, bias))
    y.backward(g)
    _assert_close(xl.grad, bias_mish_bwd_cuda(
        x.contiguous(memory_format=torch.channels_last), bias, g)[0])
    counts = kernels.launch_counts()
    assert (counts["bias_mish_cuda"], counts["bias_mish_bwd_cuda"]) == (1, 2)
    for t, b in ((x.double(), bias.double()), (x.half(), bias.half()),
                 (x, bias[:8]), (x[:, :0], bias[:0]),
                 (_rand(rng, (1, 1025, 2, 2), dev), _rand(rng, (1025,),
                                                          dev))):
        with pytest.raises(ValueError):
            bias_mish_cuda(t, b)
    with pytest.raises(ValueError):
        bias_mish_bwd_cuda(x, bias, g.bfloat16())


@pytest.mark.cuda
def test_bias_mish_exported_program_launches_the_kernel(dev, tmp_path):
    """torch.export of a Mish conv keeps the epilogue as the op
    qpwcnet::bias_mish, and the saved and loaded program runs the kernel
    with the eager forward's bits."""
    from qpwcnet_torch.ops import mish
    from qpwcnet_torch.quantize import QConv

    torch.manual_seed(5)
    m = QConv(16, 32, 3, act=mish, dtype=torch.bfloat16).to(dev)
    x = torch.randn(2, 16, 12, 20, device=dev).contiguous(
        memory_format=torch.channels_last)
    path = tmp_path / "conv.pt2"
    torch.export.save(torch.export.export(m, (x,)), str(path))
    prog = torch.export.load(str(path))
    ops = [str(n.target) for n in prog.graph.nodes if n.op == "call_function"]
    assert ops.count("qpwcnet.bias_mish.default") == 1, ops
    kernels.reset_launch_counts()
    with torch.no_grad():
        got, want = prog.module()(x), m(x)
    _same_bits(got, want)
    assert kernels.launch_counts()["bias_mish_cuda"] == 2


@pytest.fixture
def composition(monkeypatch):
    """Every caller of the epilogue runs the composition instead."""
    def use():
        monkeypatch.setattr(mish_kernel, "bias_mish_cuda", bias_mish_plain)
    return use


def _flow_train_grads(dev, dtype, seed=7):
    """One flow train step (learning rate 0) of the stem_stages=2 model at
    64x128 b2: the loss, the gradients and the launch counts."""
    from qpwcnet_torch.data import preprocess_flow_batch, synthetic_flow_batch
    from qpwcnet_torch.train import make_flow_train_step, plain_optimizer

    model = build_flow_net(0, dev, dtype=dtype, stem_stages=2,
                           head_scale="unit").train()
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = preprocess_flow_batch(*synthetic_flow_batch(gen, 2, 64, 128),
                                  out_hw=(64, 128))
    kernels.reset_launch_counts()
    make_flow_train_step()(model, plain_optimizer(model, 0.0), batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    grads = torch.cat([p.grad.flatten().double()
                       for p in model.parameters()])
    return grads, counts


@pytest.mark.cuda
def test_bias_mish_launches_in_the_flow_net(dev):
    """stem_stages=2: a flow forward launches the forward kernel 38 times
    (25 flower convs, 4 decoder UpConvs, 9 encoder convs of stages 2-4),
    a train step 44 forward and 44 backward (K2's recomputed stages 0-1
    add 6)."""
    model = build_flow_net(0, dev, dtype=torch.bfloat16, stem_stages=2)
    x = _rand(np.random.RandomState(1), (2, 64, 128, 6), dev, scale=0.3)
    kernels.reset_launch_counts()
    with torch.no_grad():
        model(x)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["bias_mish_cuda"], counts["bias_mish_bwd_cuda"]) == \
        (38, 0), counts
    _, counts = _flow_train_grads(dev, torch.bfloat16)
    assert (counts["bias_mish_cuda"], counts["bias_mish_bwd_cuda"]) == \
        (44, 44), counts


@pytest.mark.cuda
def test_bias_mish_train_step_grads_match_composition(dev, composition):
    """One train step's gradients with the kernels against the
    composition's, as the train-step checks of test_torch_cuda_models.py
    bound them: float32 within 1e-4 (relative, all leaves together); in
    bf16 the kernels' distance from the composition's float32 gradients
    at most twice the composition's own bf16 distance."""
    got = {dt: _flow_train_grads(dev, dt)[0]
           for dt in (torch.float32, torch.bfloat16)}
    composition()
    want = {dt: _flow_train_grads(dev, dt)
            for dt in (torch.float32, torch.bfloat16)}
    assert want[torch.float32][1]["bias_mish_cuda"] == 0
    w32 = want[torch.float32][0]
    assert float(w32.abs().max()) > 0
    assert float((got[torch.float32] - w32).norm()) <= 1e-4 * float(
        w32.norm())
    noise = float((want[torch.bfloat16][0] - w32).norm())
    assert float((got[torch.bfloat16] - w32).norm()) <= 2.0 * noise
