#!/usr/bin/env python3
"""Drive the PyTorch port's flow-inference, flow-training and
frame-interpolation paths on one CUDA card.

    python3 chip_smoke.py          # from the root of a repository checkout

Phases (any failure exits non-zero; nothing is caught and carried on):
  1. device: the card's name and power limit; TF32 off.
  2. build: nvcc-builds qpwcnet_torch/csrc/*.cu (sm_90a, one nvcc per
     source, all at once) and loads the library; K1's, K2's, K3's, K4a's,
     K4b's and K5's bf16 kernels must issue tensor-core instructions (HMMA
     in cuobjdump's SASS), every instantiation, and K1's, K3's, K4a's and
     K4b's float32 bodies none.
  3. kernel equality: each CUDA kernel against its plain PyTorch version
     at the headline shapes (448x1024 input, batch 8, so 2B = 16 through
     the encoder), at batch 1 (the infer app's) and at one shape that is
     no tile multiple, in float32 and bf16 (K1 also at the five levels of
     the training configuration, at C = 20 and on a map smaller than one
     tile; K3 also at the train step's level, at C = 20 and at C = 64,
     two chunks, each with flows inside the ±4 window and beyond it; K2
     also at a ragged Co 32 shape, and in bf16 at encoder stage 2's Co
     64, which float32 must refuse); the cost-volume backward
     kernels K4a and K4b at the five cost-volume levels of the training
     configuration (256x512, batch 16), at batch 1, at odd shapes (C % 8
     != 0 and W no multiple of 16; C = 256 in split channel groups), and
     the trainable cost volume's gradients against autograd of the plain
     cost volume at the finest training level.
  3c. K5, the fused decoder UpConv stage, against its plain version at the
     decoder's stages 2 and 3 of the interpolator's training step, of the
     flow headline and of batch 1, and at an odd shape, float32 and bf16;
     the trainable K5's gradients against autograd of the plain version.
  4. slice: PWCFlowNet at 448x1024 b8 with seeded, non-zero flow heads,
     exact and 'fast', against the plain model (stem_stages=0,
     cv_impl='plain') in bf16 and float32, with each kernel's launch
     count per forward and the device kernels of one bf16 forward, with
     K1's, K2's and K3's device time (torch.profiler); the float32 model on
     the card against the same model on the CPU at a small shape; then
     the infer app (qpwcnet_torch.apps.infer, --fast, 2 requests at
     448x1024) as the first main path.
  4b. train slice at 256x512 b16 (the JAX bench's training
     configuration): one train step of the exact, 'fast' and plain models
     (seeded flow heads, and a fresh 'diag' model whose flows are zero),
     every parameter's gradient against the plain model's in float32 and
     bf16, each kernel's launch count per step, the plain bf16 step
     repeated with bit-equal gradients (phases 4b and 4c run with
     cudnn.deterministic), the loss falling over 5 steps on a fixed batch;
     then the train app
     (qpwcnet_torch.apps.train_flow, synthetic data, 4 steps) as the
     second main path.
  4c. interpolator slice at 256x512 b8 (the JAX bench's pretraining
     configuration), stem_stages=2, upconv_stages=2: the eval forward
     (images and both directions' flows) against the plain interpolator
     in bf16 and float32, one pretraining step's every gradient against
     the plain model's, the launches per forward (K1 5, K2 2, K5 2) and
     per step (also K4a 5, K4b 5), the loss falling over 5 steps; one
     bf16 PWCFlowNet forward with upconv_stages=2 at 448x1024 b8 against
     the plain flow model; then three main paths: the library entry
     points (build_interpolator + make_interp_train_step, 2 steps and an
     eval forward), the pretrain_interp app (4 steps) and the
     interp_infer app (2 synthetic triplets).
  5. times: CUDA events after warm-up, median of N: each kernel against
     its plain version at the headline shapes (K4a and K4b at the training
     levels, K5 at its six shapes, with its achieved GB/s), beside its
     bound and, for K2 and K5, the cuDNN call computing the same product
     (K1, K2, K3, K4a, K4b and K5 also chained, with their achieved GB/s;
     K1, K3, K4a and K4b also their device time by torch.profiler, since
     the host's time per call exceeds the coarse levels' card time); the
     flow
     forward, the flow train step, the interpolator forward and the
     pretraining step; K5's in-model effect (upconv_stages 0 beside 2:
     the interpolator's forward and pretraining step, the exact flow
     forward) and K2's (stem_stages 0 beside 2: the exact flow forward).

The line before the card line is a JSON object with one entry per kernel:
its launches summed over the main paths' runs (each run with the counts
set to 0 just before it and read just after; each path's count is also
listed), its largest error in phase 3/3c, and its kernel, plain, bound
and library times summed over the shapes timed for it (K5: the
interpolator's two training shapes); the last line is {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
B, H, W = 8, 448, 1024
SEED = 0
REL_F32 = 1e-5       # float32: sums in another order than the plain version
REL_BF16 = 2.0 ** -7  # bf16 outputs: one bf16 ulp (2^-7) of the magnitude
N_TIMED = 10

# (h, w, C) of the five cost-volume levels at 448x1024, coarsest first
CV_LEVELS = [(14, 32, 256), (28, 64, 256), (56, 128, 128), (112, 256, 64),
             (224, 512, 32)]
# The training configuration (bench.py's train step) and its levels
TRAIN_B, TRAIN_H, TRAIN_W = 16, 256, 512
TRAIN_LEVELS = [(8, 16, 256), (16, 32, 256), (32, 64, 128), (64, 128, 64),
                (128, 256, 32)]
# Flow-head scale of the train slice: train-mode BatchNorm normalizes the
# head features up, so flows of ~1 px take a smaller k than eval mode's.
TRAIN_K = 0.2
N_STEPS_TIMED = 5
# bf16 gradients of the kernel models against the plain model's, as a
# multiple of the plain model's own bf16-against-float32 error
BF16_GRAD_FACTOR = 2.0
TRAIN_MODES = (("exact", dict(cv_impl="auto", stem_stages=2)),
               ("fast", dict(cv_impl="fast", stem_stages=2)),
               ("plain", dict(cv_impl="plain", stem_stages=0)))

KERNELS = {
    "cost_volume": dict(
        source="qpwcnet_torch/csrc/cost_volume.cu",
        replaces="qpwcnet_tpu/ops/pallas/cost_volume_kernel.py:79"),
    "downconv_stage": dict(
        source="qpwcnet_torch/csrc/stem.cu",
        replaces="qpwcnet_tpu/ops/pallas/stem_kernel.py:115"),
    "warp_cost_volume": dict(
        source="qpwcnet_torch/csrc/warp_cv.cu",
        replaces="qpwcnet_tpu/ops/pallas/warp_cv_kernel.py:57"),
    "cost_volume_bwd_prv": dict(
        source="qpwcnet_torch/csrc/cost_volume_bwd.cu",
        replaces="qpwcnet_tpu/ops/pallas/cost_volume_kernel.py:264"),
    "cost_volume_bwd_nxt": dict(
        source="qpwcnet_torch/csrc/cost_volume_bwd.cu",
        replaces="qpwcnet_tpu/ops/pallas/cost_volume_kernel.py:293"),
    "upconv_stage": dict(
        source="qpwcnet_torch/csrc/upconv.cu",
        replaces="qpwcnet_tpu/ops/pallas/upconv_kernel.py:61"),
}
# The interpolator slice: the JAX bench's pretraining configuration
# (bench.py:205-223), and the kernel model's options on it
INTERP_B = 8
INTERP_KW = dict(cv_impl="auto", stem_stages=2, upconv_stages=2)
PLAIN_KW = dict(cv_impl="plain", stem_stages=0, upconv_stages=0)
# K5's shapes, (B, H, W, Ci) -> Co: decoder stages 2 and 3 of the
# interpolator's training step (2B = 16 at 256x512), of the flow
# headline (2B = 16 at 448x1024), at batch 1 (256x512), and one shape
# that is no tile multiple
UPCONV_SHAPES = [((16, 32, 64, 128), 32), ((16, 64, 128, 64), 16),
                 ((16, 56, 128, 128), 32), ((16, 112, 256, 64), 16),
                 ((2, 32, 64, 128), 32), ((2, 64, 128, 64), 16),
                 ((3, 13, 37, 128), 32)]
# K2's shapes, (B, H, W, Ci) -> Co: encoder stages 0 and 1 of the flow
# headline (2B = 16 at 448x1024) and of batch 1, one shape that is no
# tile multiple at each of Co 16 and 32, and stage 2 of the headline
# (Co 64: bf16 only, float32 refuses it)
STEM_SHAPES = [((2 * B, H, W, 3), 16), ((2 * B, H // 2, W // 2, 16), 32),
               ((2, H, W, 3), 16), ((2, H // 2, W // 2, 16), 32),
               ((2, 70, 90, 3), 16), ((3, 38, 70, 16), 32),
               ((2 * B, H // 4, W // 4, 32), 64)]
# The H100 SXM's published peaks (NVIDIA data sheet, 700 W): device
# memory bytes/s and dense bf16 tensor-core operations/s
PEAK_BYTES = 3.35e12
PEAK_OPS_BF16 = 989e12


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------- helpers

def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def bf16_ulps(got, want) -> str:
    """max|want|, the largest |got - want| in bf16 ulps of max|want| (an
    ulp of v is 2^(floor(log2|v|) - 7)), and |want| where that error is."""
    import math

    d = (got.float() - want.float()).abs().flatten()
    worst = int(d.argmax())
    top = float(want.float().abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    return (f"max|plain|={top:.4f} (ulp {ulp:g}), max error "
            f"{float(d[worst]) / ulp:g} ulps of it, at |plain|="
            f"{abs(float(want.flatten()[worst])):.4f}")


def compare(tag, got, want, rel, errs, key):
    """Print and check max|got - want| <= rel * max(1, max|want|)."""
    import torch

    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{tag}: shape {tuple(got.shape)} vs "
          f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got.float()).all()), f"{tag}: non-finite")
    err = max_err(got, want)
    tol = rel * max(1.0, float(want.float().abs().max()))
    log(f"  {tag}: max_abs_err={err:.3e} tol={tol:.3e}")
    check(err <= tol, f"{tag}: error {err} above tolerance {tol}")
    errs[key] = max(errs.get(key, 0.0), err)


def time_ms(fn, n=N_TIMED, warmup=3) -> float:
    """Median CUDA-event time of fn() in ms over n timed calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_chain_ms(fn, n=20, warmup=3) -> float:
    """CUDA-event time of n back-to-back fn() calls, per call: where the
    host enqueues a call faster than the card runs it, the card's time."""
    import torch

    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def seed_flow_heads(model, seed: int, hw, k: float = 1.5) -> None:
    """Non-zero flow heads: of_flow ~ N(0, (k / s)^2), s = sqrt(h² + w²)
    of the level (the 'diag' output scale), and BatchNorm scale, bias and
    running statistics from a seed. k = 1.5 gives eval-mode flows of a few
    px with some beyond ±4 at the finest level (the scale
    tests/test_torch_model.py uses for its JAX comparison)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    heads = [model.flower.flow_0.flow] + [u.flow
                                          for u in model.flower.upflows]
    with torch.no_grad():
        for i, head in enumerate(heads):
            h, w = hw[0] >> (5 - i), hw[1] >> (5 - i)
            s = math.sqrt(h * h + w * w)
            dev = head.of_flow.weight.device

            def t(a):
                return torch.from_numpy(a.astype(np.float32)).to(dev)

            head.of_flow.weight.copy_(
                t(rng.normal(0, k / s, (3, 3, 16, 2)).transpose(3, 2, 0, 1)))
            head.norm.weight.copy_(t(rng.uniform(0.5, 1.5, 16)))
            head.norm.bias.copy_(t(rng.normal(0, 0.1, 16)))
            head.norm.running_mean.copy_(t(rng.normal(0, 0.1, 16)))
            head.norm.running_var.copy_(t(rng.uniform(0.5, 1.5, 16)))


def counts_of(K1=0, K2=0, K3=0, K4a=0, K4b=0, K5=0) -> dict:
    """Launch counts by wrapper name (qpwcnet_torch.ops.cuda)."""
    return {"cost_volume_cuda": K1, "downconv_stage_cuda": K2,
            "warp_cost_volume_cuda": K3, "cost_volume_bwd_prv_cuda": K4a,
            "cost_volume_bwd_nxt_cuda": K4b, "upconv_stage_cuda": K5}


def build(dtype, dev, hw=(H, W), k=1.5, **kw):
    """build_flow_net from SEED with flow heads seeded for inputs of
    size hw (k = 0: the fresh 'diag' heads, zero flow)."""
    from qpwcnet_torch.models import build_flow_net

    model = build_flow_net(SEED, dev, dtype=dtype, **kw)
    if k:
        seed_flow_heads(model, SEED + 1, hw, k=k)
    return model


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms, restored after: phases 4b and 4c
    compare gradients, and cuDNN's weight gradients of the flow heads'
    2-channel output convs otherwise change between runs."""
    import torch

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


# ----------------------------------------------------------------- phases

def phase_device():
    import torch

    log("== phase 1: device")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"  device: {name} (count {torch.cuda.device_count()})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, (smi[0] if smi else "nvidia-smi: no output")


def phase_build():
    from qpwcnet_torch.ops.cuda import _build

    log("== phase 2: build")
    t0 = time.perf_counter()
    lib = _build.library()
    log(f"  built and loaded {_build.build().name} in "
        f"{time.perf_counter() - t0:.1f} s")
    sass_tensor_cores(_build.build(), Path(_build._nvcc()).parent)
    return lib


def sass_tensor_cores(lib_path, bin_dir) -> None:
    """Count tensor-core (HMMA) instructions in K1's, K2's, K3's, K4a's,
    K4b's and K5's kernels in the built library's SASS: each bf16
    instantiation must issue them, and K1's, K3's, K4a's and K4b's float32
    bodies (CUDA-core FMAs) none."""
    import re

    cuobjdump = bin_dir / "cuobjdump"
    if not cuobjdump.exists():
        log(f"  {cuobjdump} not found: the SASS check is skipped")
        return
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name and "HMMA" in line:
            counts[name] += 1
    mma, f32, stem, stem32, cv, cv32 = {}, {}, {}, {}, {}, {}
    bwd, bwd32, wcv, wcv32 = {}, {}, {}, {}
    for name, n in counts.items():
        m = re.search(r"cost_volume_mma_kernelILi(\d+)ELi(\d+)E", name)
        if m:
            cv[f"{m[1]} rows, {9 // int(m[2])} di a warp"] = n
        if re.search(r"correlate_kernelIfLb0E", name):
            cv32["correlate_kernel<float, false>"] = n
        m = re.search(r"warp_cv_mma_kernelILi(\d+)ELi(\d+)E", name)
        if m:
            wcv[f"{m[1]} rows, {9 // int(m[2])} di a warp"] = n
        if re.search(r"correlate_kernelIfLb1E", name):
            wcv32["correlate_kernel<float, true>"] = n
        m = re.search(r"cv_bwd_mma_kernelILb([01])ELi(\d+)E", name)
        if m:
            bwd[("K4b" if m[1] == "1" else "K4a") + f", {m[2]} rows"] = n
        m = re.search(r"cv_bwd_kernelI(\w+?)Lb([01])E", name)
        if m:
            bwd32[("K4b" if m[2] == "1" else "K4a") + f" {m[1]}"] = n
        m = re.search(r"upconv_mma_kernelILi(\d+)ELi(\d+)E", name)
        if m:
            mma[f"Co {m[1]}, {m[2]} phases"] = n
        m = re.search(r"upconv_kernelILi(\d+)E", name)
        if m:
            f32[f"Co {m[1]}"] = n
        m = re.search(r"stem_mma_kernelILi(\d+)ELb([01])E", name)
        if m:
            stem[f"Co {m[1]}, " + ("Ci <= 4" if m[2] == "1" else "Ci > 4")] = n
        m = re.search(r"stem_kernelILi(\d+)E", name)
        if m:
            stem32[f"Co {m[1]}"] = n
    log(f"  SASS HMMA count: K1 bf16 {cv}, K1 float32 {cv32}")
    log(f"  SASS HMMA count: K3 bf16 {wcv}, K3 float32 {wcv32}")
    log(f"  SASS HMMA count: K4 bf16 {bwd}, K4 float32 {bwd32}")
    log(f"  SASS HMMA count: K5 bf16 {mma}, K5 float32 {f32}")
    log(f"  SASS HMMA count: K2 bf16 {stem}, K2 float32 {stem32}")
    check(len(cv) == 3 and all(n > 0 for n in cv.values()),
          f"K1's bf16 body issues no HMMA: {cv}")
    check(len(cv32) == 1 and all(n == 0 for n in cv32.values()),
          f"K1's float32 body is not the CUDA-core one: {cv32}")
    check(len(wcv) == 3 and all(n > 0 for n in wcv.values()),
          f"K3's bf16 body issues no HMMA: {wcv}")
    check(len(wcv32) == 1 and all(n == 0 for n in wcv32.values()),
          f"K3's float32 body is not the CUDA-core one: {wcv32}")
    check(len(bwd) == 6 and all(n > 0 for n in bwd.values()),
          f"K4a's and K4b's bf16 body issues no HMMA: {bwd}")
    check(sorted(bwd32) == ["K4a f", "K4b f"]
          and all(n == 0 for n in bwd32.values()),
          f"K4a's and K4b's float32 body is not the CUDA-core one: {bwd32}")
    check(len(mma) == 4 and all(n > 0 for n in mma.values()),
          f"K5's bf16 body issues no HMMA: {mma}")
    check(len(stem) == 6 and all(n > 0 for n in stem.values()),
          f"K2's bf16 body issues no HMMA: {stem}")


def phase_kernels(dev):
    import torch

    from qpwcnet_torch.ops.cost_volume import cost_volume_plain
    from qpwcnet_torch.ops.cuda.cost_volume_kernel import cost_volume_cuda
    from qpwcnet_torch.ops.cuda.stem_kernel import (
        STEM_CHANNELS, downconv_stage_cuda, downconv_stage_plain)
    from qpwcnet_torch.ops.cuda.warp_cv_kernel import (
        warp_cost_volume_cuda, warp_cost_volume_plain)

    log("== phase 3: kernel equality (max_abs_err vs plain, tolerance "
        f"{REL_F32:g} (f32) / {REL_BF16:g} (bf16; K2 {4 * REL_BF16:g}) of "
        "max(1, max|plain|))")
    g = torch.Generator(device=dev).manual_seed(SEED)
    errs = {}

    def rand(shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)
                ).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        rel = REL_F32 if dtype == torch.float32 else REL_BF16
        dn = str(dtype).split(".")[-1]
        # batch 8 (the headline) and 1 (the infer app's requests), the
        # train step's levels, odd shapes (C % 8 != 0: element-wise
        # staging; a map smaller than one tile)
        cases = ([(b, *lv) for b in (B, 1) for lv in CV_LEVELS]
                 + [(TRAIN_B, *lv) for lv in TRAIN_LEVELS]
                 + [(3, 13, 37, 24), (2, 13, 37, 20), (1, 5, 7, 32)])
        for b, h, w, c in cases:
            prv, nxt = rand((b, h, w, c), dtype), rand((b, h, w, c), dtype)
            compare(f"K1 cost_volume {dn} ({b},{h},{w},{c})",
                    cost_volume_cuda(prv, nxt), cost_volume_plain(prv, nxt),
                    rel, errs, "cost_volume")
        # flows inside the ±4 window (clipped at 3.9), and beyond it; the
        # 'fast' forward's level (b8, b1), the train step's (b16), C % 8 !=
        # 0 (element-wise gather) and C = 64 (two chunks)
        inside, beyond = (2.0, 3.9), (6.0, None)
        for shape, (fscale, lim) in (
                ((B, 224, 512, 32), inside), ((B, 224, 512, 32), beyond),
                ((1, 224, 512, 32), beyond), ((2, 13, 37, 24), beyond),
                *(((s, f) for s in ((TRAIN_B, 128, 256, 32), (2, 13, 37, 20),
                                    (2, 24, 40, 64))
                   for f in (inside, beyond)))):
            prv, nxt = rand(shape, dtype), rand(shape, dtype)
            flow = rand(shape[:3] + (2,), torch.float32, fscale)
            if lim is not None:
                flow = flow.clamp(-lim, lim)
            beyond = float((flow.abs() > 4).float().mean())
            compare(f"K3 warp_cost_volume {dn} {shape} flow std {fscale} "
                    f"({beyond:.0%} beyond ±4)",
                    warp_cost_volume_cuda(prv, nxt, flow),
                    warp_cost_volume_plain(prv, nxt, flow),
                    rel, errs, "warp_cost_volume")
        for (b, h, w, cin), cout in STEM_SHAPES:
            x = rand((b, h, w, cin), dtype, 0.5)
            params = [(rand((cout, ci, 3, 3), torch.float32,
                            (9 * ci) ** -0.5),
                       rand((cout,), torch.float32, 0.1))
                      for ci in (cin, cout, cout)]
            if cout not in STEM_CHANNELS[dtype]:
                try:
                    downconv_stage_cuda(x, params, dtype)
                except ValueError as e:
                    log(f"  K2 {dn} ({b},{h},{w},{cin})->{cout}: refused "
                        f"({e})")
                    continue
                fail(f"K2 {dn} at Co {cout} did not refuse")
            # bf16: a one-ulp rounding flip in conv_a or conv_aa moves the
            # later convs' sums across rounding points too: 4 ulps
            got = downconv_stage_cuda(x, params, dtype)
            want = downconv_stage_plain(x, params, dtype)
            compare(f"K2 downconv_stage {dn} ({b},{h},{w},{cin})->{cout}",
                    got, want,
                    rel if dtype == torch.float32 else 4 * REL_BF16,
                    errs, "downconv_stage")
            if dtype == torch.bfloat16:
                log(f"    {bf16_ulps(got, want)}")
            del got, want
        torch.cuda.empty_cache()
    return errs


def phase_kernels_bwd(dev, errs):
    """Phase 3, continued: K4a and K4b against their plain versions, and
    the trainable cost volume against autograd of the plain one."""
    import torch

    from qpwcnet_torch.ops import cuda as kernels
    from qpwcnet_torch.ops.cost_volume import (
        CostVolumeFunction, cost_volume_bwd_nxt_plain,
        cost_volume_bwd_prv_plain, cost_volume_plain)
    from qpwcnet_torch.ops.cuda.cost_volume_kernel import (
        cost_volume_bwd_nxt_cuda, cost_volume_bwd_prv_cuda)

    log("== phase 3b: cost-volume backward kernels at the training levels "
        f"({TRAIN_H}x{TRAIN_W} b{TRAIN_B} and b1), same tolerances as K1: "
        "products and sums in float32 on both sides, in the same k order")
    g = torch.Generator(device=dev).manual_seed(SEED + 5)

    def rand(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        rel = REL_F32 if dtype == torch.float32 else REL_BF16
        dn = str(dtype).split(".")[-1]
        # the training levels at b16 and b1; odd shapes: W no tile
        # multiple, C % 8 != 0 (element-wise staging), C = 256 split into
        # channel groups on a small map
        cases = ([(b, *lv) for b in (TRAIN_B, 1) for lv in TRAIN_LEVELS]
                 + [(3, 13, 37, 24), (2, 13, 37, 20), (4, 24, 40, 256)])
        for b, h, w, c in cases:
            dacc = rand((b, h, w, 81), dtype)
            prv, nxt = rand((b, h, w, c), dtype), rand((b, h, w, c), dtype)
            compare(f"K4a cost_volume_bwd_prv {dn} ({b},{h},{w},{c})",
                    cost_volume_bwd_prv_cuda(dacc, nxt),
                    cost_volume_bwd_prv_plain(dacc, nxt), rel, errs,
                    "cost_volume_bwd_prv")
            compare(f"K4b cost_volume_bwd_nxt {dn} ({b},{h},{w},{c})",
                    cost_volume_bwd_nxt_cuda(dacc, prv),
                    cost_volume_bwd_nxt_plain(dacc, prv), rel, errs,
                    "cost_volume_bwd_nxt")
        torch.cuda.empty_cache()

    # The Function (K1 forward, K4a + K4b backward) against autograd of
    # the plain cost volume, float32, at the finest training level. Where
    # a correlation is within rounding of 0, K1 and the plain forward may
    # round it to opposite signs and so take the other leaky-ReLU slope:
    # the plain backward of that slope difference is added to autograd's
    # gradient before the comparison.
    b, (h, w, c) = TRAIN_B, TRAIN_LEVELS[-1]
    prv, nxt = rand((b, h, w, c), torch.float32), rand((b, h, w, c),
                                                        torch.float32)
    gout = rand((b, h, w, 81), torch.float32)
    leaves = [t.clone().requires_grad_() for t in (prv, nxt, prv, nxt)]
    kernels.reset_launch_counts()
    out_k = CostVolumeFunction.apply(leaves[0], leaves[1])
    out_k.backward(gout)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    out_p = cost_volume_plain(leaves[2], leaves[3])
    out_p.backward(gout)
    with torch.no_grad():
        slope_k, slope_p = (torch.where(o > 0, 1.0, 0.1) for o in (out_k,
                                                                   out_p))
        flips = int((slope_k != slope_p).sum())
        ddacc = (gout * (slope_k - slope_p)).contiguous()
        want = {"prv": leaves[2].grad + cost_volume_bwd_prv_plain(ddacc, nxt),
                "nxt": leaves[3].grad + cost_volume_bwd_nxt_plain(ddacc, prv)}
    log(f"  CostVolumeFunction: {flips} of {out_k.numel()} outputs on the "
        "other leaky-ReLU slope than the plain forward's")
    for i, name in ((0, "prv"), (1, "nxt")):
        compare(f"CostVolumeFunction d{name} f32 ({b},{h},{w},{c}) vs "
                "autograd of cost_volume_plain", leaves[i].grad,
                want[name], REL_F32, {}, "function")
    check(counts == counts_of(K1=1, K4a=1, K4b=1),
          f"CostVolumeFunction launches {counts}")
    del leaves, gout, out_k, out_p, ddacc, want
    torch.cuda.empty_cache()


def upconv_params(g, dev, ci, co):
    """A transpose-conv weight (Ci, Co, 4, 4) and bias, float32, scaled so
    that the outputs are of order 1."""
    import torch

    w = torch.randn((ci, co, 4, 4), generator=g, device=dev) * (4 * ci) ** -0.5
    return w, 0.1 * torch.randn((co,), generator=g, device=dev)


def phase_kernels_upconv(dev, errs):
    """Phase 3c: K5 against its plain version at the decoder's shapes, and
    the trainable K5's gradients against autograd of the plain version."""
    import torch

    from qpwcnet_torch.ops import cuda as kernels
    from qpwcnet_torch.ops.cuda.upconv_kernel import (
        upconv_stage_cuda, upconv_stage_plain, upconv_stage_trainable)

    log("== phase 3c: K5 upconv_stage against its plain version, tolerance "
        f"{REL_F32:g} (f32) / {2 * REL_BF16:g} (bf16: two ulps, since a "
        "one-ulp flip of the rounded sum moves the bias add's and Mish's "
        "roundings too) of max(1, max|plain|)")
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    for dtype in (torch.float32, torch.bfloat16):
        rel = REL_F32 if dtype == torch.float32 else 2 * REL_BF16
        dn = str(dtype).split(".")[-1]
        for shape, co in UPCONV_SHAPES:
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            w, b = upconv_params(g, dev, shape[-1], co)
            got = upconv_stage_cuda(x, w, b, dtype)
            want = upconv_stage_plain(x, w, b, dtype)
            compare(f"K5 upconv_stage {dn} {shape}->{co}", got, want, rel,
                    errs, "upconv_stage")
            if dtype == torch.bfloat16:
                log(f"    {bf16_ulps(got, want)}")
        torch.cuda.empty_cache()

    # The trainable stage (K5 forward, the unfused composition's
    # backward) against autograd of the plain version, float32: the same
    # backward on the same inputs, so only cuDNN's own nondeterminism.
    shape, co = UPCONV_SHAPES[1]
    x = torch.randn(shape, generator=g, device=dev)
    w, b = upconv_params(g, dev, shape[-1], co)
    gout = torch.randn((shape[0], 2 * shape[1], 2 * shape[2], co),
                       generator=g, device=dev)
    grads = []
    for fn in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        kernels.reset_launch_counts()
        if fn == "kernel":
            y = upconv_stage_trainable(leaves[0], [tuple(leaves[1:])],
                                       torch.float32)
        else:
            y = upconv_stage_plain(*leaves, torch.float32)
        y.backward(gout)
        torch.cuda.synchronize()
        check(kernels.launch_counts() == counts_of(K5=int(fn == "kernel")),
              f"trainable K5 {fn}: launches {kernels.launch_counts()}")
        grads.append([t.grad for t in leaves])
    for name, got, want in zip(("x", "weight", "bias"), *grads):
        compare(f"upconv_stage_trainable d{name} f32 {shape}->{co} vs "
                "autograd of upconv_stage_plain", got, want, REL_F32, {},
                "function")
    del x, w, b, gout, grads, leaves, y
    torch.cuda.empty_cache()


def phase_slice(dev):
    import numpy as np
    import torch

    from qpwcnet_torch.apps import infer
    from qpwcnet_torch.ops import cuda as kernels
    from qpwcnet_torch.utils.config import parse_config
    from qpwcnet_torch.utils.profiling import breakdown

    log(f"== phase 4: slice, PWCFlowNet {H}x{W} b{B}, seeded flow heads")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    x = torch.rand((B, H, W, 6), generator=g, device=dev) - 0.5
    bf16, f32 = torch.bfloat16, torch.float32
    expected = {"exact": counts_of(K1=5, K2=2),
                "fast": counts_of(K1=4, K2=2, K3=1)}
    models = {}
    flows = {}
    with torch.inference_mode():
        for dtype in (bf16, f32):
            dn = str(dtype).split(".")[-1]
            for mode, kw in (("exact", dict(cv_impl="auto", stem_stages=2)),
                             ("fast", dict(cv_impl="fast", stem_stages=2)),
                             ("plain", dict(cv_impl="plain",
                                            stem_stages=0))):
                m = build(dtype, dev, **kw)
                kernels.reset_launch_counts()
                out = m(x)
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
                check(tuple(out.shape) == (B, H, W, 2)
                      and out.dtype == f32, f"{mode} {dn}: output "
                      f"{tuple(out.shape)} {out.dtype}")
                check(bool(torch.isfinite(out).all()),
                      f"{mode} {dn}: non-finite flow")
                want = expected.get(mode, {k: 0 for k in counts})
                log(f"  {mode} {dn}: launches {counts} "
                    f"mean|flow|={float(out.abs().mean()):.3f} px")
                check(counts == want, f"{mode} {dn}: launches {counts}, "
                      f"expected {want}")
                flows[mode, dtype] = out
                models[mode, dtype] = m
            if dtype == bf16:
                # every device kernel of one forward: K2 launches nothing
                # beside its kernel (no weight casts or permutes)
                for mode in ("exact", "fast"):
                    prof = breakdown(lambda: models[mode, dtype](x), n=1,
                                     warmup=1)
                    cats = prof["by_category"]
                    log(f"  {mode} {dn}: {prof['kernels']:.0f} device "
                        f"kernels a forward (torch.profiler), K1 "
                        f"{cats.get('K1', 0.0):.3f} ms, K2 "
                        f"{cats.get('K2', 0.0):.3f} ms and K3 "
                        f"{cats.get('K3', 0.0):.3f} ms of "
                        f"{prof['busy_ms']:.3f} busy ms")
            # the flow entering the finest UpFlow, where 'fast' clamps
            ms = models["plain", dtype](x, multiscale=True)
            fin_in = 2.0 * ms[-3].abs()
            beyond = float((fin_in > 4.0).float().mean())
            log(f"  {dn}: flow into the finest level: mean "
                f"{float(fin_in.mean()) / 2:.3f} px, "
                f"{beyond:.1%} of components beyond ±4 px")
            check(beyond > 0.0, "no flow beyond the fused window: the "
                  "'fast' check would be vacuous")
            del ms, fin_in
            compare_model(f"exact vs plain {dn}", flows["exact", dtype],
                          flows["plain", dtype], dtype)
            d_fast = max_err(flows["fast", dtype], flows["exact", dtype])
            m_fast = float((flows["fast", dtype]
                            - flows["exact", dtype]).abs().mean())
            log(f"  fast vs exact {dn} (window-warp clamp at ±4): "
                f"max {d_fast:.3e} mean {m_fast:.3e} px")
            models.clear()
            torch.cuda.empty_cache()

        # The card (kernels) against the CPU (plain versions), float32,
        # at a small shape.
        from qpwcnet_torch.models import build_flow_net

        xs = (torch.rand((1, 64, 128, 6), generator=torch.Generator()
                         .manual_seed(SEED + 3)) - 0.5)
        for mode in ("auto", "fast"):
            cpu = build_flow_net(SEED, "cpu", cv_impl=mode, stem_stages=2)
            gpu = build_flow_net(SEED, dev, cv_impl=mode, stem_stages=2)
            for m in (cpu, gpu):
                seed_flow_heads(m, SEED + 1, (64, 128))
            ref = cpu(xs)
            err = max_err(gpu(xs.to(dev)).cpu(), ref)
            tol = 1e-4 * max(1.0, float(ref.abs().max()))
            log(f"  card vs CPU f32 {mode} at 64x128: max_abs_err="
                f"{err:.3e} tol={tol:.3e} "
                f"mean|flow|={float(ref.abs().mean()):.3f} px")
            check(err <= tol, f"card vs CPU {mode}")
            del cpu, gpu

        log(f"  infer app: --fast --n 2 at {H}x{W} (the main path)")
        with tempfile.TemporaryDirectory() as tmp:
            cfg = parse_config(infer.Settings, [
                "--fast", "true", "--n", "2", "--height", str(H),
                "--width", str(W), "--out-dir", tmp, "--device", str(dev)])
            model = infer.build_model(cfg)
            seed_flow_heads(model, SEED + 1, (H, W))
            kernels.reset_launch_counts()
            errs = infer.run(cfg, model)
            torch.cuda.synchronize()
            main_counts = kernels.launch_counts()
            pngs = sorted(p.name for p in Path(tmp).glob("*.png"))
        log(f"  infer: warp-validation L1 {errs}, {len(pngs)} PNGs, "
            f"launches {main_counts}")
        check(len(errs) == 2 and all(np.isfinite(errs)), "infer errors")
        check(len(pngs) == 10, f"infer wrote {pngs}")
        check(main_counts == counts_of(K1=8, K2=4, K3=2),
              f"infer launches {main_counts}")
    return main_counts, x


def train_batch(dev, seed):
    """A synthetic training batch at the training configuration."""
    import torch

    from qpwcnet_torch.data import preprocess_flow_batch, synthetic_flow_batch

    gen = torch.Generator(device=dev).manual_seed(seed)
    ims_u8, flo = synthetic_flow_batch(gen, TRAIN_B, TRAIN_H, TRAIN_W)
    return preprocess_flow_batch(ims_u8, flo, out_hw=(TRAIN_H, TRAIN_W))


def build_train(dtype, dev, k=TRAIN_K, **kw):
    return build(dtype, dev, hw=(TRAIN_H, TRAIN_W), k=k, **kw)


def grad_step(model, batch, make_step=None):
    """One train step (make_flow_train_step unless ``make_step`` names
    another step maker) with the plain chain at learning rate 0, so the
    parameters stay as they were. Returns (loss, {name: grad}, launch
    counts of the step)."""
    import torch

    from qpwcnet_torch.ops import cuda as kernels
    from qpwcnet_torch.train import make_flow_train_step, plain_optimizer

    opt = plain_optimizer(model, 0.0)
    kernels.reset_launch_counts()
    m = (make_step or make_flow_train_step)()(model, opt, batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return float(m["loss"]), grads, counts


# Leaves whose gradient is the small remainder of a near-total
# cancellation: they feed a flow head's train-mode BatchNorm, directly or
# through its 1x1 conv, and BatchNorm removes any per-channel shift.
CANCELLING = ("conv1x1.bias", "of_feats.3.pointwise.bias")


def grad_scale(name, want) -> float:
    """The magnitude a leaf's float32 gradient error is measured against:
    its own max|g|, or for a cancelling leaf the largest max|g| in its
    flow head (the size of the terms that cancel)."""
    if not name.endswith(CANCELLING):
        return float(want[name].abs().max())
    head = name.split(".flow.")[0] + ".flow."
    return max(float(w.abs().max()) for n, w in want.items()
               if n.startswith(head))


def rms(t) -> float:
    return float(t.float().square().mean().sqrt())


def compare_grads(tag, got, want, ref32=None):
    """Every leaf against the plain model's. float32: max|got - want| <=
    1e-4 of grad_scale, the port's model bound (five levels of convs in
    another summation order feed the warp coordinates). bf16 (``ref32``
    holds the plain model's float32 gradients): the kernels may add no
    more error than bf16 compute itself, rms(got - want) <=
    BF16_GRAD_FACTOR * rms(want - ref32), plus 1e-6 of the leaf's max for
    the leaves that bf16 leaves exact. A bound relative to the leaf's own
    max would be meaningless in bf16 for the cancelling leaves, whose
    noise is relative to the cancelled terms."""
    import torch

    worst = []
    for name, w in want.items():
        check(bool(torch.isfinite(got[name]).all()), f"{tag} {name}: "
              "non-finite gradient")
        d = got[name] - w
        if ref32 is None:
            r = float(d.abs().max()) / max(grad_scale(name, want), 1e-30)
            worst.append((r / 1e-4, r, name))
        else:
            noise = rms(w - ref32[name])
            floor = 1e-6 * float(ref32[name].abs().max())
            r = rms(d) / max(noise, 1e-30)
            worst.append((rms(d) / (BF16_GRAD_FACTOR * noise + floor), r,
                          name))
    worst.sort(reverse=True)
    if ref32 is not None:
        cancel = [(r, n) for _, r, n in worst if n.endswith(CANCELLING)]
        log(f"  {tag}: cancelling leaves, rms(err)/rms(plain bf16 - plain "
            f"f32) (limit {BF16_GRAD_FACTOR}): "
            + ", ".join(f"{n} {r:.4f}" for r, n in cancel[:2]))
    what = "max|err|/grad_scale" if ref32 is None else \
        "rms(err)/rms(plain bf16 - plain f32)"
    log(f"  {tag}: {len(worst)} leaves, worst {what}: "
        + ", ".join(f"{n} {r:.3e}" for _, r, n in worst[:3]))
    for used, r, name in worst:
        check(used <= 1.0, f"{tag} {name}: {r:.3e}")


def phase_train(dev):
    import numpy as np
    import torch

    from qpwcnet_torch.apps import train_flow
    from qpwcnet_torch.ops import cuda as kernels
    from qpwcnet_torch.train import make_flow_train_step, plain_optimizer

    log(f"== phase 4b: train slice, PWCFlowNet {TRAIN_H}x{TRAIN_W} "
        f"b{TRAIN_B}, one train step per model")
    batch = train_batch(dev, SEED + 6)
    bf16, f32 = torch.bfloat16, torch.float32
    per_step = {"exact": counts_of(K1=5, K2=2, K4a=5, K4b=5),
                "fast": counts_of(K1=5, K2=2, K3=1, K4a=5, K4b=5),
                "plain": counts_of()}
    plain32 = None
    for dtype in (f32, bf16):
        dn = str(dtype).split(".")[-1]
        grads = {}
        for mode, kw in TRAIN_MODES:
            m = build_train(dtype, dev, **kw)
            loss, grads[mode], counts = grad_step(m, batch)
            log(f"  {mode} {dn}: loss {loss:.6f}, launches {counts}")
            check(np.isfinite(loss), f"{mode} {dn}: loss {loss}")
            check(counts == per_step[mode], f"{mode} {dn}: launches "
                  f"{counts}, expected {per_step[mode]}")
            if mode == "plain":
                # the flow entering the finest UpFlow, where 'fast' clamps
                with torch.no_grad():
                    fin_in = 2.0 * m(batch["ims"], multiscale=True)[-3].abs()
                log(f"  {dn}: flow into the finest level: mean "
                    f"{float(fin_in.mean()) / 2:.3f} px, max "
                    f"{float(fin_in.max()):.3f} px")
                check(float(fin_in.max()) < 4.0, "flow beyond the fused "
                      "window: 'fast' computes another function than plain")
                if dtype == bf16:
                    # R6: the plain bf16 step again, on a fresh model
                    _, again, _ = grad_step(build_train(dtype, dev, **kw),
                                            batch)
                    differ = [n for n in again
                              if not torch.equal(again[n], grads[mode][n])]
                    same = len(again) - len(differ)
                    log(f"  plain bf16 step repeated: {same} of "
                        f"{len(again)} gradients bit-equal")
                    check(not differ, f"plain bf16 gradients differ between "
                          f"two runs: {differ[:4]}")
                    del again
            del m
            torch.cuda.empty_cache()
        for mode in ("exact", "fast"):
            compare_grads(f"{mode} vs plain grads {dn}", grads[mode],
                          grads["plain"], plain32)
        plain32 = grads["plain"]
        del grads
    del plain32

    # Fresh 'diag' heads: zero flow at every level.
    grads = {}
    for mode, kw in (TRAIN_MODES[0], TRAIN_MODES[2]):
        m = build_train(f32, dev, k=0.0, **kw)
        _, grads[mode], counts = grad_step(m, batch)
        check(counts == per_step[mode], f"fresh {mode}: launches {counts}")
        del m
    compare_grads("fresh 'diag' exact vs plain grads float32",
                  grads["exact"], grads["plain"])
    del grads

    m = build_train(f32, dev, cv_impl="auto", stem_stages=2)
    opt = plain_optimizer(m, 3e-4)
    step = make_flow_train_step()
    losses = [float(step(m, opt, batch)["loss"]) for _ in range(5)]
    log(f"  exact float32, 5 steps on one batch (Adam 3e-4): losses "
        f"{[round(v, 6) for v in losses]}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"loss did not fall: {losses}")
    del m, opt
    torch.cuda.empty_cache()

    steps, log_every, recal = 4, 2, 16
    log(f"  train app: --data synthetic --steps {steps} --curriculum '' at "
        f"{TRAIN_H}x{TRAIN_W} b{TRAIN_B} (the main path)")
    kernels.reset_launch_counts()
    metrics = train_flow.main([
        "--data", "synthetic", "--steps", str(steps), "--curriculum", "",
        "--batch-size", str(TRAIN_B), "--height", str(TRAIN_H),
        "--width", str(TRAIN_W), "--log-every", str(log_every),
        "--recalibrate-final", str(recal), "--device", str(dev)])
    torch.cuda.synchronize()
    main_counts = kernels.launch_counts()
    log(f"  train app: last step {metrics}, launches {main_counts}")
    check(all(np.isfinite(v) for v in metrics.values()), "train app loss")
    # K1 in every forward (steps, held-out evals, recalibration passes),
    # K4a and K4b in every step's backward; cv_impl='auto', stem_stages=0
    n_fwd = steps + steps // log_every + recal
    check(main_counts == counts_of(K1=5 * n_fwd, K4a=5 * steps,
                                   K4b=5 * steps),
          f"train app launches {main_counts}")
    return main_counts, batch


def interp_batch(dev, seed, augment=False):
    """A synthetic pretraining triplet batch at the interpolator slice's
    configuration (256x512, batch 8)."""
    import torch

    from qpwcnet_torch.data import (
        preprocess_triplet_batch, synthetic_triplet_batch)

    gen = torch.Generator(device=dev).manual_seed(seed)
    a, b, c = synthetic_triplet_batch(gen, INTERP_B, TRAIN_H, TRAIN_W)
    return preprocess_triplet_batch(gen, a, b, c, augment=augment)


def build_interp(dtype, dev, k, **kw):
    """build_interpolator from SEED with flow heads seeded for inputs of
    256x512 (k = 0: the fresh 'diag' heads, zero flow)."""
    from qpwcnet_torch.models import build_interpolator

    model = build_interpolator(SEED, dev, dtype=dtype, **kw)
    if k:
        seed_flow_heads(model, SEED + 1, (TRAIN_H, TRAIN_W), k=k)
    return model


def compare_model(tag, got, want, dtype):
    """A model output against the plain model's: float32 within 1e-4 of
    the magnitude (five levels of convs in another summation order feed
    the warp coordinates: the JAX parity bound of
    tests/test_torch_model.py); bf16 within 5% of it max and 0.5% mean (a
    one-ulp difference early moves later warps)."""
    import torch

    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{tag}: shape {tuple(got.shape)} or non-finite")
    scale = max(1.0, float(want.abs().max()))
    err = max_err(got, want)
    mean = float((got - want).abs().mean())
    rel = 1e-4 if dtype == torch.float32 else 5e-2
    log(f"  {tag}: max_abs_err={err:.3e} mean_abs_err={mean:.3e} "
        f"tol={rel * scale:.3e}")
    check(err <= rel * scale, f"{tag}: {err}")
    if dtype != torch.float32:
        check(mean <= 5e-3 * scale, f"{tag}: mean {mean}")


def phase_interp(dev, x):
    """Phase 4c: the interpolator slice at 256x512 b8."""
    import numpy as np
    import torch

    from qpwcnet_torch.apps import interp_infer, pretrain_interp
    from qpwcnet_torch.models import build_interpolator
    from qpwcnet_torch.ops import cuda as kernels
    from qpwcnet_torch.train import (
        create_interp_train_state, make_interp_train_step, plain_optimizer)

    log(f"== phase 4c: interpolator slice, PWCInterpolator {TRAIN_H}x"
        f"{TRAIN_W} b{INTERP_B}, {INTERP_KW} against {PLAIN_KW}")
    bf16, f32 = torch.bfloat16, torch.float32
    batch = interp_batch(dev, SEED + 8)
    per_fwd = counts_of(K1=5, K2=2, K5=2)
    per_step = counts_of(K1=5, K2=2, K5=2, K4a=5, K4b=5)
    with torch.inference_mode():
        for dtype in (bf16, f32):
            dn = str(dtype).split(".")[-1]
            outs = {}
            for mode, kw in (("exact", INTERP_KW), ("plain", PLAIN_KW)):
                m = build_interp(dtype, dev, k=1.5, **kw)
                kernels.reset_launch_counts()
                outs[mode] = m(batch["ims"], return_flows=True)
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
                want = per_fwd if mode == "exact" else counts_of()
                check(counts == want, f"interp {mode} {dn}: launches "
                      f"{counts}, expected {want}")
                img = outs[mode][0]
                check(tuple(img.shape) == (INTERP_B, TRAIN_H, TRAIN_W, 3)
                      and img.dtype == f32, f"interp {mode} {dn}: output "
                      f"{tuple(img.shape)} {img.dtype}")
                log(f"  {mode} {dn}: launches {counts}, mean|flow_01| "
                    f"{float(outs[mode][1][0][-1].abs().mean()):.3f} px")
                del m
            compare_model(f"interp image exact vs plain {dn}",
                          outs["exact"][0], outs["plain"][0], dtype)
            for d, name in enumerate(("flos_01", "flos_10")):
                worst = max(range(6), key=lambda i: max_err(
                    outs["exact"][1][d][i], outs["plain"][1][d][i]))
                compare_model(f"interp {name}[{worst}] (worst of 6) exact "
                              f"vs plain {dn}", outs["exact"][1][d][worst],
                              outs["plain"][1][d][worst], dtype)
            del outs
            torch.cuda.empty_cache()

        # K5 in the flow model at the headline shapes
        outs = {}
        for mode, kw in (("exact", dict(cv_impl="auto", stem_stages=2,
                                        upconv_stages=2)),
                         ("plain", PLAIN_KW)):
            m = build(bf16, dev, **kw)
            kernels.reset_launch_counts()
            outs[mode] = m(x)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            want = counts_of(K1=5, K2=2, K5=2) if mode == "exact" else \
                counts_of()
            check(counts == want, f"flow net upconv_stages=2 {mode}: "
                  f"launches {counts}")
            del m
        log(f"  PWCFlowNet {H}x{W} b{B} bf16, upconv_stages=2: launches "
            f"{counts_of(K1=5, K2=2, K5=2)}")
        compare_model("flow net upconv_stages=2 vs plain bf16",
                      outs["exact"], outs["plain"], bf16)
        del outs
        torch.cuda.empty_cache()

    # One pretraining step: every parameter's gradient against the plain
    # model's, float32 and bf16, with seeded flow heads.
    plain32 = None
    for dtype in (f32, bf16):
        dn = str(dtype).split(".")[-1]
        grads = {}
        for mode, kw in (("exact", INTERP_KW), ("plain", PLAIN_KW)):
            m = build_interp(dtype, dev, k=TRAIN_K, **kw)
            loss, grads[mode], counts = grad_step(m, batch,
                                                  make_interp_train_step)
            want = per_step if mode == "exact" else counts_of()
            log(f"  pretraining step {mode} {dn}: loss {loss:.6f}, "
                f"launches {counts}")
            check(np.isfinite(loss), f"interp {mode} {dn}: loss {loss}")
            check(counts == want, f"interp step {mode} {dn}: launches "
                  f"{counts}, expected {want}")
            del m
            torch.cuda.empty_cache()
        compare_grads(f"interp exact vs plain grads {dn}", grads["exact"],
                      grads["plain"], plain32)
        plain32 = grads["plain"]
        del grads
    del plain32

    # The trainable head parameterization ('unit' + residual, fresh
    # heads): under 'diag' the heads' output scale, sqrt(h² + w²) ~ 570
    # here, turns Adam's first 3e-4 step on seeded heads into flows tens
    # of px off, and the loss jumps before it falls.
    m = build_interp(f32, dev, k=0.0, head_scale="unit", residual=True,
                     **INTERP_KW)
    opt = plain_optimizer(m, 3e-4)
    step = make_interp_train_step()
    losses = [float(step(m, opt, batch)["loss"]) for _ in range(5)]
    log(f"  interp exact float32 ('unit' heads, residual), 5 steps on one "
        f"batch (Adam 3e-4): losses {[round(v, 6) for v in losses]}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"interp loss did not fall: {losses}")
    del m, opt
    torch.cuda.empty_cache()

    # The main path: the library entry points, as bench.py drives the JAX
    # pretraining step: 2 steps on fresh augmented batches, then one eval
    # forward, bf16.
    n_steps = 2
    log(f"  interp main path: build_interpolator({INTERP_KW}, bf16) + "
        f"make_interp_train_step, {n_steps} steps + 1 eval forward")
    kernels.reset_launch_counts()
    model = build_interpolator(SEED, dev, dtype=bf16, **INTERP_KW)
    opt = create_interp_train_state(model, 1e-4)
    step = make_interp_train_step()
    metrics = [step(model, opt, interp_batch(dev, SEED + 9 + i, True))
               for i in range(n_steps)]
    model.eval()
    with torch.no_grad():
        img = model(batch["ims"])
    torch.cuda.synchronize()
    interp_counts = kernels.launch_counts()
    losses = [float(mt["loss"]) for mt in metrics]
    log(f"  interp main path: losses {losses}, launches {interp_counts}")
    check(all(np.isfinite(losses)) and bool(torch.isfinite(img).all()),
          "interp main path: non-finite")
    n_fwd = n_steps + 1
    check(interp_counts == counts_of(K1=5 * n_fwd, K2=2 * n_fwd,
                                     K5=2 * n_fwd, K4a=5 * n_steps,
                                     K4b=5 * n_steps),
          f"interp main path launches {interp_counts}")
    del model, opt, img
    torch.cuda.empty_cache()

    steps, log_every, recal = 4, 2, 4
    log(f"  pretrain app: --steps {steps} at {TRAIN_H}x{TRAIN_W} "
        f"b{INTERP_B} (a main path)")
    kernels.reset_launch_counts()
    metrics = pretrain_interp.main([
        "--steps", str(steps), "--batch-size", str(INTERP_B),
        "--height", str(TRAIN_H), "--width", str(TRAIN_W),
        "--log-every", str(log_every), "--recalibrate-final", str(recal),
        "--device", str(dev)])
    torch.cuda.synchronize()
    app_counts = kernels.launch_counts()
    log(f"  pretrain app: last logged {metrics}, launches {app_counts}")
    check(all(np.isfinite(v) for v in metrics.values())
          and "mse_eval" in metrics, "pretrain app metrics")
    # K1 in every forward (steps, held-out evals, recalibration passes),
    # K4a and K4b in every step's backward; cv_impl='auto', no stem or
    # upconv kernels (the JAX app's model)
    n_fwd = steps + steps // log_every + recal
    check(app_counts == counts_of(K1=5 * n_fwd, K4a=5 * steps,
                                  K4b=5 * steps),
          f"pretrain app launches {app_counts}")

    log(f"  interp_infer app: --data synthetic --n 2 at {TRAIN_H}x{TRAIN_W} "
        "(a main path)")
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launch_counts()
        results = interp_infer.main([
            "--data", "synthetic", "--n", "2", "--height", str(TRAIN_H),
            "--width", str(TRAIN_W), "--out-dir", tmp, "--device", str(dev)])
        torch.cuda.synchronize()
        infer_counts = kernels.launch_counts()
        pngs = sorted(p.name for p in Path(tmp).glob("*.png"))
    log(f"  interp_infer: {results}, {len(pngs)} PNGs, launches "
        f"{infer_counts}")
    check(len(results) == 2 and all(np.isfinite(r["psnr"]) for r in results),
          "interp_infer PSNR")
    check(len(pngs) == 14, f"interp_infer wrote {pngs}")
    check(infer_counts == counts_of(K1=10), f"interp_infer launches "
          f"{infer_counts}")
    return {"interp": interp_counts, "pretrain_app": app_counts,
            "interp_infer_app": infer_counts}, batch


def bound(nbytes: float, nops: float) -> tuple:
    """(bytes term, operations term) in ms: the least time the card could
    take to move nbytes through device memory and to do nops bf16
    operations on the tensor cores, at the published peaks."""
    return nbytes / PEAK_BYTES * 1e3, nops / PEAK_OPS_BF16 * 1e3


def bound_cv(b, h, w, c, extra_ops=0, extra_bytes=0):
    """K1, K3, K4a, K4b at one level, bf16: two (b, h, w, c) maps and one
    (b, h, w, 81) map moved once; 81·c multiply-adds a pixel."""
    px = b * h * w
    return bound(2 * (2 * px * c + 81 * px) + extra_bytes,
                 2 * 81 * c * px + extra_ops)


def stem_bytes(b, h, w, cin, cout):
    """K2's bytes moved once: the bf16 input and half-size output, the
    float32 weights and biases."""
    return (2 * (b * h * w * cin + b * (h // 2) * (w // 2) * cout)
            + 4 * (9 * cout * (cin + 2 * cout) + 3 * cout))


def bound_stem(b, h, w, cin, cout):
    """K2, bf16 activations: its bytes moved once; the three 3x3 convs'
    multiply-adds."""
    px = b * (h // 2) * (w // 2)
    return bound(stem_bytes(b, h, w, cin, cout),
                 2 * px * 9 * cout * (cin + 2 * cout))


def upconv_bytes(b, h, w, ci, co):
    """K5's bytes moved once: the bf16 input and 2x output, the float32
    weights and bias."""
    return 2 * (b * h * w * ci + b * 4 * h * w * co) + 4 * (16 * ci * co + co)


def bound_upconv(b, h, w, ci, co):
    """K5, bf16 activations: its bytes moved once; 4 taps of ci
    multiply-adds per output value."""
    return bound(upconv_bytes(b, h, w, ci, co), 2 * 4 * ci * b * 4 * h * w * co)


class Totals:
    """Each kernel's summed times and bound over the shapes timed for the
    kernels line."""

    def __init__(self):
        self.rows = {name: dict(ms=0.0, plain_ms=0.0, library_ms=None,
                                t_bytes=0.0, t_ops=0.0, bound_ms=0.0)
                     for name in KERNELS}

    def add(self, name, k, p, bnd, lib=None):
        r = self.rows[name]
        r["ms"] += k
        r["plain_ms"] += p
        r["t_bytes"] += bnd[0]
        r["t_ops"] += bnd[1]
        r["bound_ms"] += max(bnd)
        if lib is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + lib


def phase_times(dev, x, batch, ibatch):
    import torch
    import torch.nn.functional as F

    from qpwcnet_torch.layout import nchw
    from qpwcnet_torch.ops.cost_volume import (
        cost_volume_bwd_nxt_plain, cost_volume_bwd_prv_plain,
        cost_volume_plain)
    from qpwcnet_torch.ops.cuda.cost_volume_kernel import (
        cost_volume_bwd_nxt_cuda, cost_volume_bwd_prv_cuda,
        cost_volume_cuda)
    from qpwcnet_torch.ops.cuda.stem_kernel import (
        downconv_stage_cuda, downconv_stage_plain)
    from qpwcnet_torch.ops.cuda.upconv_kernel import (
        upconv_stage_cuda, upconv_stage_plain)
    from qpwcnet_torch.ops.cuda.warp_cv_kernel import (
        warp_cost_volume_cuda, warp_cost_volume_plain)
    from qpwcnet_torch.quantize.qlayers import same_pads
    from qpwcnet_torch.utils.cv_split import device_ms

    log(f"== phase 5: times (bf16, CUDA events, median of {N_TIMED} after "
        "warm-up; order plain, kernel, kernel, plain, reported the mean "
        "of each pair; bound = max(bytes / 3.35 TB/s, bf16 operations / "
        "989 TFLOP/s); library = one cuDNN call's time where one computes "
        "the product)")
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 4)

    def rand(shape, dtype=bf16, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)
                ).to(dtype)

    def ab(tag, kern, plain, bnd, lib=None):
        p1, k1, k2, p2 = (time_ms(plain), time_ms(kern), time_ms(kern),
                          time_ms(plain))
        k, p = (k1 + k2) / 2, (p1 + p2) / 2
        lib_ms = time_ms(lib) if lib is not None else None
        lib_txt = f" | library {lib_ms:.4f} ms" if lib is not None else ""
        log(f"  {tag}: kernel {k:.4f} ms ({k1:.4f}, {k2:.4f}) | plain "
            f"{p:.4f} ms ({p1:.4f}, {p2:.4f}) | x{p / k:.2f}{lib_txt} | "
            f"bound {max(bnd) * 1e3:.2f} us (bytes {bnd[0] * 1e3:.2f}, "
            f"ops {bnd[1] * 1e3:.2f}), kernel/bound x{k / max(bnd):.1f}")
        return k, p, lib_ms

    totals = Totals()
    with torch.inference_mode():
        # K1 at the five levels: one call (the kernels line), chained x20
        # and the device time alone (torch.profiler, every one of 20
        # kernels in its trace)
        chained = device = 0.0
        for h, w, c in CV_LEVELS:
            prv, nxt = rand((B, h, w, c)), rand((B, h, w, c))
            bnd = bound_cv(B, h, w, c)
            tag = f"K1 cost_volume ({B},{h},{w},{c})"
            k, p, _ = ab(tag, lambda: cost_volume_cuda(prv, nxt),
                         lambda: cost_volume_plain(prv, nxt), bnd)
            totals.add("cost_volume", k, p, bnd)
            kc = time_chain_ms(lambda: cost_volume_cuda(prv, nxt))
            kd = device_ms(lambda: cost_volume_cuda(prv, nxt))
            chained, device = chained + kc, device + kd
            nbytes = bnd[0] * 1e-3 * PEAK_BYTES
            log(f"    {tag}: one call {nbytes / (k * 1e-3) / 1e9:.1f} GB/s; "
                f"chained x20 {kc:.4f} ms, x{kc / max(bnd):.2f} the bound, "
                f"{nbytes / (kc * 1e-3) / 1e9:.1f} GB/s; device "
                f"{kd:.4f} ms, x{kd / max(bnd):.2f} the bound, "
                f"{nbytes / (kd * 1e-3) / 1e9:.1f} GB/s")
        r = totals.rows["cost_volume"]
        log(f"  K1 over the five levels: one call {r['ms']:.4f} ms, chained "
            f"{chained:.4f} ms, device {device:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms")
        # K2 at encoder stages 0 and 1 of the headline (the kernels line
        # sums these two) and stage 2 (Co 64, stem_stages=3)
        beats = []
        for n, ((b, h, w, cin), cout) in enumerate(
                (STEM_SHAPES[0], STEM_SHAPES[1], STEM_SHAPES[-1])):
            xs = rand((b, h, w, cin), scale=0.5)
            params = [(rand((cout, ci, 3, 3), torch.float32,
                            (9 * ci) ** -0.5),
                       rand((cout,), torch.float32, 0.1))
                      for ci in (cin, cout, cout)]
            wb = [(wt.to(bf16), bi.to(bf16)) for wt, bi in params]
            pads = same_pads(h, 3, 2)

            def cudnn_convs():
                # the three convs with their biases, no Mish: cuDNN
                y = F.pad(nchw(xs), (pads[0], pads[1], pads[0], pads[1]))
                y = F.conv2d(y, *wb[0], stride=2)
                y = F.conv2d(y, *wb[1], padding=1)
                return F.conv2d(y, *wb[2], padding=1)

            bnd = bound_stem(b, h, w, cin, cout)
            tag = f"K2 downconv_stage ({b},{h},{w},{cin})->{cout}"
            k, p, lib = ab(tag, lambda: downconv_stage_cuda(xs, params, bf16),
                           lambda: downconv_stage_plain(xs, params, bf16),
                           bnd, cudnn_convs)
            nbytes = stem_bytes(b, h, w, cin, cout)
            kc = time_chain_ms(lambda: downconv_stage_cuda(xs, params, bf16))
            lc = time_chain_ms(cudnn_convs)
            log(f"    {tag}: one call {nbytes / (k * 1e-3) / 1e9:.1f} GB/s "
                f"achieved, kernel / cuDNN x{k / lib:.2f}; chained x20 "
                f"(card time where the host keeps up): kernel {kc:.4f} ms, "
                f"x{kc / max(bnd):.1f} the bound, "
                f"{nbytes / (kc * 1e-3) / 1e9:.1f} GB/s | cuDNN {lc:.4f} ms")
            if n < 2:
                totals.add("downconv_stage", k, p, bnd, lib)
                beats.append(k < p and k < lib)
        log(f"  K2 below its plain version and cuDNN at {sum(beats)} of "
            f"{len(beats)} headline stages")
        shape = (B, 224, 512, 32)
        prv, nxt = rand(shape), rand(shape)
        flow = rand(shape[:3] + (2,), torch.float32, 3.0)
        # the bilinear warp: 4 corner products and 3 adds per channel; the
        # float32 flow read once
        bnd = bound_cv(*shape, extra_ops=7 * math.prod(shape),
                       extra_bytes=4 * 2 * math.prod(shape[:3]))
        tag = f"K3 warp_cost_volume {shape}"
        k, p, _ = ab(tag, lambda: warp_cost_volume_cuda(prv, nxt, flow),
                     lambda: warp_cost_volume_plain(prv, nxt, flow), bnd)
        totals.add("warp_cost_volume", k, p, bnd)
        kc = time_chain_ms(lambda: warp_cost_volume_cuda(prv, nxt, flow))
        kd = device_ms(lambda: warp_cost_volume_cuda(prv, nxt, flow))
        nbytes = bnd[0] * 1e-3 * PEAK_BYTES
        log(f"    {tag}: one call {nbytes / (k * 1e-3) / 1e9:.1f} GB/s, "
            f"x{k / max(bnd):.2f} the bound; chained x20 {kc:.4f} ms, "
            f"x{kc / max(bnd):.2f} the bound, "
            f"{nbytes / (kc * 1e-3) / 1e9:.1f} GB/s; device {kd:.4f} ms, "
            f"x{kd / max(bnd):.2f} the bound, "
            f"{nbytes / (kd * 1e-3) / 1e9:.1f} GB/s")
        del prv, nxt, flow
        # K4a and K4b at the five training levels: one call (the kernels
        # line), chained x20 and the device time alone (torch.profiler)
        for name, cat, kern, plain in (
                ("cost_volume_bwd_prv", "K4a", cost_volume_bwd_prv_cuda,
                 cost_volume_bwd_prv_plain),
                ("cost_volume_bwd_nxt", "K4b", cost_volume_bwd_nxt_cuda,
                 cost_volume_bwd_nxt_plain)):
            chained = device = 0.0
            for h, w, c in TRAIN_LEVELS:
                dacc, src = rand((TRAIN_B, h, w, 81)), rand((TRAIN_B, h, w, c))
                bnd = bound_cv(TRAIN_B, h, w, c)
                tag = f"{cat} {name} ({TRAIN_B},{h},{w},{c})"
                k, p, _ = ab(tag, lambda: kern(dacc, src),
                             lambda: plain(dacc, src), bnd)
                totals.add(name, k, p, bnd)
                kc = time_chain_ms(lambda: kern(dacc, src))
                kd = device_ms(lambda: kern(dacc, src))
                chained, device = chained + kc, device + kd
                nbytes = bnd[0] * 1e-3 * PEAK_BYTES
                log(f"    {tag}: one call {nbytes / (k * 1e-3) / 1e9:.1f} "
                    f"GB/s; chained x20 {kc:.4f} ms, x{kc / max(bnd):.2f} the "
                    f"bound, {nbytes / (kc * 1e-3) / 1e9:.1f} GB/s; device "
                    f"{kd:.4f} ms, x{kd / max(bnd):.2f} the bound, "
                    f"{nbytes / (kd * 1e-3) / 1e9:.1f} GB/s")
            r = totals.rows[name]
            log(f"  {cat} over the five levels: one call {r['ms']:.4f} ms, "
                f"chained {chained:.4f} ms, device {device:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms")
        del dacc, src
        # K5 at the six decoder shapes; the kernels line sums the two of
        # the interpolator's training step (its main path)
        beats_plain, beats_lib = [], []
        for n, (shape, co) in enumerate(UPCONV_SHAPES[:6]):
            xs = rand(shape)
            wt, bi = upconv_params(g, dev, shape[-1], co)
            wb = (wt.to(bf16), bi.to(bf16))
            bnd = bound_upconv(*shape, co)
            k, p, lib = ab(
                f"K5 upconv_stage {shape}->{co}",
                lambda: upconv_stage_cuda(xs, wt, bi, bf16),
                lambda: upconv_stage_plain(xs, wt, bi, bf16), bnd,
                lambda: F.conv_transpose2d(nchw(xs), *wb, stride=2,
                                           padding=1))
            gbs = upconv_bytes(*shape, co) / (k * 1e-3) / 1e9
            log(f"    K5 {shape}->{co}: {gbs:.1f} GB/s achieved "
                f"({gbs / (PEAK_BYTES / 1e9):.1%} of 3.35 TB/s), kernel / "
                f"bound x{k / max(bnd):.1f}, kernel / cuDNN x{k / lib:.2f}")
            kc = time_chain_ms(lambda: upconv_stage_cuda(xs, wt, bi, bf16))
            lc = time_chain_ms(lambda: F.conv_transpose2d(
                nchw(xs), *wb, stride=2, padding=1))
            log(f"    K5 {shape}->{co} chained x20 (card time where the host"
                f" keeps up): kernel {kc:.4f} ms, x{kc / max(bnd):.1f} the "
                f"bound, {upconv_bytes(*shape, co) / (kc * 1e-3) / 1e9:.1f} "
                f"GB/s | cuDNN {lc:.4f} ms")
            beats_plain.append(k < p)
            if shape[0] == 16:
                beats_lib.append(k <= lib)
            if n < 2:
                totals.add("upconv_stage", k, p, bnd, lib)
        del xs
        torch.cuda.empty_cache()
        log(f"  K5 below its plain version at {sum(beats_plain)} of "
            f"{len(beats_plain)} shapes, at or below cuDNN at "
            f"{sum(beats_lib)} of {len(beats_lib)} batch-16 shapes")

        fwd = {}
        for mode, kw in (("plain", dict(cv_impl="plain", stem_stages=0)),
                         ("exact", dict(cv_impl="auto", stem_stages=2)),
                         ("fast", dict(cv_impl="fast", stem_stages=2))):
            m = build(bf16, dev, **kw)
            fwd[mode] = time_ms(lambda: m(x), n=N_TIMED)
            log(f"  forward {mode} bf16 {H}x{W} b{B}: {fwd[mode]:.3f} ms, "
                f"{B / fwd[mode] * 1e3:.2f} pairs/s")
            del m
            torch.cuda.empty_cache()
        m = build(bf16, dev, cv_impl="auto", stem_stages=2)
        x1 = x[:1].contiguous()
        lat = time_ms(lambda: m(x1), n=N_TIMED)
        log(f"  forward exact bf16 {H}x{W} b1: {lat:.3f} ms")
        del m
        for mode, kw in (("plain", PLAIN_KW), ("exact", INTERP_KW)):
            m = build_interp(bf16, dev, k=1.5, **kw)
            ms = time_ms(lambda: m(ibatch["ims"]), n=N_TIMED)
            log(f"  interp forward {mode} bf16 {TRAIN_H}x{TRAIN_W} "
                f"b{INTERP_B}: {ms:.3f} ms, {INTERP_B / ms * 1e3:.2f} "
                "triplets/s")
            del m
        torch.cuda.empty_cache()

    # The train steps as the apps run them on synthetic data, one batch,
    # parameters updated every step: the flow step with the plain chain
    # and no l2 term (train_flow's synthetic default), the pretraining
    # step with the reference chain and l2 (pretrain_interp's).
    from qpwcnet_torch.train import (
        create_interp_train_state, make_flow_train_step,
        make_interp_train_step, plain_optimizer)

    step = make_flow_train_step(0.0)
    for dtype in (bf16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for mode, kw in TRAIN_MODES:
            m = build_train(dtype, dev, **kw)
            opt = plain_optimizer(m, 1e-4)
            ms = time_ms(lambda: step(m, opt, batch), n=N_STEPS_TIMED,
                         warmup=2)
            log(f"  train step {mode} {dn} {TRAIN_H}x{TRAIN_W} b{TRAIN_B}: "
                f"{ms:.3f} ms, {TRAIN_B / ms * 1e3:.2f} img/s")
            del m, opt
            torch.cuda.empty_cache()
    istep = make_interp_train_step()
    for mode, kw in (("plain", PLAIN_KW), ("exact", INTERP_KW)):
        m = build_interp(bf16, dev, k=TRAIN_K, **kw)
        opt = create_interp_train_state(m, 1e-4)
        ms = time_ms(lambda: istep(m, opt, ibatch), n=N_STEPS_TIMED,
                     warmup=2)
        log(f"  pretraining step {mode} bf16 {TRAIN_H}x{TRAIN_W} "
            f"b{INTERP_B}: {ms:.3f} ms, {INTERP_B / ms * 1e3:.2f} img/s")
        del m, opt
        torch.cuda.empty_cache()
    upconv_in_model(dev, x, ibatch)
    stem_in_model(dev, x)
    return totals.rows


def in_turns(tag, knob, runs, unit, per):
    """Time runs[0]() and runs[2]() in turns 0, 2, 2, 0 and log both
    settings of ``knob`` (ms each, ``per`` items a call in ``unit``)."""
    t = {u: [] for u in runs}
    for u in (0, 2, 2, 0):
        t[u].append(runs[u]())
    m0, m2 = (statistics.mean(t[u]) for u in (0, 2))
    log(f"    {tag}: {knob}=0 {m0:.3f} ms ({t[0][0]:.3f}, {t[0][1]:.3f}), "
        f"=2 {m2:.3f} ms ({t[2][0]:.3f}, {t[2][1]:.3f}); "
        f"{per / m0 * 1e3:.2f} vs {per / m2 * 1e3:.2f} {unit}; 2 - 0 = "
        f"{m2 - m0:+.3f} ms")


def stem_in_model(dev, x):
    """K2's effect in the exact flow forward at 448x1024 b8, bf16:
    stem_stages=0 (encoder stages 0 and 1 unfused) beside 2, all else
    equal, timed in turns 0, 2, 2, 0 on one model of each."""
    import torch

    log("  K2 in-model (stem_stages 0 beside 2, turns 0, 2, 2, 0):")
    with torch.inference_mode():
        fs = {u: build(torch.bfloat16, dev, cv_impl="auto", stem_stages=u)
              for u in (0, 2)}
        in_turns(f"flow forward exact {H}x{W} b{B}", "stem_stages",
                 {u: (lambda m=m: time_ms(lambda: m(x))) for u, m in
                  fs.items()}, "pairs/s", B)
        del fs
        torch.cuda.empty_cache()


def upconv_in_model(dev, x, ibatch):
    """K5's effect in the models, bf16: upconv_stages=0 (the decoder's
    plain stages) beside 2 (K5 at stages 2 and 3), all else equal, timed
    in turns 0, 2, 2, 0 on one model of each: the interpolator's eval
    forward and pretraining step at 256x512 b8 (INTERP_KW otherwise),
    and the exact flow forward at 448x1024 b8."""
    import torch

    from qpwcnet_torch.train import (
        create_interp_train_state, make_interp_train_step)

    bf16 = torch.bfloat16
    log("  K5 in-model (upconv_stages 0 beside 2, turns 0, 2, 2, 0):")
    ims = ibatch["ims"]
    with torch.inference_mode():
        ms = {u: build_interp(bf16, dev, k=1.5,
                              **dict(INTERP_KW, upconv_stages=u))
              for u in (0, 2)}
        in_turns(f"interp forward {TRAIN_H}x{TRAIN_W} b{INTERP_B}",
                 "upconv_stages",
                 {u: (lambda m=m: time_ms(lambda: m(ims))) for u, m in
                  ms.items()}, "triplets/s", INTERP_B)
        del ms
        fs = {u: build(bf16, dev, cv_impl="auto", stem_stages=2,
                       upconv_stages=u) for u in (0, 2)}
        in_turns(f"flow forward exact {H}x{W} b{B}", "upconv_stages",
                 {u: (lambda m=m: time_ms(lambda: m(x))) for u, m in
                  fs.items()}, "pairs/s", B)
        del fs
        torch.cuda.empty_cache()
    istep = make_interp_train_step()
    models = {u: build_interp(bf16, dev, k=TRAIN_K,
                              **dict(INTERP_KW, upconv_stages=u))
              for u in (0, 2)}
    opts = {u: create_interp_train_state(m, 1e-4) for u, m in models.items()}
    in_turns(f"pretraining step {TRAIN_H}x{TRAIN_W} b{INTERP_B}",
             "upconv_stages",
             {u: (lambda u=u: time_ms(
                 lambda: istep(models[u], opts[u], ibatch), n=N_STEPS_TIMED,
                 warmup=2)) for u in models}, "img/s", INTERP_B)
    del models, opts
    torch.cuda.empty_cache()


def main() -> int:
    if not (ROOT / "qpwcnet_torch" / "csrc").is_dir():
        fail(f"{ROOT} holds no qpwcnet_torch/csrc: run from the root of a "
             "repository checkout")
    sys.path.insert(0, str(ROOT))
    import torch

    t0 = time.perf_counter()
    kind, smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    errs = phase_kernels(dev)
    phase_kernels_bwd(dev, errs)
    phase_kernels_upconv(dev, errs)
    infer_counts, x = phase_slice(dev)
    with cudnn_deterministic():
        train_counts, batch = phase_train(dev)
        interp_paths, ibatch = phase_interp(dev, x)
    totals = phase_times(dev, x, batch, ibatch)
    log(f"== all phases passed in {time.perf_counter() - t0:.1f} s")

    paths = {"infer_app": infer_counts, "train_app": train_counts,
             **interp_paths}
    entries = []
    for name, meta in KERNELS.items():
        key = f"{name}_cuda"
        launches = sum(c[key] for c in paths.values())
        check(launches > 0, f"{name}: no launch on the main paths")
        t = totals[name]
        entries.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches,
            **{f"launches_{p}": c[key] for p, c in paths.items()},
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["t_bytes"] >= t["t_ops"]
            else "operations",
            "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
