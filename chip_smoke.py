#!/usr/bin/env python3
"""Drive the PyTorch port's flow-inference, flow-training and
frame-interpolation paths on one CUDA card.

    python3 chip_smoke.py          # from the root of a repository checkout

Phases (any failure exits non-zero; nothing is caught and carried on):
  1. device: the card's name and power limit; TF32 off.
  2. build: nvcc-builds qpwcnet_torch/csrc/*.cu (sm_90a, one nvcc per
     source, all at once) and loads the library; K1's, K2's, K3's, K4a's,
     K4b's and K5's bf16 mma.sync kernels must issue tensor-core
     instructions (HMMA in cuobjdump's SASS), every instantiation, and
     K1's, K3's, K4a's and K4b's float32 bodies none; every bf16
     instantiation of the wide stages' implicit GEMM (csrc/conv_gemm.cuh)
     must issue wgmma (HGMMA) and TMA loads (UTMALDG) and no HMMA, its
     float32 body none of them.
  3. kernel equality: each CUDA kernel against its plain PyTorch version
     at the headline shapes (448x1024 input, batch 8, so 2B = 16 through
     the encoder), at batch 1 (the infer app's) and at one shape that is
     no tile multiple, in float32 and bf16 (K1 also at the five levels of
     the training configuration, at C = 20 and on a map smaller than one
     tile; K3 also at the train step's level, at C = 20 and at C = 64,
     two chunks, each with flows inside the ±4 window and beyond it; K2
     also at a ragged Co 32 shape, and at encoder stages 2-4 (Co 64, 128,
     256) at the headline, the train step's 2B = 32 at 256x512, batch 1
     and a ragged shape, those also against the GEMM's own decomposition
     in plain PyTorch, ops/cuda/conv_gemm.py); the cost-volume backward
     kernels K4a and K4b at the five cost-volume levels of the training
     configuration (256x512, batch 16), at batch 1, at odd shapes (C % 8
     != 0 and W no multiple of 16; C = 256 in split channel groups), and
     the trainable cost volume's gradients against autograd of the plain
     cost volume at the finest training level.
  3c. K5, the fused decoder UpConv stage, against its plain version at the
     decoder's four stages of the interpolator's training step, of the
     flow headline and of batch 1 (stages 0-1 also of the flow train
     step), and at odd shapes, float32 and bf16 (stages 0-1 also against
     the GEMM's own decomposition); the trainable K5's gradients against
     autograd of the plain version.
  3d. the haloed modes of K1, K4a and K4b (nxt and dnxt of H + 8 rows:
     the spatial path's) against their haloed plain versions in float32
     and bf16 at the spatial forward's five levels (448x1024 b8 in 2 H
     shards, folded into batch 16), the train step's (256x512 b16 in 4,
     batch 64) and one odd shape; and at the headline's finest level
     split in 2 and 4 shards, the haloed K1 of every shard concatenated
     against the unhaloed K1 of the whole map (bit for bit), the shards'
     K4a outputs concatenated and their K4b outputs with the halo rows
     added back to their owners against the whole map's K4a / K4b.
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
  4d. checkpoints and the apps that need them (also under
     cudnn.deterministic): the 256x512 b16 bf16 flow model after two
     steps saved, restored on the card and onto a CPU model, all bit-equal
     (with the checkpoint's bytes and the save and restore ms); train_flow
     (bf16, b16) run 4 steps, run 2 steps, and the second resumed to 4:
     its final checkpoint bit-equal to the first's; the same for
     pretrain_interp (bf16, b8); train_flow --transfer-from-interp from
     that pretraining checkpoint; eval_sintel on a 436x1024 Sintel-layout
     fixture it writes itself ('pad' and 'resize' after recalibration,
     and without it on the card and on the CPU, within a relative 1e-4);
     infer --fast --load-ckpt at 448x1024 and interp_infer --load-ckpt:
     six more main paths, each with the launches its forwards and steps
     imply.
  4e. the fully fused configuration (stem_stages=5, upconv_stages=4: K2
     at every encoder stage, K5 at every decoder stage) on the three paths
     through the library builders, against the plain models (also under
     cudnn.deterministic): the flow forward at 448x1024 b8, exact (K1 5,
     K2 5, K5 4) and 'fast' (K1 4, K3 1, K2 5, K5 4), bf16 and float32;
     the flow train step at 256x512 b16, exact and 'fast', every gradient
     (also K4a 5, K4b 5); the interpolator at 256x512 b8: the eval
     forward, every pretraining-step gradient, the loss falling over 5
     steps, and the library entry points (2 steps and an eval forward) as
     a main path. Four main paths: fused_infer_exact, fused_infer_fast,
     fused_train and fused_interp.
  4f. the spatial (H-sharded) path at full width on the local transport
     (the H shards folded into the batch, one process, one card), under
     cudnn.deterministic, against the unsharded model (stem_stages=0,
     cv_impl='auto'): the forward at 448x1024 b8 in 2 shards (warp halo
     16; K1's haloed mode at all five levels), bf16 and float32, and the
     train step at 256x512 b16 in 4 shards (warp halo 8; the coarsest
     level falls back to the whole level's kernels), its loss, every
     gradient (phase 4b's rules) and the BatchNorm running statistics;
     the share of pixels where the window warp clamps (JAX's documented
     approximation), and the launches of K1, K4a and K4b in their haloed
     and unhaloed modes. Two main paths: spatial_infer
     (make_spatial_forward) and spatial_train (make_spatial_train_step).
  4g. the dataset paths, on fixtures it writes in a temporary directory at
     each dataset's own layout and frame size (FlyingThings3D: 17 WebP
     frames at 540x960 and their PFM flows, NaN pixels in one; Sintel: 17
     frames at 436x1024, converted by data_tools to TFRecord shards;
     Vimeo-90K: 256x448 PNG triplets; YouTube-VOS: 720x1280 JPEGs); PIL
     must decode WebP and JPEG. The flow augmentation on the card against
     the same draws on the CPU (the Sintel batch at base scale 1.0, the
     FlyingThings3D batch at 0.56, b16 -> 256x512; images within 1e-5,
     flows within 1e-4 px, each NaN sample's flow channel all 0 on both);
     then seven main paths, each with its launches: train_flow --data
     fc3d | sintel | synthetic-uniform (256x512 b16 bf16, augmentation on
     for the datasets; finite metrics and a checkpoint), pretrain_interp
     --data vimeo | ytvos | dummy (b8) and interp_infer --data vimeo (14
     PNGs); and data_tools stats, nan-scan (it must report the NaN
     sample) and preview.
  4h. the quantization slice (the block comment above phase_quant).
  4i. the last slice (under cudnn.deterministic): show_network on the
     flow net at 448x1024 and the interpolator at 256x512 (b1 bf16, with
     --trace-dir under chiprun_out/show_network/): its launches, the
     trace naming K1's kernel, and its flops equal to the CPU's count of
     the same forward plus K1's registered formula; pretrain_interp
     --debug-nan (2 steps, 256x512 b8 bf16) with its logged metrics
     bit-equal to the run without the flag, and the debug step raising
     FloatingPointError on a batch with one NaN pixel; the int8 forward at
     448x1024 b8 exact in 2 local H shards (its convs exchanging int8
     halo rows, K1's haloed mode) against the unsharded int8 forward;
     convert_quant --export at 448x1024 b1 (exact through the app, 'fast'
     through export_int8): the graphs hold qpwcnet::cost_volume x5 (x4
     and qpwcnet::warp_cost_volume x1) and each loaded .pt2 runs on the
     card bit-equal to the eager int8 forward; the last ops and losses on
     the card against the CPU at 448x1024 b8 float32. Main paths:
     show_network_flow, show_network_interp, debug_nan_pretrain,
     int8_spatial_infer and int8_export.
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
     forward) and K2's (stem_stages 0 beside 2: the exact flow forward);
     the wide stages' (K2 at stages 2-4 and K5 at stages 0-1 of the
     headline and the training steps: one call, chained, each against the
     bound and cuDNN, and each device kernel's time: the weights'
     rounding, then the GEMM of each conv); the fully fused configuration's
     in-model effect (stem_stages 2 beside 5, upconv_stages 2 beside 4,
     two rounds of turns, and the card's busy time by torch.profiler: the
     exact flow forward, the flow train step, the pretraining step); the
     haloed modes one call each (K1 at the spatial forward's five levels,
     K4a and K4b at the train step's four haloed levels) beside their
     plain versions and bounds (the halo rows counted); the sharded
     forward and train step beside the unsharded ones; the data path on
     phase 4g's fixtures: host decoding a sample, the augmentation's card
     time a batch and the batch's host-to-card copy, and the train_flow
     step fed from the FlyingThings3D loader beside the step on synthetic
     batches (wall time in turns) with its wait on the loader; the int8
     forwards (exact, 'fast', exact in 2 local H shards) beside the bf16
     one and the QAT step beside the float one; show_network's forward
     times and TFLOP/s from phase 4i.

The line before the card line is a JSON object with one entry per kernel:
its launches summed over the main paths' runs (each run with the counts
set to 0 just before it and read just after; each path's count is also
listed), its largest error in phase 3/3c, and its kernel, plain, bound
and library times summed over the shapes timed for it (K2: the
headline's five encoder stages; K5: the interpolator's four training
stages; the haloed modes: the spatial paths' levels, phase 3d's error);
the last line is {"ok": true, "device": {...}}.
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
    # the haloed modes of K1, K4a and K4b (the spatial path's)
    "cost_volume_haloed": dict(
        source="qpwcnet_torch/csrc/cost_volume.cu",
        replaces="qpwcnet_tpu/ops/pallas/cost_volume_kernel.py:504"),
    "cost_volume_bwd_prv_haloed": dict(
        source="qpwcnet_torch/csrc/cost_volume_bwd.cu",
        replaces="qpwcnet_tpu/ops/pallas/cost_volume_kernel.py:354"),
    "cost_volume_bwd_nxt_haloed": dict(
        source="qpwcnet_torch/csrc/cost_volume_bwd.cu",
        replaces="qpwcnet_tpu/ops/pallas/cost_volume_kernel.py:392"),
    # no Pallas counterpart: XLA fuses the JAX package's bias add and Mish
    "bias_mish": dict(
        source="qpwcnet_torch/csrc/bias_mish.cu",
        replaces="none (XLA fuses bias + Mish into the conv)"),
}
# The bias + Mish epilogue's shapes, (B, C, H, W) channels_last bf16:
# flower.l4's widest conv at the headline (b8, 128 channels at 224x512),
# encoder stage 1 of the train cell's step (2 x b32 frames, 16 channels
# at 192x384), and C % 8 != 0 (the element-wise body)
MISH_SHAPES = [(B, 128, H // 2, W // 2), (64, 16, 192, 384), (3, 20, 9, 11)]
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
# K5's wide stages (the implicit GEMM), decoder stages 0 and 1: the
# interpolator's training step (2B = 16 at 256x512), the flow train step
# (2B = 32), the flow headline (2B = 16 at 448x1024), batch 1 and one
# shape that is no tile multiple
UPCONV_WIDE_SHAPES = [((16, 8, 16, 256), 128), ((16, 16, 32, 256), 64),
                      ((32, 8, 16, 256), 128), ((32, 16, 32, 256), 64),
                      ((16, 14, 32, 256), 128), ((16, 28, 64, 256), 64),
                      ((2, 14, 32, 256), 128), ((2, 28, 64, 256), 64),
                      ((3, 7, 13, 256), 128), ((3, 9, 11, 256), 64)]
# K2's shapes, (B, H, W, Ci) -> Co: encoder stages 0 and 1 of the flow
# headline (2B = 16 at 448x1024) and of batch 1, one shape that is no
# tile multiple at each of Co 16 and 32, and stage 2 of the headline
# (Co 64: the implicit GEMM, as stages 3-4)
STEM_SHAPES = [((2 * B, H, W, 3), 16), ((2 * B, H // 2, W // 2, 16), 32),
               ((2, H, W, 3), 16), ((2, H // 2, W // 2, 16), 32),
               ((2, 70, 90, 3), 16), ((3, 38, 70, 16), 32),
               ((2 * B, H // 4, W // 4, 32), 64)]
# K2 at stage 2 (Co 64) of the train step (2B = 32 at 256x512), of batch
# 1 and at no tile multiple; stages 3 and 4 (the implicit GEMM in both
# dtypes) at the headline, the train step, batch 1 and no tile multiple
STEM_WIDE_SHAPES = [
    ((2 * TRAIN_B, TRAIN_H // 4, TRAIN_W // 4, 32), 64),
    ((2, H // 4, W // 4, 32), 64), ((3, 38, 70, 32), 64),
    ((2 * B, H // 8, W // 8, 64), 128), ((2 * B, H // 16, W // 16, 128), 256),
    ((2 * TRAIN_B, TRAIN_H // 8, TRAIN_W // 8, 64), 128),
    ((2 * TRAIN_B, TRAIN_H // 16, TRAIN_W // 16, 128), 256),
    ((2, H // 8, W // 8, 64), 128), ((2, H // 16, W // 16, 128), 256),
    ((3, 26, 38, 64), 128), ((3, 14, 22, 128), 256)]
# csrc/conv_gemm.cuh's modes: K2's stride-2 and stride-1 convs, K5's
# transpose conv
GEMM_MODES = {"0": "conv s2", "1": "conv s1", "2": "up"}
# The fully fused configuration: every encoder stage through K2, every
# decoder stage through K5
FUSED_KW = dict(stem_stages=5, upconv_stages=4)
# The spatial (H-sharded) path on the local transport: the headline
# forward split in 2 H shards with the default 16-row warp halo, the
# train step split in 4 with an 8-row halo (tests/test_spatial.py's)
SPATIAL_N_FWD, SPATIAL_HALO_FWD = 2, 16
SPATIAL_N_TRAIN, SPATIAL_HALO_TRAIN = 4, 8
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


def counts_of(K1=0, K2=0, K3=0, K4a=0, K4b=0, K5=0, K1h=0, K4ah=0,
              K4bh=0) -> dict:
    """Launch counts by wrapper name (qpwcnet_torch.ops.cuda); K1h,
    K4ah, K4bh: the haloed modes."""
    return {"cost_volume_cuda": K1, "downconv_stage_cuda": K2,
            "warp_cost_volume_cuda": K3, "cost_volume_bwd_prv_cuda": K4a,
            "cost_volume_bwd_nxt_cuda": K4b, "upconv_stage_cuda": K5,
            "cost_volume_haloed_cuda": K1h,
            "cost_volume_bwd_prv_haloed_cuda": K4ah,
            "cost_volume_bwd_nxt_haloed_cuda": K4bh}


def k_only(counts: dict) -> dict:
    """The K1-K5 wrappers' part of a launch_counts() reading, which the
    paths' checks compare with counts_of(); main() checks the bias + Mish
    kernels' part on every path."""
    return {k: counts[k] for k in counts_of()}


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
    """Count tensor-core instructions in K1's, K2's, K3's, K4a's, K4b's
    and K5's kernels in the built library's SASS: each bf16 mma.sync
    instantiation must issue HMMA, and K1's, K3's, K4a's and K4b's float32
    bodies (CUDA-core FMAs) none; each bf16 instantiation of the wide
    stages' GEMM must issue wgmma (HGMMA) and TMA loads (UTMALDG) and no
    HMMA, its float32 body none of the three, and the old mma.sync GEMM
    (conv_gemm_mma_kernel) must be gone."""
    import re

    cuobjdump = bin_dir / "cuobjdump"
    if not cuobjdump.exists():
        log(f"  {cuobjdump} not found: the SASS check is skipped")
        return
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    counts, ops, name = {}, {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
            ops[name] = dict(HMMA=0, HGMMA=0, UTMALDG=0)
        elif name:
            for op in ops[name]:
                if op in line:
                    ops[name][op] += 1
            counts[name] = ops[name]["HMMA"]
    mma, f32, stem, stem32, cv, cv32 = {}, {}, {}, {}, {}, {}
    bwd, bwd32, wcv, wcv32, gemm, gemm32 = {}, {}, {}, {}, {}, {}
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
        m = re.search(r"conv_gemm_wgmma_kernelILi(\d)ELi(\d+)ELi(\d+)E",
                      name)
        if m:
            gemm[f"{GEMM_MODES[m[1]]} {m[2]}x{m[3]}"] = ops[name]
        m = re.search(r"conv_gemm_f32_kernelILi(\d)E", name)
        if m:
            gemm32[GEMM_MODES[m[1]]] = ops[name]
    log(f"  SASS HMMA count: K1 bf16 {cv}, K1 float32 {cv32}")
    log(f"  SASS HMMA count: K3 bf16 {wcv}, K3 float32 {wcv32}")
    log(f"  SASS HMMA count: K4 bf16 {bwd}, K4 float32 {bwd32}")
    log(f"  SASS HMMA count: K5 bf16 {mma}, K5 float32 {f32}")
    log(f"  SASS HMMA count: K2 bf16 {stem}, K2 float32 {stem32}")
    log(f"  SASS HGMMA / UTMALDG / HMMA count: the wide stages' GEMM (K2 "
        f"stages 2-4: conv s2, s1; K5 stages 0-1: up; BM x BN) bf16 {gemm},"
        f" float32 {gemm32}")
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
    check(len(stem) == 4 and all(n > 0 for n in stem.values()),
          f"K2's bf16 body issues no HMMA: {stem}")
    check(len(gemm) == 9 and all(
        o["HGMMA"] > 0 and o["UTMALDG"] > 0 and o["HMMA"] == 0
        for o in gemm.values()),
          f"the wide stages' bf16 GEMM is not wgmma fed by TMA: {gemm}")
    check(len(gemm32) == 3 and all(
        not any(o.values()) for o in gemm32.values()),
          f"the wide stages' float32 GEMM is not the CUDA-core one: {gemm32}")
    old = [n for n in counts if "conv_gemm_mma_kernel" in n]
    check(not old, f"the mma.sync GEMM is still in the library: {old}")


def phase_kernels(dev):
    import torch

    from qpwcnet_torch.ops.cost_volume import cost_volume_plain
    from qpwcnet_torch.ops.cuda.cost_volume_kernel import cost_volume_cuda
    from qpwcnet_torch.ops.cuda.conv_gemm import downconv_stage_gemm_plain
    from qpwcnet_torch.ops.cuda.stem_kernel import (
        STEM_GEMM_CHANNELS, downconv_stage_cuda, downconv_stage_plain)
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
        for (b, h, w, cin), cout in STEM_SHAPES + STEM_WIDE_SHAPES:
            x = rand((b, h, w, cin), dtype, 0.5)
            params = [(rand((cout, ci, 3, 3), torch.float32,
                            (9 * ci) ** -0.5),
                       rand((cout,), torch.float32, 0.1))
                      for ci in (cin, cout, cout)]
            # bf16: a one-ulp rounding flip in conv_a or conv_aa moves the
            # later convs' sums across rounding points too: 4 ulps
            got = downconv_stage_cuda(x, params, dtype)
            want = downconv_stage_plain(x, params, dtype)
            rel_k2 = rel if dtype == torch.float32 else 4 * REL_BF16
            compare(f"K2 downconv_stage {dn} ({b},{h},{w},{cin})->{cout}",
                    got, want, rel_k2, errs, "downconv_stage")
            if dtype == torch.bfloat16:
                log(f"    {bf16_ulps(got, want)}")
            if cout in STEM_GEMM_CHANNELS[dtype]:
                # the GEMM's own decomposition (conv_gemm.py), in plain
                # PyTorch: the same boxes, views and weight layout
                want = downconv_stage_gemm_plain(x, params, dtype)
                compare(f"K2 downconv_stage {dn} ({b},{h},{w},{cin})->"
                        f"{cout} vs conv_gemm_plain", got, want, rel_k2,
                        errs, "downconv_stage")
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
    check(k_only(counts) == counts_of(K1=1, K4a=1, K4b=1),
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
    from qpwcnet_torch.ops.cuda.conv_gemm import upconv_stage_gemm_plain
    from qpwcnet_torch.ops.cuda.upconv_kernel import (
        UPCONV_GEMM_CHANNELS, upconv_stage_cuda, upconv_stage_plain,
        upconv_stage_trainable)

    log("== phase 3c: K5 upconv_stage against its plain version, tolerance "
        f"{REL_F32:g} (f32) / {2 * REL_BF16:g} (bf16: two ulps, since a "
        "one-ulp flip of the rounded sum moves the bias add's and Mish's "
        "roundings too) of max(1, max|plain|)")
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    for dtype in (torch.float32, torch.bfloat16):
        rel = REL_F32 if dtype == torch.float32 else 2 * REL_BF16
        dn = str(dtype).split(".")[-1]
        for shape, co in UPCONV_SHAPES + UPCONV_WIDE_SHAPES:
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            w, b = upconv_params(g, dev, shape[-1], co)
            got = upconv_stage_cuda(x, w, b, dtype)
            want = upconv_stage_plain(x, w, b, dtype)
            compare(f"K5 upconv_stage {dn} {shape}->{co}", got, want, rel,
                    errs, "upconv_stage")
            if dtype == torch.bfloat16:
                log(f"    {bf16_ulps(got, want)}")
            if co in UPCONV_GEMM_CHANNELS:
                compare(f"K5 upconv_stage {dn} {shape}->{co} vs "
                        "conv_gemm_plain", got,
                        upconv_stage_gemm_plain(x, w, b, dtype), rel, errs,
                        "upconv_stage")
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
        counts = kernels.launch_counts()
        check(k_only(counts) == counts_of(K5=int(fn == "kernel")),
              f"trainable K5 {fn}: launches {counts}")
        grads.append([t.grad for t in leaves])
    for name, got, want in zip(("x", "weight", "bias"), *grads):
        compare(f"upconv_stage_trainable d{name} f32 {shape}->{co} vs "
                "autograd of upconv_stage_plain", got, want, REL_F32, {},
                "function")
    del x, w, b, gout, grads, leaves, y
    torch.cuda.empty_cache()


def phase_kernels_mish(dev, errs):
    """Phase 3e: the bias + Mish kernels. The forward against the
    composition bit for bit (bf16 and float32); the backward's dx against
    its PyTorch statement (bias_mish_backward_plain, the same float32
    operations: one bf16 ulp of the magnitude at most) and dbias within
    1e-5 of it (another summation order), repeated bit for bit."""
    import torch

    from qpwcnet_torch.ops.cuda.mish_kernel import (
        bias_mish_backward_plain, bias_mish_bwd_cuda, bias_mish_cuda,
        bias_mish_plain)

    log("== phase 3e: bias + Mish (forward bit for bit, backward against "
        "its plain statement)")
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    cl = torch.channels_last
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for shape in MISH_SHAPES:
            x = (6 * torch.randn(shape, generator=g, device=dev)).to(
                dtype).contiguous(memory_format=cl)
            b = torch.randn(shape[1], generator=g, device=dev)
            compare(f"bias_mish forward {dn} {shape}", bias_mish_cuda(x, b),
                    bias_mish_plain(x, b), 0.0, errs, "bias_mish")
            gr = torch.randn(shape, generator=g, device=dev).to(
                dtype).contiguous(memory_format=cl)
            dx, db = bias_mish_bwd_cuda(x, b, gr)
            want = bias_mish_backward_plain(x, b, gr)
            compare(f"bias_mish backward dx {dn} {shape}", dx, want[0],
                    REL_BF16 if dtype == torch.bfloat16 else 0.0, {},
                    "bias_mish_bwd")
            compare(f"bias_mish backward dbias {dn} {shape}", db, want[1],
                    1e-5, {}, "bias_mish_bwd")
            again = bias_mish_bwd_cuda(x, b, gr)
            check(torch.equal(again[0], dx) and torch.equal(again[1], db),
                  f"bias_mish backward {dn} {shape}: not repeatable")
            del x, gr, dx, db, want, again
        torch.cuda.empty_cache()


def halo_shards(x, n, r=4):
    """The n H shards of x (B, H, W, C), each with the r rows of its
    neighbours above and below (zeros at the global ends): a list of
    (B, H/n + 2r, W, C) tensors, as the spatial path's exchange builds
    them."""
    import torch.nn.functional as F

    hl = x.shape[1] // n
    pad = F.pad(x, (0, 0, 0, 0, r, r))
    return [pad[:, s * hl:s * hl + hl + 2 * r].contiguous()
            for s in range(n)]


def spatial_levels():
    """(B, h, w, C) of the haloed kernels' calls on the spatial paths: the
    headline's five levels split in SPATIAL_N_FWD H shards folded into the
    batch, and the train step's split in SPATIAL_N_TRAIN."""
    return ([(SPATIAL_N_FWD * B, h // SPATIAL_N_FWD, w, c)
             for h, w, c in CV_LEVELS],
            [(SPATIAL_N_TRAIN * TRAIN_B, h // SPATIAL_N_TRAIN, w, c)
             for h, w, c in TRAIN_LEVELS])


def phase_kernels_haloed(dev, errs):
    """Phase 3d: the haloed modes of K1, K4a and K4b against their plain
    versions, and the shards of a map against the whole map."""
    import torch

    from qpwcnet_torch.ops.cost_volume import (
        cost_volume_bwd_nxt_plain, cost_volume_bwd_prv_plain,
        cost_volume_plain_haloed)
    from qpwcnet_torch.ops.cuda.cost_volume_kernel import (
        cost_volume_bwd_nxt_cuda, cost_volume_bwd_nxt_haloed_cuda,
        cost_volume_bwd_prv_cuda, cost_volume_bwd_prv_haloed_cuda,
        cost_volume_cuda, cost_volume_haloed_cuda)

    log("== phase 3d: the haloed kernel modes (nxt of H + 8 rows; dnxt of "
        "H + 8 rows) against their plain versions, phase 3's tolerances, "
        f"at the spatial forward's levels ({H}x{W} b{B} in "
        f"{SPATIAL_N_FWD} shards), the train step's ({TRAIN_H}x{TRAIN_W} "
        f"b{TRAIN_B} in {SPATIAL_N_TRAIN}) and one odd shape")
    g = torch.Generator(device=dev).manual_seed(SEED + 8)

    def rand(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    fwd_levels, train_levels = spatial_levels()
    for dtype in (torch.float32, torch.bfloat16):
        rel = REL_F32 if dtype == torch.float32 else REL_BF16
        dn = str(dtype).split(".")[-1]
        for b, h, w, c in fwd_levels + train_levels + [(3, 13, 37, 24)]:
            prv = rand((b, h, w, c), dtype)
            nxt_h = rand((b, h + 8, w, c), dtype)
            dacc = rand((b, h, w, 81), dtype)
            compare(f"K1 haloed {dn} ({b},{h},{w},{c})",
                    cost_volume_haloed_cuda(prv, nxt_h),
                    cost_volume_plain_haloed(prv, nxt_h), rel, errs,
                    "cost_volume_haloed")
            compare(f"K4a haloed {dn} ({b},{h},{w},{c})",
                    cost_volume_bwd_prv_haloed_cuda(dacc, nxt_h),
                    cost_volume_bwd_prv_plain(dacc, nxt_h, True), rel, errs,
                    "cost_volume_bwd_prv_haloed")
            compare(f"K4b haloed {dn} ({b},{h},{w},{c})",
                    cost_volume_bwd_nxt_haloed_cuda(dacc, prv),
                    cost_volume_bwd_nxt_plain(dacc, prv, True), rel, errs,
                    "cost_volume_bwd_nxt_haloed")
            del prv, nxt_h, dacc
        torch.cuda.empty_cache()

        # Shard equivalence at the headline's finest level: each shard's
        # haloed K1, concatenated, is the unhaloed K1 of the whole map bit
        # for bit (each pixel has the same products in the same order);
        # the shards' K4a outputs, concatenated, and their K4b outputs
        # with the halo rows added back to their owners (float32 adds, as
        # the exchange's backward sums them) are the whole map's.
        b, (h, w, c), r = B, CV_LEVELS[-1], 4
        prv, nxt = rand((b, h, w, c), dtype), rand((b, h, w, c), dtype)
        dacc = rand((b, h, w, 81), dtype)
        whole = {"K1": cost_volume_cuda(prv, nxt),
                 "K4a": cost_volume_bwd_prv_cuda(dacc, nxt),
                 "K4b": cost_volume_bwd_nxt_cuda(dacc, prv)}
        for n in (2, 4):
            hl = h // n
            rows = [slice(s * hl, (s + 1) * hl) for s in range(n)]
            halos = halo_shards(nxt, n, r)
            k1 = torch.cat([cost_volume_haloed_cuda(
                prv[:, rs].contiguous(), nh) for rs, nh in zip(rows, halos)],
                1)
            torch.cuda.synchronize()
            same = torch.equal(k1, whole["K1"])
            log(f"  K1 {dn}: {n} haloed shards concatenated "
                f"{'==' if same else '!='} the whole map's K1, bit for bit "
                f"(max_abs_err {max_err(k1, whole['K1']):.3e})")
            check(same, f"K1 {dn}: {n} shards differ from the whole map")
            k4a = torch.cat([cost_volume_bwd_prv_haloed_cuda(
                dacc[:, rs].contiguous(), nh) for rs, nh in zip(rows, halos)],
                1)
            compare(f"K4a {dn}: {n} haloed shards vs the whole map", k4a,
                    whole["K4a"], rel, {}, "shards")
            k4b = torch.zeros((b, h + 2 * r, w, c), device=dev)
            for s, rs in enumerate(rows):
                k4b[:, s * hl:s * hl + hl + 2 * r] += \
                    cost_volume_bwd_nxt_haloed_cuda(
                        dacc[:, rs].contiguous(),
                        prv[:, rs].contiguous()).float()
            compare(f"K4b {dn}: {n} haloed shards, halo rows added back, vs "
                    "the whole map", k4b[:, r:-r], whole["K4b"], rel, {},
                    "shards")
            del halos, k1, k4a, k4b
        del prv, nxt, dacc, whole
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
                want = expected.get(mode, counts_of())
                log(f"  {mode} {dn}: launches {counts} "
                    f"mean|flow|={float(out.abs().mean()):.3f} px")
                check(k_only(counts) == want, f"{mode} {dn}: launches "
                      f"{counts}, expected {want}")
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

        check_replays(dev, x)

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
        check(k_only(main_counts) == counts_of(K1=8, K2=4, K3=2),
              f"infer launches {main_counts}")
        # bias + Mish after each of the 38 Mish convs that run as modules
        # at stem_stages=2, in each of the 2 forwards
        check((main_counts["bias_mish_cuda"],
               main_counts["bias_mish_bwd_cuda"]) == (2 * 38, 0),
              f"infer bias + Mish launches {main_counts}")
    return main_counts, x


def check_replays(dev, x, n=6):
    """The benchmark's main path at the headline shape (bf16, exact and
    'fast', under the caller's inference_mode): n calls on distinct
    inputs, x first; the first runs eagerly, the second captures the
    forward's CUDA graph and the rest copy their input in and replay.
    Every output, all held to the end, is bit for bit the eager forward
    of its input; the replays count n - 2 and the kernel launches n
    forwards."""
    import torch

    from qpwcnet_torch.ops import cuda as kernels
    from qpwcnet_torch.utils import tracing

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    xs = [x] + [torch.rand(x.shape, generator=g, device=dev) - 0.5
                for _ in range(n - 1)]
    for mode, kw, per in (
            ("exact", dict(cv_impl="auto", stem_stages=2),
             dict(K1=5, K2=2)),
            ("fast", dict(cv_impl="fast", stem_stages=2),
             dict(K1=4, K2=2, K3=1))):
        m = build(torch.bfloat16, dev, **kw)
        before = tracing.counts().get("flow_net.graph_replays", 0)
        kernels.reset_launch_counts()
        outs = [m(xi) for xi in xs]
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        replays = tracing.counts().get("flow_net.graph_replays", 0) - before
        same = [torch.equal(o, m._forward(xi, False))
                for o, xi in zip(outs, xs)]
        log(f"  {mode} bf16 replays: {n} calls, {replays} replays, "
            f"bit for bit eager {same}, launches {counts}")
        check(replays == n - 2, f"{mode} replays: {replays} of {n} calls")
        check(all(same), f"{mode} replay against eager: {same}")
        want = counts_of(**{k: n * v for k, v in per.items()})
        check(k_only(counts) == want and counts["bias_mish_cuda"] == n * 38,
              f"{mode} replays: launches {counts}, expected {want} and "
              f"{n} x 38 bias + Mish")
        del m, outs
    torch.cuda.empty_cache()


def train_batch(dev, seed):
    """A synthetic training batch at the training configuration."""
    import torch

    from qpwcnet_torch.data import preprocess_flow_batch, synthetic_flow_batch

    gen = torch.Generator(device=dev).manual_seed(seed)
    ims_u8, flo = synthetic_flow_batch(gen, TRAIN_B, TRAIN_H, TRAIN_W)
    return preprocess_flow_batch(ims_u8, flo, out_hw=(TRAIN_H, TRAIN_W))


def build_train(dtype, dev, k=TRAIN_K, **kw):
    return build(dtype, dev, hw=(TRAIN_H, TRAIN_W), k=k, **kw)


@contextlib.contextmanager
def plain_epilogue():
    """Every caller of the bias + Mish epilogue (each looks up
    ``mish_kernel.bias_mish_cuda``) runs the composition
    (``mish_kernel.bias_mish_plain``) instead of the kernels: a plain
    model then runs no hand-written kernel, so the gradient checks hold
    the kernel models, the bias + Mish kernels among them, against plain
    PyTorch."""
    from qpwcnet_torch.ops.cuda import mish_kernel

    saved = mish_kernel.bias_mish_cuda
    mish_kernel.bias_mish_cuda = mish_kernel.bias_mish_plain
    try:
        yield
    finally:
        mish_kernel.bias_mish_cuda = saved


def grad_step(model, batch, make_step=None, plain=False):
    """One train step (make_flow_train_step unless ``make_step`` names
    another step maker) with the plain chain at learning rate 0, so the
    parameters stay as they were; ``plain``: under plain_epilogue().
    Returns (loss, {name: grad}, launch counts of the step)."""
    import torch

    from qpwcnet_torch.ops import cuda as kernels
    from qpwcnet_torch.train import make_flow_train_step, plain_optimizer

    opt = plain_optimizer(model, 0.0)
    kernels.reset_launch_counts()
    with plain_epilogue() if plain else contextlib.nullcontext():
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
            loss, grads[mode], counts = grad_step(m, batch,
                                                  plain=mode == "plain")
            log(f"  {mode} {dn}: loss {loss:.6f}, launches {counts}")
            check(np.isfinite(loss), f"{mode} {dn}: loss {loss}")
            check(k_only(counts) == per_step[mode], f"{mode} {dn}: launches "
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
                                            batch, plain=True)
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
        _, grads[mode], counts = grad_step(m, batch, plain=mode == "plain")
        check(k_only(counts) == per_step[mode],
              f"fresh {mode}: launches {counts}")
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
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launch_counts()
        metrics = train_flow.main([
            "--data", "synthetic", "--steps", str(steps), "--curriculum", "",
            "--batch-size", str(TRAIN_B), "--height", str(TRAIN_H),
            "--width", str(TRAIN_W), "--log-every", str(log_every),
            "--recalibrate-final", str(recal), "--device", str(dev),
            "--run-root", tmp])
        torch.cuda.synchronize()
        main_counts = kernels.launch_counts()
    log(f"  train app: last step {metrics}, launches {main_counts}")
    check(all(np.isfinite(v) for v in metrics.values()), "train app loss")
    # K1 in every forward (steps, held-out evals, recalibration passes),
    # K4a and K4b in every step's backward; cv_impl='auto', stem_stages=0
    n_fwd = steps + steps // log_every + recal
    check(k_only(main_counts) == counts_of(K1=5 * n_fwd, K4a=5 * steps,
                                           K4b=5 * steps),
          f"train app launches {main_counts}")
    # bias + Mish after each of the 44 Mish convs (stem_stages=0) in every
    # forward, and their backward in every step
    check((main_counts["bias_mish_cuda"],
           main_counts["bias_mish_bwd_cuda"]) == (44 * n_fwd, 44 * steps),
          f"train app bias + Mish launches {main_counts}")
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
                check(k_only(counts) == want, f"interp {mode} {dn}: launches "
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
            check(k_only(counts) == want, f"flow net upconv_stages=2 {mode}: "
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
                                                  make_interp_train_step,
                                                  plain=mode == "plain")
            want = per_step if mode == "exact" else counts_of()
            log(f"  pretraining step {mode} {dn}: loss {loss:.6f}, "
                f"launches {counts}")
            check(np.isfinite(loss), f"interp {mode} {dn}: loss {loss}")
            check(k_only(counts) == want, f"interp step {mode} {dn}: launches "
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
    check(k_only(interp_counts) == counts_of(K1=5 * n_fwd, K2=2 * n_fwd,
                                     K5=2 * n_fwd, K4a=5 * n_steps,
                                     K4b=5 * n_steps),
          f"interp main path launches {interp_counts}")
    del model, opt, img
    torch.cuda.empty_cache()

    steps, log_every, recal = 4, 2, 4
    log(f"  pretrain app: --steps {steps} at {TRAIN_H}x{TRAIN_W} "
        f"b{INTERP_B} (a main path)")
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launch_counts()
        metrics = pretrain_interp.main([
            "--steps", str(steps), "--batch-size", str(INTERP_B),
            "--height", str(TRAIN_H), "--width", str(TRAIN_W),
            "--log-every", str(log_every), "--recalibrate-final", str(recal),
            "--device", str(dev), "--run-root", tmp])
        torch.cuda.synchronize()
        app_counts = kernels.launch_counts()
    log(f"  pretrain app: last logged {metrics}, launches {app_counts}")
    check(all(np.isfinite(v) for v in metrics.values())
          and "mse_eval" in metrics, "pretrain app metrics")
    # K1 in every forward (steps, held-out evals, recalibration passes),
    # K4a and K4b in every step's backward; cv_impl='auto', no stem or
    # upconv kernels (the JAX app's model)
    n_fwd = steps + steps // log_every + recal
    check(k_only(app_counts) == counts_of(K1=5 * n_fwd, K4a=5 * steps,
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
    check(k_only(infer_counts) == counts_of(K1=10), f"interp_infer launches "
          f"{infer_counts}")
    return {"interp": interp_counts, "pretrain_app": app_counts,
            "interp_infer_app": infer_counts}, batch


def phase_fused(dev, x, batch, ibatch):
    """Phase 4e: the fully fused configuration (FUSED_KW: K2 at every
    encoder stage, K5 at every decoder stage) on the three paths at full
    width and depth, against the plain models: the flow forward at
    448x1024 b8, the flow train step at 256x512 b16 and the interpolator
    at 256x512 b8 (eval forward, pretraining step, 5 steps of loss). Each
    path's launches, counted from 0 just before it, feed the kernels
    line."""
    import numpy as np
    import torch

    from qpwcnet_torch.models import build_interpolator
    from qpwcnet_torch.ops import cuda as kernels
    from qpwcnet_torch.train import (
        create_interp_train_state, make_interp_train_step, plain_optimizer)

    log(f"== phase 4e: the fully fused configuration {FUSED_KW} against "
        f"{PLAIN_KW}")
    t_phase = time.perf_counter()
    bf16, f32 = torch.bfloat16, torch.float32
    paths = {}
    fwd = {"exact": counts_of(K1=5, K2=5, K5=4),
           "fast": counts_of(K1=4, K2=5, K3=1, K5=4)}
    with torch.inference_mode():
        for dtype in (bf16, f32):
            dn = str(dtype).split(".")[-1]
            want = build(dtype, dev, **PLAIN_KW)(x)
            for mode, cv in (("exact", "auto"), ("fast", "fast")):
                m = build(dtype, dev, cv_impl=cv, **FUSED_KW)
                kernels.reset_launch_counts()
                out = m(x)
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
                log(f"  flow forward {mode} {dn} {H}x{W} b{B}: launches "
                    f"{counts}, mean|flow|={float(out.abs().mean()):.3f} px")
                check(k_only(counts) == fwd[mode], f"fused flow forward "
                      f"{mode} {dn}: launches {counts}, expected {fwd[mode]}")
                if dtype == bf16:
                    paths[f"fused_infer_{mode}"] = counts
                if mode == "exact":
                    compare_model(f"fused flow exact vs plain {dn}", out,
                                  want, dtype)
                else:
                    log(f"  fused fast vs plain {dn} (window-warp clamp at "
                        f"±4): max {max_err(out, want):.3e} px")
                del m, out
            del want
            torch.cuda.empty_cache()

    # The flow train step: every gradient against the plain model's.
    per_step = {"exact": counts_of(K1=5, K2=5, K5=4, K4a=5, K4b=5),
                "fast": counts_of(K1=5, K2=5, K3=1, K5=4, K4a=5, K4b=5),
                "plain": counts_of()}
    plain32 = None
    for dtype in (f32, bf16):
        dn = str(dtype).split(".")[-1]
        grads = {}
        for mode, kw in (("exact", dict(cv_impl="auto", **FUSED_KW)),
                         ("fast", dict(cv_impl="fast", **FUSED_KW)),
                         ("plain", PLAIN_KW)):
            m = build_train(dtype, dev, **kw)
            loss, grads[mode], counts = grad_step(m, batch,
                                                  plain=mode == "plain")
            log(f"  train step {mode} {dn}: loss {loss:.6f}, launches "
                f"{counts}")
            check(np.isfinite(loss), f"fused {mode} {dn}: loss {loss}")
            check(k_only(counts) == per_step[mode], f"fused train step "
                  f"{mode} {dn}: launches {counts}, expected {per_step[mode]}")
            if dtype == bf16 and mode == "exact":
                paths["fused_train"] = counts
            del m
            torch.cuda.empty_cache()
        for mode in ("exact", "fast"):
            compare_grads(f"fused {mode} vs plain grads {dn}", grads[mode],
                          grads["plain"], plain32)
        plain32 = grads["plain"]
        del grads
    del plain32

    # The interpolator: the eval forward and one pretraining step against
    # the plain interpolator, then the loss over 5 steps.
    with torch.inference_mode():
        for dtype in (bf16, f32):
            dn = str(dtype).split(".")[-1]
            outs = {}
            for mode, kw in (("fused", dict(cv_impl="auto", **FUSED_KW)),
                             ("plain", PLAIN_KW)):
                m = build_interp(dtype, dev, k=1.5, **kw)
                kernels.reset_launch_counts()
                outs[mode] = m(ibatch["ims"], return_flows=True)
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
                want = fwd["exact"] if mode == "fused" else counts_of()
                check(k_only(counts) == want, f"interp {mode} {dn}: launches "
                      f"{counts}, expected {want}")
                del m
            compare_model(f"fused interp image vs plain {dn}",
                          outs["fused"][0], outs["plain"][0], dtype)
            for d, name in enumerate(("flos_01", "flos_10")):
                worst = max(range(6), key=lambda i: max_err(
                    outs["fused"][1][d][i], outs["plain"][1][d][i]))
                compare_model(f"fused interp {name}[{worst}] (worst of 6) "
                              f"vs plain {dn}", outs["fused"][1][d][worst],
                              outs["plain"][1][d][worst], dtype)
            del outs
            torch.cuda.empty_cache()
    plain32 = None
    for dtype in (f32, bf16):
        dn = str(dtype).split(".")[-1]
        grads = {}
        for mode, kw in (("fused", dict(cv_impl="auto", **FUSED_KW)),
                         ("plain", PLAIN_KW)):
            m = build_interp(dtype, dev, k=TRAIN_K, **kw)
            loss, grads[mode], counts = grad_step(m, ibatch,
                                                  make_interp_train_step,
                                                  plain=mode == "plain")
            want = per_step["exact"] if mode == "fused" else counts_of()
            log(f"  pretraining step {mode} {dn}: loss {loss:.6f}, "
                f"launches {counts}")
            check(np.isfinite(loss), f"interp {mode} {dn}: loss {loss}")
            check(k_only(counts) == want, f"fused pretraining step {mode} "
                  f"{dn}: launches {counts}, expected {want}")
            del m
            torch.cuda.empty_cache()
        compare_grads(f"fused interp vs plain grads {dn}", grads["fused"],
                      grads["plain"], plain32)
        plain32 = grads["plain"]
        del grads
    del plain32
    m = build_interp(f32, dev, k=0.0, head_scale="unit", residual=True,
                     cv_impl="auto", **FUSED_KW)
    opt = plain_optimizer(m, 3e-4)
    step = make_interp_train_step()
    losses = [float(step(m, opt, ibatch)["loss"]) for _ in range(5)]
    log(f"  fused interp float32 ('unit' heads, residual), 5 steps on one "
        f"batch (Adam 3e-4): losses {[round(v, 6) for v in losses]}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"fused interp loss did not fall: {losses}")
    del m, opt
    torch.cuda.empty_cache()

    # The library entry points, as phase 4c's main path: 2 pretraining
    # steps on fresh augmented batches and one eval forward, bf16.
    n_steps = 2
    kernels.reset_launch_counts()
    model = build_interpolator(SEED, dev, dtype=bf16, cv_impl="auto",
                               **FUSED_KW)
    opt = create_interp_train_state(model, 1e-4)
    step = make_interp_train_step()
    metrics = [step(model, opt, interp_batch(dev, SEED + 9 + i, True))
               for i in range(n_steps)]
    model.eval()
    with torch.no_grad():
        img = model(ibatch["ims"])
    torch.cuda.synchronize()
    paths["fused_interp"] = kernels.launch_counts()
    losses = [float(mt["loss"]) for mt in metrics]
    log(f"  fused interp main path: losses {losses}, launches "
        f"{paths['fused_interp']}")
    check(all(np.isfinite(losses)) and bool(torch.isfinite(img).all()),
          "fused interp main path: non-finite")
    n_fwd = n_steps + 1
    check(k_only(paths["fused_interp"]) == counts_of(
        K1=5 * n_fwd, K2=5 * n_fwd, K5=4 * n_fwd, K4a=5 * n_steps,
        K4b=5 * n_steps), f"fused interp main path launches "
          f"{paths['fused_interp']}")
    del model, opt, img
    torch.cuda.empty_cache()
    log(f"  phase 4e wall time {time.perf_counter() - t_phase:.1f} s")
    return paths


def warp_clamp_share(flows, halo, n, h) -> str:
    """The share of the pixels whose flow into a windowed warp (a level
    whose shards hold at least ``halo`` rows) has |flow_y| > halo: where
    the spatial path's window clamps, JAX's documented approximation.
    ``flows``: the unsharded model's multiscale flows, coarse to fine;
    UpFlow i reads 2x flows[i] upsampled."""
    parts = []
    for i, f in enumerate(flows[:-2]):
        rows = 2 * f.shape[1]
        if rows // n < halo:
            continue
        share = float((2.0 * f[..., 1].abs() > halo).float().mean())
        parts.append(f"{rows}x{2 * f.shape[2]} {share:.4%}")
    return (", ".join(parts) or "no windowed level") + \
        f" (rows {h}, {n} shards, halo {halo})"


def spatial_counts(h, n, step=False) -> dict:
    """The launches of one sharded forward (and with ``step`` its
    backward) at input height h in n shards: the levels with 4 rows a
    shard or more (r = 4) take the haloed modes, the coarser ones fall
    back to the whole level's unhaloed kernels."""
    whole = sum((h >> (5 - i)) // n < 4 for i in range(5))
    bwd = dict(K4a=whole, K4b=whole, K4ah=5 - whole, K4bh=5 - whole)
    return counts_of(K1=whole, K1h=5 - whole, **(bwd if step else {}))


def phase_spatial(dev, x, batch):
    """Phase 4f: the spatial (H-sharded) path at full width on the local
    transport (the shards folded into the batch), against the unsharded
    model: the forward (n = 2, warp halo 16) and the train step (n = 4,
    warp halo 8), each through the library's entry points as a main
    path."""
    import numpy as np
    import torch

    from qpwcnet_torch.ops import cuda as kernels
    from qpwcnet_torch.parallel import (
        SpatialConfig, make_mesh, make_spatial_forward,
        make_spatial_train_step, shard_batch_spatial, unshard_batch_spatial)
    from qpwcnet_torch.train import make_flow_train_step

    t_phase = time.perf_counter()
    log(f"== phase 4f: the spatial (H-sharded) path, local transport: the "
        f"forward at {H}x{W} b{B} in {SPATIAL_N_FWD} shards (warp halo "
        f"{SPATIAL_HALO_FWD}), the train step at {TRAIN_H}x{TRAIN_W} "
        f"b{TRAIN_B} in {SPATIAL_N_TRAIN} (halo {SPATIAL_HALO_TRAIN}), "
        "against the unsharded model (stem_stages=0, cv_impl='auto')")
    bf16, f32 = torch.bfloat16, torch.float32
    paths = {}

    n, halo = SPATIAL_N_FWD, SPATIAL_HALO_FWD
    mesh = make_mesh(n_data=1, n_model=n)
    fwd = make_spatial_forward(lambda m, ims: m(ims), mesh)
    xs = shard_batch_spatial(x, mesh)
    with torch.inference_mode():
        for dtype in (bf16, f32):
            dn = str(dtype).split(".")[-1]
            ref = build(dtype, dev, cv_impl="auto", stem_stages=0)
            flows = ref(x, multiscale=True)
            want = flows[-1]
            sp = build(dtype, dev, cv_impl="auto",
                       spatial=SpatialConfig(mesh, warp_halo=halo))
            kernels.reset_launch_counts()
            out = fwd(sp, xs)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            got = unshard_batch_spatial(out, mesh)
            log(f"  sharded forward {dn}: launches {counts}; the window "
                f"warp clamps at {warp_clamp_share(flows, halo, n, H)}")
            check(tuple(out.shape) == (n * B, H // n, W, 2),
                  f"sharded forward {dn}: output {tuple(out.shape)}")
            check(k_only(counts) == spatial_counts(H, n),
                  f"sharded forward {dn}: launches {counts}")
            # JAX's own bound for this comparison is 2e-3 (float32,
            # tests/test_spatial.py); bf16 keeps phase 4's model bound
            # (5% max, 0.5% mean of the magnitude), since a one-ulp flip
            # early moves the later warps
            scale = max(1.0, float(want.abs().max()))
            err, mean = max_err(got, want), float((got - want).abs().mean())
            rel = 2e-3 if dtype == f32 else 5e-2
            log(f"  sharded vs unsharded forward {dn}: max_abs_err="
                f"{err:.3e} mean_abs_err={mean:.3e} tol={rel * scale:.3e} "
                f"mean|flow|={float(want.abs().mean()):.3f} px")
            check(bool(torch.isfinite(got).all()), f"sharded {dn}: "
                  "non-finite flow")
            check(err <= rel * scale, f"sharded forward {dn}: {err}")
            if dtype == bf16:
                check(mean <= 5e-3 * scale, f"sharded forward {dn}: mean "
                      f"{mean}")
                paths["spatial_infer"] = counts
            del ref, sp, flows, out, got, want
            torch.cuda.empty_cache()

    n, halo = SPATIAL_N_TRAIN, SPATIAL_HALO_TRAIN
    mesh = make_mesh(n_data=1, n_model=n)
    sbatch = {k: shard_batch_spatial(v, mesh) for k, v in batch.items()}

    def spatial_step():
        return make_spatial_train_step(make_flow_train_step(), mesh)

    # the coarsest level (8 rows, 2 a shard) falls back to the whole
    # level's unhaloed kernels
    per_step = spatial_counts(TRAIN_H, n, step=True)
    ref32 = None
    for dtype in (f32, bf16):
        dn = str(dtype).split(".")[-1]
        ref = build_train(dtype, dev, cv_impl="auto", stem_stages=0)
        with torch.no_grad():
            flows = ref(batch["ims"], multiscale=True)
        log(f"  train step {dn}: the window warp clamps at "
            f"{warp_clamp_share(flows, halo, n, TRAIN_H)}")
        del flows
        ref = build_train(dtype, dev, cv_impl="auto", stem_stages=0)
        loss_u, g_u, counts_u = grad_step(ref, batch)
        sp = build_train(dtype, dev, cv_impl="auto",
                         spatial=SpatialConfig(mesh, warp_halo=halo))
        loss_s, g_s, counts_s = grad_step(sp, sbatch, spatial_step)
        log(f"  sharded train step {dn}: loss {loss_s:.6f} (unsharded "
            f"{loss_u:.6f}), launches {counts_s}")
        check(np.isfinite(loss_s), f"sharded step {dn}: loss {loss_s}")
        check(k_only(counts_u) == counts_of(K1=5, K4a=5, K4b=5),
              f"unsharded step {dn}: launches {counts_u}")
        check(k_only(counts_s) == per_step, f"sharded step {dn}: launches "
              f"{counts_s}, expected {per_step}")
        # the loss: float32 to 1e-5 (tests/test_spatial.py's); bf16 to
        # 5e-3, phase 4's mean bound on the flows it is a mean of
        rel = 1e-5 if dtype == f32 else 5e-3
        check(abs(loss_s - loss_u) <= rel * max(1.0, abs(loss_u)),
              f"sharded step {dn}: loss {loss_s} vs {loss_u}")
        compare_grads(f"sharded vs unsharded step grads {dn}", g_s, g_u,
                      ref32)
        # BatchNorm running statistics after the step (from every shard's
        # batch statistics): float32 to 1e-5 (JAX's), bf16 to 1e-2 of the
        # magnitude (statistics of bf16 features)
        bn_rel = 1e-5 if dtype == f32 else 1e-2
        worst = 0.0
        for (name, a), (_, b) in zip(
                ((k, v) for k, v in sp.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))),
                ((k, v) for k, v in ref.state_dict().items()
                 if k.endswith(("running_mean", "running_var")))):
            e = max_err(a, b) / max(1.0, float(b.abs().max()))
            worst = max(worst, e)
            check(e <= bn_rel, f"sharded step {dn}: {name} {e:.3e}")
        log(f"  sharded step {dn}: BatchNorm running statistics, worst "
            f"relative error {worst:.3e} (limit {bn_rel:g})")
        if dtype == f32:
            ref32 = g_u
        else:
            paths["spatial_train"] = counts_s
        del ref, sp, g_u, g_s
        torch.cuda.empty_cache()
    del ref32
    log(f"  phase 4f wall time {time.perf_counter() - t_phase:.1f} s")
    return paths


def state_diff(a, b) -> list:
    """The leaves in which two checkpoints (torch.load of state.pt) or
    two (model, chain) pairs' states differ: the step, every state_dict
    entry and every Adam step/exp_avg/exp_avg_sq, compared on the host
    bit for bit."""
    import torch

    diff = [] if a["step"] == b["step"] else ["step"]
    if a["model"].keys() != b["model"].keys():
        return diff + ["model keys"]
    diff += [k for k in a["model"]
             if not torch.equal(a["model"][k].cpu(), b["model"][k].cpu())]
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    if sa.keys() != sb.keys() or not sa:
        return diff + ["Adam state keys"]
    diff += [f"adam.{i}.{n}" for i in sa
             for n in ("step", "exp_avg", "exp_avg_sq")
             if not torch.equal(sa[i][n].cpu(), sb[i][n].cpu())]
    return diff


def live_state(model, chain) -> dict:
    """A (model, GradientChain) pair in the layout of a checkpoint."""
    return {"step": chain.global_step, "model": model.state_dict(),
            "optimizer": chain.state_dict()}


def load_ckpt(ckpt_dir, step) -> dict:
    import torch

    return torch.load(Path(ckpt_dir) / str(step) / "state.pt",
                      map_location="cpu", weights_only=True)


def write_sintel_fixture(root, dev, seed, h=436, w=1024, disp=8.0,
                         n_frames=3) -> None:
    """A Sintel-layout tree: one sequence of n_frames frames at h x w of a
    warped synthetic texture (frame_k = warp(frame_k+1, flow_k)) and its
    n_frames - 1 .flo files, written by the port's own PNG and .flo
    writers."""
    import numpy as np
    import torch

    from qpwcnet_torch.data.flo_format import write_flo
    from qpwcnet_torch.data.synthetic import random_flow_field, random_texture
    from qpwcnet_torch.ops.warp import backward_warp
    from qpwcnet_torch.vis import write_png

    gen = torch.Generator(device=dev).manual_seed(seed)
    pad = int(2 * disp + 1)
    hp, wp = h + 2 * pad, w + 2 * pad
    frames = [random_texture(gen, 1, hp, wp)]
    flows = []
    for _ in range(n_frames - 1):
        flows.insert(0, random_flow_field(gen, 1, hp, wp, max_disp=disp))
        frames.insert(0, backward_warp(frames[0], flows[0]))
    img_dir = Path(root) / "training" / "final" / "seq"
    flo_dir = Path(root) / "training" / "flow" / "seq"
    img_dir.mkdir(parents=True)
    flo_dir.mkdir(parents=True)
    crop = (0, slice(pad, pad + h), slice(pad, pad + w))
    for i, f in enumerate(frames):
        rgb = torch.clamp(torch.round(f[crop] * 255.0), 0, 255)
        write_png(img_dir / f"frame_{i + 1:04d}.png",
                  rgb.to(torch.uint8).cpu().numpy())
    for i, fl in enumerate(flows):
        write_flo(flo_dir / f"frame_{i + 1:04d}.flo",
                  fl[crop].cpu().numpy().astype(np.float32))


def phase_ckpt(dev, batch):
    """Phase 4d: checkpoints and the apps that need them."""
    import numpy as np
    import torch

    from qpwcnet_torch.apps import (
        eval_sintel, infer, interp_infer, pretrain_interp, train_flow)
    from qpwcnet_torch.data.flo_format import read_flo
    from qpwcnet_torch.models import build_flow_net
    from qpwcnet_torch.ops import cuda as kernels
    from qpwcnet_torch.train import (
        CheckpointManager, make_flow_train_step, plain_optimizer)
    from qpwcnet_torch.utils.config import parse_config

    log("== phase 4d: checkpoints and the apps that need them")
    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)

        # 1. The round trip on the card, and onto a CPU model.
        model = build_train(bf16, dev, cv_impl="auto", stem_stages=2)
        opt = plain_optimizer(model, 1e-4)
        step = make_flow_train_step()
        for _ in range(2):
            step(model, opt, batch)
        mgr = CheckpointManager(tmp / "roundtrip")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(mgr.save(2, model, opt), "round trip: save refused")
        save_ms = 1e3 * (time.perf_counter() - t0)
        nbytes = (tmp / "roundtrip" / "2" / "state.pt").stat().st_size
        fresh = build_train(bf16, dev, k=0.0, cv_impl="auto", stem_stages=2)
        chain = plain_optimizer(fresh, 1e-4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = mgr.restore(fresh, chain)
        torch.cuda.synchronize()
        restore_ms = 1e3 * (time.perf_counter() - t0)
        cpu = build_flow_net(SEED + 1, "cpu", dtype=bf16, cv_impl="auto",
                             stem_stages=2)
        cpu_chain = plain_optimizer(cpu, 1e-4)
        cpu_step = mgr.restore(cpu, cpu_chain)
        want = live_state(model, opt)
        d_card = state_diff(want, live_state(fresh, chain))
        d_cpu = state_diff(want, live_state(cpu, cpu_chain))
        model.eval()
        fresh.eval()
        with torch.inference_mode():
            same_fwd = torch.equal(model(batch["ims"]), fresh(batch["ims"]))
        log(f"  round trip, {TRAIN_H}x{TRAIN_W} b{TRAIN_B} bf16 after 2 "
            f"steps: {nbytes} bytes, save {save_ms:.3f} ms, restore "
            f"{restore_ms:.3f} ms (card); step {got} / {cpu_step}; "
            f"differing leaves card {d_card[:4]}, CPU {d_cpu[:4]}; "
            f"forward bit-equal {same_fwd}")
        check(got == cpu_step == 2 and not d_card and not d_cpu and same_fwd,
              "checkpoint round trip")
        del model, opt, fresh, chain, cpu, cpu_chain
        torch.cuda.empty_cache()

        # 2. train_flow: run A (4 steps), run B (2 steps), run C (B
        # resumed to 4 steps); C's final checkpoint must equal A's.
        targs = ["--data", "synthetic", "--curriculum", "", "--batch-size",
                 str(TRAIN_B), "--height", str(TRAIN_H), "--width",
                 str(TRAIN_W), "--compute-dtype", "bfloat16",
                 "--recalibrate-final", "0", "--log-every", "2",
                 "--ckpt-every", "2", "--device", str(dev), "--run-root",
                 str(tmp / "flow")]
        flow_ckpt = tmp / "flow" / "000" / "ckpt"
        kernels.reset_launch_counts()
        train_flow.main(targs + ["--steps", "4"])
        train_flow.main(targs + ["--steps", "2"])
        train_flow.main(targs + ["--steps", "4", "--load-ckpt",
                                 str(tmp / "flow" / "001" / "ckpt")])
        torch.cuda.synchronize()
        paths["train_resume"] = kernels.launch_counts()
        diff = state_diff(load_ckpt(flow_ckpt, 4),
                          load_ckpt(tmp / "flow" / "002" / "ckpt", 4))
        steps = [CheckpointManager(tmp / "flow" / f"00{r}" / "ckpt")
                 .all_steps() for r in range(3)]
        log(f"  train_flow A 4 / B 2 / C B->4 steps: checkpoints {steps}, "
            f"C against A: {len(diff)} differing leaves {diff[:6]}, "
            f"launches {paths['train_resume']}")
        check(steps == [[2, 4], [2], [4]], f"train_flow steps {steps}")
        check(not diff, "train_flow resumed run differs from the "
              f"uninterrupted one: {diff}")
        n_steps, n_fwd = 4 + 2 + 2, 4 + 2 + 2 + 2 + 1 + 1
        check(k_only(paths["train_resume"]) == counts_of(
            K1=5 * n_fwd, K4a=5 * n_steps, K4b=5 * n_steps),
            f"train_flow resume launches {paths['train_resume']}")

        # 3. The same for pretrain_interp, augmentation on.
        pargs = ["--batch-size", str(INTERP_B), "--height", str(TRAIN_H),
                 "--width", str(TRAIN_W), "--compute-dtype", "bfloat16",
                 "--recalibrate-final", "0", "--log-every", "2",
                 "--ckpt-every", "2", "--device", str(dev), "--run-root",
                 str(tmp / "pre")]
        pre_ckpt = tmp / "pre" / "000" / "ckpt"
        kernels.reset_launch_counts()
        pretrain_interp.main(pargs + ["--steps", "4"])
        pretrain_interp.main(pargs + ["--steps", "2"])
        pretrain_interp.main(pargs + ["--steps", "4", "--load-ckpt",
                                      str(tmp / "pre" / "001" / "ckpt")])
        torch.cuda.synchronize()
        paths["pretrain_resume"] = kernels.launch_counts()
        diff = state_diff(load_ckpt(pre_ckpt, 4),
                          load_ckpt(tmp / "pre" / "002" / "ckpt", 4))
        log(f"  pretrain_interp A 4 / B 2 / C B->4 steps: C against A: "
            f"{len(diff)} differing leaves {diff[:6]}, launches "
            f"{paths['pretrain_resume']}")
        check(not diff, "pretrain_interp resumed run differs from the "
              f"uninterrupted one: {diff}")
        check(k_only(paths["pretrain_resume"]) == counts_of(
            K1=5 * n_fwd, K4a=5 * n_steps, K4b=5 * n_steps),
            f"pretrain resume launches {paths['pretrain_resume']}")

        # 4. --transfer-from-interp: --steps 0 keeps the state before the
        # first step; --steps 2 is the path (its curriculum is skipped).
        xargs = ["--data", "synthetic", "--curriculum", "1,1",
                 "--batch-size", str(TRAIN_B), "--height", str(TRAIN_H),
                 "--width", str(TRAIN_W), "--compute-dtype", "bfloat16",
                 "--recalibrate-final", "0", "--log-every", "2",
                 "--ckpt-every", "2", "--device", str(dev), "--load-ckpt",
                 str(pre_ckpt), "--transfer-from-interp", "true",
                 "--run-root", str(tmp / "xfer")]
        train_flow.main(xargs + ["--steps", "0"])
        src = load_ckpt(pre_ckpt, 4)["model"]
        dst = load_ckpt(tmp / "xfer" / "000" / "ckpt", 0)["model"]
        shared = [k for k in dst if k.split(".")[0] in
                  ("encoder", "decoder", "flower")
                  and not k.endswith(("running_mean", "running_var",
                                      "num_batches_tracked"))]
        differ = [k for k in shared if not torch.equal(dst[k], src[k])]
        kernels.reset_launch_counts()
        metrics = train_flow.main(xargs + ["--steps", "2"])
        torch.cuda.synchronize()
        paths["transfer_app"] = kernels.launch_counts()
        log(f"  train_flow --transfer-from-interp: {len(shared)} "
            f"parameters from the interpolator's checkpoint, "
            f"{len(differ)} differ; 2 steps {metrics}, launches "
            f"{paths['transfer_app']}")
        check(len(shared) > 100 and not differ, f"transfer: {differ[:4]}")
        check(all(np.isfinite(v) for v in metrics.values()),
              "transfer run loss")
        check(k_only(paths["transfer_app"])
              == counts_of(K1=5 * 3, K4a=10, K4b=10),
              f"transfer launches {paths['transfer_app']}")

        # 5. eval_sintel on a Sintel-layout fixture at 436x1024.
        write_sintel_fixture(tmp / "sintel", dev, SEED + 20)
        eargs = ["--data-path", str(tmp / "sintel"), "--load-ckpt",
                 str(flow_ckpt)]

        def evaluate(*extra):
            return eval_sintel.run(parse_config(eval_sintel.Settings,
                                                eargs + list(extra)))

        kernels.reset_launch_counts()
        pad = evaluate("--protocol", "pad", "--recalibrate", "2",
                       "--device", str(dev))
        resize = evaluate("--protocol", "resize", "--recalibrate", "2",
                          "--device", str(dev))
        # card against CPU: a checkpoint of the float32 flow net with
        # seeded heads (flows of ~2 px in eval mode; run A's 4 steps
        # leave them near 0, and the EPE then near predict-zero's)
        seeded = build(torch.float32, dev)
        CheckpointManager(tmp / "seeded").save(
            0, seeded, plain_optimizer(seeded, 0.0))
        del seeded
        eargs[-1] = str(tmp / "seeded")
        card = evaluate("--recalibrate", "0", "--device", str(dev))
        torch.cuda.synchronize()
        paths["eval_sintel_app"] = kernels.launch_counts()
        on_cpu = evaluate("--recalibrate", "0", "--device", "cpu")
        rel = abs(card["value"] - on_cpu["value"]) / abs(on_cpu["value"])
        zero = float(np.mean([
            np.linalg.norm(read_flo(f), axis=-1).mean() for f in
            sorted((tmp / "sintel" / "training" / "flow").rglob("*.flo"))]))
        log(f"  eval_sintel: run A's checkpoint, pad {pad}, resize "
            f"{resize}; seeded heads, recalibrate 0: card "
            f"{card['value']!r} CPU {on_cpu['value']!r} (relative "
            f"{rel:.3e}, limit 1e-4; predict-zero {zero!r}); launches "
            f"{paths['eval_sintel_app']}")
        for r in (pad, resize, card, on_cpu):
            check(r["n"] == 2 and np.isfinite(r["value"]),
                  f"eval_sintel {r}")
        check(rel <= 1e-4, f"eval_sintel card against CPU: {rel}")
        # not vacuous: the flows move the EPE off predict-zero's by 100
        # times the tolerance
        check(abs(card["value"] - zero) > 1e-2 * zero,
              "eval_sintel card against CPU: vacuous, the EPE is "
              "predict-zero's")
        # float32 K1, 448x1024 b1: 2 recalibration and 2 eval forwards in
        # each of the first two runs, 2 eval forwards in the third
        check(k_only(paths["eval_sintel_app"]) == counts_of(K1=5 * 10),
              f"eval_sintel launches {paths['eval_sintel_app']}")

        # 6. infer --fast --load-ckpt and interp_infer --load-ckpt.
        cfg = parse_config(infer.Settings, [
            "--fast", "true", "--n", "2", "--height", str(H), "--width",
            str(W), "--out-dir", str(tmp / "infer"), "--device", str(dev),
            "--load-ckpt", str(flow_ckpt)])
        model = infer.build_model(cfg)
        saved = load_ckpt(flow_ckpt, 4)["model"]
        loaded = [k for k, v in model.state_dict().items()
                  if not torch.equal(v.cpu(), saved[k])]
        kernels.reset_launch_counts()
        errs = infer.run(cfg, model)
        torch.cuda.synchronize()
        paths["infer_ckpt_app"] = kernels.launch_counts()
        del model
        with tempfile.TemporaryDirectory() as out:
            kernels.reset_launch_counts()
            results = interp_infer.main([
                "--data", "synthetic", "--n", "2", "--height", str(TRAIN_H),
                "--width", str(TRAIN_W), "--out-dir", out, "--device",
                str(dev), "--load-ckpt", str(pre_ckpt)])
            torch.cuda.synchronize()
            paths["interp_infer_ckpt_app"] = kernels.launch_counts()
        log(f"  infer --fast --load-ckpt: {len(loaded)} leaves differ from "
            f"the checkpoint, warp-validation L1 {errs}, launches "
            f"{paths['infer_ckpt_app']}; interp_infer --load-ckpt: "
            f"{results}, launches {paths['interp_infer_ckpt_app']}")
        check(not loaded, f"infer --load-ckpt: {loaded[:4]}")
        check(len(errs) == 2 and all(np.isfinite(errs)), "infer errors")
        check(k_only(paths["infer_ckpt_app"]) == counts_of(K1=8, K2=4, K3=2),
              f"infer --load-ckpt launches {paths['infer_ckpt_app']}")
        check(len(results) == 2
              and all(np.isfinite(r["psnr"]) for r in results),
              "interp_infer --load-ckpt PSNR")
        check(k_only(paths["interp_infer_ckpt_app"]) == counts_of(K1=10),
              f"interp_infer --load-ckpt launches "
              f"{paths['interp_infer_ckpt_app']}")
    torch.cuda.empty_cache()
    log(f"  phase 4d wall time {time.perf_counter() - t_phase:.1f} s")
    return paths


# ------------------------------------------------------- phase 4g: data

DATA_B, DATA_STEPS, DATA_LOG, DATA_RECAL = 16, 4, 2, 2
FT3D_HW, SINTEL_HW, VIMEO_HW, YTVOS_HW = (540, 960), (436, 1024), \
    (256, 448), (720, 1280)
FT3D_NAN_FRAME = 3


def write_pfm(path, arr) -> None:
    """A little-endian 3-channel PFM of arr (H, W, 3) float32 (rows
    stored bottom-up)."""
    import numpy as np

    h, w = arr.shape[:2]
    Path(path).write_bytes(f"PF\n{w} {h}\n-1.0\n".encode()
                           + np.flipud(arr).astype("<f4").tobytes())


def frames_u8(gen, n, h, w):
    """n textures (H, W, 3) as host uint8 arrays, made on the card."""
    import torch

    from qpwcnet_torch.data.synthetic import random_texture

    t = random_texture(gen, n, h, w)
    return torch.clamp(torch.round(t * 255.0), 0, 255).to(
        torch.uint8).cpu().numpy()


def write_data_fixtures(root, dev, seed) -> dict:
    """The four datasets in their own layouts and frame sizes under root,
    each at least one batch: FlyingThings3D (17 WebP frames at 540x960 and
    their PFM flows, NaN pixels in one), Sintel (17 frames at 436x1024,
    converted by data_tools to 2 TFRecord shards), Vimeo-90K (8 train and
    2 test triplets of 256x448 PNGs) and YouTube-VOS (8 train videos of 5
    720x1280 JPEGs). Returns the data paths by mode."""
    import numpy as np
    import torch
    from PIL import Image

    from qpwcnet_torch.apps import data_tools
    from qpwcnet_torch.data.synthetic import random_flow_field
    from qpwcnet_torch.vis import write_png

    root = Path(root)
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, w = FT3D_HW
    left = root / "f3d" / "frames_finalpass_webp" / "TRAIN" / "A" / \
        "0000" / "left"
    flo_dir = root / "f3d" / "optical_flow" / "TRAIN" / "A" / "0000" / \
        "into_future" / "left"
    left.mkdir(parents=True)
    flo_dir.mkdir(parents=True)
    for k, img in enumerate(frames_u8(gen, DATA_B + 1, h, w)):
        Image.fromarray(img).save(left / f"{6 + k:04d}.webp", quality=90)
        flo = random_flow_field(gen, 1, h, w, max_disp=24.0)[0].cpu().numpy()
        flo = np.concatenate([flo, np.zeros((h, w, 1), np.float32)], -1)
        if k == FT3D_NAN_FRAME:
            flo[h // 5:h // 5 + 4, w // 5:w // 5 + 10, 0] = np.nan
        write_pfm(flo_dir / f"OpticalFlowIntoFuture_{6 + k:04d}_L.pfm", flo)
    data_tools.main(["fc3d-set", "--root", str(root / "f3d"), "--out",
                     str(root / "f3d_set.txt")])

    write_sintel_fixture(root / "sintel", dev, seed + 1, *SINTEL_HW,
                         n_frames=DATA_B + 1)
    data_tools.main(["convert", "--root", str(root / "sintel"), "--out",
                     str(root / "shards"), "--shards", "2"])

    vimeo = root / "vimeo"
    keys = [f"{i // 4 + 1:05d}/{i % 4 + 1:04d}" for i in range(10)]
    frames = frames_u8(gen, 3 * len(keys), *VIMEO_HW)
    for i, key in enumerate(keys):
        d = vimeo / "sequences" / key
        d.mkdir(parents=True)
        for j in range(3):
            write_png(d / f"im{j + 1}.png", frames[3 * i + j])
    (vimeo / "tri_trainlist.txt").write_text("\n".join(keys[:8]) + "\n")
    (vimeo / "tri_testlist.txt").write_text("\n".join(keys[8:]) + "\n")

    for v in range(8):
        d = root / "ytvos" / "train" / "JPEGImages" / f"v{v:03d}"
        d.mkdir(parents=True)
        for k, img in enumerate(frames_u8(gen, 5, *YTVOS_HW)):
            Image.fromarray(img).save(d / f"{5 * k:05d}.jpg", quality=90)
    return {"fc3d": str(root / "f3d_set.txt"),
            "sintel": str(root / "shards" / "*.tfrecord"),
            "vimeo": str(vimeo), "ytvos": str(root / "ytvos"), "dummy": ""}


def compare_augmentation(tag, dev, ims_u8, flo, base_scale, seed):
    """preprocess_flow_batch with the same draws (made on the CPU) on the
    card and on the CPU: images within 1e-5, flows within 1e-4 px, and
    each sample's flow channel that holds a NaN all 0 on both."""
    import numpy as np
    import torch

    from qpwcnet_torch.data import (
        draw_flow_augmentation, preprocess_flow_batch)

    draws = draw_flow_augmentation(torch.Generator().manual_seed(seed),
                                   ims_u8.shape[0], base_scale)
    out = (TRAIN_H, TRAIN_W)
    cpu = preprocess_flow_batch(torch.from_numpy(ims_u8),
                                torch.from_numpy(flo), out, draws)
    card = preprocess_flow_batch(
        torch.from_numpy(ims_u8).to(dev), torch.from_numpy(flo).to(dev),
        out, {k: v.to(dev) for k, v in draws.items()})
    torch.cuda.synchronize()
    e_ims = max_err(card["ims"].cpu(), cpu["ims"])
    e_flo = max_err(card["flo"].cpu(), cpu["flo"])
    nan = np.argwhere(np.isnan(flo).any(axis=(1, 2)))
    zeroed = [bool((o["flo"][b, ..., c] == 0).all()) for b, c in nan
              for o in (cpu, card)]
    log(f"  augmentation {tag} b{ims_u8.shape[0]} {ims_u8.shape[1]}x"
        f"{ims_u8.shape[2]} -> {out[0]}x{out[1]}, base scale {base_scale}: "
        f"card against CPU, images {e_ims:.3e} (tol 1e-5), flows "
        f"{e_flo:.3e} px (tol 1e-4); NaN (sample, channel)s "
        f"{nan.tolist()} zeroed on CPU and card: {zeroed}")
    check(bool(torch.isfinite(card["ims"]).all()
               and torch.isfinite(card["flo"]).all()),
          f"augmentation {tag}: non-finite")
    check(e_ims <= 1e-5 and e_flo <= 1e-4,
          f"augmentation {tag}: card against CPU {e_ims}, {e_flo}")
    check(all(zeroed), f"augmentation {tag}: a NaN channel not zeroed")


def phase_data(dev, root) -> dict:
    """Phase 4g: the dataset paths on their own fixtures (written under
    root): the flow augmentation on the card against the CPU, the
    train_flow, pretrain_interp and interp_infer dataset modes (main
    paths) and the data_tools subcommands."""
    import contextlib
    import io
    import os

    import numpy as np
    import torch
    from PIL import features

    from qpwcnet_torch.apps import (
        data_tools, interp_infer, pretrain_interp, train_flow)
    from qpwcnet_torch.ops import cuda as kernels
    from qpwcnet_torch.utils.config import parse_config

    log("== phase 4g: the dataset paths (FlyingThings3D, Sintel, "
        "Vimeo-90K, YouTube-VOS fixtures at their own sizes)")
    t_phase = time.perf_counter()
    codecs = {c: features.check(c) for c in ("webp", "jpg", "zlib")}
    log(f"  PIL codecs: {codecs}")
    check(all(codecs.values()), f"PIL lacks a codec: {codecs}")
    root = Path(root)
    data = write_data_fixtures(root, dev, SEED + 30)
    log(f"  fixtures written in {time.perf_counter() - t_phase:.1f} s")

    # 1. The augmentation, card against CPU, on the decoded datasets.
    sintel = parse_config(train_flow.Settings, [
        "--data", "sintel", "--data-path", data["sintel"], "--batch-size",
        str(DATA_B)])
    fc3d = parse_config(train_flow.Settings, [
        "--data", "fc3d", "--data-path", data["fc3d"], "--batch-size",
        str(DATA_B)])
    for tag, cfg, scale in (("Sintel", sintel, 1.0),
                            ("FlyingThings3D", fc3d, 0.56)):
        loader = train_flow._dataset_loader(cfg)
        ims_u8, flo = next(iter(loader))
        loader.close()
        compare_augmentation(tag, dev, ims_u8, flo, scale, SEED + 31)
    del ims_u8, flo

    # 2. The apps' dataset modes: each a main path.
    paths = {}
    os.environ["QPWCNET_TORCH_CACHE"] = str(root / "cache")

    def app(name, fn, argv):
        kernels.reset_launch_counts()
        out = fn(argv)
        torch.cuda.synchronize()
        paths[name] = kernels.launch_counts()
        return out

    common = ["--steps", str(DATA_STEPS), "--height", str(TRAIN_H),
              "--width", str(TRAIN_W), "--compute-dtype", "bfloat16",
              "--log-every", str(DATA_LOG), "--recalibrate-final",
              str(DATA_RECAL), "--device", str(dev)]
    for mode, extra in (("fc3d", ["--base-scale", "0.56"]), ("sintel", []),
                        ("synthetic-uniform", [])):
        run_root = root / "runs" / mode
        m = app(f"data_{mode}", train_flow.main, common + [
            "--data", mode, "--data-path", data.get(mode, ""),
            "--batch-size", str(TRAIN_B), "--run-root", str(run_root)]
            + extra)
        saved = (run_root / "000" / "ckpt" / str(DATA_STEPS) /
                 "state.pt").exists()
        log(f"  train_flow --data {mode} {' '.join(extra)} (b{TRAIN_B}, "
            f"bf16, {DATA_STEPS} steps): last step {m}, checkpoint "
            f"{saved}, launches {paths[f'data_{mode}']}")
        check(all(np.isfinite(v) for v in m.values()) and saved,
              f"train_flow --data {mode}")
        n_fwd = DATA_STEPS + DATA_STEPS // DATA_LOG + DATA_RECAL
        check(k_only(paths[f"data_{mode}"]) == counts_of(
            K1=5 * n_fwd, K4a=5 * DATA_STEPS, K4b=5 * DATA_STEPS),
            f"train_flow --data {mode} launches")
    for mode in ("vimeo", "ytvos", "dummy"):
        run_root = root / "pre" / mode
        m = app(f"data_{mode}", pretrain_interp.main, common + [
            "--data", mode, "--data-path", data[mode], "--batch-size",
            str(INTERP_B), "--run-root", str(run_root)])
        saved = (run_root / "000" / "ckpt" / str(DATA_STEPS) /
                 "state.pt").exists()
        log(f"  pretrain_interp --data {mode} (b{INTERP_B}, bf16, "
            f"{DATA_STEPS} steps): last logged loss {m.get('loss')}, loader "
            f"wait {m.get('loader_wait_ms')} ms a step, checkpoint {saved}, "
            f"launches {paths[f'data_{mode}']}")
        check(np.isfinite(m["loss"]) and saved, f"pretrain --data {mode}")
        check(k_only(paths[f"data_{mode}"]) == counts_of(
            K1=5 * (DATA_STEPS + DATA_RECAL), K4a=5 * DATA_STEPS,
            K4b=5 * DATA_STEPS), f"pretrain --data {mode} launches")
    results = app("data_interp_infer_vimeo", interp_infer.main, [
        "--data", "vimeo", "--data-path", data["vimeo"], "--n", "2",
        "--height", str(TRAIN_H), "--width", str(TRAIN_W), "--out-dir",
        str(root / "interp_out"), "--device", str(dev)])
    pngs = list((root / "interp_out").glob("*.png"))
    log(f"  interp_infer --data vimeo: {results}, {len(pngs)} PNGs, "
        f"launches {paths['data_interp_infer_vimeo']}")
    check(len(results) == 2 and all(np.isfinite(r["psnr"])
                                    for r in results), "interp_infer vimeo")
    check(len(pngs) == 14, f"interp_infer vimeo wrote {len(pngs)} PNGs")
    check(k_only(paths["data_interp_infer_vimeo"]) == counts_of(K1=10),
          "interp_infer vimeo launches")
    del os.environ["QPWCNET_TORCH_CACHE"]

    # 3. data_tools (the fc3d set file and the shards above came from
    # fc3d-set and convert).
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        data_tools.main(["stats", "--shards", data["sintel"]])
        data_tools.main(["nan-scan", "--set-file", data["fc3d"]])
    data_tools.main(["preview", "--shards", data["sintel"], "--out",
                     str(root / "preview.png"), "--device", str(dev)])
    said = out.getvalue().splitlines()
    log(f"  data_tools stats / nan-scan: {said}; preview "
        f"{(root / 'preview.png').stat().st_size} bytes")
    check(said[0].startswith(f"n={DATA_B} ") and said[1] ==
          f"1/{DATA_B} samples contain NaNs", f"data_tools said {said}")
    torch.cuda.empty_cache()
    log(f"  phase 4g wall time {time.perf_counter() - t_phase:.1f} s")
    return paths


# The quantization slice (phase 4h): QAT at the train slices' shapes, int8
# inference at the JAX bench's int8 headline (bench.py:243-264: 448x1024
# b8, bf16 activations), the QAT apps and convert_quant. The plain models
# take cv_impl='plain' (K1, K4a, K4b as plain PyTorch); the 'fast' int8
# reference also runs K3's plain version (plain_fused_warp).
QUANT_FLIP_SHARE = 0.01  # int8 codes a kernel may flip at a chained conv


@contextlib.contextmanager
def plain_fused_warp():
    """K3's wrapper swapped for its plain version on card tensors (the
    Functions look the wrapper up at call time): the reference of the
    int8 'fast' model, whose finest level computes the window warp."""
    from qpwcnet_torch.ops.cuda import warp_cv_kernel as k3

    saved = k3.warp_cost_volume_cuda
    k3.warp_cost_volume_cuda = k3.warp_cost_volume_plain
    try:
        yield
    finally:
        k3.warp_cost_volume_cuda = saved


def ranges_of(model) -> dict:
    from qpwcnet_torch.quantize.qlayers import quant_ranges

    return {k: b.detach().clone() for k, b in quant_ranges(model).items()}


def range_err(got, want) -> float:
    """The largest |got - want| of any range vector over its largest
    channel."""
    return max(float((got[k] - w).abs().max()) / max(float(w.max()), 1e-30)
               for k, w in want.items())


def qat_steps(dev, build_fn, batch, make_step, per_step, tag):
    """One QAT step (learning rate 0) of the plain model in float32 and
    bf16 and of the kernel model in bf16: the loss, every gradient
    (phase 4b's bf16 rule against the plain bf16 step, the plain float32
    step its noise floor) and the ranges the step's forward set (within
    2x the plain bf16 step's own distance from the float32 one, plus 1e-6
    of the range). Returns the kernel step's launches."""
    import numpy as np
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    res = {}
    for mode, dtype, cv in (("plain", f32, "plain"), ("plain", bf16, "plain"),
                            ("kernel", bf16, "auto")):
        m = build_fn(dtype, cv)
        loss, grads, counts = grad_step(m, batch, make_step,
                                        plain=mode == "plain")
        dn = str(dtype).split(".")[-1]
        log(f"  {tag} QAT step {mode} {dn}: loss {loss:.6f}, launches "
            f"{counts}")
        check(np.isfinite(loss), f"{tag} QAT {mode} {dn}: loss {loss}")
        want = per_step if mode == "kernel" else counts_of()
        check(k_only(counts) == want, f"{tag} QAT {mode} {dn}: launches "
              f"{counts}, expected {want}")
        res[mode, dtype] = (loss, grads, ranges_of(m), counts)
        del m
        torch.cuda.empty_cache()
    (l32, g32, r32, _), (lp, gp, rp, _), (lk, gk, rk, counts) = (
        res["plain", f32], res["plain", bf16], res["kernel", bf16])
    check(min(float(r.max()) for r in rk.values()) > 0.0,
          f"{tag}: a range the step left at 0")
    noise = abs(lp - l32)
    log(f"  {tag} QAT loss kernel - plain bf16 {abs(lk - lp):.3e}, plain "
        f"bf16 - f32 {noise:.3e}")
    check(abs(lk - lp) <= 2.0 * noise + 1e-6 * abs(lp), f"{tag} QAT loss")
    compare_grads(f"{tag} QAT kernel vs plain grads bfloat16", gk, gp, g32)
    e, n = range_err(rk, rp), range_err(rp, r32)
    log(f"  {tag} QAT ranges after the step: kernel vs plain bf16 {e:.3e} "
        f"of the largest channel, plain bf16 vs f32 {n:.3e}")
    check(e <= 2.0 * n + 1e-6, f"{tag} QAT ranges {e} vs noise {n}")
    return counts


def int8_flow(dev, x, quant, cv_impl, ranges_from):
    """A bf16 PWCFlowNet in int8 mode with the seeded heads and the
    ranges (and BatchNorm statistics) of ``ranges_from``."""
    import torch

    m = build(torch.bfloat16, dev, cv_impl=cv_impl, quant=quant)
    m.load_state_dict(ranges_from.state_dict())
    return m


def emitted(model, name, store: list):
    """A hook keeping the int8 codes of the QTensor the conv ``name``
    emits; returns its handle."""
    return model.get_submodule(name).register_forward_hook(
        lambda mod, inp, out: store.append(out.q))


def phase_quant(dev, x, batch, ibatch) -> dict:
    """Phase 4h: the quantization slice (module docstring)."""
    import dataclasses

    import numpy as np
    import torch

    from qpwcnet_torch.apps import convert_quant, pretrain_interp, train_flow
    from qpwcnet_torch.ops import cuda as kernels
    from qpwcnet_torch.quantize import QuantConfig, load_int8_bundle
    from qpwcnet_torch.train import make_interp_train_step

    log("== phase 4h: the quantization slice")
    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    qat = QuantConfig()
    int8 = dataclasses.replace(qat, mode="int8")
    paths = {}
    steps = counts_of(K1=5, K4a=5, K4b=5)

    paths["qat_train"] = qat_steps(
        dev, lambda dt, cv: build_train(dt, dev, cv_impl=cv, quant=qat),
        batch, None, steps, f"flow {TRAIN_H}x{TRAIN_W} b{TRAIN_B}")
    paths["qat_pretrain"] = qat_steps(
        dev, lambda dt, cv: build_interp(dt, dev, k=1.5, cv_impl=cv,
                                         quant=qat),
        ibatch, make_interp_train_step, steps,
        f"pretraining {TRAIN_H}x{TRAIN_W} b{INTERP_B}")

    # int8 inference at the headline: ranges from two QAT train-mode
    # forwards of the bf16 model on this batch's halves
    with torch.inference_mode():
        calib = build(bf16, dev, cv_impl="auto", quant=qat).train()
        for half in (x[:B // 2], x[B // 2:]):
            calib(half)
        calib.eval()
        want = {}
        # the finest head's first chained conv: its emitted int8 codes
        chained = "flower.upflows.3.flow.of_feats.0.pointwise"
        for mode, cv in (("exact", "plain"),
                         ("fast", ("plain",) * 4 + ("fused",))):
            codes = []
            with plain_fused_warp():
                ref = int8_flow(dev, x, int8, cv, calib)
                hook = emitted(ref, chained, codes)
                kernels.reset_launch_counts()
                want[mode] = ref(x)
                torch.cuda.synchronize()
                check(k_only(kernels.launch_counts()) == counts_of(),
                      f"int8 plain {mode}: launches")
                hook.remove()
            got_m = int8_flow(dev, x, int8,
                              "auto" if mode == "exact" else "fast", calib)
            hook = emitted(got_m, chained, codes)
            kernels.reset_launch_counts()
            got = got_m(x)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            hook.remove()
            expect = counts_of(K1=5) if mode == "exact" else \
                counts_of(K1=4, K3=1)
            log(f"  int8 {mode} bf16 {H}x{W} b{B}: launches {counts}, "
                f"mean|flow|={float(got.abs().mean()):.3f} px")
            check(k_only(counts) == expect, f"int8 {mode}: launches {counts}, "
                  f"expected {expect}")
            paths[f"int8_infer_{mode}"] = counts
            compare_model(f"int8 {mode} kernels vs plain bf16", got,
                          want[mode], bf16)
            d = (codes[1].int() - codes[0].int()).abs()
            n, tot, dmax = int((d > 0).sum()), d.numel(), int(d.max())
            log(f"  int8 {mode}: codes of the finest head's first chained "
                f"conv (of_feats.0.pointwise) differing from the plain "
                f"model's: {n} of {tot} ({n / tot:.3e}), at most {dmax}")
            check(n <= QUANT_FLIP_SHARE * tot, f"int8 {mode}: {n} flips")
            del ref, got_m, got, codes, d
        fl = build(bf16, dev, cv_impl="auto")
        fl.load_state_dict({k: v for k, v in calib.state_dict().items()
                            if "amax" not in k})
        f_out = fl(x)
        for mode in ("exact", "fast"):
            err = float((want[mode] - f_out).abs().mean())
            log(f"  int8 {mode} (plain) vs the bf16 float model: "
                f"mean|delta|={err:.4f} px "
                f"({100 * err / float(f_out.abs().mean()):.1f}% of "
                f"mean|flow|, convert_quant --check's measure)")
        del calib, fl, f_out, want
        torch.cuda.empty_cache()

    # The apps: train_flow / pretrain_interp --qat, A 2 steps, B 1, C B
    # resumed to 2: C's checkpoint must equal A's, ranges included.
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for app, name, b, extra in (
                (train_flow, "qat_train_app", TRAIN_B,
                 ["--data", "synthetic", "--curriculum", ""]),
                (pretrain_interp, "qat_pretrain_app", INTERP_B, [])):
            root = tmp / name
            args = extra + [
                "--qat", "true", "--batch-size", str(b), "--height",
                str(TRAIN_H), "--width", str(TRAIN_W), "--compute-dtype",
                "bfloat16", "--recalibrate-final", "0", "--log-every", "1",
                "--ckpt-every", "1", "--device", str(dev), "--run-root",
                str(root)]
            kernels.reset_launch_counts()
            app.main(args + ["--steps", "2"])
            app.main(args + ["--steps", "1"])
            app.main(args + ["--steps", "2", "--load-ckpt",
                             str(root / "001" / "ckpt")])
            torch.cuda.synchronize()
            paths[name] = kernels.launch_counts()
            a = load_ckpt(root / "000" / "ckpt", 2)
            diff = state_diff(a, load_ckpt(root / "002" / "ckpt", 2))
            n_ranges = sum("amax" in k for k in a["model"])
            log(f"  {app.__name__.split('.')[-1]} --qat A 2 / B 1 / C B->2 "
                f"steps (bf16 b{b}): C against A: {len(diff)} differing "
                f"leaves {diff[:6]} ({n_ranges} ranges among them), "
                f"launches {paths[name]}")
            check(n_ranges >= 118 and not diff,
                  f"{name}: resumed run differs: {diff}")
            # each step and each log's held-out forward run K1
            check(k_only(paths[name])
                  == counts_of(K1=5 * 8, K4a=5 * 4, K4b=5 * 4),
                  f"{name} launches {paths[name]}")

        out = tmp / "int8.npz"
        kernels.reset_launch_counts()
        res = convert_quant.run(dataclasses.replace(
            convert_quant.Settings(), steps=3, height=TRAIN_H,
            width=TRAIN_W, out=str(out), device=str(dev)))
        torch.cuda.synchronize()
        paths["convert_quant"] = kernels.launch_counts()
        loaded = load_int8_bundle(out)
        same = list(loaded) == list(res["int8"]) and all(
            np.array_equal(getattr(loaded[k], f), getattr(res["int8"][k], f))
            for k in loaded for f in ("kernel_i8", "w_scale", "in_amax")
            if getattr(loaded[k], f) is not None)
        log(f"  convert_quant --steps 3 --check true at {TRAIN_H}x{TRAIN_W}: "
            f"{res['n_convs']} convs, {res['n_int8_weights']} int8 weights, "
            f"{out.stat().st_size} bytes; int8 vs float "
            f"{res['check_pct']:.1f}% of mean|flow|; the bundle loads back "
            f"equal: {same}; launches {paths['convert_quant']}")
        check(same and res["n_convs"] == 69, "convert_quant bundle")
        check(np.isfinite(res["check_pct"]), "convert_quant --check")
        # 3 calibration steps, then the int8 and float forwards
        check(k_only(paths["convert_quant"])
              == counts_of(K1=25, K4a=15, K4b=15),
              f"convert_quant launches {paths['convert_quant']}")
    log(f"  phase 4h took {time.perf_counter() - t_phase:.1f} s")
    return paths


# The last slice (phase 4i): show_network with the profiling tools, the
# pretraining app's --debug-nan, the int8 forward on the H-sharded path,
# convert_quant --export on the card through the kernels' custom ops, and
# the last ops and losses on the card against the CPU.
LAST_FLIP_SHARE = 1e-3  # int8 codes the sharded forward may flip (0.1%)
EXPORT_HW = (H, W)      # convert_quant --export: the headline at batch 1


def k1_flops(levels, batch) -> int:
    """K1's registered flop formula (2·81·C a pixel) summed over one
    forward's five cost volumes, ``batch`` images a level."""
    return sum(2 * 81 * c * batch * h * w for h, w, c in levels)


def graph_ops(exported) -> dict:
    """The calls of the kernels' custom ops in an ExportedProgram (its
    graph and any subgraph of it), by op name."""
    counts = {"qpwcnet.cost_volume": 0, "qpwcnet.warp_cost_volume": 0,
              "qpwcnet.bias_mish": 0}
    for gm in exported.graph_module.modules():
        graph = getattr(gm, "graph", None)
        for node in (graph.nodes if graph is not None else ()):
            name = str(node.target)
            for op in counts:
                if node.op == "call_function" and name.startswith(op + "."):
                    counts[op] += 1
    return counts


def show_network_path(dev, model, hw, levels, k1_batch) -> tuple:
    """show_network at hw, batch 1, bf16 (--trace-dir under chiprun_out/):
    its launches (a forward each for cost_analysis, time_fn's 2 + 10 and
    the trace), the trace naming K1's bf16 kernel, and its flops equal to
    the same forward's on the CPU (the kernels' plain versions, which the
    counter does not count) plus K1's formula. Returns (launches, the
    app's numbers)."""
    import io
    import re

    import torch

    from qpwcnet_torch.apps import show_network
    from qpwcnet_torch.models import build_flow_net, build_interpolator
    from qpwcnet_torch.ops import cuda as kernels
    from qpwcnet_torch.utils.profiling import CATEGORIES, cost_analysis

    trace_dir = ROOT / "chiprun_out" / "show_network" / model
    cfg = show_network.Settings(model=model, height=hw[0], width=hw[1],
                                trace_dir=str(trace_dir),
                                compute_dtype="bfloat16", device=str(dev))
    kernels.reset_launch_counts()
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        res = show_network.run(cfg)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    lines = said.getvalue().splitlines()
    log(f"  show_network {model} {hw[0]}x{hw[1]} b1 bf16: {res['params']:,}"
        f" params, {lines[-2]}; {lines[-1]}; launches {counts}")
    check(f"TOTAL: {res['params']:,} params" in lines,
          f"show_network {model}: no TOTAL line")
    check(k_only(counts) == counts_of(K1=5 * 14), f"show_network {model}: "
          f"launches {counts}, expected K1 5 x 14 forwards")
    traces = sorted(trace_dir.glob("*.pt.trace.json"))
    check(bool(traces), f"show_network {model}: no trace in {trace_dir}")
    events = json.loads(traces[-1].read_text())["traceEvents"]
    k1 = dict(CATEGORIES)["K1"]
    n_k1 = sum(1 for e in events if e.get("cat") == "kernel"
               and re.search(k1, e.get("name", "")))
    log(f"  show_network {model}: trace {traces[-1].name} "
        f"({traces[-1].stat().st_size} bytes), {n_k1} K1 kernel events")
    check(n_k1 == 5, f"show_network {model}: trace K1 events {n_k1}")
    build_cpu = build_flow_net if model == "flow" else build_interpolator
    cpu = cost_analysis(build_cpu(0, "cpu"),
                        torch.zeros((1, *hw, 6), dtype=torch.float32))
    extra = k1_flops(levels, k1_batch)
    log(f"  show_network {model}: card flops {res['flops']:.0f} = CPU "
        f"{cpu['flops']:.0f} + K1's formula {extra}; bytes card "
        f"{res['bytes']:.0f}, CPU {cpu['bytes accessed']:.0f}")
    check(res["flops"] == cpu["flops"] + extra,
          f"show_network {model}: flops {res['flops']} vs "
          f"{cpu['flops'] + extra}")
    return counts, res


def debug_nan_path(dev, ibatch, root) -> dict:
    """pretrain_interp --debug-nan true against the run without it (2
    synthetic steps at 256x512 b8 bf16, a log each step): the logged
    metrics bit-equal; then the debug step on ibatch with one NaN pixel
    raises FloatingPointError before the optimizer. Returns the debug
    run's launches."""
    import torch

    from qpwcnet_torch.apps import pretrain_interp
    from qpwcnet_torch.ops import cuda as kernels
    from qpwcnet_torch.train import (
        create_interp_train_state,
        make_interp_train_step,
    )

    logged = {}
    for flag in ("false", "true"):
        run_root = root / f"debug_nan_{flag}"
        args = ["--steps", "2", "--batch-size", str(INTERP_B), "--height",
                str(TRAIN_H), "--width", str(TRAIN_W), "--compute-dtype",
                "bfloat16", "--recalibrate-final", "0", "--log-every", "1",
                "--ckpt-every", "100", "--device", str(dev), "--run-root",
                str(run_root), "--debug-nan", flag]
        kernels.reset_launch_counts()
        pretrain_interp.main(args)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        lines = (run_root / "000" / "log" / "metrics.jsonl").read_text()
        logged[flag] = [{k: v for k, v in json.loads(s).items()
                         if k not in ("images_per_sec", "time")}
                        for s in lines.splitlines()]
    log(f"  pretrain_interp --debug-nan true, 2 steps bf16 "
        f"{TRAIN_H}x{TRAIN_W} b{INTERP_B}: losses "
        f"{[m['loss'] for m in logged['true']]}, without the flag "
        f"{[m['loss'] for m in logged['false']]}; launches {counts}")
    check(len(logged["true"]) == 2 and logged["true"] == logged["false"],
          "--debug-nan: the logged metrics differ from the run without it")
    # 2 steps and 2 held-out eval forwards
    check(k_only(counts) == counts_of(K1=20, K4a=10, K4b=10),
          f"--debug-nan launches {counts}")

    model = build_interp(torch.bfloat16, dev, k=1.5)
    chain = create_interp_train_state(model, 1e-4)
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    bad = {k: v.clone() for k, v in ibatch.items()}
    bad["ims"][-1, TRAIN_H // 3, TRAIN_W // 5, 4] = float("nan")
    raised = None
    try:
        make_interp_train_step(debug_nan=True)(model, chain, bad)
    except FloatingPointError as e:
        raised = str(e)
    log(f"  --debug-nan on a batch with one NaN pixel: "
        f"FloatingPointError({raised!r})")
    check(raised is not None, "--debug-nan: a NaN batch did not raise")
    check(chain.global_step == 0 and all(
        torch.equal(p, params[k]) for k, p in model.named_parameters()),
        "--debug-nan: the optimizer ran on a NaN batch")
    del model, chain
    torch.cuda.empty_cache()
    return counts


def int8_calibrated(dev, x):
    """The bf16 QAT flow model with ranges from two train-mode forwards
    on x's halves (phase 4h's calibration)."""
    import torch

    from qpwcnet_torch.quantize import QuantConfig

    calib = build(torch.bfloat16, dev, cv_impl="auto",
                  quant=QuantConfig()).train()
    half = x.shape[0] // 2
    with torch.inference_mode():
        for part in ((x[:half], x[half:]) if half else (x, x)):
            calib(part)
    return calib.eval()


def int8_spatial_path(dev, x, calib) -> dict:
    """The int8 forward at 448x1024 b8 exact in 2 local H shards against
    the unsharded int8 forward on the card: phase 4f's bf16 rule for the
    flow, the codes of the finest head's first chained conv within
    LAST_FLIP_SHARE, the haloed K1 launches. Returns the launches."""
    import dataclasses

    import torch

    from qpwcnet_torch.ops import cuda as kernels
    from qpwcnet_torch.parallel import (
        SpatialConfig, make_mesh, make_spatial_forward, shard_batch_spatial,
        unshard_batch_spatial)
    from qpwcnet_torch.quantize import QuantConfig

    int8 = dataclasses.replace(QuantConfig(), mode="int8")
    n, halo = SPATIAL_N_FWD, SPATIAL_HALO_FWD
    mesh = make_mesh(n_data=1, n_model=n)
    chained = "flower.upflows.3.flow.of_feats.0.pointwise"
    with torch.inference_mode():
        ref = int8_flow(dev, x, int8, "auto", calib)
        codes = []
        hook = emitted(ref, chained, codes)
        want = ref(x)
        hook.remove()
        sp = build(torch.bfloat16, dev, cv_impl="auto", quant=int8,
                   spatial=SpatialConfig(mesh, warp_halo=halo))
        sp.load_state_dict(calib.state_dict())
        hook = emitted(sp, chained, codes)
        fwd = make_spatial_forward(lambda m, ims: m(ims), mesh)
        kernels.reset_launch_counts()
        out = fwd(sp, shard_batch_spatial(x, mesh))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        hook.remove()
        got = unshard_batch_spatial(out, mesh)
        log(f"  int8 exact sharded {H}x{W} b{B} in {n} shards: launches "
            f"{counts}")
        check(k_only(counts) == spatial_counts(H, n), f"int8 sharded: "
              f"launches {counts}, expected {spatial_counts(H, n)}")
        check(counts["cost_volume_haloed_cuda"] > 0, "int8 sharded: no "
              "haloed K1 launch")
        compare_model("int8 sharded vs unsharded bf16", got, want,
                      torch.bfloat16)
        whole = mesh.model.gather(codes[1], 2)
        d = (whole.int() - codes[0].int()).abs()
        nd, tot = int((d > 0).sum()), d.numel()
        log(f"  int8 sharded: codes of {chained} differing from the "
            f"unsharded model's: {nd} of {tot} ({nd / tot:.3e}), at most "
            f"{int(d.max())}")
        check(nd <= LAST_FLIP_SHARE * tot, f"int8 sharded: {nd} flips")
    del ref, sp, want, got, codes
    torch.cuda.empty_cache()
    return counts


def export_path(dev, root) -> dict:
    """convert_quant --export on the card at 448x1024 b1 (exact, the
    app's own run: 3 calibration steps, the bundle, the check, the
    export) and the 'fast' int8 model through export_int8: each graph
    holds the kernels' ops (exact: qpwcnet::cost_volume x5; 'fast': x4
    and qpwcnet::warp_cost_volume x1), and each loaded .pt2 runs on the
    card bit-equal to the eager int8 forward holding the program's
    state. Returns the launches of both (the app's, and the loaded
    programs' runs)."""
    import dataclasses

    import numpy as np
    import torch

    from qpwcnet_torch.apps import convert_quant
    # importing the kernels registers their ops, which the load needs
    from qpwcnet_torch.ops import cuda as kernels
    from qpwcnet_torch.quantize import QuantConfig

    int8 = dataclasses.replace(QuantConfig(), mode="int8")
    h, w = EXPORT_HW
    x1 = torch.from_numpy(np.random.RandomState(1).uniform(
        -0.5, 0.5, (1, h, w, 6)).astype(np.float32)).to(dev)
    total = dict.fromkeys(kernels.launch_counts(), 0)
    for mode in ("exact", "fast"):
        path = root / f"int8_{mode}.pt2"
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        if mode == "exact":
            convert_quant.run(dataclasses.replace(
                convert_quant.Settings(), steps=3, height=h, width=w,
                out=str(root / "int8.npz"), export=str(path),
                device=str(dev)))
        else:
            calib = int8_calibrated(dev, x1)
            model = build(torch.float32, dev, hw=(h, w), cv_impl="fast",
                          quant=int8)
            model.load_state_dict(calib.state_dict())
            convert_quant.export_int8(model, path, x1)
            del calib, model
        t_export = time.perf_counter() - t0
        exported = torch.export.load(str(path))
        ops = graph_ops(exported)
        # the epilogue of each of the 44 Mish convs (no stem kernel in
        # int8) is the op too, so the program runs the bias + Mish kernel
        want_ops = {"qpwcnet.cost_volume": 5 if mode == "exact" else 4,
                    "qpwcnet.warp_cost_volume": 0 if mode == "exact" else 1,
                    "qpwcnet.bias_mish": 44}
        log(f"  convert_quant --export {mode} {h}x{w} b1: {path.stat().st_size}"
            f" bytes, {len(exported.graph.nodes)} nodes, custom ops {ops} "
            f"({t_export:.1f} s to here)")
        check(ops == want_ops, f"export {mode}: ops {ops}, expected "
              f"{want_ops}")
        eager = build(torch.float32, dev, hw=(h, w), k=0, quant=int8,
                      cv_impl="auto" if mode == "exact" else "fast")
        missing, _ = eager.load_state_dict(exported.state_dict,
                                           strict=False)
        check(not missing, f"export {mode}: state without {missing[:4]}")
        prog = exported.module()
        before = kernels.launch_counts()["bias_mish_cuda"]
        with torch.inference_mode():
            got = prog(x1)
            want = eager(x1)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        epilogues = counts["bias_mish_cuda"] - before
        same = bool(torch.equal(got, want))
        log(f"  loaded .pt2 {mode} on the card vs the eager int8 forward: "
            f"bit-equal {same}, mean|flow|={float(want.abs().mean()):.4f}"
            f"; launches {counts}")
        check(same and bool(torch.isfinite(got).all()),
              f"export {mode}: the loaded program differs")
        check(counts["cost_volume_cuda"] > 0 and (
            mode == "exact" or counts["warp_cost_volume_cuda"] > 0)
            and epilogues == 2 * 44,
            f"export {mode}: launches {counts}, bias + Mish in the loaded "
            f"program and the eager forward {epilogues}")
        total = {k: total[k] + counts[k] for k in total}
        del exported, prog, eager, got, want
        torch.cuda.empty_cache()
    return total


def last_ops_on_card(dev, x) -> None:
    """The last slice's ops and losses on the card against the CPU at
    448x1024 b8 float32: the losses, the manual warp and the flow
    inversion with their gradients within 1e-5 of the magnitude; the
    argmax decoding exactly; the occlusion mask but where a truncation met
    an integer boundary an ulp apart (LAST_FLIP_SHARE of the pixels)."""
    import numpy as np
    import torch

    from qpwcnet_torch.ops import (
        backward_warp_manual, cost_volume_to_flow, estimate_occlusion_map,
        invert_flow)
    from qpwcnet_torch.train import (
        flow_finetune_loss, flow_mse_loss, piecewise_halving_schedule,
        triangular2_cyclic_schedule)

    errs = {}
    rng = np.random.RandomState(SEED + 40)
    flow = rng.uniform(-12, 12, (B, H, W, 2)).astype(np.float32)
    pred = rng.uniform(-3, 3, (B, H // 4, W // 4, 2)).astype(np.float32)
    img = x[..., :3].float().cpu().numpy()
    cpu = torch.device("cpu")

    def both(fn, *arrays, grad=True):
        outs = []
        for d in (cpu, dev):
            ts = [torch.from_numpy(a).to(d).requires_grad_(grad)
                  for a in arrays]
            y = fn(*ts)
            if grad:
                y.backward(torch.ones_like(y) if y.dim() else None)
                outs.append([y.detach().cpu()] + [t.grad.cpu() for t in ts])
            else:
                outs.append([y.cpu()])
        return outs

    for tag, fn, arrays in (
            ("flow_mse_loss", flow_mse_loss, (flow, pred)),
            ("flow_finetune_loss", flow_finetune_loss, (flow, pred)),
            ("backward_warp_manual", backward_warp_manual, (img, flow)),
            ("invert_flow", invert_flow, (flow,))):
        c, g = both(fn, *arrays)
        for i, (a, b) in enumerate(zip(g, c)):
            name = tag if i == 0 else f"{tag} grad {i - 1}"
            compare(f"{name} card vs CPU", a.to(dev), b.to(dev), REL_F32,
                    errs, tag)
    c, g = both(estimate_occlusion_map, flow, grad=False)
    nd = int((c[0] != g[0]).sum())
    log(f"  estimate_occlusion_map card vs CPU: {nd} of {c[0].numel()} "
        f"pixels differ; occluded {float(c[0].mean()):.3f}")
    check(nd <= LAST_FLIP_SHARE * c[0].numel(), f"occlusion: {nd}")
    # a cost volume of the finest level's size, in half steps: many ties
    cvol = (np.round(2.0 * rng.standard_normal((B, H // 2, W // 2, 81)))
            / 2.0).astype(np.float32)
    c, g = both(cost_volume_to_flow, cvol, grad=False)
    log(f"  cost_volume_to_flow card vs CPU on a {tuple(cvol.shape)} cost "
        f"volume: equal {torch.equal(c[0], g[0])}")
    check(torch.equal(c[0], g[0]), "cost_volume_to_flow: card vs CPU")
    piecewise, cyclic = (piecewise_halving_schedule(TRAIN_B),
                         triangular2_cyclic_schedule(TRAIN_B))
    b0 = int(400_000 * 8 / TRAIN_B)
    log(f"  schedules (host functions, no card work): piecewise "
        f"{piecewise(b0 - 1):g} -> {piecewise(b0):g} at {b0}, triangular2 "
        f"at 0 / 2500 / 5000: {cyclic(0):g} / {cyclic(2500):g} / "
        f"{cyclic(5000):g}")
    check(piecewise(b0) == 0.5 * piecewise(b0 - 1), "piecewise schedule")
    del cvol
    torch.cuda.empty_cache()


def phase_last(dev, x, ibatch) -> tuple:
    """Phase 4i: the last slice (module docstring). Returns (the main
    paths' launches, show_network's numbers by model)."""
    import torch

    log("== phase 4i: the last slice")
    t_phase = time.perf_counter()
    paths, shows = {}, {}
    for model, hw, levels, k1_batch in (
            ("flow", (H, W), CV_LEVELS, 1),
            ("interp", (TRAIN_H, TRAIN_W), TRAIN_LEVELS, 2)):
        paths[f"show_network_{model}"], shows[model] = show_network_path(
            dev, model, hw, levels, k1_batch)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        paths["debug_nan_pretrain"] = debug_nan_path(dev, ibatch, tmp)
        calib = int8_calibrated(dev, x)
        paths["int8_spatial_infer"] = int8_spatial_path(dev, x, calib)
        del calib
        torch.cuda.empty_cache()
        paths["int8_export"] = export_path(dev, tmp)
    last_ops_on_card(dev, x)
    log(f"  phase 4i took {time.perf_counter() - t_phase:.1f} s")
    return paths, shows


def quant_times(dev, x, batch) -> None:
    """Phase 5's quantization rows: CUDA-event times of the int8 forward
    (exact and 'fast', and exact in 2 local H shards through
    make_spatial_forward) beside the bf16 float exact forward at the
    headline, and of the QAT flow train step beside the float step at
    256x512 b16 bf16."""
    import dataclasses

    import torch

    from qpwcnet_torch.parallel import (
        SpatialConfig, make_mesh, make_spatial_forward, shard_batch_spatial)
    from qpwcnet_torch.quantize import QuantConfig
    from qpwcnet_torch.train import make_flow_train_step, plain_optimizer

    bf16 = torch.bfloat16
    qat = QuantConfig()
    int8 = dataclasses.replace(qat, mode="int8")
    mesh = make_mesh(n_data=1, n_model=SPATIAL_N_FWD)
    fwd = make_spatial_forward(lambda m, ims: m(ims), mesh)
    xs = shard_batch_spatial(x, mesh)
    with torch.inference_mode():
        calib = build(bf16, dev, cv_impl="auto", quant=qat).train()
        calib(x[:B // 2])
        calib.eval()
        rows = [("bf16 float exact", build(bf16, dev, cv_impl="auto"))]
        rows += [(f"int8 {m}", int8_flow(dev, x, int8, cv, calib))
                 for m, cv in (("exact", "auto"), ("fast", "fast"))]
        for tag, m in rows:
            log(f"  time: flow forward {tag} {H}x{W} b{B}: "
                f"{time_ms(lambda: m(x)):.3f} ms")
        sp = build(bf16, dev, cv_impl="auto", quant=int8,
                   spatial=SpatialConfig(mesh, warp_halo=SPATIAL_HALO_FWD))
        sp.load_state_dict(calib.state_dict())
        log(f"  time: flow forward int8 exact sharded ({SPATIAL_N_FWD} "
            f"local H shards) {H}x{W} b{B}: "
            f"{time_ms(lambda: fwd(sp, xs)):.3f} ms")
        del rows, calib, sp
    torch.cuda.empty_cache()
    step = make_flow_train_step()
    for tag, kw in (("float", {}), ("QAT", dict(quant=qat))):
        m = build_train(bf16, dev, cv_impl="auto", **kw)
        opt = plain_optimizer(m, 0.0)
        log(f"  time: flow train step {tag} bf16 {TRAIN_H}x{TRAIN_W} "
            f"b{TRAIN_B}: {time_ms(lambda: step(m, opt, batch), n=5):.3f} ms")
        del m, opt
        torch.cuda.empty_cache()


def show_times(shows: dict) -> None:
    """Phase 5's show_network rows: the forward times it measured in phase
    4i (time_fn: CUDA events, the median of 10 after 2 warm-up calls) and
    the TFLOP/s of its cost_analysis flops."""
    for model, r in shows.items():
        log(f"  time: show_network {model} forward bf16 b1: "
            f"{r['forward_s'] * 1e3:.3f} ms, {r['flops'] / 1e9:.3f} GFLOP "
            f"({r['tflops']:.3f} TFLOP/s), {r['bytes'] / 1e6:.1f} MB by "
            f"cost_analysis")


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


def bound_cv_haloed(b, h, w, c):
    """The haloed modes at one shard level, bf16: the (b, h, w, c) map,
    the haloed (b, h + 8, w, c) map and the (b, h, w, 81) map moved once
    (K1: prv, nxt_h, out; K4a: dacc, nxt_h, dprv; K4b: dacc, prv, dnxt_h);
    81·c multiply-adds a pixel."""
    px = b * h * w
    return bound(2 * (px * c + b * (h + 8) * w * c + 81 * px),
                 2 * 81 * c * px)


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


def device_time(fn) -> float:
    """``cv_split.device_ms`` of fn, or nan where the profiler kept no
    kernel record in any of its windows (it drops records now and then):
    a device time that was not measured, logged as such and as nan."""
    from qpwcnet_torch.utils.cv_split import device_ms

    try:
        return device_ms(fn)
    except RuntimeError as e:
        log(f"    device time not measured: {e}")
        return math.nan


def mish_times(dev, totals):
    """The bias + Mish kernels at MISH_SHAPES in bf16 against the
    composition (its forward; its autograd backward as the time of
    forward + backward less the forward's), and their bound: bytes moved
    once over 3.35 TB/s, 4 an element forward (x in, out out) and 6
    backward (x and g in, dx out). The first shape (flower.l4) goes on the
    kernels line."""
    import torch

    from qpwcnet_torch.ops.cuda.mish_kernel import (
        bias_mish_bwd_cuda, bias_mish_cuda, bias_mish_plain)

    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    cl = torch.channels_last
    for i, shape in enumerate(MISH_SHAPES[:2]):
        x = (6 * torch.randn(shape, generator=g, device=dev)).to(
            torch.bfloat16).contiguous(memory_format=cl)
        b = torch.randn(shape[1], generator=g, device=dev)
        gr = torch.randn(shape, generator=g, device=dev).to(
            torch.bfloat16).contiguous(memory_format=cl)
        n = x.numel()
        bnd_f = (4 * n / PEAK_BYTES * 1e3, 0.0)
        bnd_b = (6 * n / PEAK_BYTES * 1e3, 0.0)
        p1, k1, k2, p2 = (time_ms(lambda: bias_mish_plain(x, b)),
                          time_ms(lambda: bias_mish_cuda(x, b)),
                          time_ms(lambda: bias_mish_cuda(x, b)),
                          time_ms(lambda: bias_mish_plain(x, b)))
        k, p = (k1 + k2) / 2, (p1 + p2) / 2
        xr, br = x.clone().requires_grad_(), b.clone().requires_grad_()
        both = time_ms(lambda: torch.autograd.grad(
            bias_mish_plain(xr, br), (xr, br), gr))
        pb = both - time_ms(lambda: bias_mish_plain(xr, br))
        kb = time_ms(lambda: bias_mish_bwd_cuda(x, b, gr))
        log(f"  bias_mish {shape} bf16: forward kernel {k:.4f} ms ({k1:.4f}"
            f", {k2:.4f}) | composition {p:.4f} ms | x{p / k:.2f} | bound "
            f"{bnd_f[0] * 1e3:.2f} us, kernel/bound x{k / bnd_f[0]:.2f}; "
            f"backward kernel {kb:.4f} ms | composition's autograd "
            f"{pb:.4f} ms | bound {bnd_b[0] * 1e3:.2f} us, kernel/bound "
            f"x{kb / bnd_b[0]:.2f}")
        kf = time_chain_ms(lambda: bias_mish_cuda(x, b))
        kbc = time_chain_ms(lambda: bias_mish_bwd_cuda(x, b, gr))
        kd = device_time(lambda: bias_mish_cuda(x, b))
        log(f"    chained x20: forward {kf:.4f} ms (x{kf / bnd_f[0]:.2f} the "
            f"bound), backward {kbc:.4f} ms (x{kbc / bnd_b[0]:.2f}); "
            f"forward device {kd:.4f} ms (x{kd / bnd_f[0]:.2f})")
        if i == 0:
            totals.add("bias_mish", k, p, bnd_f)
        del x, gr, xr, br
        torch.cuda.empty_cache()


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
        cost_volume_plain, cost_volume_plain_haloed)
    from qpwcnet_torch.ops.cuda.cost_volume_kernel import (
        cost_volume_bwd_nxt_cuda, cost_volume_bwd_nxt_haloed_cuda,
        cost_volume_bwd_prv_cuda, cost_volume_bwd_prv_haloed_cuda,
        cost_volume_cuda, cost_volume_haloed_cuda)
    from qpwcnet_torch.ops.cuda.stem_kernel import (
        downconv_stage_cuda, downconv_stage_plain)
    from qpwcnet_torch.ops.cuda.upconv_kernel import (
        upconv_stage_cuda, upconv_stage_plain)
    from qpwcnet_torch.ops.cuda.warp_cv_kernel import (
        warp_cost_volume_cuda, warp_cost_volume_plain)
    from qpwcnet_torch.ops.conv import same_pads
    from qpwcnet_torch.utils.gemm_times import kernel_ms

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
            kd = device_time(lambda: cost_volume_cuda(prv, nxt))
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
        # K2 at the headline's five encoder stages (the kernels line sums
        # all five, the fully fused forward's; stages 0-1 are logged
        # apart), then stages 3, 4 and 2 at the train step's shapes; the
        # wide stages (2-4, the GEMM) with each device kernel's time
        beats, first_two = [], 0.0
        for n, ((b, h, w, cin), cout) in enumerate(
                (STEM_SHAPES[0], STEM_SHAPES[1], STEM_SHAPES[6],
                 STEM_WIDE_SHAPES[3], STEM_WIDE_SHAPES[4],
                 STEM_WIDE_SHAPES[5], STEM_WIDE_SHAPES[6],
                 STEM_WIDE_SHAPES[0])):
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
                f"achieved, x{k / max(bnd):.1f} the bound, kernel / cuDNN "
                f"x{k / lib:.2f}; chained x20 (card time where the host "
                f"keeps up): kernel {kc:.4f} ms, x{kc / max(bnd):.1f} the "
                f"bound, {nbytes / (kc * 1e-3) / 1e9:.1f} GB/s | cuDNN "
                f"{lc:.4f} ms, kernel / cuDNN x{kc / lc:.2f}")
            if n >= 2:
                # prep_w33, then conv_a (mode 0) and conv_aa + conv_b
                # (mode 1, two launches)
                parts = kernel_ms(
                    lambda: downconv_stage_cuda(xs, params, bf16))
                log(f"    {tag}: device ms " + ", ".join(
                    f"{k} {v:.4f}" for k, v in parts.items())
                    + f"; sum {sum(parts.values()):.4f} (x"
                    f"{sum(parts.values()) / max(bnd):.1f} the bound)")
            if n < 5:
                totals.add("downconv_stage", k, p, bnd, lib)
                beats.append(k < p and k < lib)
            first_two += k if n < 2 else 0.0
            del xs, params, wb
        log(f"  K2 below its plain version and cuDNN at {sum(beats)} of "
            f"{len(beats)} headline stages; stages 0-1 one call "
            f"{first_two:.4f} ms, all five "
            f"{totals.rows['downconv_stage']['ms']:.4f} ms")
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
        kd = device_time(lambda: warp_cost_volume_cuda(prv, nxt, flow))
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
                kd = device_time(lambda: kern(dacc, src))
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
        # The haloed modes, one call each (the kernels line), the halo
        # rows in the bound: K1 at the spatial forward's five levels, K4a
        # and K4b at the train step's levels that launch them (4 rows a
        # shard or more; the coarsest falls back to the whole level)
        fwd_levels, train_levels = spatial_levels()
        for b, h, w, c in fwd_levels:
            prv, nxt_h = rand((b, h, w, c)), rand((b, h + 8, w, c))
            bnd = bound_cv_haloed(b, h, w, c)
            k, p, _ = ab(f"K1 haloed ({b},{h},{w},{c}) nxt +8 rows",
                         lambda: cost_volume_haloed_cuda(prv, nxt_h),
                         lambda: cost_volume_plain_haloed(prv, nxt_h), bnd)
            totals.add("cost_volume_haloed", k, p, bnd)
        for name, cat, kern, plain in (
                ("cost_volume_bwd_prv_haloed", "K4a haloed",
                 cost_volume_bwd_prv_haloed_cuda,
                 lambda d, m: cost_volume_bwd_prv_plain(d, m, True)),
                ("cost_volume_bwd_nxt_haloed", "K4b haloed",
                 cost_volume_bwd_nxt_haloed_cuda,
                 lambda d, m: cost_volume_bwd_nxt_plain(d, m, True))):
            for b, h, w, c in train_levels:
                if h < 4:
                    continue
                rows = h + 8 if name.endswith("prv_haloed") else h
                dacc, src = rand((b, h, w, 81)), rand((b, rows, w, c))
                bnd = bound_cv_haloed(b, h, w, c)
                k, p, _ = ab(f"{cat} ({b},{h},{w},{c})",
                             lambda: kern(dacc, src),
                             lambda: plain(dacc, src), bnd)
                totals.add(name, k, p, bnd)
        for name in KERNELS:
            if name.endswith("haloed"):
                r = totals.rows[name]
                log(f"  {name}: one call {r['ms']:.4f} ms over its levels, "
                    f"plain {r['plain_ms']:.4f} ms, bound "
                    f"{r['bound_ms']:.4f} ms")
        del prv, nxt_h, dacc, src
        # K5 at the six decoder shapes of stages 2-3 and the six of stages
        # 0-1 (the interpolator's and the flow's training steps, the
        # headline); the kernels line sums the interpolator's training
        # step's four stages (the fully fused pretraining path)
        beats_plain, beats_lib = [], []
        for n, (shape, co) in enumerate(UPCONV_SHAPES[:6]
                                        + UPCONV_WIDE_SHAPES[:6]):
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
                f"GB/s | cuDNN {lc:.4f} ms, kernel / cuDNN x{kc / lc:.2f}")
            if n >= 6:
                parts = kernel_ms(lambda: upconv_stage_cuda(xs, wt, bi, bf16))
                log(f"    K5 {shape}->{co}: device ms " + ", ".join(
                    f"{k} {v:.4f}" for k, v in parts.items())
                    + f"; sum {sum(parts.values()):.4f} (x"
                    f"{sum(parts.values()) / max(bnd):.1f} the bound)")
            beats_plain.append(k < p)
            if shape[0] == 16:
                beats_lib.append(k <= lib)
            if n in (0, 1, 6, 7):
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

    mish_times(dev, totals)

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
    spatial_times(dev, x, batch)
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
    fused_in_model(dev, x, batch, ibatch)
    return totals.rows


def data_times(dev, root, n_steps=10, rounds=1):
    """Phase 5, the data path at 256x512 b16 bf16 on the phase 4g
    fixtures: host decoding a sample (FlyingThings3D's two WebP frames
    and PFM flow, a Sintel record), the augmentation's card time a batch
    (540x960 -> 256x512, base scale 0.56; and its host-to-card copy), and
    the train_flow step fed from the FlyingThings3D loader (augmentation
    on) beside the step on synthetic batches made on the card, wall ms a
    step in turns synthetic, dataset, dataset, synthetic (n_steps each
    after warm-up), with the time a dataset step waits on the loader."""
    import glob

    import numpy as np
    import torch

    from qpwcnet_torch.apps import train_flow
    from qpwcnet_torch.data import (
        draw_flow_augmentation, preprocess_flow_batch)
    from qpwcnet_torch.data.augment import color_augment_pair, scale_and_crop
    from qpwcnet_torch.data.fchairs3d import decode_pair, read_set_file
    from qpwcnet_torch.data.pfm import read_pfm
    from qpwcnet_torch.data.pipeline import load_image
    from qpwcnet_torch.data.tfrecord import (
        parse_sintel_example, tfrecord_iterator)
    from qpwcnet_torch.parallel import make_mesh_for_batch, make_parallel_step
    from qpwcnet_torch.train import make_flow_train_step

    log(f"  the data path ({TRAIN_H}x{TRAIN_W} b{TRAIN_B} bf16, phase 4g's "
        "fixtures; host clock for the host's work):")
    root = Path(root)
    pairs = read_set_file(root / "f3d_set.txt")

    def host_ms(fn, items):
        t0 = time.perf_counter()
        for it in items:
            fn(*it)
        return 1e3 * (time.perf_counter() - t0) / len(items)

    webp = host_ms(lambda a, b, f: (load_image(a), load_image(b)), pairs)
    pfm = host_ms(lambda a, b, f: read_pfm(f), pairs)
    pair = host_ms(decode_pair, pairs)
    records = [r for s in sorted(glob.glob(str(root / "shards" / "*")))
               for r in tfrecord_iterator(s)]
    rec = host_ms(parse_sintel_example, [(r,) for r in records])
    log(f"    host decode a sample, one thread: FlyingThings3D "
        f"{FT3D_HW[0]}x{FT3D_HW[1]} {pair:.2f} ms (two WebP frames "
        f"{webp:.2f}, PFM {pfm:.2f}); Sintel record {SINTEL_HW[0]}x"
        f"{SINTEL_HW[1]} {rec:.2f} ms ({len(pairs)} and {len(records)} "
        "samples)")

    cfg = train_flow.Settings(
        data="fc3d", data_path=str(root / "f3d_set.txt"),
        batch_size=TRAIN_B, height=TRAIN_H, width=TRAIN_W, base_scale=0.56,
        compute_dtype="bfloat16", device=str(dev))
    loader = train_flow._dataset_loader(cfg)
    batches = iter(loader)
    ims_u8, flo = next(batches)
    nbytes = ims_u8.nbytes + flo.nbytes
    copy = time_ms(lambda: (torch.from_numpy(ims_u8).to(dev),
                            torch.from_numpy(flo).to(dev)))
    d_ims, d_flo = torch.from_numpy(ims_u8).to(dev), torch.from_numpy(
        flo).to(dev)
    draws = draw_flow_augmentation(
        torch.Generator(device=dev).manual_seed(SEED + 32), TRAIN_B, 0.56)
    aug = time_ms(lambda: preprocess_flow_batch(d_ims, d_flo,
                                                (TRAIN_H, TRAIN_W), draws))
    crop = time_ms(lambda: scale_and_crop(
        d_ims, d_flo, (TRAIN_H, TRAIN_W), draws["scale"], draws["oy_frac"],
        draws["ox_frac"], draws["flip_ud"], draws["flip_lr"]))
    cropped = scale_and_crop(d_ims, d_flo, (TRAIN_H, TRAIN_W),
                             draws["scale"], draws["oy_frac"],
                             draws["ox_frac"])[0]
    color = time_ms(lambda: color_augment_pair(
        cropped, draws["brightness"], draws["saturation"], draws["hue"],
        draws["contrast"]))
    log(f"    augmentation on the card, {TRAIN_B}x{FT3D_HW[0]}x{FT3D_HW[1]}"
        f" -> {TRAIN_H}x{TRAIN_W}: {aug:.4f} ms a batch (CUDA events; of "
        f"it flips + scale and crop {crop:.4f}, colour {color:.4f}); "
        f"host-to-card copy of the batch ({nbytes / 1e6:.1f} MB, pageable)"
        f" {copy:.4f} ms")
    del d_ims, d_flo, cropped

    model = train_flow.build_model(cfg)
    kind, _ = train_flow._resolve_optimizer(cfg)
    opt = train_flow._make_optimizer(kind, model, cfg.learning_rate)
    step_fn = make_parallel_step(make_flow_train_step(),
                                 make_mesh_for_batch(TRAIN_B))
    waits = []

    def dataset_step(i):
        t = time.perf_counter()
        ims, fl = next(batches)
        waits.append(time.perf_counter() - t)
        step_fn(model, opt, train_flow.prepare_batch(cfg, ims, fl, i))

    def synthetic_step(i):
        step_fn(model, opt, train_flow._batch(cfg, SEED + i, TRAIN_H,
                                              TRAIN_W, 24.0))

    turn_waits = []

    def wall(fn):
        def run():
            for i in range(2):
                fn(i)
            torch.cuda.synchronize()
            start = len(waits)
            t0 = time.perf_counter()
            for i in range(n_steps):
                fn(i)
            torch.cuda.synchronize()
            if len(waits) > start:
                turn_waits.append(1e3 * np.array(waits[start:]))
            return 1e3 * (time.perf_counter() - t0) / n_steps
        return run

    in_turns(f"flow step {TRAIN_H}x{TRAIN_W} b{TRAIN_B} bf16, wall ms a "
             "step", "data", {"synthetic": wall(synthetic_step),
                              "fc3d": wall(dataset_step)},
             "img/s", TRAIN_B, rounds=rounds)
    log("    the dataset step's wait on the loader, ms a step, each turn's "
        f"mean (max) over {n_steps} steps, 4 loader threads: "
        + ", ".join(f"{float(t.mean()):.3f} ({float(t.max()):.3f})"
                    for t in turn_waits))
    loader.close()
    del model, opt
    torch.cuda.empty_cache()


def spatial_times(dev, x, batch):
    """The sharded forward (SPATIAL_N_FWD shards) and train step
    (SPATIAL_N_TRAIN) on the local transport beside the unsharded model
    (stem_stages=0, cv_impl='auto'), bf16, in turns a, b, b, a; for the
    record: the shards run in one process on one card."""
    import torch

    from qpwcnet_torch.parallel import (
        SpatialConfig, make_mesh, make_spatial_forward,
        make_spatial_train_step, shard_batch_spatial)
    from qpwcnet_torch.train import make_flow_train_step, plain_optimizer

    bf16 = torch.bfloat16
    mesh = make_mesh(n_data=1, n_model=SPATIAL_N_FWD)
    fwd = make_spatial_forward(lambda m, ims: m(ims), mesh)
    xs = shard_batch_spatial(x, mesh)
    ref = build(bf16, dev, cv_impl="auto", stem_stages=0)
    sp = build(bf16, dev, cv_impl="auto",
               spatial=SpatialConfig(mesh, warp_halo=SPATIAL_HALO_FWD))
    with torch.inference_mode():
        runs = {"unsharded": lambda: time_ms(lambda: ref(x)),
                "sharded": lambda: time_ms(lambda: fwd(sp, xs))}
        t = {k: [] for k in runs}
        for k in ("unsharded", "sharded", "sharded", "unsharded"):
            t[k].append(runs[k]())
    log(f"  forward bf16 {H}x{W} b{B}: unsharded {t['unsharded']} ms, "
        f"{SPATIAL_N_FWD} shards {t['sharded']} ms")
    del ref, sp
    mesh = make_mesh(n_data=1, n_model=SPATIAL_N_TRAIN)
    sbatch = {k: shard_batch_spatial(v, mesh) for k, v in batch.items()}
    models = {}
    for k, spatial in (("unsharded", None), ("sharded", SpatialConfig(
            mesh, warp_halo=SPATIAL_HALO_TRAIN))):
        m = build_train(bf16, dev, cv_impl="auto", stem_stages=0,
                        spatial=spatial)
        models[k] = (m, plain_optimizer(m, 1e-4))
    steps = {"unsharded": (make_flow_train_step(0.0), batch),
             "sharded": (make_spatial_train_step(make_flow_train_step(0.0),
                                                 mesh), sbatch)}
    t = {k: [] for k in steps}
    for k in ("unsharded", "sharded", "sharded", "unsharded"):
        step, b = steps[k]
        t[k].append(time_ms(lambda: step(*models[k], b), n=N_STEPS_TIMED,
                            warmup=2))
    log(f"  train step bf16 {TRAIN_H}x{TRAIN_W} b{TRAIN_B}: unsharded "
        f"{t['unsharded']} ms, {SPATIAL_N_TRAIN} shards {t['sharded']} ms")
    del models
    torch.cuda.empty_cache()


def in_turns(tag, knob, runs, unit, per, rounds=1):
    """Time the two settings a, b of ``knob`` (``runs`` = {a: fn, b: fn},
    each fn() the ms of one timing) in turns a, b, b, a, ``rounds`` times,
    and log each setting's mean and turns, and b - a against the spread
    of the turns within a setting (ms each, ``per`` items a call in
    ``unit``)."""
    a, b = runs
    t = {u: [] for u in runs}
    for _ in range(rounds):
        for u in (a, b, b, a):
            t[u].append(runs[u]())
    ma, mb = (statistics.mean(t[u]) for u in (a, b))
    spread = max(max(v) - min(v) for v in t.values())
    log(f"    {tag}: {knob}={a} {ma:.3f} ms "
        f"({', '.join(f'{v:.3f}' for v in t[a])}), ={b} {mb:.3f} ms "
        f"({', '.join(f'{v:.3f}' for v in t[b])}); {per / ma * 1e3:.2f} vs "
        f"{per / mb * 1e3:.2f} {unit}; {b} - {a} = {mb - ma:+.3f} ms, "
        f"largest spread of one setting's turns {spread:.3f} ms")


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


def busy_in_turns(tag, knob, fns, per_turn=3):
    """The card's busy time (torch.profiler: the union of the device
    kernels' intervals, per call) of the two settings a, b of ``knob``
    (``fns`` = {a: fn, b: fn}), ``per_turn`` calls a turn, in turns a, b,
    b, a: unlike the wall time, it leaves out the host's share."""
    from qpwcnet_torch.utils.profiling import breakdown

    a, b = fns
    t = {u: [] for u in fns}
    for u in (a, b, b, a):
        try:
            t[u].append(breakdown(fns[u], n=per_turn, warmup=1)["busy_ms"])
        except RuntimeError as e:  # a window without device records
            log(f"    {tag}, {knob}={u}: device busy not measured: {e}")
            t[u].append(math.nan)
    ma, mb = (statistics.mean(t[u]) for u in (a, b))
    spread = max(max(v) - min(v) for v in t.values())
    log(f"    {tag}, device busy: {knob}={a} {ma:.3f} ms "
        f"({', '.join(f'{v:.3f}' for v in t[a])}), ={b} {mb:.3f} ms "
        f"({', '.join(f'{v:.3f}' for v in t[b])}); {b} - {a} = "
        f"{mb - ma:+.3f} ms, largest spread of one setting's turns "
        f"{spread:.3f} ms")


def fused_in_model(dev, x, batch, ibatch, rounds=2):
    """The fully fused configuration's in-model effect, bf16, one knob at
    a time from the kernels' earlier configuration (stem_stages=2,
    upconv_stages=2): stem_stages 2 beside 5 and upconv_stages 2 beside
    4, each in turns a, b, b, a ``rounds`` times on one model of each
    (wall time, CUDA events) and then its card busy time (torch.profiler,
    one round: 3 forwards or 1 step a turn; tracing a step's 4000-8000
    launches takes seconds of host time), on the exact flow forward at
    448x1024 b8, the flow train step at 256x512 b16 and the pretraining
    step at 256x512 b8."""
    import torch

    from qpwcnet_torch.train import (
        create_interp_train_state, make_flow_train_step,
        make_interp_train_step, plain_optimizer)

    bf16 = torch.bfloat16
    log(f"  fused in-model (stem_stages 2 beside 5, upconv_stages 2 beside "
        f"4, the other knob at 2; {rounds} x turns a, b, b, a; then the "
        f"card's busy time in turns a, b, b, a):")
    step = make_flow_train_step(0.0)
    istep = make_interp_train_step()
    for knob, (a, b) in (("stem_stages", (2, 5)), ("upconv_stages", (2, 4))):
        def kw(u):
            return dict(dict(stem_stages=2, upconv_stages=2), **{knob: u})

        with torch.inference_mode():
            fs = {u: build(bf16, dev, cv_impl="auto", **kw(u)) for u in (a, b)}
            tag = f"flow forward exact {H}x{W} b{B}"
            in_turns(tag, knob, {u: (lambda m=m: time_ms(lambda: m(x)))
                                 for u, m in fs.items()}, "pairs/s", B, rounds)
            busy_in_turns(tag, knob, {u: (lambda m=m: m(x))
                                      for u, m in fs.items()})
            del fs
        torch.cuda.empty_cache()
        ms = {u: build_train(bf16, dev, cv_impl="auto", **kw(u))
              for u in (a, b)}
        opts = {u: plain_optimizer(m, 1e-4) for u, m in ms.items()}
        tag = f"flow train step exact {TRAIN_H}x{TRAIN_W} b{TRAIN_B}"
        in_turns(tag, knob, {u: (lambda u=u: time_ms(
            lambda: step(ms[u], opts[u], batch), n=N_STEPS_TIMED, warmup=2))
            for u in ms}, "img/s", TRAIN_B, rounds)
        busy_in_turns(tag, knob, {u: (lambda u=u: step(ms[u], opts[u], batch))
                                  for u in ms}, per_turn=1)
        del ms, opts
        torch.cuda.empty_cache()
        ms = {u: build_interp(bf16, dev, k=TRAIN_K, cv_impl="auto", **kw(u))
              for u in (a, b)}
        opts = {u: create_interp_train_state(m, 1e-4) for u, m in ms.items()}
        tag = f"pretraining step {TRAIN_H}x{TRAIN_W} b{INTERP_B}"
        in_turns(tag, knob, {u: (lambda u=u: time_ms(
            lambda: istep(ms[u], opts[u], ibatch), n=N_STEPS_TIMED,
            warmup=2)) for u in ms}, "img/s", INTERP_B, rounds)
        busy_in_turns(tag, knob, {u: (lambda u=u: istep(ms[u], opts[u],
                                                        ibatch))
                                  for u in ms}, per_turn=1)
        del ms, opts
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
    phase_kernels_mish(dev, errs)
    phase_kernels_haloed(dev, errs)
    infer_counts, x = phase_slice(dev)
    with cudnn_deterministic():
        train_counts, batch = phase_train(dev)
        interp_paths, ibatch = phase_interp(dev, x)
        ckpt_paths = phase_ckpt(dev, batch)
        fused_paths = phase_fused(dev, x, batch, ibatch)
        spatial_paths = phase_spatial(dev, x, batch)
        quant_paths = phase_quant(dev, x, batch, ibatch)
        last_paths, shows = phase_last(dev, x, ibatch)
    with tempfile.TemporaryDirectory() as data_root:
        data_paths = phase_data(dev, data_root)
        totals = phase_times(dev, x, batch, ibatch)
        data_times(dev, data_root)
        quant_times(dev, x, batch)
        show_times(shows)
    log(f"== all phases passed in {time.perf_counter() - t0:.1f} s")

    paths = {"infer_app": infer_counts, "train_app": train_counts,
             **interp_paths, **ckpt_paths, **fused_paths, **spatial_paths,
             **quant_paths, **last_paths, **data_paths}
    # every path runs Mish convs on the card (25 or more a forward in each
    # configuration), each through the bias + Mish kernel, and a path
    # that ran the cost volume's backward ran the epilogue's too
    for p, c in paths.items():
        bwd = (c["cost_volume_bwd_prv_cuda"]
               + c["cost_volume_bwd_prv_haloed_cuda"])
        check(c["bias_mish_cuda"] > 0 and (c["bias_mish_bwd_cuda"] > 0
                                           or not bwd),
              f"{p}: bias + Mish launches {c}")
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
