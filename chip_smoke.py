#!/usr/bin/env python3
"""Drive the PyTorch port's flow-inference and flow-training paths on one
CUDA card.

    python3 chip_smoke.py          # from the root of a repository checkout

Phases (any failure exits non-zero; nothing is caught and carried on):
  1. device: the card's name and power limit; TF32 off.
  2. build: nvcc-builds qpwcnet_torch/csrc/*.cu (sm_90a) and loads it.
  3. kernel equality: each CUDA kernel against its plain PyTorch version
     at the headline shapes (448x1024 input, batch 8, so 2B = 16 through
     the encoder), at batch 1 (the infer app's) and at one shape that is
     no tile multiple, in float32 and bf16; the cost-volume backward
     kernels K4a and K4b at the five cost-volume levels of the training
     configuration (256x512, batch 16), at batch 1 and at an odd shape,
     and the trainable cost volume's gradients against autograd of the
     plain cost volume at the finest training level.
  4. slice: PWCFlowNet at 448x1024 b8 with seeded, non-zero flow heads,
     exact and 'fast', against the plain model (stem_stages=0,
     cv_impl='plain') in bf16 and float32, with each kernel's launch
     count per forward; the float32 model on the card against the same
     model on the CPU at a small shape; then the infer app
     (qpwcnet_torch.apps.infer, --fast, 2 requests at 448x1024) as the
     first main path.
  4b. train slice at 256x512 b16 (the JAX bench's training
     configuration): one train step of the exact, 'fast' and plain models
     (seeded flow heads, and a fresh 'diag' model whose flows are zero),
     every parameter's gradient against the plain model's in float32 and
     bf16, each kernel's launch count per step, the loss falling over 5
     steps on a fixed batch; then the train app
     (qpwcnet_torch.apps.train_flow, synthetic data, 4 steps) as the
     second main path.
  5. times: CUDA events after warm-up, median of N: each kernel against
     its plain version at the headline shapes (K4a and K4b at the training
     levels), the whole forward, and the train step.

The line before the card line is a JSON object with one entry per kernel,
whose launch count is the sum over the two main paths' runs (each run
with the counts set to 0 just before it and read just after); the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
}


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


def counts_of(K1=0, K2=0, K3=0, K4a=0, K4b=0) -> dict:
    """Launch counts by wrapper name (qpwcnet_torch.ops.cuda)."""
    return {"cost_volume_cuda": K1, "downconv_stage_cuda": K2,
            "warp_cost_volume_cuda": K3, "cost_volume_bwd_prv_cuda": K4a,
            "cost_volume_bwd_nxt_cuda": K4b}


def build(dtype, dev, hw=(H, W), k=1.5, **kw):
    """build_flow_net from SEED with flow heads seeded for inputs of
    size hw (k = 0: the fresh 'diag' heads, zero flow)."""
    from qpwcnet_torch.models import build_flow_net

    model = build_flow_net(SEED, dev, dtype=dtype, **kw)
    if k:
        seed_flow_heads(model, SEED + 1, hw, k=k)
    return model


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
    return lib


def phase_kernels(dev):
    import torch

    from qpwcnet_torch.ops.cost_volume import cost_volume_plain
    from qpwcnet_torch.ops.cuda.cost_volume_kernel import cost_volume_cuda
    from qpwcnet_torch.ops.cuda.stem_kernel import (
        downconv_stage_cuda, downconv_stage_plain)
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
        # batch 8 (the headline) and 1 (the infer app's requests)
        cases = ([(b, *lv) for b in (B, 1) for lv in CV_LEVELS]
                 + [(3, 13, 37, 24)])
        for b, h, w, c in cases:
            prv, nxt = rand((b, h, w, c), dtype), rand((b, h, w, c), dtype)
            compare(f"K1 cost_volume {dn} ({b},{h},{w},{c})",
                    cost_volume_cuda(prv, nxt), cost_volume_plain(prv, nxt),
                    rel, errs, "cost_volume")
        # flows inside the ±4 window (clipped at 3.9), and beyond it
        for shape, fscale, lim in (((B, 224, 512, 32), 2.0, 3.9),
                                   ((B, 224, 512, 32), 6.0, None),
                                   ((1, 224, 512, 32), 6.0, None),
                                   ((2, 13, 37, 24), 6.0, None)):
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
        for (b, h, w, cin), cout in (((2 * B, H, W, 3), 16),
                                     ((2 * B, H // 2, W // 2, 16), 32),
                                     ((2, H, W, 3), 16),
                                     ((2, H // 2, W // 2, 16), 32),
                                     ((2, 70, 90, 3), 16)):
            x = rand((b, h, w, cin), dtype, 0.5)
            params = [(rand((cout, ci, 3, 3), torch.float32,
                            (9 * ci) ** -0.5),
                       rand((cout,), torch.float32, 0.1))
                      for ci in (cin, cout, cout)]
            # bf16: a one-ulp rounding flip in conv_a or conv_aa moves the
            # later convs' sums across rounding points too: 4 ulps
            compare(f"K2 downconv_stage {dn} ({b},{h},{w},{cin})->{cout}",
                    downconv_stage_cuda(x, params, dtype),
                    downconv_stage_plain(x, params, dtype),
                    rel if dtype == torch.float32 else 4 * REL_BF16,
                    errs, "downconv_stage")
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
        cases = ([(b, *lv) for b in (TRAIN_B, 1) for lv in TRAIN_LEVELS]
                 + [(3, 13, 37, 24)])
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


def phase_slice(dev):
    import numpy as np
    import torch

    from qpwcnet_torch.apps import infer
    from qpwcnet_torch.ops import cuda as kernels
    from qpwcnet_torch.utils.config import parse_config

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
            ref = flows["plain", dtype]
            scale = max(1.0, float(ref.abs().max()))
            # float32: five levels of convs in another summation order
            # feeding the warp coordinates, 1e-4 of the flow magnitude (the
            # JAX parity bound of tests/test_torch_model.py); bf16: a
            # one-ulp difference early moves later warps, 5% of it max
            # and 0.5% mean.
            rel = 1e-4 if dtype == f32 else 5e-2
            err = max_err(flows["exact", dtype], ref)
            mean = float((flows["exact", dtype] - ref).abs().mean())
            log(f"  exact vs plain {dn}: max_abs_err={err:.3e} "
                f"mean_abs_err={mean:.3e} tol={rel * scale:.3e}")
            check(err <= rel * scale, f"exact vs plain {dn}: {err}")
            if dtype == bf16:
                check(mean <= 5e-3 * scale, f"exact vs plain {dn} mean")
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


def grad_step(model, batch):
    """One make_flow_train_step with the plain chain at learning rate 0,
    so the parameters stay as they were. Returns (loss, {name: grad},
    launch counts of the step)."""
    import torch

    from qpwcnet_torch.ops import cuda as kernels
    from qpwcnet_torch.train import make_flow_train_step, plain_optimizer

    opt = plain_optimizer(model, 0.0)
    kernels.reset_launch_counts()
    m = make_flow_train_step()(model, opt, batch)
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


def phase_times(dev, x, batch):
    import torch

    from qpwcnet_torch.ops.cost_volume import (
        cost_volume_bwd_nxt_plain, cost_volume_bwd_prv_plain,
        cost_volume_plain)
    from qpwcnet_torch.ops.cuda.cost_volume_kernel import (
        cost_volume_bwd_nxt_cuda, cost_volume_bwd_prv_cuda,
        cost_volume_cuda)
    from qpwcnet_torch.ops.cuda.stem_kernel import (
        downconv_stage_cuda, downconv_stage_plain)
    from qpwcnet_torch.ops.cuda.warp_cv_kernel import (
        warp_cost_volume_cuda, warp_cost_volume_plain)

    log(f"== phase 5: times (bf16, CUDA events, median of {N_TIMED} after "
        "warm-up; order plain, kernel, kernel, plain, reported the mean "
        "of each pair)")
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 4)

    def rand(shape, dtype=bf16, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)
                ).to(dtype)

    def ab(tag, kern, plain):
        p1, k1, k2, p2 = (time_ms(plain), time_ms(kern), time_ms(kern),
                          time_ms(plain))
        k, p = (k1 + k2) / 2, (p1 + p2) / 2
        log(f"  {tag}: kernel {k:.4f} ms ({k1:.4f}, {k2:.4f}) | plain "
            f"{p:.4f} ms ({p1:.4f}, {p2:.4f}) | x{p / k:.2f}")
        return k, p

    totals = {name: [0.0, 0.0] for name in KERNELS}
    with torch.inference_mode():
        for h, w, c in CV_LEVELS:
            prv, nxt = rand((B, h, w, c)), rand((B, h, w, c))
            k, p = ab(f"K1 cost_volume ({B},{h},{w},{c})",
                      lambda: cost_volume_cuda(prv, nxt),
                      lambda: cost_volume_plain(prv, nxt))
            totals["cost_volume"][0] += k
            totals["cost_volume"][1] += p
        for (b, h, w, cin), cout in (((2 * B, H, W, 3), 16),
                                     ((2 * B, H // 2, W // 2, 16), 32)):
            xs = rand((b, h, w, cin), scale=0.5)
            params = [(rand((cout, ci, 3, 3), torch.float32,
                            (9 * ci) ** -0.5),
                       rand((cout,), torch.float32, 0.1))
                      for ci in (cin, cout, cout)]
            k, p = ab(f"K2 downconv_stage ({b},{h},{w},{cin})->{cout}",
                      lambda: downconv_stage_cuda(xs, params, bf16),
                      lambda: downconv_stage_plain(xs, params, bf16))
            totals["downconv_stage"][0] += k
            totals["downconv_stage"][1] += p
        shape = (B, 224, 512, 32)
        prv, nxt = rand(shape), rand(shape)
        flow = rand(shape[:3] + (2,), torch.float32, 3.0)
        k, p = ab(f"K3 warp_cost_volume {shape}",
                  lambda: warp_cost_volume_cuda(prv, nxt, flow),
                  lambda: warp_cost_volume_plain(prv, nxt, flow))
        totals["warp_cost_volume"] = [k, p]
        del prv, nxt, flow
        for name, kern, plain in (
                ("cost_volume_bwd_prv", cost_volume_bwd_prv_cuda,
                 cost_volume_bwd_prv_plain),
                ("cost_volume_bwd_nxt", cost_volume_bwd_nxt_cuda,
                 cost_volume_bwd_nxt_plain)):
            totals[name] = [0.0, 0.0]
            for h, w, c in TRAIN_LEVELS:
                dacc, src = rand((TRAIN_B, h, w, 81)), rand((TRAIN_B, h, w, c))
                k, p = ab(f"{name} ({TRAIN_B},{h},{w},{c})",
                          lambda: kern(dacc, src), lambda: plain(dacc, src))
                totals[name][0] += k
                totals[name][1] += p
        del dacc, src
        torch.cuda.empty_cache()

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
        torch.cuda.empty_cache()

    # The train step as the app runs it on synthetic data (plain chain,
    # no l2 term), one batch, parameters updated every step.
    from qpwcnet_torch.train import make_flow_train_step, plain_optimizer

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
    return totals


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
    infer_counts, x = phase_slice(dev)
    train_counts, batch = phase_train(dev)
    totals = phase_times(dev, x, batch)
    log(f"== all phases passed in {time.perf_counter() - t0:.1f} s")

    entries = []
    for name, meta in KERNELS.items():
        key = f"{name}_cuda"
        launches = infer_counts[key] + train_counts[key]
        check(launches > 0, f"{name}: no launch on the main paths")
        entries.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches,
            "launches_infer_app": infer_counts[key],
            "launches_train_app": train_counts[key],
            "max_abs_err": errs[name],
            "ms": totals[name][0], "plain_ms": totals[name][1]})
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
