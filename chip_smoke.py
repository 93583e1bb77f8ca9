#!/usr/bin/env python3
"""Drive the PyTorch port's flow-inference path on one CUDA card.

    python3 chip_smoke.py          # from the root of a repository checkout

Phases (any failure exits non-zero; nothing is caught and carried on):
  1. device: the card's name and power limit; TF32 off.
  2. build: nvcc-builds qpwcnet_torch/csrc/*.cu (sm_90a) and loads it.
  3. kernel equality: each CUDA kernel against its plain PyTorch version
     at the headline shapes (448x1024 input, batch 8, so 2B = 16 through
     the encoder), at batch 1 (the infer app's) and at one shape that is
     no tile multiple, in float32 and bf16.
  4. slice: PWCFlowNet at 448x1024 b8 with seeded, non-zero flow heads,
     exact and 'fast', against the plain model (stem_stages=0,
     cv_impl='plain') in bf16 and float32, with each kernel's launch
     count per forward; the float32 model on the card against the same
     model on the CPU at a small shape; then the infer app
     (qpwcnet_torch.apps.infer, --fast, 2 requests at 448x1024) as the
     main path whose launch counts the JSON line reports.
  5. times: CUDA events after warm-up, median of N: each kernel against
     its plain version at the headline shapes, and the whole forward.

The line before the card line is a JSON object with one entry per kernel;
the last line is {"ok": true, "device": {...}}.
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


def build(dtype, dev, **kw):
    from qpwcnet_torch.models import build_flow_net

    model = build_flow_net(SEED, dev, dtype=dtype, **kw)
    seed_flow_heads(model, SEED + 1, (H, W))
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
    expected = {"exact": {"cost_volume_cuda": 5, "downconv_stage_cuda": 2,
                          "warp_cost_volume_cuda": 0},
                "fast": {"cost_volume_cuda": 4, "downconv_stage_cuda": 2,
                         "warp_cost_volume_cuda": 1}}
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
        check(main_counts == {"cost_volume_cuda": 8,
                              "downconv_stage_cuda": 4,
                              "warp_cost_volume_cuda": 2},
              f"infer launches {main_counts}")
    return main_counts, x


def phase_times(dev, x):
    import torch

    from qpwcnet_torch.ops.cost_volume import cost_volume_plain
    from qpwcnet_torch.ops.cuda.cost_volume_kernel import cost_volume_cuda
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
    main_counts, x = phase_slice(dev)
    totals = phase_times(dev, x)
    log(f"== all phases passed in {time.perf_counter() - t0:.1f} s")

    launch_key = {"cost_volume": "cost_volume_cuda",
                  "downconv_stage": "downconv_stage_cuda",
                  "warp_cost_volume": "warp_cost_volume_cuda"}
    entries = []
    for name, meta in KERNELS.items():
        entries.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": main_counts[launch_key[name]],
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
