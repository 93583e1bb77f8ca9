"""Device-time breakdown of a step with ``torch.profiler``.

    python -m qpwcnet_torch.utils.profiling        # on a CUDA card

profiles the exact bf16 flow train step at 256x512, batch 16 (the JAX
bench's training configuration; cv_impl='auto', stem_stages=2, the
plain chain) and the interpolator's bf16 pretraining step at 256x512,
batch 8 (the JAX bench's pretraining configuration), for the kernel model
(stem_stages=2, upconv_stages=2) and the plain model, and prints one
markdown table row each: kernels per step, the host-clock wall of the
profiled steps, the device busy time (the union of the kernel
intervals) and its share of the wall, and device ms per step by
category (each CUDA kernel of the port by name, cuDNN, elementwise,
reductions, the warp's gathers and scatters, concatenation, the
optimizer, other). The profiler adds host time, so its wall is above
the CUDA-event step times of chip_smoke.py.
"""

from __future__ import annotations

import re
import sys
import time

import torch

# (category, pattern of the demangled kernel name); the first match wins
CATEGORIES = (
    # K1: the float32 body (CUDA cores) and the bf16 body (tensor cores)
    ("K1", r"correlate_kernel<[^>]*, false>|cost_volume_mma_kernel"),
    # K3: the float32 body (CUDA cores) and the bf16 body (tensor cores)
    ("K3", r"correlate_kernel<[^>]*, true>|warp_cv_mma_kernel"),
    # K4a, K4b: the float32 body (CUDA cores) and the bf16 body (tensor
    # cores)
    ("K4a", r"cv_bwd_kernel<[^>]*, false>|cv_bwd_mma_kernel<false"),
    ("K4b", r"cv_bwd_kernel<[^>]*, true>|cv_bwd_mma_kernel<true"),
    ("K2", r"qpw::stem_(mma_)?kernel"),
    ("K5", r"qpw::upconv_(mma_)?kernel"),
    ("optimizer", r"multi_tensor|[Aa]dam"),
    ("cuDNN", r"cudnn|conv|xmma|implicit|gemm|cutlass|nchwToNhwc|nhwcToNchw"),
    ("gather/scatter", r"index|gather|scatter"),
    ("concat", r"CatArray"),
    ("reduce", r"reduce"),
    ("elementwise", r"elementwise"),
)


def category(name: str) -> str:
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name):
            return cat
    return "other"


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def breakdown(fn, n: int = 3, warmup: int = 3) -> dict:
    """Profile n calls of fn() after warm-up. Returns per-call {'kernels',
    'wall_ms', 'busy_ms', 'busy_share', 'by_category': {cat: ms}}."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device events")
    by_cat: dict[str, float] = {}
    for e in kernels:
        c = category(e.name)
        by_cat[c] = by_cat.get(c, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    busy = _union_us((e.time_range.start, e.time_range.end)
                     for e in kernels) / 1e3 / n
    return {"kernels": len(kernels) / n, "wall_ms": wall, "busy_ms": busy,
            "busy_share": busy / wall, "by_category": by_cat}


def _flow_train_step(kw: dict, b: int = 16, h: int = 256, w: int = 512):
    from qpwcnet_torch.data import preprocess_flow_batch, synthetic_flow_batch
    from qpwcnet_torch.models import build_flow_net
    from qpwcnet_torch.train import make_flow_train_step, plain_optimizer

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ims, flo = synthetic_flow_batch(gen, b, h, w)
    batch = preprocess_flow_batch(ims, flo, out_hw=(h, w))
    model = build_flow_net(0, dev, dtype=torch.bfloat16, **kw)
    opt = plain_optimizer(model, 1e-4)
    step = make_flow_train_step(0.0)
    return lambda: step(model, opt, batch)


def _pretraining_step(kw: dict, b: int = 8, h: int = 256, w: int = 512):
    from qpwcnet_torch.data import (
        preprocess_triplet_batch,
        synthetic_triplet_batch,
    )
    from qpwcnet_torch.models import build_interpolator
    from qpwcnet_torch.train import (
        create_interp_train_state,
        make_interp_train_step,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = preprocess_triplet_batch(
        None, *synthetic_triplet_batch(gen, b, h, w), augment=False)
    model = build_interpolator(0, dev, dtype=torch.bfloat16, **kw)
    opt = create_interp_train_state(model, 1e-4)
    step = make_interp_train_step()
    return lambda: step(model, opt, batch)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profiling: needs a CUDA card")
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{smi}; torch {torch.__version__}")
    cats = [c for c, _ in CATEGORIES] + ["other"]
    print("| step | kernels/step | profiled wall ms | device busy ms (share)"
          " | " + " | ".join(cats) + " |")
    for name, make, kw in (
            ("flow step exact bf16", _flow_train_step,
             dict(cv_impl="auto", stem_stages=2)),
            ("pretraining exact bf16", _pretraining_step,
             dict(stem_stages=2, upconv_stages=2)),
            ("pretraining plain bf16", _pretraining_step,
             dict(cv_impl="plain"))):
        r = breakdown(make(kw))
        cells = [f"{r['by_category'].get(c, 0.0):.3f}" for c in cats]
        print(f"| {name} | {r['kernels']:.0f} | {r['wall_ms']:.3f} | "
              f"{r['busy_ms']:.3f} ({r['busy_share']:.1%}) | "
              + " | ".join(cells) + " |", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
