#!/usr/bin/env python3
"""Times of the port's hand-written CUDA kernels on one card, beside their
plain PyTorch versions, cuDNN and their bounds.

    python3 kernel_times.py        # from the root of a checkout, on a card

prints one markdown row a shape, bf16, and a row a kernel summing its
shapes (PERF.md §6's table): K1 at the five cost-volume levels of the
flow headline (448x1024, batch 8); K1 haloed at those levels in 2 H
shards (the H-sharded forward's); K2 at the headline's five encoder
stages; K3 at the 'fast' forward's finest level; K4a and K4b at the five
levels of the flow train step (256x512, batch 16); K4a and K4b haloed at
that step's levels in 4 H shards that launch them (4 rows a shard or
more); K5 at the pretraining step's four decoder stages (256x512, batch
8); bias + Mish at flower.l4's widest conv at the headline.

Columns: one call (the median of 10 CUDA-event windows around one call,
the wrapper's host time inside, in turns plain, kernel, kernel, plain:
each side's mean), chained (20 back-to-back calls between two events:
the card's time where the host keeps up), device (torch.profiler: the
device kernels of one call, over 20 calls queued behind a spin kernel),
the plain version's one call, cuDNN's one call for the same product (K2:
its three convs, K5: its transpose conv, with the biases and without
Mish), the bound (perfbench/work.py: bytes moved once over 3.35 TB/s or
bf16 operations over 989 TFLOP/s, the larger; bias + Mish: its bf16
input read and output written once) and one call over the bound.

It imports only the kernels' public wrappers and plain versions, so a
copy of it at the root of another checkout times that checkout's
kernels: the way to compare two commits on one card.
"""

from __future__ import annotations

import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

from perfbench.work import bound, bound_cv, bound_stem, bound_upconv
from qpwcnet_torch.ops.cost_volume import (
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
from qpwcnet_torch.ops.cuda.mish_kernel import bias_mish_cuda, bias_mish_plain
from qpwcnet_torch.ops.cuda.stem_kernel import (
    downconv_stage_cuda,
    downconv_stage_plain,
)
from qpwcnet_torch.ops.cuda.upconv_kernel import (
    upconv_stage_cuda,
    upconv_stage_plain,
)
from qpwcnet_torch.ops.cuda.warp_cv_kernel import (
    warp_cost_volume_cuda,
    warp_cost_volume_plain,
)

BF16 = torch.bfloat16
B, TRAIN_B, INTERP_B = 8, 16, 8
# (h, w, C) of the cost volumes, coarsest first: the headline's, the
# train step's
CV_LEVELS = [(14, 32, 256), (28, 64, 256), (56, 128, 128), (112, 256, 64),
             (224, 512, 32)]
TRAIN_LEVELS = [(8, 16, 256), (16, 32, 256), (32, 64, 128), (64, 128, 64),
                (128, 256, 32)]
HALO = 4   # rows of each neighbour shard
# K2's input (B, H, W, Ci) -> Co at the headline's encoder stages 0-4
STEM = [((2 * B, 448, 1024, 3), 16), ((2 * B, 224, 512, 16), 32),
        ((2 * B, 112, 256, 32), 64), ((2 * B, 56, 128, 64), 128),
        ((2 * B, 28, 64, 128), 256)]
# K5's input -> Co at the pretraining step's decoder stages 0-3
UPCONV = [((2 * INTERP_B, 8, 16, 256), 128), ((2 * INTERP_B, 16, 32, 256), 64),
          ((2 * INTERP_B, 32, 64, 128), 32), ((2 * INTERP_B, 64, 128, 64), 16)]
# ~3 ms of the card's clock: longer than the host takes to enqueue 20
# calls, so that the card is busy while tracing starts
SPIN_CYCLES = 5_000_000


def one_call_ms(fn, n: int = 10, warmup: int = 3) -> float:
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


def chained_ms(fn, n: int = 20, warmup: int = 3) -> float:
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


def device_ms(fn, n: int = 20, tries: int = 3) -> float:
    """Device ms of one fn() call: each device kernel's mean duration in a
    torch.profiler trace of n calls times its records a call, summed. The
    profiler drops a record now and then (one or two of 20 in a
    long-lived process), so a kernel's mean is over the records kept; a
    window that kept none is profiled again, up to ``tries`` windows;
    nan where none kept any (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPIN_CYCLES)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        recs: dict[str, list[float]] = {}
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and "spin_kernel" not in e.name):
                recs.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if recs:
            return sum(statistics.mean(v) * max(1, round(len(v) / n))
                       for v in recs.values()) / 1e3
    return float("nan")


def rows(dev):
    """(kernel, shape, the kernel's call, the plain call, cuDNN's call or
    None, bound s) for every row of the table; a row's calls are timed
    before the next row's inputs are made."""
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(shape, dtype=BF16, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)

    for h, w, c in CV_LEVELS:
        prv, nxt = rand((B, h, w, c)), rand((B, h, w, c))
        yield ("K1", (B, h, w, c), lambda: cost_volume_cuda(prv, nxt),
               lambda: cost_volume_plain(prv, nxt), None,
               bound_cv(B, h, w, c))
    for h, w, c in CV_LEVELS:
        b, h = 2 * B, h // 2
        prv, nxt_h = rand((b, h, w, c)), rand((b, h + 2 * HALO, w, c))
        yield ("K1 haloed", (b, h, w, c),
               lambda: cost_volume_haloed_cuda(prv, nxt_h),
               lambda: cost_volume_plain_haloed(prv, nxt_h), None,
               bound_cv(b, h, w, c, extra_bytes=2 * 2 * HALO * b * w * c))
    for (b, h, w, ci), co in STEM:
        x = rand((b, h, w, ci), scale=0.5)
        params = [(rand((co, c, 3, 3), torch.float32, (9 * c) ** -0.5),
                   rand((co,), torch.float32, 0.1)) for c in (ci, co, co)]
        wb = [(wt.to(BF16), bi.to(BF16)) for wt, bi in params]
        xn = x.permute(0, 3, 1, 2)

        def cudnn(xn=xn, wb=wb):
            # SAME on an even input: stride 2 pads (0, 1), stride 1 (1, 1)
            y = F.conv2d(F.pad(xn, (0, 1, 0, 1)), *wb[0], stride=2)
            y = F.conv2d(y, *wb[1], padding=1)
            return F.conv2d(y, *wb[2], padding=1)

        yield ("K2", (b, h, w, ci, co),
               lambda x=x, p=params: downconv_stage_cuda(x, p, BF16),
               lambda x=x, p=params: downconv_stage_plain(x, p, BF16),
               cudnn, bound_stem(b, h, w, ci, co))
    shape = (B, 224, 512, 32)
    prv, nxt = rand(shape), rand(shape)
    flow = rand(shape[:3] + (2,), torch.float32, 3.0)
    # K3 also reads the float32 flow
    yield ("K3", shape, lambda: warp_cost_volume_cuda(prv, nxt, flow),
           lambda: warp_cost_volume_plain(prv, nxt, flow), None,
           bound_cv(*shape, extra_bytes=8 * B * 224 * 512))
    for name, kern, plain in (
            ("K4a", cost_volume_bwd_prv_cuda, cost_volume_bwd_prv_plain),
            ("K4b", cost_volume_bwd_nxt_cuda, cost_volume_bwd_nxt_plain)):
        for h, w, c in TRAIN_LEVELS:
            dacc, src = rand((TRAIN_B, h, w, 81)), rand((TRAIN_B, h, w, c))
            yield (name, (TRAIN_B, h, w, c),
                   lambda k=kern, d=dacc, s=src: k(d, s),
                   lambda p=plain, d=dacc, s=src: p(d, s), None,
                   bound_cv(TRAIN_B, h, w, c))
    for name, kern, plain, rows_in in (
            ("K4a haloed", cost_volume_bwd_prv_haloed_cuda,
             cost_volume_bwd_prv_plain, 2 * HALO),
            ("K4b haloed", cost_volume_bwd_nxt_haloed_cuda,
             cost_volume_bwd_nxt_plain, 0)):
        for h, w, c in TRAIN_LEVELS:
            b, h = 4 * TRAIN_B, h // 4
            if h < HALO:
                continue
            dacc, src = rand((b, h, w, 81)), rand((b, h + rows_in, w, c))
            yield (name, (b, h, w, c),
                   lambda k=kern, d=dacc, s=src: k(d, s),
                   lambda p=plain, d=dacc, s=src: p(d, s, True), None,
                   bound_cv(b, h, w, c,
                            extra_bytes=2 * 2 * HALO * b * w * c))
    for shape, co in UPCONV:
        x = rand(shape)
        ci = shape[-1]
        wt = rand((ci, co, 4, 4), torch.float32, (4 * ci) ** -0.5)
        bi = rand((co,), torch.float32, 0.1)
        wb = (wt.to(BF16), bi.to(BF16))
        yield ("K5", (*shape, co),
               lambda x=x, wt=wt, bi=bi: upconv_stage_cuda(x, wt, bi, BF16),
               lambda x=x, wt=wt, bi=bi: upconv_stage_plain(x, wt, bi, BF16),
               lambda x=x, wb=wb: F.conv_transpose2d(
                   x.permute(0, 3, 1, 2), *wb, stride=2, padding=1),
               bound_upconv(*shape, co))
    shape = (B, 128, 224, 512)
    x = (6 * torch.randn(shape, generator=g, device=dev)).to(BF16).contiguous(
        memory_format=torch.channels_last)
    bi = torch.randn(shape[1], generator=g, device=dev)
    yield ("bias + Mish", shape, lambda: bias_mish_cuda(x, bi),
           lambda: bias_mish_plain(x, bi), None,
           bound(2 * x.element_size() * x.numel(), 0))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    import qpwcnet_torch

    print(f"{smi}; torch {torch.__version__}; package "
          f"{qpwcnet_torch.__file__}", flush=True)
    cols = ("one call", "chained", "device", "plain", "cuDNN")
    print("| kernel | shape | " + " | ".join(f"{c} ms" for c in cols)
          + " | bound µs | one call ÷ bound |")
    print("|---|---|" + "---:|" * (len(cols) + 2))

    def fmt(v):
        return "—" if v is None else f"{v:.4f}"

    def row(name, shape, t, bnd):
        print(f"| {name} | {shape} | " + " | ".join(fmt(t[c]) for c in cols)
              + f" | {bnd * 1e6:.2f} | {t['one call'] / (bnd * 1e3):.1f} |",
              flush=True)

    dev = torch.device("cuda", 0)
    totals: dict[str, tuple[dict, float]] = {}
    with torch.inference_mode():
        for name, shape, kern, plain, lib, bnd in rows(dev):
            p1, k1, k2, p2 = (one_call_ms(plain), one_call_ms(kern),
                              one_call_ms(kern), one_call_ms(plain))
            t = {"one call": (k1 + k2) / 2, "chained": chained_ms(kern),
                 "device": device_ms(kern), "plain": (p1 + p2) / 2,
                 "cuDNN": None if lib is None else one_call_ms(lib)}
            row(name, shape, t, bnd)
            tot, b_sum = totals.get(name, (dict.fromkeys(cols), 0.0))
            totals[name] = ({c: t[c] if tot[c] is None else tot[c] + t[c]
                             for c in cols}, b_sum + bnd)
            torch.cuda.empty_cache()
    print("\nsummed over each kernel's shapes:\n")
    print("| kernel | shapes | " + " | ".join(f"{c} ms" for c in cols)
          + " | bound µs | one call ÷ bound |")
    print("|---|---|" + "---:|" * (len(cols) + 2))
    for name, (t, bnd) in totals.items():
        row(name, "all", t, bnd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
