"""Times of the wide stages (``csrc/conv_gemm.cuh``) at the models' shapes.

    python -m qpwcnet_torch.utils.gemm_times [--json PATH]    # on a card

prints one markdown row a shape, bf16, for K2 at encoder stages 2-4 and
K5 at decoder stages 0-1: at the flow headline (448x1024, 2B = 16), the
flow train step (256x512, 2B = 32), the interpolator's pretraining step
(K5: 256x512, 2B = 16), batch 1 and one shape that is no tile multiple
(stage 2). Columns: the bound (bytes moved once over 3.35 TB/s, or bf16
operations over 989 TFLOP/s, the larger), one call (the median of 10
CUDA-event windows around one call, the wrapper's host time inside),
chained (20 back-to-back calls between CUDA events after 3 warm-up
calls: the card's time where the host keeps up), chained / bound, the
cuDNN call for the same convolutions (``F.conv2d`` x 3 or
``F.conv_transpose2d``, bias, no Mish: one call and chained), and the
device time of each device kernel of one call (torch.profiler over 20
calls). The script imports only the wrappers' public functions, so it
also times another checkout's kernels: run the file itself with that
checkout first on ``PYTHONPATH``, e.g. ``PYTHONPATH=../parent python
qpwcnet_torch/utils/gemm_times.py`` from inside it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

from qpwcnet_torch.ops.cuda.stem_kernel import downconv_stage_cuda
from qpwcnet_torch.ops.cuda.upconv_kernel import upconv_stage_cuda

PEAK_BYTES, PEAK_OPS = 3.35e12, 989e12
# (stage, shape (B, H, W, Ci), Co), K2's input and K5's
STEM = [("K2 s2 headline", (16, 112, 256, 32), 64),
        ("K2 s2 train", (32, 64, 128, 32), 64),
        ("K2 s2 b1", (2, 112, 256, 32), 64),
        ("K2 s2 ragged", (3, 38, 70, 32), 64),
        ("K2 s3 headline", (16, 56, 128, 64), 128),
        ("K2 s3 train", (32, 32, 64, 64), 128),
        ("K2 s4 headline", (16, 28, 64, 128), 256),
        ("K2 s4 train", (32, 16, 32, 128), 256)]
UP = [("K5 s0 interp", (16, 8, 16, 256), 128),
      ("K5 s0 train", (32, 8, 16, 256), 128),
      ("K5 s0 headline", (16, 14, 32, 256), 128),
      ("K5 s1 interp", (16, 16, 32, 256), 64),
      ("K5 s1 train", (32, 16, 32, 256), 64),
      ("K5 s1 headline", (16, 28, 64, 256), 64)]


def bound_ms(nbytes: float, nops: float) -> float:
    return max(nbytes / PEAK_BYTES, nops / PEAK_OPS) * 1e3


def stem_bound(b, h, w, ci, co) -> float:
    """The bf16 input and output moved once, the float32 weights; the
    three convs' multiply-adds."""
    px = b * (h // 2) * (w // 2)
    nbytes = (2 * (b * h * w * ci + px * co)
              + 4 * (9 * co * (ci + 2 * co) + 3 * co))
    return bound_ms(nbytes, 2 * px * 9 * co * (ci + 2 * co))


def up_bound(b, h, w, ci, co) -> float:
    """The bf16 input and 2x output moved once, the float32 weight; 4
    taps of ci multiply-adds per output value."""
    nbytes = (2 * (b * h * w * ci + 4 * b * h * w * co)
              + 4 * (16 * ci * co + co))
    return bound_ms(nbytes, 2 * 4 * ci * 4 * b * h * w * co)


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


def kernel_ms(fn, n: int = 20) -> dict[str, float]:
    """Device ms a call of each device kernel fn launches, by its name up
    to the argument list, from torch.profiler over n calls queued behind
    a spin kernel: the mean of the records kept (the profiler drops one
    now and then) times the records a call (a name may launch twice a
    call, as K2's stride-1 GEMM does)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    recs: dict[str, list[float]] = {}
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or "spin_kernel" in e.name):
            continue
        name = e.name.split("(")[0].replace("void ", "").replace("qpw::", "")
        recs.setdefault(name, []).append(e.time_range.elapsed_us())
    return {name: sum(v) / len(v) * max(1, round(len(v) / n)) / 1e3
            for name, v in recs.items()}


def rows(dev):
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(shape, dtype=bf16, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)

    for tag, (b, h, w, ci), co in STEM:
        x = rand((b, h, w, ci), scale=0.5)
        params = [(rand((co, c, 3, 3), torch.float32, (9 * c) ** -0.5),
                   rand((co,), torch.float32, 0.1)) for c in (ci, co, co)]
        wb = [(wt.to(bf16), bi.to(bf16)) for wt, bi in params]
        xn = x.permute(0, 3, 1, 2)

        def cudnn(xn=xn, wb=wb):
            # SAME on an even input: stride 2 pads (0, 1), stride 1 (1, 1)
            y = F.conv2d(F.pad(xn, (0, 1, 0, 1)), *wb[0], stride=2)
            y = F.conv2d(y, *wb[1], padding=1)
            return F.conv2d(y, *wb[2], padding=1)

        yield tag, (b, h, w, ci), co, stem_bound(b, h, w, ci, co), \
            lambda x=x, params=params: downconv_stage_cuda(x, params, bf16), \
            cudnn
    for tag, (b, h, w, ci), co in UP:
        x = rand((b, h, w, ci))
        wt = rand((ci, co, 4, 4), torch.float32, (4 * ci) ** -0.5)
        bi = rand((co,), torch.float32, 0.1)
        wb = (wt.to(bf16), bi.to(bf16))
        xn = x.permute(0, 3, 1, 2)
        yield tag, (b, h, w, ci), co, up_bound(b, h, w, ci, co), \
            lambda x=x, wt=wt, bi=bi: upconv_stage_cuda(x, wt, bi, bf16), \
            lambda xn=xn, wb=wb: F.conv_transpose2d(xn, *wb, stride=2,
                                                    padding=1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write the rows to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gemm_times: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    import qpwcnet_torch

    print(f"{smi}; torch {torch.__version__}; package "
          f"{qpwcnet_torch.__file__}", flush=True)
    dev = torch.device("cuda", 0)
    print("| stage | shape (B,H,W,Ci)->Co | bound µs | one call ms | "
          "chained ms | chained ÷ bound | cuDNN one call ms | cuDNN chained "
          "ms | one call ÷ cuDNN | device ms by kernel |")
    print("|---|---|---:|---:|---:|---:|---:|---:|---:|---|")
    out = []
    with torch.inference_mode():
        for tag, shape, co, bnd, kern, lib in rows(dev):
            one, ch = one_call_ms(kern), chained_ms(kern)
            lone, lch = one_call_ms(lib), chained_ms(lib)
            dk = kernel_ms(kern)
            parts = ", ".join(f"{k} {v:.4f}" for k, v in dk.items())
            print(f"| {tag} | {shape}->{co} | {bnd * 1e3:.2f} | {one:.4f} | "
                  f"{ch:.4f} | {ch / bnd:.1f} | {lone:.4f} | {lch:.4f} | "
                  f"{one / lone:.2f} | {parts} |", flush=True)
            out.append(dict(stage=tag, shape=list(shape), co=co,
                            bound_ms=bnd, one_call_ms=one, chained_ms=ch,
                            cudnn_ms=lone, cudnn_chained_ms=lch,
                            device_ms=dk))
            torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(device=smi, rows=out), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
