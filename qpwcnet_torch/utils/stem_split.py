"""Where K2's bf16 time goes: ``csrc/stem.cu`` built four ways and timed.

    python -m qpwcnet_torch.utils.stem_split        # on a CUDA card

builds the bf16 stem kernel as it is ("full"), without Mish (the epilogue
rounds the sum and adds the bias only: "no Mish"), without the products
(the k loops skipped, the ldmatrix loads with them: "no products") and
without both ("neither": the input staging, the epilogue's rounding and
stores, the barriers), each into its own library under
``build/qpwcnet_torch/stem_split/``, and prints one markdown row a shape:
each variant's time of one call, chained (20 back-to-back calls between
CUDA events after 3 warm-up calls), at encoder stages 0-1 of the flow
headline (448x1024, 2B = 16), the widths the fused bf16 body is built
for (stages 2-4 run the implicit GEMM of ``csrc/conv_gemm.cuh``: its
times are ``qpwcnet_torch.utils.gemm_times``'s). Only "full" computes the
stage; the others exist to be timed.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from qpwcnet_torch.ops.cuda import _build

MISH = "mish2(y)"
K_LOOP = "for (int kk = 0; kk < kin; kk += 16) {"
SHAPES = (((16, 448, 1024, 3), 16), ((16, 224, 512, 16), 32))


def variants(src: str) -> dict[str, str]:
    for pat in (MISH, K_LOOP):
        if src.count(pat) != 1:
            raise RuntimeError(f"stem.cu no longer holds {pat!r} once")
    no_mish = src.replace(MISH, "y")
    skip = K_LOOP.replace("kk < kin", "kk < 0")
    return {"full": src, "no Mish": no_mish,
            "no products": src.replace(K_LOOP, skip),
            "neither": no_mish.replace(K_LOOP, skip)}


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile the variants (one nvcc each, all at once) and load them."""
    root = _build.BUILD_DIR / "stem_split"
    jobs = {}
    for i, (name, src) in enumerate(
            variants((_build.CSRC_DIR / "stem.cu").read_text()).items()):
        d = root / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "stem.cu").write_text(src)
        lib = d / "libstem.so"
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
               "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-I",
               str(_build.CSRC_DIR), "-o", str(lib), str(d / "stem.cu")]
        jobs[name] = (lib, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, cmd, proc) in jobs.items():
        out, err = proc.communicate()
        _build._require_ok(proc.returncode, cmd, out, err)
        fn = ctypes.CDLL(str(lib)).qpw_downconv_stage
        fn.argtypes = _build.SIGNATURES["qpw_downconv_stage"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("stem_split: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{smi}; torch {torch.__version__}", flush=True)
    libs = build_all()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    print("| shape (B,H,W,Ci)->Co | " + " | ".join(f"{n} ms" for n in libs)
          + " |")
    for (b, h, w, cin), cout in SHAPES:
        x = (0.5 * torch.randn((b, h, w, cin), generator=g, device=dev)
             ).bfloat16()
        params = [t for ci in (cin, cout, cout) for t in (
            torch.randn((cout, ci, 3, 3), generator=g, device=dev)
            * (9 * ci) ** -0.5,
            0.1 * torch.randn((cout,), generator=g, device=dev))]
        out = torch.empty((b, h // 2, w // 2, cout), dtype=torch.bfloat16,
                          device=dev)
        cells = []
        for fn in libs.values():
            def call(fn=fn):
                _build.check(fn(x.data_ptr(), *(p.data_ptr() for p in params),
                                out.data_ptr(), None, None, b, h, w, cin,
                                cout, 1, _build.stream_ptr(dev)),
                             "qpw_downconv_stage")
            cells.append(f"{chained_ms(call):.4f}")
        print(f"| ({b},{h},{w},{cin})->{cout} | " + " | ".join(cells) + " |",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
