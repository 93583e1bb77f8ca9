"""Where K1's bf16 time goes: ``csrc/cost_volume.cu`` (with the shared
``csrc/cv_mma.cuh``) built seven ways and timed.

    python -m qpwcnet_torch.utils.cv_split        # on a CUDA card

builds the cost-volume kernel as it is ("full"), without the products
(the k16 loop skipped, its ldmatrix loads with it: "no products"),
without the output stores (the epilogue still rounds into shared memory:
"no stores"), without both ("neither": the staging copies, the
epilogue's rounding and the barriers), and whole with the launcher's tile
shape forced to (TY, DG) = (8, 1), (4, 3) or (2, 9) at every level
("tiles 8x1", "tiles 4x3", "tiles 2x9"), each into its own library under
``build/qpwcnet_torch/cv_split/`` (one nvcc each, all at once), and
prints one markdown row a level of the flow headline (448x1024, batch 8):
each variant's device time a call (torch.profiler over 20 calls after 3
warm-up calls) and the bound (bytes moved once at 3.35 TB/s). The
"no ..." and "neither" variants exist to be timed; the others compute the
cost volume and are held against its plain version (one bf16 ulp).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from qpwcnet_torch.ops.cost_volume import cost_volume_plain
from qpwcnet_torch.ops.cuda import _build

K_LOOP = "for (int ks = 0; ks < CM_CC / 16; ++ks) {"
STORES = "for (int i = tid; i < TY * CM_UNITS; i += Cfg::NT) {"
TILE8 = "if (runs * ((H + 7) / 8) >= 2LL * n_sm)"
TILE4 = "if (runs * ((H + 3) / 4) >= n_sm)"
# the variants that compute the cost volume
COMPUTES = ("full", "tiles 8x1", "tiles 4x3", "tiles 2x9")
# ~3 ms of the card's clock: longer than the host takes to enqueue 20 calls
SPIN_CYCLES = 5_000_000
LEVELS = ((8, 14, 32, 256), (8, 28, 64, 256), (8, 56, 128, 128),
          (8, 112, 256, 64), (8, 224, 512, 32))


def flatten(name: str) -> str:
    """csrc/``name`` with the shared header ``cv_mma.cuh`` written into it
    (its ``#pragma once`` dropped), so that a variant can edit the parts
    that the header holds."""
    header = (_build.CSRC_DIR / "cv_mma.cuh").read_text().replace(
        "#pragma once\n", "")
    src = (_build.CSRC_DIR / name).read_text()
    include = '#include "cv_mma.cuh"\n'
    if src.count(include) != 1:
        raise RuntimeError(f"{name} no longer includes cv_mma.cuh once")
    return src.replace(include, header)


def variants(src: str, name: str = "cost_volume.cu") -> dict[str, str]:
    """The variants of a flattened source (:func:`flatten`): whole, without
    the products, without the stores, without both, and with each tile
    shape forced."""
    for pat in (K_LOOP, STORES, TILE8, TILE4):
        if src.count(pat) != 1:
            raise RuntimeError(f"{name} no longer holds {pat!r} once")
    no_mma = K_LOOP.replace("ks < CM_CC / 16", "ks < 0")
    no_st = STORES.replace("i < TY * CM_UNITS", "i < 0")
    return {"full": src,
            "no products": src.replace(K_LOOP, no_mma),
            "no stores": src.replace(STORES, no_st),
            "neither": src.replace(K_LOOP, no_mma).replace(STORES, no_st),
            "tiles 8x1": src.replace(TILE8, "if (true)"),
            "tiles 4x3": src.replace(TILE8, "if (false)").replace(
                TILE4, "if (true)"),
            "tiles 2x9": src.replace(TILE8, "if (false)").replace(
                TILE4, "if (false)")}


def build(srcs: dict[str, str], entries=("qpw_cost_volume",),
          subdir: str = "cv_split") -> dict[str, ctypes.CDLL]:
    """One library a variant, one nvcc each, all started together; each
    variant's namespace is renamed so that its template symbols do not
    bind to another loaded library's. ``entries`` are the C entry points
    to bind (``_build.SIGNATURES``)."""
    out = _build.BUILD_DIR / subdir
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src in srcs.items():
        tag = name.replace(" ", "_")
        cu, lib = out / f"cv_{tag}.cu", out / f"cv_{tag}.so"
        cu.write_text(src)
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
               "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
               f"-Dqpw=qpw_{tag}", "-I", str(_build.CSRC_DIR), "-o",
               str(lib), str(cu)]
        jobs[name] = (cmd, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (cmd, lib, proc) in jobs.items():
        res_out, res_err = proc.communicate()
        _build._require_ok(proc.returncode, cmd, res_out, res_err)
        so = ctypes.CDLL(str(lib))
        for entry in entries:
            fn = getattr(so, entry)
            fn.argtypes = _build.SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = so
    return libs


def device_ms(fn, n: int = 20, tries: int = 3) -> float:
    """Device time a call of fn's one kernel: the mean duration of its
    kernels in a torch.profiler trace of n calls after 3 warm-up calls,
    queued behind a spin kernel of a few ms so that the card is busy while
    tracing starts and the host enqueues the calls. The profiler drops a
    kernel's record now and then (one or two of 20 in a long-lived
    process), so the mean is over the records it kept; a window that kept
    fewer than half, or more than n, is profiled again, up to ``tries``
    windows."""
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
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "spin_kernel" not in e.name]
        if n // 2 <= len(events) <= n:
            return (sum(e.time_range.elapsed_us() for e in events) / 1e3
                    / len(events))
    raise RuntimeError(f"{len(events)} device kernels for {n} calls")


def _check(name, shape, got, want) -> None:
    """A variant that computes the cost volume against the plain version:
    one bf16 ulp of the magnitude."""
    err = float((got.float() - want.float()).abs().max())
    tol = 2.0 ** -7 * max(1.0, float(want.float().abs().max()))
    if not err <= tol:
        raise SystemExit(f"cv_split: {name} at {shape}: error {err} > {tol}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("cv_split needs a CUDA card")
    libs = build(variants(flatten("cost_volume.cu")))
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    stream = _build.stream_ptr(dev)
    print("| level (B,H,W,C) | " + " | ".join(libs) + " | bound |")
    print("|---" * (len(libs) + 2) + "|")
    for shape in LEVELS:
        prv, nxt = (torch.randn(shape, generator=g, device=dev)
                    .to(torch.bfloat16) for _ in range(2))
        out = torch.empty(shape[:3] + (81,), device=dev, dtype=torch.bfloat16)
        b, h, w, c = shape

        def call(lib):
            err = lib.qpw_cost_volume(prv.data_ptr(), nxt.data_ptr(),
                                      out.data_ptr(), b, h, w, c, 0, 1,
                                      stream)
            _build.check(err, "qpw_cost_volume")

        times = []
        for name, lib in libs.items():
            times.append(device_ms(lambda lib=lib: call(lib)))
            if name in COMPUTES:
                _check(name, shape, out, cost_volume_plain(prv, nxt))
        nbytes = 2 * (2 * b * h * w * c + 81 * b * h * w)
        print(f"| {shape} | " + " | ".join(f"{t:.4f}" for t in times)
              + f" | {nbytes / 3.35e12 * 1e3:.4f} |")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device ms a call; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
