"""Where K3's bf16 time goes: ``csrc/warp_cv.cu`` (with the shared
``csrc/cv_mma.cuh``) built seven ways and timed.

    python -m qpwcnet_torch.utils.wcv_split        # on a CUDA card

builds the fused warp+correlate as it is ("full"), without the gather
(the window staged by cp.async from nxt unwarped, as K1 stages it: "no
gather"), without the products ("no products"), without the output stores
("no stores"), and whole with the tile shape forced to (TY, DG) = (8, 1),
(4, 3) or (2, 9) ("tiles 8x1", "tiles 4x3", "tiles 2x9"), each into its
own library under ``build/qpwcnet_torch/wcv_split/`` (one nvcc each, all
at once), and prints one markdown row for the `'fast'` forward's K3 level
(224x512, C = 32, batch 8) and one for the train step's (128x256, batch
16): each variant's device time a call (``cv_split.device_ms``) and the
bound (bytes moved once at 3.35 TB/s). The variants that compute the
fused warp+correlate are held against its plain version, "no gather"
against the plain cost volume of the unwarped maps (one bf16 ulp).
"""

from __future__ import annotations

import subprocess
import sys

import torch

from qpwcnet_torch.ops.cost_volume import cost_volume_plain
from qpwcnet_torch.ops.cuda import _build
from qpwcnet_torch.ops.cuda.warp_cv_kernel import warp_cost_volume_plain
from qpwcnet_torch.utils.cv_split import (_check, build, device_ms, flatten,
                                          variants)

GATHER = ("wcv_gather<TY, DG>(nb, buf, corner, wax, way, ch * CM_CC, W, C, "
          "vec);")
COPY = ("cm_stage<TY, DG>(nb, pb, buf, ch * CM_CC, 0, Cfg::WIN, x0, y0, H, "
        "W, C, vec); cp_async_commit();")
COMPUTES = ("full", "tiles 8x1", "tiles 4x3", "tiles 2x9")
LEVELS = ((8, 224, 512, 32), (16, 128, 256, 32))


def wcv_variants(src: str) -> dict[str, str]:
    if src.count(GATHER) != 1:
        raise RuntimeError(f"warp_cv.cu no longer holds {GATHER!r} once")
    out = variants(src, "warp_cv.cu")
    del out["neither"]
    out["no gather"] = src.replace(GATHER, COPY)
    order = ("full", "no gather", "no products", "no stores", *COMPUTES[1:])
    return {k: out[k] for k in order}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("wcv_split needs a CUDA card")
    libs = build(wcv_variants(flatten("warp_cv.cu")),
                 entries=("qpw_warp_cost_volume",), subdir="wcv_split")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    stream = _build.stream_ptr(dev)
    print("| level (B,H,W,C) | " + " | ".join(libs) + " | bound |")
    print("|---" * (len(libs) + 2) + "|")
    for shape in LEVELS:
        prv, nxt = (torch.randn(shape, generator=g, device=dev)
                    .to(torch.bfloat16) for _ in range(2))
        flow = 3.0 * torch.randn(shape[:3] + (2,), generator=g, device=dev)
        out = torch.empty(shape[:3] + (81,), device=dev, dtype=torch.bfloat16)
        b, h, w, c = shape

        def call(lib):
            err = lib.qpw_warp_cost_volume(
                prv.data_ptr(), nxt.data_ptr(), flow.data_ptr(),
                out.data_ptr(), b, h, w, c, 4.0, 1, stream)
            _build.check(err, "qpw_warp_cost_volume")

        times = []
        for name, lib in libs.items():
            times.append(device_ms(lambda lib=lib: call(lib)))
            if name in COMPUTES:
                _check(name, shape, out, warp_cost_volume_plain(prv, nxt,
                                                                flow))
            elif name == "no gather":
                _check(name, shape, out, cost_volume_plain(prv, nxt))
        # K3's bytes moved once: prv, nxt and the output in bf16, the
        # float32 flow
        nbytes = 2 * (2 * b * h * w * c + 81 * b * h * w) + 8 * b * h * w
        print(f"| {shape} | " + " | ".join(f"{t:.4f}" for t in times)
              + f" | {nbytes / 3.35e12 * 1e3:.4f} |")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device ms a call; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
