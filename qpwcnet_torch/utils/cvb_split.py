"""Where K4a's and K4b's bf16 time goes: ``csrc/cost_volume_bwd.cu``
built eight ways and timed.

    python -m qpwcnet_torch.utils.cvb_split       # on a CUDA card

builds the backward kernels as they are ("full"), without the band's
build from the staged dacc (its registers zero: "no band"), without
dacc's staging and the band's build ("no dacc"), without the products
(their ldmatrix loads and mma, and with them the band's build, which
nothing else reads: "no products"), without the output stores (the
epilogue still rounds into shared memory: "no stores"), and whole with
the launcher's tile height forced to 8, 4 or 2 rows at every level
("tiles 8", "tiles 4", "tiles 2"), each
into its own library under ``build/qpwcnet_torch/cvb_split/`` (one nvcc
each, all at once), and prints one markdown row a kernel and level of the
flow train step (256x512, batch 16): each variant's device time a call
(torch.profiler over 20 calls after 3 warm-up calls) and the bound (bytes
moved once at 3.35 TB/s). The "no ..." variants exist to be timed; the
others compute the gradients and are held against the plain versions
(one bf16 ulp).
"""

from __future__ import annotations

import subprocess
import sys

import torch

from qpwcnet_torch.ops.cost_volume import (
    cost_volume_bwd_nxt_plain,
    cost_volume_bwd_prv_plain,
)
from qpwcnet_torch.ops.cuda import _build
from qpwcnet_torch.utils.cv_split import _check, build, device_ms

BAND = ("band[j][h] = ((uint32_t)d[o0] | (uint32_t)d[o1] << 16) &\n"
        "                     mask[j][h] & row_mask;")
DACC = "for (int r = warp; r < Cfg::DROWS; r += TY) {"
PRODUCTS = "if (c0 + mt * 16 < C) {"
SKIP = "if (REVERSED) {\n          const int a = max(el0, 0)"
STORES = "for (int u = lane; u < CB_TX * 4; u += 32) {"
TILE8 = "if (2 * blocks(8) >= n_sm)"
TILE4 = "if (2 * blocks(4) >= n_sm)"
# the variants that compute the gradients
COMPUTES = ("full", "no skip", "tiles 8", "tiles 4", "tiles 2")
LEVELS = ((16, 8, 16, 256), (16, 16, 32, 256), (16, 32, 64, 128),
          (16, 64, 128, 64), (16, 128, 256, 32))
KERNELS = (("K4a", "qpw_cost_volume_bwd_prv", cost_volume_bwd_prv_plain),
           ("K4b", "qpw_cost_volume_bwd_nxt", cost_volume_bwd_nxt_plain))


def variants(src: str) -> dict[str, str]:
    for pat in (BAND, DACC, SKIP, PRODUCTS, STORES, TILE8, TILE4):
        if src.count(pat) != 1:
            raise RuntimeError(
                f"cost_volume_bwd.cu no longer holds {pat!r} once")
    no_band = src.replace(BAND, "band[j][h] = 0u;")
    return {"full": src,
            "no band": no_band,
            "no dacc": no_band.replace(
                DACC, DACC.replace("r < Cfg::DROWS", "r < 0")),
            "no skip": src.replace(SKIP, SKIP.replace("REVERSED", "false")),
            "no products": src.replace(PRODUCTS, "if (false) {"),
            "no stores": src.replace(STORES,
                                     STORES.replace("u < CB_TX * 4", "u < 0")),
            "tiles 8": src.replace(TILE8, "if (true)"),
            "tiles 4": src.replace(TILE8, "if (false)").replace(
                TILE4, "if (true)"),
            "tiles 2": src.replace(TILE8, "if (false)").replace(
                TILE4, "if (false)")}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("cvb_split needs a CUDA card")
    src = (_build.CSRC_DIR / "cost_volume_bwd.cu").read_text()
    libs = build(variants(src), entries=[e for _, e, _ in KERNELS],
                 subdir="cvb_split")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    stream = _build.stream_ptr(dev)
    print("| kernel | level (B,H,W,C) | " + " | ".join(libs) + " | bound |")
    print("|---" * (len(libs) + 3) + "|")
    for kern, entry, plain in KERNELS:
        for shape in LEVELS:
            b, h, w, c = shape
            dacc = torch.randn((b, h, w, 81), generator=g, device=dev).to(
                torch.bfloat16)
            src_map = torch.randn(shape, generator=g, device=dev).to(
                torch.bfloat16)
            out = torch.empty(shape, device=dev, dtype=torch.bfloat16)

            def call(lib):
                err = getattr(lib, entry)(
                    dacc.data_ptr(), src_map.data_ptr(), out.data_ptr(), b,
                    h, w, c, 0, 1, stream)
                _build.check(err, entry)

            times = []
            for name, lib in libs.items():
                times.append(device_ms(lambda lib=lib: call(lib)))
                if name in COMPUTES:
                    _check(f"{kern} {name}", shape, out, plain(dacc, src_map))
            nbytes = 2 * (2 * b * h * w * c + 81 * b * h * w)
            print(f"| {kern} | {shape} | "
                  + " | ".join(f"{t:.4f}" for t in times)
                  + f" | {nbytes / 3.35e12 * 1e3:.4f} |")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device ms a call; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
