"""Interpolator inference / visualization app (port of
qpwcnet_tpu/apps/interp_infer.py). Headless: runs the frame-interpolation
model on triplets and writes PNGs of the frames, the predicted middle
frame and both directions' flows, and the warp sanity check (frame 2
warped by the upsampled half flow, against the middle frame); prints
each triplet's PSNR and half-warp L1.

Run: python -m qpwcnet_torch.apps.interp_infer --data synthetic --n 2

Modes: 'synthetic' (the JAX app's RandomState(0) uniform triplets, so the
inputs are the same), 'dummy' (black frames), 'vimeo' (Vimeo-90K's 'test'
split under ``--data-path``) and 'ytvos' (YouTube-VOS's 'valid' split);
the datasets' first ``--n`` triplets, each frame read and resized to
``--height x --width``. ``--load-ckpt <ckpt dir>`` loads the parameters
and BatchNorm statistics of that directory's latest checkpoint (a
``pretrain_interp`` run's) into the JAX app's model.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from qpwcnet_torch.utils.config import with_args


@dataclasses.dataclass
class Settings:
    data: str = "dummy"       # 'dummy' | 'vimeo' | 'ytvos' | 'synthetic'
    data_path: str = ""
    load_ckpt: str = ""
    height: int = 256
    width: int = 512
    n: int = 2
    out_dir: str = ""         # default: <tempdir>/qpwcnet_torch/interp_infer
    device: str = "cuda"


def build_model(cfg: Settings) -> torch.nn.Module:
    """The JAX app's model (build_interpolator from seed 0, as its
    jax.random.key(0): 'diag' heads, no residual), with the parameters
    and statistics of cfg.load_ckpt's latest checkpoint when set."""
    from qpwcnet_torch.models import build_interpolator
    from qpwcnet_torch.train import CheckpointManager

    model = build_interpolator(0, torch.device(cfg.device))
    if cfg.load_ckpt:
        CheckpointManager(cfg.load_ckpt).restore_params(model)
    return model


def _triplets(cfg: Settings):
    """(f0, f1, f2) float32 (H, W, 3) numpy frames in [0, 1]."""
    from qpwcnet_torch.data.pipeline import load_image
    from qpwcnet_torch.data.triplet import (
        DummyTripletDataset,
        VimeoTriplet,
        YoutubeVos,
    )

    if cfg.data == "synthetic":
        rng = np.random.RandomState(0)
        for _ in range(cfg.n):
            yield tuple(rng.uniform(0, 1, (cfg.height, cfg.width, 3))
                        .astype(np.float32) for _ in range(3))
        return
    if cfg.data == "vimeo":
        ds = VimeoTriplet(cfg.data_path, "test")
    elif cfg.data == "ytvos":
        ds = YoutubeVos(cfg.data_path, "valid")
    elif cfg.data == "dummy":
        ds = DummyTripletDataset(n=cfg.n, hw=(cfg.height, cfg.width))
    else:
        raise ValueError(f"unknown data source {cfg.data!r}")
    for k in ds.keys()[:cfg.n]:
        yield tuple(load_image(p, (cfg.height, cfg.width)).astype(np.float32)
                    / 255.0 for p in ds[k])


def _save(path, arr01: torch.Tensor) -> None:
    from qpwcnet_torch.vis import write_png

    arr = np.clip(arr01.float().cpu().numpy() * 255.0, 0, 255)
    write_png(path, arr.astype(np.uint8))


def run(cfg: Settings, model: torch.nn.Module) -> list[dict]:
    """The inference loop over cfg's triplets with ``model`` (on
    cfg.device, in eval mode). Returns each triplet's {'psnr',
    'halfwarp_l1'}."""
    from qpwcnet_torch.ops import backward_warp, flow_to_image
    from qpwcnet_torch.ops.resize import upsample2x_bilinear

    device = torch.device(cfg.device)
    out_dir = Path(cfg.out_dir or Path(tempfile.gettempdir())
                   / "qpwcnet_torch" / "interp_infer")
    out_dir.mkdir(parents=True, exist_ok=True)

    results = []
    with torch.inference_mode():
        for i, frames in enumerate(_triplets(cfg)):
            f0, f1, f2 = (torch.from_numpy(f).to(device) for f in frames)
            ims = torch.cat([f0, f2], dim=-1)[None] - 0.5
            pred, (flos_01, flos_10) = model(ims, return_flows=True)
            mid_pred = pred[0] + 0.5

            _save(out_dir / f"{i:03d}_frame0.png", f0)
            _save(out_dir / f"{i:03d}_mid_pred.png", mid_pred)
            _save(out_dir / f"{i:03d}_mid_true.png", f1)
            _save(out_dir / f"{i:03d}_frame2.png", f2)
            _save(out_dir / f"{i:03d}_flow01.png",
                  flow_to_image(flos_01[-1][0]))
            _save(out_dir / f"{i:03d}_flow10.png",
                  flow_to_image(flos_10[-1][0]))

            # Warp sanity check: frame 2 warped by the 2x-upsampled half
            # flow, against the middle frame.
            flo_u = upsample2x_bilinear(flos_01[-2], scale=2.0)
            f2_w = backward_warp(f2[None], 0.5 * flo_u)[0]
            _save(out_dir / f"{i:03d}_frame2_halfwarp.png", f2_w)
            l1 = float(torch.mean(torch.abs(f2_w - f1)))
            psnr = -10 * math.log10(
                float(torch.mean((mid_pred - f1) ** 2)) + 1e-12)
            results.append({"psnr": psnr, "halfwarp_l1": l1})
            print(f"[{i}] interp PSNR={psnr:.2f} dB, half-warp L1={l1:.4f}",
                  file=sys.stderr)
    print(f"wrote {out_dir}", file=sys.stderr)
    return results


@with_args(Settings)
def main(cfg: Settings) -> list[dict]:
    return run(cfg, build_model(cfg))


if __name__ == "__main__":
    main()
