"""Flow inference / visualization app (port of qpwcnet_tpu/apps/infer.py).
Headless: writes PNGs of each frame pair, the warped next frame and the
flow, and prints each pair's warp-validation L1.

``--load-ckpt <ckpt dir>`` loads the parameters and BatchNorm statistics
of that directory's latest checkpoint into the JAX app's model.

Run: python -m qpwcnet_torch.apps.infer --data synthetic --n 2 [--fast true]
"""

from __future__ import annotations

import dataclasses
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from qpwcnet_torch.utils.config import with_args


@dataclasses.dataclass
class Settings:
    data: str = "synthetic"    # 'synthetic' | 'sintel'
    data_path: str = ""        # sintel shard glob
    load_ckpt: str = ""        # run ckpt dir
    height: int = 256
    width: int = 512
    n: int = 4                 # number of examples
    out_dir: str = ""          # default: <tempdir>/qpwcnet_torch/infer
    # bf16 compute + fused CUDA encoder stem (exact semantics) + fused
    # warp+correlate at the finest level (window-warp approximation there).
    fast: bool = False
    device: str = "cuda"


def _save(path, arr01: torch.Tensor) -> None:
    from qpwcnet_torch.vis import write_png

    arr = np.clip(arr01.float().cpu().numpy() * 255.0, 0, 255)
    write_png(path, arr.astype(np.uint8))


def build_model(cfg: Settings) -> torch.nn.Module:
    """The JAX app's model (build_flow_net from seed 0, as its
    jax.random.key(0): 'diag' heads, no residual), with the parameters
    and statistics of cfg.load_ckpt's latest checkpoint when set."""
    from qpwcnet_torch.models import build_flow_net
    from qpwcnet_torch.train import CheckpointManager

    fast_kw = {}
    if cfg.fast:
        fast_kw = dict(dtype=torch.bfloat16, cv_impl="fast", stem_stages=2)
    model = build_flow_net(0, torch.device(cfg.device), **fast_kw)
    if cfg.load_ckpt:
        CheckpointManager(cfg.load_ckpt).restore_params(model)
    return model


def run(cfg: Settings, model: torch.nn.Module) -> list[float]:
    """The inference loop over cfg's data with ``model`` (on cfg.device,
    in eval mode). Returns the warp-validation L1 of each example."""
    from qpwcnet_torch.ops import backward_warp, flow_to_image
    from qpwcnet_torch.ops.resize import resize_bilinear

    device = torch.device(cfg.device)
    out_dir = Path(cfg.out_dir or Path(tempfile.gettempdir())
                   / "qpwcnet_torch" / "infer")
    out_dir.mkdir(parents=True, exist_ok=True)

    if cfg.data == "sintel":
        from qpwcnet_torch.data.sintel import sintel_tfrecord_iterator

        source = sintel_tfrecord_iterator(cfg.data_path)
    else:
        rng = np.random.RandomState(0)

        def synth():
            for _ in range(cfg.n):
                ims = rng.randint(
                    0, 255, (cfg.height, cfg.width, 6), np.uint8)
                flo = np.tile(
                    rng.uniform(-6, 6, (1, 1, 2)).astype(np.float32),
                    (cfg.height, cfg.width, 1))
                yield ims, flo

        source = synth()

    errs = []
    with torch.inference_mode():
        for i, (ims_u8, flo_gt) in enumerate(source):
            if i >= cfg.n:
                break
            ims = torch.from_numpy(
                ims_u8[None].astype(np.float32) / 255.0).to(device)
            flo_gt = torch.from_numpy(np.asarray(flo_gt, np.float32))
            if ims.shape[1:3] != (cfg.height, cfg.width):
                scale = torch.tensor([cfg.width / ims.shape[2],
                                      cfg.height / ims.shape[1]])
                ims = resize_bilinear(ims, (cfg.height, cfg.width))
                flo_gt = resize_bilinear(
                    flo_gt[None], (cfg.height, cfg.width))[0] * scale
            flo = model(ims - 0.5)[0]

            prv, nxt = ims[0, ..., :3], ims[0, ..., 3:]
            nxt_w = backward_warp(nxt[None].contiguous(), flo[None])[0]

            _save(out_dir / f"{i:03d}_prv.png", prv)
            _save(out_dir / f"{i:03d}_nxt.png", nxt)
            _save(out_dir / f"{i:03d}_nxt_warped.png", nxt_w)
            _save(out_dir / f"{i:03d}_flow.png", flow_to_image(flo))
            _save(out_dir / f"{i:03d}_flow_gt.png", flow_to_image(flo_gt))
            warp_err = float(torch.mean(torch.abs(nxt_w - prv)))
            errs.append(warp_err)
            print(f"[{i}] warp-validation L1={warp_err:.4f}", file=sys.stderr)
    print(f"wrote {out_dir}", file=sys.stderr)
    return errs


@with_args(Settings)
def main(cfg: Settings) -> list[float]:
    return run(cfg, build_model(cfg))


if __name__ == "__main__":
    main()
