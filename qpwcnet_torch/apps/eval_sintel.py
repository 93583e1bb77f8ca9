"""Sintel EPE evaluation (port of qpwcnet_tpu/apps/eval_sintel.py, the
quality gate): the mean end-point error of the flow model over MPI-Sintel
training pairs, printed as one JSON line {"metric": "sintel EPE",
"value", "n", "protocol"}.

Protocols: 'pad' (standard) zero-pads each [0, 1] frame pair to the next
multiple of 32, subtracts 0.5 (so the pad reads -0.5), and crops the
prediction back; 'resize' runs at (height, width) and rescales the
bilinearly upsampled flow by (w0 / width, h0 / height). With
``--load-ckpt`` and ``--recalibrate N > 0`` the BatchNorm statistics are
first re-estimated over the first N pairs, with the protocol's
preprocessing.

Run: python -m qpwcnet_torch.apps.eval_sintel --data-path <sintel root or
shard glob> --load-ckpt <ckpt dir>
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from qpwcnet_torch.utils.config import with_args


@dataclasses.dataclass
class Settings:
    data_path: str = ""       # sintel shard glob or directory root
    load_ckpt: str = ""
    limit: int = 0            # 0 = all
    protocol: str = "pad"     # 'pad' (standard) | 'resize'
    height: int = 448         # resize protocol only
    width: int = 1024         # resize protocol only
    # BatchNorm re-estimation passes over the eval inputs before scoring
    # (with --load-ckpt only). 0 disables.
    recalibrate: int = 100
    device: str = "cuda"


def _source(cfg: Settings):
    """(ims (H, W, 6) uint8, flo (H, W, 2) float32) pairs."""
    if Path(cfg.data_path).is_dir():
        from qpwcnet_torch.data.sintel import sintel_dir_iterator

        return sintel_dir_iterator(cfg.data_path)
    from qpwcnet_torch.data.sintel import sintel_tfrecord_iterator

    return sintel_tfrecord_iterator(cfg.data_path)


def _preprocess(cfg: Settings, ims_u8: np.ndarray) -> torch.Tensor:
    """The protocol's model input: (1, H', W', 6) in [-0.5, 0.5]."""
    from qpwcnet_torch.ops.resize import resize_bilinear

    ims = torch.from_numpy(ims_u8[None].astype(np.float32) / 255.0).to(
        cfg.device)
    if cfg.protocol == "pad":
        h0, w0 = ims.shape[1:3]
        ims = F.pad(ims, (0, 0, 0, -(-w0 // 32) * 32 - w0,
                          0, -(-h0 // 32) * 32 - h0))
    else:
        ims = resize_bilinear(ims, (cfg.height, cfg.width))
    return ims - 0.5


def run(cfg: Settings) -> dict:
    """Score build_flow_net(0) (with cfg.load_ckpt's latest parameters
    and statistics) over cfg's Sintel pairs; returns the JSON record."""
    from qpwcnet_torch.models import build_flow_net
    from qpwcnet_torch.ops.resize import resize_bilinear
    from qpwcnet_torch.train import (
        CheckpointManager,
        epe_error,
        recalibrate_batch_stats,
    )

    if cfg.protocol not in ("pad", "resize"):
        raise ValueError(f"--protocol {cfg.protocol}: 'pad' or 'resize'")
    model = build_flow_net(0, torch.device(cfg.device))
    if cfg.load_ckpt:
        CheckpointManager(cfg.load_ckpt).restore_params(model)
        if cfg.recalibrate:
            recalibrate_batch_stats(
                model, (_preprocess(cfg, ims) for ims, _ in _source(cfg)),
                cfg.recalibrate)
            print(f"recalibrated BN stats over {cfg.recalibrate} frames",
                  file=sys.stderr)
    model.eval()

    epes = []
    with torch.inference_mode():
        for i, (ims_u8, flo_gt) in enumerate(_source(cfg)):
            if cfg.limit and i >= cfg.limit:
                break
            h0, w0 = ims_u8.shape[:2]
            flo = model(_preprocess(cfg, ims_u8))
            if cfg.protocol == "pad":
                flo_full = flo[:, :h0, :w0]
            else:
                flo_full = resize_bilinear(flo, (h0, w0)) * torch.tensor(
                    [w0 / cfg.width, h0 / cfg.height], device=flo.device)
            gt = torch.from_numpy(np.asarray(flo_gt, np.float32)[None])
            epes.append(float(epe_error(gt.to(flo.device), flo_full)))
            if (i + 1) % 50 == 0:
                print(f"{i + 1}: running EPE {np.mean(epes):.3f}",
                      file=sys.stderr)
    return {"metric": "sintel EPE",
            "value": float(np.mean(epes)) if epes else None,
            "n": len(epes), "protocol": cfg.protocol}


@with_args(Settings)
def main(cfg: Settings) -> dict:
    result = run(cfg)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
