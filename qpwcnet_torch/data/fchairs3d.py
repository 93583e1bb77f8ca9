"""FlyingThings3D loader (the port's copy of
qpwcnet_tpu/data/fchairs3d.py; the reference misnames the dataset
"fchairs3d"). Pairs consecutive WebP frames of
``frames_finalpass_webp/<split>/<letter>/<seq>/left`` with
``optical_flow/<split>/<letter>/<seq>/into_future/left/
OpticalFlowIntoFuture_<frame>_L.pfm``, through a precomputed set file that
lists the pairs. Decoding is numpy and PIL on the host.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np

from qpwcnet_torch.data.pfm import read_pfm
from qpwcnet_torch.data.pipeline import load_image


def fc3d_pairs(root, split: str = "TRAIN"):
    """Yield (prv_webp, nxt_webp, flow_pfm) path triples."""
    root = Path(root)
    img_root = root / "frames_finalpass_webp" / split
    flo_root = root / "optical_flow" / split
    for letter in sorted(p for p in img_root.iterdir() if p.is_dir()):
        for seq in sorted(p for p in letter.iterdir() if p.is_dir()):
            left = seq / "left"
            if not left.is_dir():
                continue
            frames = sorted(left.glob("*.webp"))
            for prv, nxt in zip(frames[:-1], frames[1:]):
                idx = int(prv.stem)
                flo = (flo_root / letter.name / seq.name / "into_future" /
                       "left" / f"OpticalFlowIntoFuture_{idx:04d}_L.pfm")
                if flo.exists():
                    yield str(prv), str(nxt), str(flo)


def write_set_file(root, out_path, split: str = "TRAIN") -> int:
    """Write the set file (one tab-separated pair a line); returns the
    number of pairs."""
    pairs = list(fc3d_pairs(root, split))
    with open(out_path, "w") as f:
        for prv, nxt, flo in pairs:
            f.write(f"{prv}\t{nxt}\t{flo}\n")
    return len(pairs)


def read_set_file(path) -> list[tuple[str, str, str]]:
    out = []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) == 3:
                out.append(tuple(parts))
    return out


def decode_pair(prv_path, nxt_path, flo_path):
    """-> (ims (H, W, 6) uint8, flo (H, W, 2) float32). FlyingThings3D's
    PFM flow has 3 channels, of which the first two are (u, v)."""
    flo = read_pfm(flo_path)
    if flo.ndim == 3:
        flo = flo[..., :2]
    ims = np.concatenate([load_image(prv_path), load_image(nxt_path)], -1)
    return ims, np.ascontiguousarray(flo)


def fc3d_iterator(set_file, shuffle: bool = True,
                  seed: int = 0) -> Iterator[tuple]:
    """Yield decoded (ims, flo) pairs of a set file, the whole set
    shuffled by ``RandomState(seed)``."""
    pairs = read_set_file(set_file)
    if shuffle:
        rng = np.random.RandomState(seed)
        rng.shuffle(pairs)
    for prv, nxt, flo in pairs:
        yield decode_pair(prv, nxt, flo)
