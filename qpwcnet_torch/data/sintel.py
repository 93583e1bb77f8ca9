"""MPI-Sintel flow dataset: directory reader + TFRecord shard
reader/converter (the port's copy of qpwcnet_tpu/data/sintel.py).
"""

from __future__ import annotations

import glob
from pathlib import Path
from typing import Iterator

import numpy as np

from qpwcnet_torch.data.flo_format import read_flo
from qpwcnet_torch.data.tfrecord import (
    make_sintel_example,
    parse_sintel_example,
    tfrecord_iterator,
    write_tfrecord,
)


def sintel_pairs(root, pass_name: str = "final"):
    """Yield (prv_png_path, nxt_png_path, flo_path) for consecutive frame
    pairs of every training sequence (convert_tfrecord.py pairing:
    frame_N.png + frame_{N+1}.png + frame_N.flo)."""
    root = Path(root)
    img_dir = root / "training" / pass_name
    flo_dir = root / "training" / "flow"
    for seq in sorted(p for p in img_dir.iterdir() if p.is_dir()):
        frames = sorted(seq.glob("frame_*.png"))
        for prv, nxt in zip(frames[:-1], frames[1:]):
            flo = flo_dir / seq.name / (prv.stem + ".flo")
            if flo.exists():
                yield str(prv), str(nxt), str(flo)


def sintel_dir_iterator(root, pass_name: str = "final"):
    """Yield (ims (H,W,6) uint8, flo (H,W,2) f32) straight from a Sintel
    directory tree."""
    from PIL import Image

    for prv, nxt, flo in sintel_pairs(root, pass_name):
        a = np.asarray(Image.open(prv).convert("RGB"))
        b = np.asarray(Image.open(nxt).convert("RGB"))
        yield np.concatenate([a, b], -1), read_flo(flo)


def convert_to_tfrecords(root, out_dir, pass_name: str = "final",
                         n_shards: int = 32) -> list[str]:
    """Sintel directory -> ZLIB TFRecord shards
    (app/data/convert_tfrecord.py + shard_tfrecord.py combined)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    pairs = list(sintel_pairs(root, pass_name))
    shard_paths = [
        out_dir / f"sintel-{i:02d}-of-{n_shards:02d}.tfrecord"
        for i in range(n_shards)
    ]

    def records_for(shard):
        for k, (prv, nxt, flo) in enumerate(pairs):
            if k % n_shards != shard:
                continue
            yield make_sintel_example(
                Path(prv).read_bytes(),
                Path(nxt).read_bytes(),
                read_flo(flo),
            )

    for i, p in enumerate(shard_paths):
        write_tfrecord(p, records_for(i))
    return [str(p) for p in shard_paths]


def sintel_tfrecord_iterator(shards) -> Iterator[tuple]:
    """Yield (ims (H,W,6) uint8, flo (H,W,2) f32) from TFRecord shards:
    a list of paths, or one path or glob pattern, relative or absolute
    (the JAX function's ``Path().glob`` refuses absolute patterns)."""
    if isinstance(shards, (str, Path)):
        shards = sorted(glob.glob(str(shards))) or [shards]
    for shard in shards:
        for rec in tfrecord_iterator(shard):
            yield parse_sintel_example(rec)
