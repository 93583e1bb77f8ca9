"""PFM (portable float map) reader for FlyingThings3D's optical flow (the
port's copy of qpwcnet_tpu/data/pfm.py): numpy on the host."""

from __future__ import annotations

import re

import numpy as np


def read_pfm(path) -> np.ndarray:
    """Read a PFM file -> (H, W) or (H, W, 3) float32 in top-down row
    order (PFM stores its rows bottom-up)."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")

        dims = f.readline()
        while dims.startswith(b"#"):  # comments
            dims = f.readline()
        m = re.match(rb"^(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM dims {dims!r}")
        w, h = int(m.group(1)), int(m.group(2))

        scale = float(f.readline().strip())
        endian = "<" if scale < 0 else ">"

        data = np.frombuffer(f.read(w * h * channels * 4),
                             dtype=f"{endian}f4")
    data = data.reshape((h, w, channels) if channels > 1 else (h, w))
    return np.flipud(data).astype(np.float32).copy()
