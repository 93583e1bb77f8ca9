"""Middlebury .flo format codec (the port's copy of
qpwcnet_tpu/data/flo_format.py: magic float 202021.25, int32
width/height, h*w*2 float32 (u, v))."""

from __future__ import annotations

import struct

import numpy as np

FLO_MAGIC = 202021.25


def read_flo(path) -> np.ndarray:
    """Read a .flo file -> (H, W, 2) float32 flow in (x, y) order."""
    with open(path, "rb") as f:
        magic = struct.unpack("<f", f.read(4))[0]
        if abs(magic - FLO_MAGIC) > 1e-3:
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = struct.unpack("<i", f.read(4))[0]
        h = struct.unpack("<i", f.read(4))[0]
        data = np.frombuffer(f.read(h * w * 2 * 4), dtype="<f4")
    return data.reshape(h, w, 2).copy()


def write_flo(path, flow: np.ndarray) -> None:
    """Write an (H, W, 2) float32 flow to .flo."""
    flow = np.asarray(flow, dtype="<f4")
    assert flow.ndim == 3 and flow.shape[-1] == 2, flow.shape
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(struct.pack("<f", FLO_MAGIC))
        f.write(struct.pack("<ii", w, h))
        f.write(flow.tobytes())
