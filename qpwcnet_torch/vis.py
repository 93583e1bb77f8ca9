"""Visualization output (port of qpwcnet_tpu/vis.py): PNGs written without
image libraries (zlib + struct from the stdlib), and named images tiled
into one canvas."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def write_png(path, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    Path(path).write_bytes(png)


def _to_u8(img) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    return img


def tile_images(images: dict, cols: int = 3) -> np.ndarray:
    """Tile named images (H, W, 3) or (H, W), uint8 or float in [0, 1],
    of any sizes, row by row into one uint8 canvas of cols columns (the
    port's copy of qpwcnet_tpu/vis.py:tile_images)."""
    items = [_to_u8(v) for v in images.values()]
    h = max(v.shape[0] for v in items)
    w = max(v.shape[1] for v in items)
    rows = (len(items) + cols - 1) // cols
    canvas = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, img in enumerate(items):
        r, c = divmod(i, cols)
        canvas[r * h:r * h + img.shape[0], c * w:c * w + img.shape[1]] = img
    return canvas


def show(images: dict, out_path=None) -> np.ndarray:
    """Write the tiled canvas of ``images`` as a PNG to out_path
    (``<tempdir>/qpwcnet_torch_show.png`` by default) and return it. The
    JAX function can also open an OpenCV window; the port is headless."""
    import tempfile

    canvas = tile_images(images)
    if out_path is None:
        out_path = Path(tempfile.gettempdir()) / "qpwcnet_torch_show.png"
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    write_png(out_path, canvas)
    return canvas
