"""TFRecord container codec + the Sintel example schema (the port's copy
of qpwcnet_tpu/data/tfrecord.py, without its native C helpers) — pure
Python, no TF runtime.

TFRecord framing: per record
  uint64 length | uint32 masked-crc32c(length) | bytes data |
  uint32 masked-crc32c(data)
with optional whole-stream ZLIB compression (the reference writes ZLIB
shards, tfrecord.py:30).

Schema ('sintel' example): {width int64, height int64, prv png-bytes,
nxt png-bytes, flo TensorProto(float32 HxWx2)}.
"""

from __future__ import annotations

import io
import struct
import zlib
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

from qpwcnet_torch.data import proto

# ------------------------------------------------------------- crc32c

_CRC_TABLE = None


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78  # Castagnoli, reflected
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            table.append(crc)
        _CRC_TABLE = np.asarray(table, np.uint32)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = np.uint32(0xFFFFFFFF)
    arr = np.frombuffer(data, np.uint8)
    crc_val = int(crc)
    tbl = table.tolist()
    for b in arr.tolist():
        crc_val = (crc_val >> 8) ^ tbl[(crc_val ^ b) & 0xFF]
    return crc_val ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) & 0xFFFFFFFF


def _mask_add(crc: int) -> int:
    return (crc + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------ container

def _iter_records(stream: io.BufferedReader,
                  verify_crc: bool = False) -> Iterator[bytes]:
    while True:
        header = stream.read(12)
        if len(header) < 12:
            return
        (length,) = struct.unpack("<Q", header[:8])
        data = stream.read(length)
        footer = stream.read(4)  # data crc
        if len(data) < length:
            return
        if verify_crc:
            (len_crc,) = struct.unpack("<I", header[8:12])
            if _mask_add(_masked_crc(header[:8])) != len_crc:
                raise ValueError("TFRecord length CRC mismatch")
            if len(footer) < 4:
                raise ValueError("TFRecord truncated data CRC")
            (data_crc,) = struct.unpack("<I", footer)
            if _mask_add(_masked_crc(data)) != data_crc:
                raise ValueError("TFRecord data CRC mismatch")
        yield data


def tfrecord_iterator(path, compression: str | None = "auto",
                      verify_crc: bool = False) -> Iterator[bytes]:
    """Iterate raw record payloads from a TFRecord file. compression:
    'auto' (sniff zlib header), 'zlib', or None."""
    raw = Path(path).read_bytes()
    if compression == "auto":
        compression = "zlib" if raw[:1] == b"\x78" else None
    if compression == "zlib":
        raw = zlib.decompress(raw)
    yield from _iter_records(io.BufferedReader(io.BytesIO(raw)),
                             verify_crc)


def write_tfrecord(path, records: Iterable[bytes],
                   compression: str | None = "zlib") -> int:
    """Write records to a TFRecord file; returns count."""
    out = bytearray()
    n = 0
    for rec in records:
        header = struct.pack("<Q", len(rec))
        out += header
        out += struct.pack("<I", _mask_add(_masked_crc(header)))
        out += rec
        out += struct.pack("<I", _mask_add(_masked_crc(rec)))
        n += 1
    data = bytes(out)
    if compression == "zlib":
        data = zlib.compress(data)
    Path(path).write_bytes(data)
    return n


# -------------------------------------------------------- sintel schema

def make_sintel_example(prv_png: bytes, nxt_png: bytes,
                        flo: np.ndarray) -> bytes:
    """Encode one Sintel example (tfrecord.py:23-46 schema)."""
    h, w = flo.shape[:2]
    return proto.encode_example({
        "width": int(w),
        "height": int(h),
        "prv": prv_png,
        "nxt": nxt_png,
        "flo": proto.encode_float_tensor(flo.astype(np.float32)),
    })


def _decode_png(data: bytes) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    # convert() on an already-RGB image still copies the whole bitmap
    # (~30% of the sample decode budget on a 436x1024 frame); skip it.
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img)


def parse_sintel_example(record: bytes):
    """Decode one example -> (ims (H,W,6) uint8 concat[prv,nxt],
    flo (H,W,2) float32) — the read_record output contract
    (tfrecord.py:53-80)."""
    ex = proto.decode_example(record)
    prv = _decode_png(ex["prv"])
    nxt = _decode_png(ex["nxt"])
    flo = proto.decode_float_tensor(ex["flo"])
    h, w = int(ex["height"][0]), int(ex["width"][0])
    flo = flo.reshape(h, w, 2)
    ims = np.concatenate([prv, nxt], axis=-1)
    return ims, flo
