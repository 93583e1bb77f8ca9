"""Minimal protobuf wire-format codec for tf.train.Example and
TensorProto (the port's copy of qpwcnet_tpu/data/proto.py) — enough to
read/write the Sintel TFRecord schema without a TensorFlow runtime.

Wire format implemented by hand: varints, length-delimited fields.
Only the fields the Sintel schema uses are supported:

  Example{ features: Features{ feature: map<string, Feature> } }
  Feature = oneof { BytesList bytes_list=1, FloatList float_list=2,
                    Int64List int64_list=3 }
  TensorProto{ dtype=1 (DT_FLOAT=1), tensor_shape=2{ dim{ size=1 } },
               tensor_content=4 }
"""

from __future__ import annotations

import struct

import numpy as np


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _write_tag(out: bytearray, field: int, wire_type: int) -> None:
    _write_varint(out, (field << 3) | wire_type)


def _write_len_delimited(out: bytearray, field: int, payload: bytes):
    _write_tag(out, field, 2)
    _write_varint(out, len(payload))
    out.extend(payload)


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message buffer.
    value is bytes for wire type 2, int for 0, raw 8/4 bytes for 1/5."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            val = buf[pos:pos + 4]
            pos += 4
        elif wt == 1:
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


# ---------------------------------------------------------------- Example

def encode_example(features: dict) -> bytes:
    """features: name -> bytes | int | list[int] | float | list[float]."""
    feat_map = bytearray()
    for name, value in features.items():
        feature = bytearray()
        if isinstance(value, bytes):
            lst = bytearray()
            _write_len_delimited(lst, 1, value)
            _write_len_delimited(feature, 1, bytes(lst))  # bytes_list
        elif isinstance(value, (int, np.integer)) or (
            isinstance(value, (list, tuple))
            and value
            and isinstance(value[0], (int, np.integer))
        ):
            vals = [value] if isinstance(value, (int, np.integer)) else value
            lst = bytearray()
            for v in vals:
                _write_tag(lst, 1, 0)
                _write_varint(lst, int(v) & 0xFFFFFFFFFFFFFFFF)
            _write_len_delimited(feature, 3, bytes(lst))  # int64_list
        else:
            vals = [value] if isinstance(value, float) else list(value)
            lst = bytearray()
            payload = struct.pack(f"<{len(vals)}f", *vals)
            _write_len_delimited(lst, 1, payload)  # packed floats
            _write_len_delimited(feature, 2, bytes(lst))  # float_list
        entry = bytearray()
        _write_len_delimited(entry, 1, name.encode())
        _write_len_delimited(entry, 2, bytes(feature))
        _write_len_delimited(feat_map, 1, bytes(entry))

    features_msg = bytes(feat_map)
    example = bytearray()
    _write_len_delimited(example, 1, features_msg)
    return bytes(example)


def decode_example(buf: bytes) -> dict:
    """-> name -> bytes | list[int] | np.ndarray(float32)."""
    out = {}
    for f, _, features_msg in _iter_fields(buf):
        if f != 1:
            continue
        for f2, _, entry in _iter_fields(features_msg):
            if f2 != 1:
                continue
            name = None
            feature = None
            for f3, _, v in _iter_fields(entry):
                if f3 == 1:
                    name = v.decode()
                elif f3 == 2:
                    feature = v
            if name is None or feature is None:
                continue
            for f4, _, lst in _iter_fields(feature):
                if f4 == 1:  # bytes_list
                    for f5, _, b in _iter_fields(lst):
                        if f5 == 1:
                            out[name] = b
                elif f4 == 3:  # int64_list
                    vals = []
                    for f5, wt5, v5 in _iter_fields(lst):
                        if f5 == 1 and wt5 == 0:
                            vals.append(v5)
                    out[name] = vals
                elif f4 == 2:  # float_list (packed)
                    for f5, _, b in _iter_fields(lst):
                        if f5 == 1:
                            out[name] = np.frombuffer(b, "<f4").copy()
    return out


# ------------------------------------------------------------ TensorProto

_DT_FLOAT = 1


def encode_float_tensor(arr: np.ndarray) -> bytes:
    """Serialize a float32 ndarray as a TensorProto (the format
    tf.io.serialize_tensor produces for the 'flo' feature)."""
    arr = np.ascontiguousarray(arr, dtype="<f4")
    shape_msg = bytearray()
    for s in arr.shape:
        dim = bytearray()
        _write_tag(dim, 1, 0)
        _write_varint(dim, s)
        _write_len_delimited(shape_msg, 2, bytes(dim))
    out = bytearray()
    _write_tag(out, 1, 0)
    _write_varint(out, _DT_FLOAT)
    _write_len_delimited(out, 2, bytes(shape_msg))
    _write_len_delimited(out, 4, arr.tobytes())
    return bytes(out)


def decode_float_tensor(buf: bytes) -> np.ndarray:
    dtype = None
    shape = []
    content = None
    float_vals = []
    for f, wt, v in _iter_fields(buf):
        if f == 1 and wt == 0:
            dtype = v
        elif f == 2 and wt == 2:  # TensorShapeProto
            for f2, _, dim in _iter_fields(v):
                if f2 == 2:
                    for f3, wt3, s in _iter_fields(dim):
                        if f3 == 1 and wt3 == 0:
                            shape.append(s)
        elif f == 4 and wt == 2:
            content = v
        elif f == 5 and wt == 5:  # unpacked float_val
            float_vals.append(struct.unpack("<f", v)[0])
        elif f == 5 and wt == 2:  # packed float_val
            float_vals.extend(np.frombuffer(v, "<f4").tolist())
    if dtype != _DT_FLOAT:
        raise ValueError(f"unsupported TensorProto dtype {dtype}")
    if content is not None:
        arr = np.frombuffer(content, "<f4").copy()
    else:
        arr = np.asarray(float_vals, np.float32)
    return arr.reshape(shape) if shape else arr
