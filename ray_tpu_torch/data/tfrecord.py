"""TFRecord datasource — no TensorFlow dependency.

Reference: ray ``python/ray/data/datasource/tfrecords_datasource.py``
(which imports TF).  TPU-native stacks feed JAX, so this reads the format
directly: the TFRecord framing is

    [8B little-endian length][4B masked crc32c(length)]
    [data bytes]            [4B masked crc32c(data)]

and the payload is a ``tf.train.Example`` protobuf — a single map field
``features`` of name → Feature, where Feature is a oneof of bytes_list /
float_list / int64_list.  Both layers are simple enough to parse (and
write) by hand; rows come back as dicts of python/numpy values.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List

import numpy as np

# ------------------------------------------------------------------ crc32c
_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    _CRC_TABLE = table
    return table


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------ proto parsing
def _read_varint(buf: bytes, off: int):
    result = shift = 0
    while True:
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _iter_fields(buf: bytes) -> Iterator:
    """Yield (field_number, wire_type, value) over a proto message."""
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            value, off = _read_varint(buf, off)
        elif wire == 2:  # length-delimited
            ln, off = _read_varint(buf, off)
            value = buf[off : off + ln]
            off += ln
        elif wire == 5:  # 32-bit
            value = buf[off : off + 4]
            off += 4
        elif wire == 1:  # 64-bit
            value = buf[off : off + 8]
            off += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _parse_feature(buf: bytes):
    """Feature: oneof {1: BytesList, 2: FloatList, 3: Int64List}."""
    for field, _wire, value in _iter_fields(buf):
        if field == 1:  # BytesList { repeated bytes value = 1 }
            return [v for f, _w, v in _iter_fields(value) if f == 1]
        if field == 2:  # FloatList { repeated float value = 1 [packed] }
            floats: List[float] = []
            for f, w, v in _iter_fields(value):
                if f != 1:
                    continue
                if w == 2:  # packed
                    floats.extend(
                        struct.unpack(f"<{len(v) // 4}f", v)
                    )
                else:
                    floats.append(struct.unpack("<f", v)[0])
            return np.asarray(floats, np.float32)
        if field == 3:  # Int64List { repeated int64 value = 1 [packed] }
            def signed(x: int) -> int:
                # proto int64 varints are two's-complement in 64 bits.
                return x - (1 << 64) if x >= (1 << 63) else x

            ints: List[int] = []
            for f, w, v in _iter_fields(value):
                if f != 1:
                    continue
                if w == 2:
                    off = 0
                    while off < len(v):
                        x, off = _read_varint(v, off)
                        ints.append(signed(x))
                else:
                    ints.append(signed(v))
            return np.asarray(ints, np.int64)
    return None


def parse_example(data: bytes) -> Dict[str, Any]:
    """tf.train.Example { Features features = 1 };
    Features { map<string, Feature> feature = 1 }."""
    row: Dict[str, Any] = {}
    for field, _w, features_buf in _iter_fields(data):
        if field != 1:
            continue
        for f2, _w2, entry in _iter_fields(features_buf):
            if f2 != 1:
                continue
            name, feat = None, None
            for f3, _w3, v3 in _iter_fields(entry):
                if f3 == 1:
                    name = v3.decode()
                elif f3 == 2:
                    feat = _parse_feature(v3)
            if name is not None:
                value = feat
                if isinstance(value, list) and len(value) == 1:
                    value = value[0]
                elif isinstance(value, np.ndarray) and value.size == 1:
                    value = value[0]
                row[name] = value
    return row


def _encode_feature(value) -> bytes:
    """Python value → Feature bytes (bytes/str → BytesList, float(s) →
    FloatList, int(s) → Int64List)."""

    def ld(field: int, payload: bytes) -> bytes:
        return _write_varint(field << 3 | 2) + _write_varint(len(payload)) + payload

    if isinstance(value, (bytes, str)):
        b = value.encode() if isinstance(value, str) else value
        return ld(1, ld(1, b))
    arr = np.asarray(value)
    if np.issubdtype(arr.dtype, np.floating):
        packed = struct.pack(f"<{arr.size}f", *arr.ravel().astype(np.float32))
        return ld(2, ld(1, packed))
    if np.issubdtype(arr.dtype, np.integer):
        payload = b"".join(
            _write_varint(int(x) & ((1 << 64) - 1)) for x in arr.ravel()
        )
        return ld(3, ld(1, payload))
    raise TypeError(f"cannot encode {type(value).__name__} as a Feature")


def encode_example(row: Dict[str, Any]) -> bytes:
    def ld(field: int, payload: bytes) -> bytes:
        return _write_varint(field << 3 | 2) + _write_varint(len(payload)) + payload

    entries = b""
    for name, value in row.items():
        entry = ld(1, name.encode()) + ld(2, _encode_feature(value))
        entries += ld(1, entry)
    return ld(1, entries)


# ------------------------------------------------------------------ file IO
def read_tfrecord_file(path: str) -> List[Dict[str, Any]]:
    rows = []
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                break
            (length,) = struct.unpack("<Q", header[:8])
            data = f.read(length)
            f.read(4)  # data crc (not verified; format-level integrity
            # belongs to the storage layer here)
            rows.append(parse_example(data))
    return rows


def write_tfrecord_file(rows: List[Dict[str, Any]], path: str) -> str:
    with open(path, "wb") as f:
        for row in rows:
            data = encode_example(row)
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))
    return path
