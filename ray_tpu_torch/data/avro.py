"""Avro Object Container File codec — dependency-free.

Reference: ray ``python/ray/data/_internal/datasource/avro_datasource.py``
reads Avro through the ``fastavro`` package.  Neither ``avro`` nor
``fastavro`` is available here, so — like ``data/tfrecord.py`` for
TFRecord — this module implements the container-file framing and the
schema-driven binary encoding directly from the Avro 1.11 spec:

* OCF layout: ``Obj\\x01`` magic, metadata map (``avro.schema`` JSON +
  ``avro.codec``), 16-byte sync marker, then data blocks of
  ``(row_count, byte_size, payload, sync)``.
* Codecs: ``null`` and ``deflate`` (raw DEFLATE via zlib, wbits=-15).
* Types: null/boolean/int/long/float/double/bytes/string/record/enum/
  array/map/union/fixed; logical types decode as their underlying type.

Longs are zigzag varints; arrays/maps are block-encoded (a negative
count is followed by a byte size and means ``abs(count)`` items).
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, Dict, List, Optional

MAGIC = b"Obj\x01"


# ------------------------------------------------------------- primitives
def _read_long(buf: io.BytesIO) -> int:
    shift = 0
    acc = 0
    while True:
        b = buf.read(1)
        if not b:
            raise EOFError("truncated varint")
        byte = b[0]
        acc |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)  # zigzag


def _write_long(value: int) -> bytes:
    acc = (value << 1) ^ (value >> 63)  # zigzag (Python ints: arithmetic shift)
    out = bytearray()
    while True:
        bits = acc & 0x7F
        acc >>= 7
        if acc:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _read_bytes(buf: io.BytesIO) -> bytes:
    n = _read_long(buf)
    data = buf.read(n)
    if len(data) != n:
        raise EOFError("truncated bytes")
    return data


# ------------------------------------------------------------ schema codec
def _decode(schema, buf: io.BytesIO):
    if isinstance(schema, list):  # union
        return _decode(schema[_read_long(buf)], buf)
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "record":
            return {
                f["name"]: _decode(f["type"], buf) for f in schema["fields"]
            }
        if t == "enum":
            return schema["symbols"][_read_long(buf)]
        if t == "array":
            out = []
            while True:
                count = _read_long(buf)
                if count == 0:
                    return out
                if count < 0:
                    _read_long(buf)  # block byte size: skippable, unused
                    count = -count
                for _ in range(count):
                    out.append(_decode(schema["items"], buf))
        if t == "map":
            out = {}
            while True:
                count = _read_long(buf)
                if count == 0:
                    return out
                if count < 0:
                    _read_long(buf)
                    count = -count
                for _ in range(count):
                    key = _read_bytes(buf).decode()
                    out[key] = _decode(schema["values"], buf)
        if t == "fixed":
            return buf.read(schema["size"])
        return _decode(t, buf)  # named/logical wrapper: unwrap
    # primitive (schema is a string)
    if schema == "null":
        return None
    if schema == "boolean":
        return buf.read(1) == b"\x01"
    if schema in ("int", "long"):
        return _read_long(buf)
    if schema == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if schema == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if schema == "bytes":
        return _read_bytes(buf)
    if schema == "string":
        return _read_bytes(buf).decode()
    raise ValueError(f"unsupported avro type: {schema!r}")


def _encode(schema, value, out: bytearray) -> None:
    if isinstance(schema, list):  # union: pick the first matching branch
        for i, branch in enumerate(schema):
            if _matches(branch, value):
                out += _write_long(i)
                _encode(branch, value, out)
                return
        raise ValueError(f"value {value!r} matches no union branch {schema}")
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "record":
            # .get, not []: infer_schema null-unions fields absent from
            # some rows, so encoding must tolerate the absence too.
            for f in schema["fields"]:
                _encode(f["type"], value.get(f["name"]), out)
            return
        if t == "enum":
            out += _write_long(schema["symbols"].index(value))
            return
        if t == "array":
            # len() instead of truthiness: numpy arrays are valid array
            # values and raise on bool().
            if len(value):
                out += _write_long(len(value))
                for item in value:
                    _encode(schema["items"], item, out)
            out += _write_long(0)
            return
        if t == "map":
            if len(value):
                out += _write_long(len(value))
                for k, v in value.items():
                    kb = k.encode()
                    out += _write_long(len(kb))
                    out += kb
                    _encode(schema["values"], v, out)
            out += _write_long(0)
            return
        if t == "fixed":
            out += bytes(value)
            return
        _encode(t, value, out)
        return
    if schema == "null":
        return
    if schema == "boolean":
        out.append(1 if value else 0)
        return
    if schema in ("int", "long"):
        out += _write_long(int(value))
        return
    if schema == "float":
        out += struct.pack("<f", float(value))
        return
    if schema == "double":
        out += struct.pack("<d", float(value))
        return
    if schema == "bytes":
        out += _write_long(len(value))
        out += bytes(value)
        return
    if schema == "string":
        data = str(value).encode()
        out += _write_long(len(data))
        out += data
        return
    raise ValueError(f"unsupported avro type: {schema!r}")


def _matches(schema, value) -> bool:
    # numpy scalar types count as their python analogs — ColumnarBlock
    # iteration yields np.int64/np.float32/np.bool_ values and
    # infer_schema/_type_name already accept them.
    import numpy as np

    t = schema["type"] if isinstance(schema, dict) else schema
    if t == "null":
        return value is None
    if t == "boolean":
        return isinstance(value, (bool, np.bool_))
    if t in ("int", "long"):
        return isinstance(value, (int, np.integer)) and not isinstance(
            value, (bool, np.bool_)
        )
    if t in ("float", "double"):
        return isinstance(value, (float, np.floating))
    if t == "string":
        return isinstance(value, str)
    if t in ("bytes", "fixed"):
        return isinstance(value, (bytes, bytearray))
    if t == "array":
        return isinstance(value, (list, np.ndarray))
    if t in ("map", "record"):
        return isinstance(value, dict)
    if t == "enum":
        return isinstance(value, str)
    return value is not None


def infer_schema(rows: List[Dict[str, Any]], name: str = "Row") -> dict:
    """Record schema from sample rows; a column whose values include None
    becomes a ``["null", T]`` union."""

    def of(values, field):
        types = set()
        for v in values:
            if v is None:
                types.add("null")
            else:
                types.add(_type_name(v))
        types.discard("null")
        if len(types) > 1:
            raise ValueError(f"mixed types for field {field!r}: {types}")
        base: Any = next(iter(types)) if types else "null"
        if base == "array":
            # len() guards, not truthiness — ndarray columns raise on bool()
            items = [x for v in values
                     if v is not None and len(v) for x in v]
            # Recurse: an array of maps/arrays needs the FULL nested
            # schema ({"type": "map", "values": ...}), not the bare type
            # name — _encode rejects bare "map"/"array".
            base = {"type": "array",
                    "items": of(items, f"{field}[]") if items else "string"}
        elif base == "map":
            vals = [x for v in values
                    if v is not None and len(v) for x in v.values()]
            base = {"type": "map",
                    "values": of(vals, f"{field}{{}}") if vals else "string"}
        if any(v is None for v in values) and base != "null":
            return ["null", base]
        return base

    keys: List[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    return {
        "type": "record",
        "name": name,
        "fields": [
            {"name": k, "type": of([r.get(k) for r in rows], k)} for k in keys
        ],
    }


def _type_name(v) -> str:
    import numpy as np

    if isinstance(v, bool) or isinstance(v, np.bool_):
        return "boolean"
    if isinstance(v, (int, np.integer)):
        return "long"
    if isinstance(v, (float, np.floating)):
        return "double"
    if isinstance(v, str):
        return "string"
    if isinstance(v, (bytes, bytearray)):
        return "bytes"
    if isinstance(v, (list, np.ndarray)):
        return "array"
    if isinstance(v, dict):
        return "map"
    raise ValueError(f"cannot infer avro type of {type(v)}")


# ------------------------------------------------------------------- files
def read_avro_file(path: str) -> List[Dict[str, Any]]:
    """All rows of one OCF file.  Top-level record schemas yield dict rows;
    any other top-level type yields ``{"value": v}`` rows."""
    with open(path, "rb") as f:
        data = f.read()
    buf = io.BytesIO(data)
    if buf.read(4) != MAGIC:
        raise ValueError(f"{path}: not an Avro object container file")
    meta: Dict[str, bytes] = {}
    while True:
        count = _read_long(buf)
        if count == 0:
            break
        if count < 0:
            _read_long(buf)
            count = -count
        for _ in range(count):
            key = _read_bytes(buf).decode()
            meta[key] = _read_bytes(buf)
    schema = json.loads(meta["avro.schema"])
    codec = meta.get("avro.codec", b"null").decode()
    sync = buf.read(16)
    is_record = isinstance(schema, dict) and schema.get("type") == "record"
    rows: List[Dict[str, Any]] = []
    while buf.tell() < len(data):
        n_rows = _read_long(buf)
        payload = _read_bytes(buf)
        if codec == "deflate":
            payload = zlib.decompress(payload, -15)
        elif codec != "null":
            raise ValueError(f"unsupported avro codec: {codec}")
        block = io.BytesIO(payload)
        for _ in range(n_rows):
            v = _decode(schema, block)
            rows.append(v if is_record else {"value": v})
        if buf.read(16) != sync:
            raise ValueError(f"{path}: sync marker mismatch (corrupt file)")
    return rows


def write_avro_file(rows: List[Dict[str, Any]], path: str,
                    schema: Optional[dict] = None,
                    codec: str = "null") -> str:
    schema = schema or infer_schema(rows or [{}])
    body = bytearray()
    for r in rows:
        _encode(schema, r, body)
    payload = bytes(body)
    if codec == "deflate":
        payload = zlib.compress(payload, 9)[2:-4]  # strip zlib header+adler
    elif codec != "null":
        raise ValueError(f"unsupported avro codec: {codec}")
    sync = os.urandom(16)
    out = bytearray(MAGIC)
    meta = {"avro.schema": json.dumps(schema).encode(),
            "avro.codec": codec.encode()}
    out += _write_long(len(meta))
    for k, v in meta.items():
        kb = k.encode()
        out += _write_long(len(kb))
        out += kb
        out += _write_long(len(v))
        out += v
    out += _write_long(0)
    out += sync
    if rows:
        out += _write_long(len(rows))
        out += _write_long(len(payload))
        out += payload
        out += sync
    with open(path, "wb") as f:
        f.write(out)
    return path
