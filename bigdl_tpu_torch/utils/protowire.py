"""Schema-less protobuf wire-format codec (port of
``bigdl_tpu/utils/protowire.py``; the port keeps its own copy and never
imports the JAX package's).

``nn/tf_ops.py::ParseExample`` decodes ``tf.Example`` records with it.
Messages are decoded generically into {field_number: [values]} trees and
interpreted by field number against the public .proto schemas: no
protobuf runtime is needed.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple


# ------------------------------------------------------------------ encode
def varint(n: int) -> bytes:
    out = bytearray()
    n &= 0xFFFFFFFFFFFFFFFF
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def tag(field: int, wire: int) -> bytes:
    return varint((field << 3) | wire)


def enc_varint(field: int, v: int) -> bytes:
    return tag(field, 0) + varint(int(v))


def enc_double(field: int, v: float) -> bytes:
    return tag(field, 1) + struct.pack("<d", v)


def enc_float(field: int, v: float) -> bytes:
    return tag(field, 5) + struct.pack("<f", v)


def enc_bytes(field: int, v: bytes) -> bytes:
    return tag(field, 2) + varint(len(v)) + v


def enc_string(field: int, v: str) -> bytes:
    return enc_bytes(field, v.encode("utf-8"))


def enc_packed_floats(field: int, vals) -> bytes:
    return enc_bytes(field, b"".join(struct.pack("<f", float(v)) for v in vals))


def enc_packed_doubles(field: int, vals) -> bytes:
    return enc_bytes(field, b"".join(struct.pack("<d", float(v)) for v in vals))


def enc_packed_varints(field: int, vals) -> bytes:
    return enc_bytes(field, b"".join(varint(int(v)) for v in vals))


# ------------------------------------------------------------------ decode
def read_varint(data: bytes, i: int) -> Tuple[int, int]:
    v = 0
    shift = 0
    while True:
        b = data[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


def iter_fields(data: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field, wire_type, raw_value). Length-delimited -> bytes, varint ->
    int, fixed64/fixed32 -> raw bytes."""
    i, n = 0, len(data)
    while i < n:
        key, i = read_varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = read_varint(data, i)
            yield field, wire, v
        elif wire == 1:
            yield field, wire, data[i:i + 8]
            i += 8
        elif wire == 5:
            yield field, wire, data[i:i + 4]
            i += 4
        elif wire == 2:
            ln, i = read_varint(data, i)
            yield field, wire, data[i:i + ln]
            i += ln
        else:
            raise ValueError(f"unsupported wire type {wire}")


def decode(data: bytes) -> Dict[int, List]:
    """One message level -> {field: [raw values in order]}."""
    out: Dict[int, List] = {}
    for field, _, value in iter_fields(data):
        out.setdefault(field, []).append(value)
    return out


# Typed readers over decode() results --------------------------------------
def as_string(v: bytes) -> str:
    return v.decode("utf-8")


def as_float(v) -> float:
    if isinstance(v, bytes):
        return struct.unpack("<f" if len(v) == 4 else "<d", v)[0]
    return float(v)


def as_signed(v: int, bits: int = 64) -> int:
    if v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


def packed_floats(v: bytes) -> List[float]:
    return list(struct.unpack(f"<{len(v) // 4}f", v))


def packed_doubles(v: bytes) -> List[float]:
    return list(struct.unpack(f"<{len(v) // 8}d", v))


def packed_varints(v) -> List[int]:
    """Accepts either packed bytes or an already-decoded single varint."""
    if isinstance(v, int):
        return [v]
    out = []
    i = 0
    while i < len(v):
        val, i = read_varint(v, i)
        out.append(val)
    return out


def repeated_varints(values: List) -> List[int]:
    """Flatten a repeated scalar field that may mix packed and unpacked."""
    out: List[int] = []
    for v in values:
        out.extend(packed_varints(v))
    return out
