"""Minimal protobuf wire-format codec for TensorBoard event files (a
copy of ``bigdl_tpu/visualization/proto.py``, which imports no
framework).

The reference writes TF summary/event protos from Scala with checked-in
generated classes (visualization/Summary.scala:32-108, tensorboard/
FileWriter.scala). Python analog: hand-rolled varint/wire encoding of the
few message types TensorBoard needs — no protobuf runtime dependency.

Messages (field numbers from the public tensorflow event.proto /
summary.proto):
  Event:   wall_time=1(double) step=2(int64) file_version=3(string)
           summary=5(message)
  Summary: value=1(repeated message)
  Value:   tag=1(string) simple_value=2(float) histo=5(message)
  HistogramProto: min=1 max=2 num=3 sum=4 sum_squares=5 (double)
           bucket_limit=6(packed double) bucket=7(packed double)
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Tuple


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag_free_int64(n: int) -> int:
    return n & 0xFFFFFFFFFFFFFFFF  # proto int64 negative -> 10-byte varint


def tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def enc_double(field: int, v: float) -> bytes:
    return tag(field, 1) + struct.pack("<d", v)


def enc_float(field: int, v: float) -> bytes:
    return tag(field, 5) + struct.pack("<f", v)


def enc_int64(field: int, v: int) -> bytes:
    return tag(field, 0) + _varint(_zigzag_free_int64(int(v)))


def enc_bytes(field: int, v: bytes) -> bytes:
    return tag(field, 2) + _varint(len(v)) + v


def enc_string(field: int, v: str) -> bytes:
    return enc_bytes(field, v.encode("utf-8"))


def enc_packed_doubles(field: int, vals) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in vals)
    return enc_bytes(field, payload)


def histogram_proto(minv, maxv, num, total, sum_sq, limits, counts) -> bytes:
    return (enc_double(1, minv) + enc_double(2, maxv) + enc_double(3, num) +
            enc_double(4, total) + enc_double(5, sum_sq) +
            enc_packed_doubles(6, limits) + enc_packed_doubles(7, counts))


def scalar_value(tag_name: str, value: float) -> bytes:
    return enc_string(1, tag_name) + enc_float(2, value)


def histo_value(tag_name: str, histo: bytes) -> bytes:
    return enc_string(1, tag_name) + enc_bytes(5, histo)


def summary(values: List[bytes]) -> bytes:
    return b"".join(enc_bytes(1, v) for v in values)


def event(wall_time: float, step: int = None, file_version: str = None,
          summary_bytes: bytes = None) -> bytes:
    out = enc_double(1, wall_time)
    if step is not None:
        out += enc_int64(2, step)
    if file_version is not None:
        out += enc_string(3, file_version)
    if summary_bytes is not None:
        out += enc_bytes(5, summary_bytes)
    return out


# ------------------------------------------------------------------ decode
def iter_fields(data: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field, wire_type, value) over a serialized message. Length-delimited
    values are returned as bytes; varints as int; fixed as raw bytes."""
    i, n = 0, len(data)
    while i < n:
        v = 0
        shift = 0
        while True:
            b = data[i]
            i += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        field, wire = v >> 3, v & 7
        if wire == 0:
            val = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                val |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield field, wire, val
        elif wire == 1:
            yield field, wire, data[i:i + 8]
            i += 8
        elif wire == 5:
            yield field, wire, data[i:i + 4]
            i += 4
        elif wire == 2:
            ln = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                ln |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield field, wire, data[i:i + ln]
            i += ln
        else:
            raise ValueError(f"unsupported wire type {wire}")


def parse_event(data: bytes) -> dict:
    """Decode an Event into {wall_time, step, values: [(tag, simple_value)]}."""
    out = {"wall_time": 0.0, "step": 0, "values": []}
    for field, wire, val in iter_fields(data):
        if field == 1 and wire == 1:
            out["wall_time"] = struct.unpack("<d", val)[0]
        elif field == 2 and wire == 0:
            step = val
            if step >= 1 << 63:
                step -= 1 << 64
            out["step"] = step
        elif field == 5 and wire == 2:
            for f2, w2, v2 in iter_fields(val):  # Summary.value
                if f2 == 1 and w2 == 2:
                    tag_name, simple = None, None
                    for f3, w3, v3 in iter_fields(v2):
                        if f3 == 1 and w3 == 2:
                            tag_name = v3.decode("utf-8")
                        elif f3 == 2 and w3 == 5:
                            simple = struct.unpack("<f", v3)[0]
                    if tag_name is not None and simple is not None:
                        out["values"].append((tag_name, simple))
    return out
