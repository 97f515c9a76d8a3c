"""CRC32C and TFRecord framing (a copy of the pure-Python half of
``bigdl_tpu/native/__init__.py``: ``crc32c``, ``masked_crc32c``,
``tfrecord_frame``, ``tfrecord_iter``). The JAX package runs them in its
C++ library where it is built and falls back to this code; the port
has only this code (the native library is ROADMAP.md, Queue 1 item 12).
The bytes are the same either way.
"""

from __future__ import annotations

import struct

_CRC_TABLE = None


def _table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        tbl = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            tbl.append(crc)
        _CRC_TABLE = tbl
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    tbl = _table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ tbl[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord_frame(payload: bytes) -> bytes:
    """One TFRecord: len u64le | masked_crc(len) | data | masked_crc(data)."""
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header)) + payload
            + struct.pack("<I", masked_crc32c(payload)))


def tfrecord_iter(data: bytes):
    """Yield the payloads of a concatenation of framed records; raises on
    a CRC mismatch or a truncated record."""
    off = 0
    n = len(data)
    while off + 12 <= n:
        (length,) = struct.unpack_from("<Q", data, off)
        (lcrc,) = struct.unpack_from("<I", data, off + 8)
        if masked_crc32c(data[off:off + 8]) != lcrc:
            raise ValueError(f"tfrecord length crc mismatch at {off}")
        if off + 16 + length > n:
            raise ValueError("truncated tfrecord")
        payload = data[off + 12: off + 12 + length]
        (dcrc,) = struct.unpack_from("<I", data, off + 12 + length)
        if masked_crc32c(payload) != dcrc:
            raise ValueError(f"tfrecord data crc mismatch at {off}")
        yield payload
        off += 16 + length
