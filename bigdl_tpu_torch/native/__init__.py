"""The port's build of the repo's C++ runtime (``native/*.cc``), bound with
ctypes (port of ``bigdl_tpu/native/__init__.py``).

What it holds: the CRC32C / TFRecord codec (``native/crc32c.cc``), the
ordered multithreaded byte-range reader (``native/dataloader.cc``:
:class:`PrefetchReader`) and the one-pass crop + flip + normalize of an
HWC uint8 image (``native/augment.cc``: :func:`fused_augment`).

The build: at first use, ``g++ -O3 -fPIC -std=c++17 -shared`` compiles
the three sources, with ``-lpthread``, into ``build/bigdl_tpu_torch/`` at
the root of the checkout, never into the JAX package (``make -C native``
writes ``bigdl_tpu/native/libbigdl_native.so``; it is not run here, and
that library is never loaded). The file name carries a hash of the
compiler flags and of each source's name and bytes, so an edited source
gives a new library and a stale one is never loaded. The compiler links
to a PID-suffixed temporary file that is renamed into place, so
processes building at once (a parallel test run) never load a
half-written file. A compile that fails raises with the compiler's
output.

Where there is no toolchain (no C++ compiler, or no ``native/`` sources
beside the package), every entry point takes the Python path the JAX
package falls back to, :func:`native_available` is False and
:func:`unavailable_reason` says why. The Python codec gives the same
bytes; the reader runs on a Python thread pool, in the same order; and
:func:`fused_augment` returns None, which sends its caller to the numpy
path (bit-identical: both multiply by the same f32 reciprocal).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence

REPO = Path(__file__).resolve().parents[2]
SOURCES = tuple(REPO / "native" / n
                for n in ("crc32c.cc", "dataloader.cc", "augment.cc"))
BUILD_DIR = REPO / "build" / "bigdl_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-lpthread",)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_reason: Optional[str] = None          # why the library is unavailable
_tried = False


def compiler() -> Optional[str]:
    """``$CXX`` if set, else ``g++`` on PATH, else None."""
    return os.environ.get("CXX") or shutil.which("g++")


def library_path(sources: Sequence[Path] = SOURCES,
                 build_dir: Path = BUILD_DIR) -> Path:
    """Where the library built from ``sources`` lives: a hash of the
    flags and of each source's name and bytes."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    for src in sources:
        h.update(Path(src).name.encode() + b"\0")
        h.update(Path(src).read_bytes())
    return Path(build_dir) / f"libbigdl_native-{h.hexdigest()[:16]}.so"


def build(sources: Sequence[Path] = SOURCES,
          build_dir: Path = BUILD_DIR) -> Path:
    """Compile the library unless its hashed file exists; its path.
    Raises with the compiler's output if the compile fails."""
    out = library_path(sources, build_dir)
    if out.exists():
        return out
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler: set CXX or put g++ on PATH")
    Path(build_dir).mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, sources), *LIBS],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native runtime build failed ({cxx} exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p, u64, i64 = (ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
                     ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    sigs = {
        "bigdl_crc32c": (ctypes.c_uint32, [ctypes.c_char_p, u64]),
        "bigdl_masked_crc32c": (ctypes.c_uint32, [ctypes.c_char_p, u64]),
        "bigdl_tfrecord_frame": (u64, [ctypes.c_char_p, u64,
                                       ctypes.c_char_p]),
        "bigdl_loader_create": (ctypes.c_void_p, [ctypes.c_int,
                                                  ctypes.c_int]),
        "bigdl_loader_submit": (i64, [ctypes.c_void_p, ctypes.c_char_p,
                                      u64, u64]),
        "bigdl_loader_next": (i64, [
            ctypes.c_void_p, ctypes.POINTER(u8p), ctypes.POINTER(u64),
            ctypes.POINTER(ctypes.c_int)]),
        "bigdl_loader_free": (None, [ctypes.c_void_p, i64]),
        "bigdl_loader_destroy": (None, [ctypes.c_void_p]),
        "bigdl_fused_augment": (None, [
            u8p, i64, i64, i64,           # img, h, w, c
            i64, i64, i64, i64,           # top, left, crop h, crop w
            ctypes.c_int, f32p, f32p,     # flip, mean, 1/std
            f32p]),                       # out
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None where there is no
    toolchain (:func:`unavailable_reason` says why). A failed compile
    raises."""
    global _lib, _reason, _tried
    with _lock:
        if _tried:
            return _lib
        missing = [str(s) for s in SOURCES if not Path(s).exists()]
        if missing:
            _reason = f"native sources not found: {', '.join(missing)}"
        elif compiler() is None:
            _reason = "no C++ compiler: set CXX or put g++ on PATH"
        else:
            _lib = _bind(ctypes.CDLL(str(build())))
        _tried = True
        return _lib


def native_available() -> bool:
    """True when the library is built and loaded."""
    return get_lib() is not None


def unavailable_reason() -> Optional[str]:
    """Why :func:`native_available` is False (None when it is True)."""
    get_lib()
    return _reason


# ---------------------------------------------------------------- crc32c
_CRC_TABLE = None


def _py_table():
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
    lib = get_lib()
    if lib is not None:
        return lib.bigdl_crc32c(data, len(data))
    tbl = _py_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ tbl[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    lib = get_lib()
    if lib is not None:
        return lib.bigdl_masked_crc32c(data, len(data))
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -------------------------------------------------------------- tfrecord
def tfrecord_frame(payload: bytes) -> bytes:
    """One TFRecord: len u64le | masked_crc(len) | data | masked_crc(data)."""
    lib = get_lib()
    if lib is not None:
        out = ctypes.create_string_buffer(len(payload) + 16)
        n = lib.bigdl_tfrecord_frame(payload, len(payload), out)
        return out.raw[:n]
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header)) + payload
            + struct.pack("<I", masked_crc32c(payload)))


def tfrecord_iter(data: bytes):
    """Yield the payloads of a concatenation of framed records; raises on
    a CRC mismatch or a truncated record (≙ TFRecordIterator.scala)."""
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


# ------------------------------------------------------------ data loader
def _read_range(path: str, offset: int, length: int) -> bytes:
    with open(path, "rb") as f:
        if offset:
            f.seek(offset)
        return f.read(length) if length else f.read()


class PrefetchReader:
    """Ordered multithreaded byte-range reader: reads are submitted as
    (path, offset, length) (length 0: to the end of the file), run on
    ``n_threads`` threads and handed back by :meth:`next` in submission
    order. ``use_native`` (default) runs them on the C++ pool, which
    holds at most ``capacity`` in flight (``submit`` blocks beyond it);
    otherwise, or where there is no toolchain, on a Python thread pool
    (file reads release the interpreter lock), unbounded. ``native``
    records which pool serves this reader."""

    def __init__(self, n_threads: int = 4, capacity: int = 32,
                 use_native: bool = True):
        self._lib = get_lib() if use_native else None
        self.native = self._lib is not None
        self._handle = self._pool = None
        if self.native:
            self._handle = self._lib.bigdl_loader_create(n_threads, capacity)
        else:
            self._pool = ThreadPoolExecutor(
                max(1, n_threads), thread_name_prefix="bigdl-reader")
            self._pending: deque = deque()
            self._submitted = 0

    def submit(self, path: str, offset: int = 0, length: int = 0) -> int:
        """Queue one read; its job id (0, 1, ... in submission order)."""
        if self.native:
            return self._lib.bigdl_loader_submit(
                self._handle, os.fsencode(path), offset, length)
        self._pending.append(self._pool.submit(_read_range, path, offset,
                                               length))
        self._submitted += 1
        return self._submitted - 1

    def next(self) -> bytes:
        """The next completed read, in submission order. Raises an
        ``OSError`` on a failed read, ``IndexError`` when nothing is
        outstanding."""
        if not self.native:
            if not self._pending:
                raise IndexError("no outstanding reads")
            return self._pending.popleft().result()
        data = ctypes.POINTER(ctypes.c_uint8)()
        length = ctypes.c_uint64()
        err = ctypes.c_int()
        jid = self._lib.bigdl_loader_next(
            self._handle, ctypes.byref(data), ctypes.byref(length),
            ctypes.byref(err))
        if jid < 0:
            raise IndexError("no outstanding reads")
        try:
            if err.value != 0:
                raise IOError(f"native read failed (code {err.value})")
            return ctypes.string_at(data, length.value)
        finally:
            self._lib.bigdl_loader_free(self._handle, jid)

    def close(self):
        if self._handle is not None:
            self._lib.bigdl_loader_destroy(self._handle)
            self._handle = None
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------- fused augment
def fused_augment_available() -> bool:
    return native_available()


def fused_augment(img, top: int, left: int, crop_h: int, crop_w: int,
                  flip: bool, means, inv_stds):
    """One-pass crop + flip + normalize: (h, w, c) uint8 C-contiguous ->
    (crop_h, crop_w, c) float32 ``(pixel - mean) * inv_std``. Returns None
    where the library is unavailable or the input does not qualify (the
    caller takes the numpy path): a non-uint8, non-3-D or non-contiguous
    image, ``means`` / ``inv_stds`` whose length is not c, or a crop
    window out of bounds (the C kernel trusts its arguments and would
    read past the buffers). The call releases the interpreter lock."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    if img.dtype != np.uint8 or img.ndim != 3 or not img.flags.c_contiguous:
        return None
    h, w, c = img.shape
    mean = np.ascontiguousarray(means, np.float32)
    inv = np.ascontiguousarray(inv_stds, np.float32)
    if mean.shape != (c,) or inv.shape != (c,):
        return None
    if not (0 <= top and 0 <= left and crop_h >= 1 and crop_w >= 1
            and top + crop_h <= h and left + crop_w <= w):
        return None
    out = np.empty((crop_h, crop_w, c), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.bigdl_fused_augment(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, c, top, left, crop_h, crop_w, int(bool(flip)),
        mean.ctypes.data_as(f32p), inv.ctypes.data_as(f32p),
        out.ctypes.data_as(f32p))
    return out
