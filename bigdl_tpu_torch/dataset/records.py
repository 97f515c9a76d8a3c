"""Sharded record files for large datasets, the ImageNet path (port of
``bigdl_tpu/dataset/records.py``).

Shards are TFRecord files (framed by the port's ``utils/tfrecord.py``),
each payload a self-describing binary Sample, the JAX package's bytes::

    u16 n_features | u16 n_labels | tensors...
    tensor: u8 dtype_code | u8 ndim | u32 shape[ndim] | raw little-endian bytes

:class:`RecordFileDataSet` splits the files round-robin over
``num_shards`` readers and walks its shard's records with the
reference's infinite shuffled-index iterator (``seed + shard_id``). Its
reads are byte ranges read through the port's ``PrefetchReader``, up to
``lookahead`` in flight, returned in order, as the JAX reader does: on
the C++ pool (``native/dataloader.cc``) by default, on a Python thread
pool with ``native_reader=False`` or where there is no toolchain;
``reader_pool`` records which one served the last walk ("native" or
"python"). The JAX reader takes its shard from
``jax.process_index()`` / ``process_count()``; here ``shard_id`` /
``num_shards`` default to the rank and world size of the
``torch.distributed`` process group when one is up, else to (0, 1).
"""

from __future__ import annotations

import glob
import os
import struct
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.native import (PrefetchReader, masked_crc32c,
                                    tfrecord_frame)

_DTYPES = {
    0: np.dtype("float32"), 1: np.dtype("float64"), 2: np.dtype("int32"),
    3: np.dtype("int64"), 4: np.dtype("uint8"), 5: np.dtype("int8"),
    6: np.dtype("bool"), 7: np.dtype("float16"), 8: np.dtype("uint16"),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}


def _encode_tensor(a: np.ndarray) -> bytes:
    a = np.ascontiguousarray(a)
    code = _DTYPE_CODES.get(a.dtype)
    if code is None:
        a = a.astype(np.float32)
        code = _DTYPE_CODES[a.dtype]
    head = struct.pack("<BB", code, a.ndim)
    head += struct.pack(f"<{a.ndim}I", *a.shape)
    return head + a.tobytes()


def _decode_tensor(buf: bytes, off: int) -> Tuple[np.ndarray, int]:
    code, ndim = struct.unpack_from("<BB", buf, off)
    off += 2
    shape = struct.unpack_from(f"<{ndim}I", buf, off)
    off += 4 * ndim
    dt = _DTYPES[code]
    n = int(np.prod(shape)) if ndim else 1
    a = np.frombuffer(buf, dt, count=n, offset=off).reshape(shape)
    return a, off + n * dt.itemsize


def encode_sample(s: Sample) -> bytes:
    out = [struct.pack("<HH", len(s.features), len(s.labels))]
    out.extend(_encode_tensor(a) for a in s.features)
    out.extend(_encode_tensor(a) for a in s.labels)
    return b"".join(out)


def decode_sample(buf: bytes) -> Sample:
    n_f, n_l = struct.unpack_from("<HH", buf, 0)
    off = 4
    feats, labels = [], []
    for _ in range(n_f):
        a, off = _decode_tensor(buf, off)
        feats.append(a)
    for _ in range(n_l):
        a, off = _decode_tensor(buf, off)
        labels.append(a)
    return Sample(feats, labels if labels else None)


def write_record_shards(samples: Sequence[Sample], out_dir: str,
                        num_shards: int = 8, prefix: str = "part") -> List[str]:
    """Write samples round-robin into ``num_shards`` TFRecord files
    (``{prefix}-{i:05d}-of-{num_shards:05d}.tfrecord``); their paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = [os.path.join(out_dir,
                          f"{prefix}-{i:05d}-of-{num_shards:05d}.tfrecord")
             for i in range(num_shards)]
    files = [open(p, "wb") for p in paths]
    try:
        for i, s in enumerate(samples):
            files[i % num_shards].write(tfrecord_frame(encode_sample(s)))
    finally:
        for f in files:
            f.close()
    return paths


def index_record_file(path: str) -> List[Tuple[int, int]]:
    """[(payload offset, payload length)] of every record of a TFRecord
    file, checking each length's CRC: one scan, for byte-range reads
    afterwards."""
    entries = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        off = 0
        while off + 12 <= size:
            head = f.read(12)
            if len(head) < 12:
                break
            (length,) = struct.unpack_from("<Q", head, 0)
            (lcrc,) = struct.unpack_from("<I", head, 8)
            if masked_crc32c(head[:8]) != lcrc:
                raise ValueError(f"{path}: length crc mismatch at {off}")
            entries.append((off + 12, int(length)))
            off += 16 + length
            f.seek(off)
    return entries


def _process_group() -> Tuple[int, int]:
    """(rank, world size) of the default torch.distributed group, or
    (0, 1) when none is up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class RecordFileDataSet(AbstractDataSet):
    """Dataset over TFRecord shard files (a directory's ``*.tfrecord`` or
    a glob), streamed: the records need not fit in memory. ``size()`` is
    the global record count, ``local_size()`` this shard's.
    ``native_reader`` chooses the C++ reader (default) or the Python
    pool."""

    def __init__(self, path_or_glob: str, shard_id: Optional[int] = None,
                 num_shards: Optional[int] = None, seed: int = 1,
                 lookahead: int = 16, n_threads: int = 4,
                 native_reader: bool = True):
        if os.path.isdir(path_or_glob):
            paths = sorted(glob.glob(os.path.join(path_or_glob, "*.tfrecord")))
        else:
            paths = sorted(glob.glob(path_or_glob))
        if not paths:
            raise FileNotFoundError(f"no record files match {path_or_glob}")
        rank, world = _process_group()
        self.num_shards = num_shards if num_shards is not None else world
        self.shard_id = shard_id if shard_id is not None else rank
        indexes = [index_record_file(p) for p in paths]
        self._all_counts = [len(ix) for ix in indexes]
        # round-robin file split across shards (files >> shards for balance)
        mine = [i for i in range(len(paths))
                if i % self.num_shards == self.shard_id]
        self._paths = [paths[i] for i in mine]
        self._entries: List[Tuple[str, int, int]] = [
            (paths[i], off, length) for i in mine
            for off, length in indexes[i]]
        self._index = np.arange(len(self._entries))
        self._rng = np.random.RandomState(seed + self.shard_id)
        self.lookahead = max(1, lookahead)
        self.n_threads = max(1, n_threads)
        self.native_reader = native_reader
        self.reader_pool: Optional[str] = None

    def size(self) -> int:
        return int(sum(self._all_counts))

    def local_size(self) -> int:
        return len(self._entries)

    def shuffle(self) -> None:
        self._rng.shuffle(self._index)

    def _read_iter(self, order: Iterator[int]) -> Iterator[Sample]:
        """The records at ``order``, in order, read ``lookahead`` ahead."""
        reader = PrefetchReader(self.n_threads, capacity=self.lookahead * 2,
                                use_native=self.native_reader)
        self.reader_pool = "native" if reader.native else "python"
        try:
            pending = 0
            order = iter(order)
            done = False
            while True:
                while pending < self.lookahead and not done:
                    idx = next(order, None)
                    if idx is None:
                        done = True
                        break
                    reader.submit(*self._entries[idx])
                    pending += 1
                if pending == 0:
                    return
                yield decode_sample(reader.next())
                pending -= 1
        finally:
            reader.close()

    def data(self, train: bool = True) -> Iterator[Sample]:
        n = len(self._entries)
        if not train:
            return self._read_iter(iter(range(n)))
        if n == 0:
            raise ValueError(
                f"record shard {self.shard_id}/{self.num_shards} holds no "
                f"files: write at least num_shards record files (got "
                f"{len(self._all_counts)} in total)")
        offset = int(self._rng.randint(0, n))

        def infinite_order():
            i = offset
            while True:
                yield int(self._index[i % n])
                i += 1

        return self._read_iter(infinite_order())
