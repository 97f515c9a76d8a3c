"""TensorBoard-compatible event file writers (port of
``bigdl_tpu/visualization/tensorboard.py``): TFRecord-framed event protos
with CRC32C masking, written by a background thread. The framing is
``utils/tfrecord.py`` (the port's native codec where its library is
built, its Python path where not), byte for byte the JAX package's, so
event files written by either package read back through the other's
``read_scalar``.
"""

from __future__ import annotations

import os
import queue
import socket
import threading
import time
from typing import List, Optional

from bigdl_tpu_torch.utils import file as bt_file
from bigdl_tpu_torch.utils import tfrecord
from bigdl_tpu_torch.visualization import proto


class RecordWriter:
    """Append TFRecord-framed payloads to a file (≙ RecordWriter.scala)."""

    def __init__(self, path: str):
        self.path = path
        # fresh file per run (timestamped name): 'ab' locally, one
        # streaming 'wb' on object stores (buckets have no append)
        self._f = bt_file.open_file(path, "ab")

    def write(self, payload: bytes) -> None:
        self._f.write(tfrecord.tfrecord_frame(payload))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class EventWriter:
    """Queue + background thread draining events to a RecordWriter
    (≙ EventWriter.scala). The first record is the file_version event."""

    def __init__(self, log_dir: str, flush_secs: float = 2.0):
        bt_file.makedirs(log_dir)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(log_dir, fname)
        self._writer = RecordWriter(self.path)
        self._writer.write(proto.event(time.time(), file_version="brain.Event:2"))
        self._q: "queue.Queue[Optional[bytes]]" = queue.Queue()
        self._flush_secs = flush_secs
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def add_event(self, event_bytes: bytes) -> "EventWriter":
        self._q.put(event_bytes)
        return self

    def flush(self) -> "EventWriter":
        """Block until everything queued so far is on disk."""
        done = threading.Event()
        self._q.put(done)
        done.wait(timeout=10)
        return self

    def _run(self):
        last_flush = time.time()
        while True:
            try:
                item = self._q.get(timeout=self._flush_secs)
            except queue.Empty:
                item = ()
            if item is None:
                break
            if isinstance(item, threading.Event):
                self._writer.flush()
                item.set()
                continue
            if item:
                self._writer.write(item)
            if time.time() - last_flush >= self._flush_secs:
                self._writer.flush()
                last_flush = time.time()
        self._writer.flush()
        self._writer.close()

    def close(self):
        self._q.put(None)
        self._thread.join(timeout=10)


class FileWriter:
    """User-facing writer (≙ FileWriter.scala): add scalar/histogram
    summaries by (tag, value, step)."""

    def __init__(self, log_dir: str, flush_secs: float = 2.0):
        self.log_dir = log_dir
        self._events = EventWriter(log_dir, flush_secs)

    def add_scalar(self, tag: str, value: float, step: int) -> "FileWriter":
        s = proto.summary([proto.scalar_value(tag, float(value))])
        self._events.add_event(proto.event(time.time(), step=step, summary_bytes=s))
        return self

    def add_histogram(self, tag: str, values, step: int) -> "FileWriter":
        import numpy as np

        arr = np.asarray(values, dtype=np.float64).reshape(-1)
        limits = _exp_bucket_limits()
        counts, _ = np.histogram(arr, bins=[-np.inf] + limits) if arr.size else (
            np.zeros(len(limits)), None)
        h = proto.histogram_proto(
            float(arr.min()) if arr.size else 0.0,
            float(arr.max()) if arr.size else 0.0,
            float(arr.size), float(arr.sum()), float((arr ** 2).sum()),
            limits, counts.tolist())
        s = proto.summary([proto.histo_value(tag, h)])
        self._events.add_event(proto.event(time.time(), step=step, summary_bytes=s))
        return self

    def flush(self):
        self._events.flush()
        return self

    def close(self):
        self._events.close()


_BUCKETS: Optional[List[float]] = None


def _exp_bucket_limits() -> List[float]:
    """Exponential histogram buckets (≙ Summary.scala:144-172): ±1e-12·1.1^k
    out to 1e20, mirrored negative, with 0 between."""
    global _BUCKETS
    if _BUCKETS is None:
        pos = []
        v = 1e-12
        while v < 1e20:
            pos.append(v)
            v *= 1.1
        _BUCKETS = [-x for x in reversed(pos)] + pos
    return _BUCKETS


def read_scalar(log_dir: str, tag: str):
    """Read back (step, wall_time, value) triples for a tag from all event
    files (≙ Summary.readScalar, visualization/Summary.scala:77)."""
    out = []
    if not bt_file.is_remote(log_dir) and not os.path.isdir(log_dir):
        return out
    try:
        names = sorted(bt_file.listdir(log_dir))
    except (FileNotFoundError, NotADirectoryError, OSError):
        return out
    for fname in names:
        if ".tfevents." not in fname:
            continue
        with bt_file.open_file(os.path.join(log_dir, fname), "rb") as f:
            data = f.read()
        for payload in tfrecord.tfrecord_iter(data):
            ev = proto.parse_event(payload)
            for t, v in ev["values"]:
                if t == tag:
                    out.append((ev["step"], ev["wall_time"], v))
    out.sort(key=lambda r: r[0])
    return out
