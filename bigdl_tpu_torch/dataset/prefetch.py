"""Background prefetch: overlap the input pipeline with the device step
(port of ``bigdl_tpu/dataset/prefetch.py``).

:func:`prefetch` runs the host-side pipeline (batching, stacking) and a
``transfer`` function on a background thread, a bounded queue ahead of
the consumer. :func:`to_device` is the transfer the training loop gives
it: each numpy array is staged in pinned host memory and copied with
``non_blocking=True`` on the current stream, so the host thread queues
the copy and moves on, and the step that reads the batch runs after it
on the same stream. Pinned blocks go back to PyTorch's caching host
allocator, which holds them until their copy has finished.
:func:`device_prefetch` joins the two for a stream of batches.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn.sparse import SparseMiniBatch, SparseTensor
from bigdl_tpu_torch.utils.table import Table


class _Stop:
    pass


_STOP = _Stop()


def prefetch(iterator: Iterator, buffer_size: int = 2,
             transfer: Optional[Callable] = None) -> Iterator:
    """Wrap ``iterator`` with a background thread and a queue of
    ``buffer_size`` items; ``transfer`` runs on that thread. An exception
    in the producer is raised again at the consumer. Closing the returned
    generator (or dropping it) stops the thread and drops what it
    buffered, and joins the thread: a producer left running at
    interpreter exit can be torn down in the middle of a library call."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, buffer_size))
    err = []
    stop = threading.Event()

    def _put(item) -> bool:
        """Bounded put that gives up once the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in iterator:
                if transfer is not None:
                    item = transfer(item)
                if not _put(item):
                    return
        except BaseException as e:  # raised again at the consumer
            err.append(e)
        finally:
            _put(_STOP)

    t = threading.Thread(target=produce, daemon=True, name="bigdl-prefetch")
    t.start()

    def consume():
        try:
            while True:
                item = q.get()
                if item is _STOP:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()
            # the producer gives up at its next put (within 0.1 s) or when
            # its current item is done; draining unblocks a waiting put. A
            # source blocked for good is left behind after 30 s
            deadline = time.monotonic() + 30.0
            while t.is_alive() and time.monotonic() < deadline:
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.1)

    return consume()


def to_device(value, device: torch.device):
    """A numpy array (or tensor) as a tensor on ``device``: through pinned
    memory and a non-blocking copy for a CUDA device. A ``SparseTensor``
    moves its indices and values so."""
    if isinstance(value, SparseTensor):
        return SparseTensor(to_device(value.indices, device),
                            to_device(value.values, device), value.shape)
    t = torch.as_tensor(np.ascontiguousarray(value)
                        if isinstance(value, np.ndarray) else value)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    else:
        t = t.to(device)
    return t


def device_prefetch(batch_iterator: Iterator, sharding=None,
                    buffer_size: int = 2, device=DEFAULT_DEVICE) -> Iterator:
    """Batches (``MiniBatch``es, ``SparseMiniBatch``es, arrays, or lists /
    tuples / dicts / Tables of arrays) staged onto ``device`` by :func:`to_device` on a prefetch
    thread, ``buffer_size`` ahead. ``sharding`` (the JAX placement of the
    batch dimension over a mesh) names the process group, or the axis of
    the default mesh, that the global batch is split over: each rank
    stages only its own contiguous shard of every array's leading
    dimension, which the group's size must divide."""
    from bigdl_tpu_torch.dataset.minibatch import MiniBatch

    dev = resolve_device(device)
    shard = _sharder(sharding) if sharding is not None else (lambda x: x)

    def put(x):
        if isinstance(x, Table):
            return Table(*[put(v) for v in x.values()])
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        return to_device(shard(x), dev)

    def transfer(b):
        if isinstance(b, MiniBatch):
            return MiniBatch([put(x) for x in b.inputs],
                             [put(t) for t in b.targets] or None)
        if isinstance(b, SparseMiniBatch):
            return SparseMiniBatch([put(x) for x in b.features],
                                   None if b.labels is None
                                   else put(b.labels))
        return put(b)

    return prefetch(batch_iterator, buffer_size=buffer_size,
                    transfer=transfer)


def _sharder(sharding):
    """The function that cuts this rank's rows out of a batch array for
    ``device_prefetch(sharding=)``: ``sharding`` is a process group, or
    an axis name (or tuple of names) of ``Engine.default_mesh()``."""
    from bigdl_tpu_torch.parallel import collectives as C

    n, r = C.group_size(sharding), C.group_rank(sharding)

    def cut(x):
        rows = len(x)
        if rows % n:
            raise ValueError(f"batch of {rows} rows does not split over "
                             f"the {n} ranks of the sharding")
        per = rows // n
        return x[r * per:(r + 1) * per]

    return cut
