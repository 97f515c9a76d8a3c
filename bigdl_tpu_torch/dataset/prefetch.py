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
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch


class _Stop:
    pass


_STOP = _Stop()


def prefetch(iterator: Iterator, buffer_size: int = 2,
             transfer: Optional[Callable] = None) -> Iterator:
    """Wrap ``iterator`` with a background thread and a queue of
    ``buffer_size`` items; ``transfer`` runs on that thread. An exception
    in the producer is raised again at the consumer. Closing the returned
    generator (or dropping it) stops the thread and drops what it
    buffered."""
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
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass

    return consume()


def to_device(value, device: torch.device):
    """A numpy array (or tensor) as a tensor on ``device``: through pinned
    memory and a non-blocking copy for a CUDA device."""
    t = torch.as_tensor(np.ascontiguousarray(value)
                        if isinstance(value, np.ndarray) else value)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    else:
        t = t.to(device)
    return t

