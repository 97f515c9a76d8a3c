"""Micro-batching of concurrent requests (port of ``_MicroBatcher`` from
``bigdl_tpu/optim/prediction_service.py``).

Concurrent single-sample requests with the same (shape, dtype) signature
coalesce into one stacked call of ``run_batch``. The JAX package pads
every batch to ``max_batch`` so that XLA compiles one program; eager
PyTorch compiles nothing, so a batch here holds exactly the requests that
arrived. The flight-recorder and telemetry hooks wait for the
observability slice of the port.
"""

from __future__ import annotations

import threading
import time

import numpy as np


class _MicroBatcher:
    """Coalesce concurrent requests into one ``run_batch(stacked)`` call.

    The first request of a signature starts a daemon drain thread that
    waits up to ``timeout_ms`` for ``max_batch`` requests, then runs the
    batch and hands each request its row of the output. ``on_batch`` is
    called with the real batch size on the drain thread just before
    ``run_batch``. ``submit_timeout_s`` bounds a submitter's wait (None
    waits forever)."""

    def __init__(self, run_batch, max_batch: int, timeout_ms: float,
                 on_batch=None, submit_timeout_s=None):
        self._run = run_batch
        self.max_batch = max_batch
        self.timeout = timeout_ms / 1000.0
        self.submit_timeout_s = submit_timeout_s
        self._lock = threading.Condition()
        self._pending = {}   # signature -> list of (array, event, slot)
        self._on_batch = on_batch

    def submit(self, x):
        """Queue one sample; blocks until its batch lands and returns this
        sample's row of the output."""
        x = np.asarray(x)
        sig = (x.shape, x.dtype.str)
        ev = threading.Event()
        slot = {}
        with self._lock:
            group = self._pending.setdefault(sig, [])
            group.append((x, ev, slot))
            if len(group) == 1:
                # group leader: wait out the window, then run this group
                threading.Thread(target=self._drain, args=(sig,),
                                 daemon=True).start()
            self._lock.notify_all()
        if not ev.wait(self.submit_timeout_s):
            raise RuntimeError(
                f"micro-batch request still unanswered after "
                f"{self.submit_timeout_s}s (batch window "
                f"{self.timeout * 1000:.1f}ms): the drain thread died or "
                "the device dispatch wedged")
        if "error" in slot:
            raise slot["error"]
        return slot["out"]

    def _drain(self, sig):
        deadline = time.monotonic() + self.timeout
        with self._lock:
            while (len(self._pending.get(sig, ())) < self.max_batch
                   and time.monotonic() < deadline):
                self._lock.wait(timeout=max(0.0, deadline - time.monotonic()))
            group = self._pending.get(sig, [])
            batch, rest = group[:self.max_batch], group[self.max_batch:]
            if rest:  # stragglers past the cap get their own leader
                self._pending[sig] = rest
                threading.Thread(target=self._drain, args=(sig,),
                                 daemon=True).start()
            else:
                self._pending.pop(sig, None)
        if self._on_batch is not None:
            self._on_batch(len(batch))
        try:
            outs = self._run(np.stack([b[0] for b in batch]))
            for i, (_, ev, slot) in enumerate(batch):
                slot["out"] = outs[i]
                ev.set()
        except Exception as e:
            for _, ev, slot in batch:
                slot["error"] = e
                ev.set()
