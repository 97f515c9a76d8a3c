"""Thread-safe concurrent inference (port of
``bigdl_tpu/optim/prediction_service.py``: ``PredictionService``, its
``_MicroBatcher``, the Activity codec and the error tensor).

``num_threads`` bounds the forwards in flight (the reference's pool of
model instances; one module serves every thread here, as one jitted
function does in the JAX package). With ``max_batch``, concurrent
single-sample requests with the same (shape, dtype) signature coalesce
into one stacked forward; ``sample_ndim`` names the rank of such a
request, and a request of another rank (or a Table) runs alone. The JAX
package pads every batch to ``max_batch`` so that XLA compiles one
program; eager PyTorch compiles nothing, so a batch here holds the
requests that arrived, except that a lone request is stacked with a copy
of itself (``optim.evaluator.no_lone_row``, the copy's output dropped):
the model never sees a stack of one, as in JAX.

The bytes protocol is the JAX package's npz codec (keys ``a:0`` for a
bare tensor, ``t:<repr(key)>`` for Table slots, ``allow_pickle=False``),
so bytes written by either package decode in the other. A failure at
any stage returns the error tensor (a unicode scalar naming the stage)
and never raises. Outputs come back as host numpy arrays (bf16 as f32:
numpy has no bf16). ``stats()`` gives the JAX keys (``served``,
``dispatches``, ``mean_batch_occupancy``) from the service's own
counters. Telemetry lands in ``registry`` (the process default unless
given) under ``bdt_serve_*{service=service_name}``: requests, dispatches,
errors, batch occupancy, queue wait, in-flight requests, and the
dispatch time, which a ``serve/dispatch`` span measures; a micro-batched
request's ``batch/enqueue`` / ``batch/dispatch`` / ``batch/error`` events
go to the flight recorder.
"""

from __future__ import annotations

import ast
import io
import itertools
import threading
import time
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.observability.events import (
    default_recorder, next_request_id,
)
from bigdl_tpu_torch.observability import profiler
from bigdl_tpu_torch.observability.instruments import serving_instruments
from bigdl_tpu_torch.observability.tracing import trace
from bigdl_tpu_torch.optim.evaluator import model_device, no_lone_row
from bigdl_tpu_torch.utils.table import Table

#: How long a micro-batcher's drain thread waits with no request (and no
#: profiler capture to host) before it exits; the next request starts it.
DRAIN_IDLE_S = 2.0


def serialize_activity(activity) -> bytes:
    """Activity (array | Table of arrays) -> npz bytes."""
    payload = {}
    if isinstance(activity, Table):
        for k, v in activity.items():
            payload[f"t:{k!r}"] = _host(v)
    else:
        payload["a:0"] = _host(activity)
    buf = io.BytesIO()
    np.savez(buf, **payload)
    return buf.getvalue()


def deserialize_activity(data: bytes):
    """npz bytes -> an array, or a Table for ``t:`` keys. Pickled object
    arrays are refused: serving bytes are untrusted."""
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        keys = list(z.keys())
        if keys == ["a:0"]:
            return z["a:0"]
        out = Table()
        for k in keys:
            if not k.startswith("t:"):
                raise ValueError(f"bad activity key {k!r}")
            out[ast.literal_eval(k[2:])] = z[k]
        return out


def _error_tensor(stage: str, e: Exception) -> np.ndarray:
    """A unicode scalar naming the failure stage and its message, in
    place of an exception raised into the caller."""
    msg = (f"Exception caught during [{stage}]! \n"
           f"The message is {e} \n"
           f"The cause is {e.__cause__}")
    return np.asarray(msg)


def _host(value):
    """A tensor as a host numpy array (bf16 as f32); arrays pass."""
    if torch.is_tensor(value):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.cpu().numpy()
    return np.asarray(value)


def _row(outs, i: int):
    """Row ``i`` of a batched output, a Table's structure kept."""
    if isinstance(outs, Table):
        row = Table()
        for k, v in outs.items():
            row[k] = v[i]
        return row
    return outs[i]


class _MicroBatcher:
    """Coalesce concurrent requests into one ``run_batch(stacked)`` call.

    Requests group by (``key``, shape, dtype). One daemon drain thread
    serves every group: it waits out each group's window (``timeout_ms``
    from the group's first request, or until ``max_batch`` requests are
    in), runs the batches one at a time and hands each request its row
    of the output; a group submitted with a ``key`` runs as
    ``run_batch(stacked, key)``. ``on_batch`` is called with the real
    batch size on the drain thread just before ``run_batch``. The drain
    thread is the loop that launches the device work, so it hosts
    ``observability.profiler`` captures asked for on other threads
    (``hosting`` / ``poll`` between batches and in its waits): a capture
    lasts its seconds and holds the kernels of every batch in its
    window. With nothing queued it is an idle host: it leaves a capture
    to a loop with work, or takes it with its next request. The thread
    starts with the first request and exits after ``DRAIN_IDLE_S`` with
    no request and no capture to host; a capture asked for while no loop
    runs runs on its caller's thread.
    ``submit_timeout_s`` bounds a submitter's wait (None waits forever).
    ``telemetry`` (a ``serving_instruments`` namespace) receives each
    request's queue wait, the batch occupancy, the dispatch count and
    time (a ``serve/dispatch`` span) and the errors; a request submitted
    with a ``request_id`` is tagged in ``recorder`` (``batch/enqueue``,
    ``batch/dispatch``, ``batch/error``)."""

    def __init__(self, run_batch, max_batch: int, timeout_ms: float,
                 on_batch=None, submit_timeout_s=None, telemetry=None,
                 recorder=None, name: str = "batch"):
        self._run = run_batch
        self.max_batch = max_batch
        self.timeout = timeout_ms / 1000.0
        self.submit_timeout_s = submit_timeout_s
        self._lock = threading.Condition()
        # (key, shape, dtype) -> [deadline, [(array, event, slot, t_enq,
        # request_id), ...]]
        self._pending = {}
        self._on_batch = on_batch
        self._telemetry = telemetry
        self._rec = recorder if recorder is not None else default_recorder()
        self.name = name
        self._thread: Optional[threading.Thread] = None
        self._idle = False      # the drain thread has nothing queued

    def submit(self, x, request_id=None, detail=None, key=None):
        """Queue one sample; blocks until its batch lands and returns this
        sample's row of the output. ``detail`` (a dict) receives
        ``t_launch``, the monotonic instant the batch was dispatched."""
        x = np.asarray(x)
        gkey = (key, x.shape, x.dtype.str)
        ev = threading.Event()
        slot = detail if detail is not None else {}
        if request_id is not None:
            # before the request is poppable: batch/dispatch must never
            # precede batch/enqueue in its timeline
            self._rec.record("batch/enqueue", request_id, service=self.name)
        with self._lock:
            now = time.monotonic()
            group = self._pending.setdefault(gkey, [now + self.timeout, []])
            group[1].append((x, ev, slot, now, request_id))
            self._idle = False
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._drain, daemon=True,
                    name=f"{self.name}-drain")
                self._thread.start()
            if len(group[1]) in (1, self.max_batch):
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

    def _rouse(self):
        with self._lock:
            self._lock.notify_all()

    def _take(self, now):
        """(key, batch) of the ready group whose window ends first, or
        None; stragglers past ``max_batch`` get a window of their own.
        Called with the lock held."""
        ready = [(g[0], k) for k, g in self._pending.items()
                 if len(g[1]) >= self.max_batch or g[0] <= now]
        if not ready:
            return None
        gkey = min(ready, key=lambda r: r[0])[1]
        group = self._pending[gkey][1]
        batch, rest = group[:self.max_batch], group[self.max_batch:]
        if rest:
            self._pending[gkey] = [now + self.timeout, rest]
        else:
            del self._pending[gkey]
        return gkey[0], batch

    def _drain(self):
        """Run the batches as their windows end, hosting profiler
        captures meanwhile; exit once idle with nothing to host."""
        try:
            with profiler.hosting(self._rouse, idle=lambda: self._idle):
                idle_since = time.monotonic()
                while True:
                    left = profiler.poll()
                    with self._lock:
                        now = time.monotonic()
                        job = self._take(now)
                        self._idle = job is None and not self._pending
                        if job is None:
                            if self._pending:
                                wait = min(g[0] for g in
                                           self._pending.values()) - now
                            elif left is None and \
                                    now - idle_since >= DRAIN_IDLE_S:
                                self._thread = None
                                return
                            else:
                                wait = DRAIN_IDLE_S - (now - idle_since)
                            if left is not None:
                                wait = min(wait, left)
                            self._lock.wait(timeout=max(wait, 0.0))
                            continue
                    self._launch(*job)
                    idle_since = time.monotonic()
        except BaseException as e:
            # answer every waiting request rather than leave it hanging
            with self._lock:
                groups, self._pending = list(self._pending.values()), {}
            for _, batch in groups:
                for _, ev, slot, _, _ in batch:
                    slot["error"] = RuntimeError(
                        f"the micro-batch drain thread died: {e!r}")
                    ev.set()
            raise
        finally:
            with self._lock:
                if self._thread is threading.current_thread():
                    self._thread = None

    def _launch(self, key, batch):
        tel = self._telemetry
        try:
            if tel is not None:
                now = time.monotonic()
                for b in batch:
                    tel.queue_wait_seconds.observe(now - b[3])
                tel.batch_occupancy.observe(len(batch))
                tel.dispatches_total.inc()
            if self._on_batch is not None:
                self._on_batch(len(batch))
            t0 = time.monotonic()
            for _, _, slot, _, rid in batch:
                slot["t_launch"] = t0
                if rid is not None:
                    self._rec.record("batch/dispatch", rid,
                                     service=self.name,
                                     batch_size=len(batch))
            stacked = no_lone_row(np.stack([b[0] for b in batch]))
            with trace.span("serve/dispatch",
                            histogram=tel.dispatch_seconds
                            if tel is not None else None):
                outs = (self._run(stacked) if key is None
                        else self._run(stacked, key))
            for i, (_, ev, slot, _, _) in enumerate(batch):
                slot["out"] = _row(outs, i)
                ev.set()
        except Exception as e:
            if tel is not None:
                tel.errors_total.inc(len(batch))
            for _, ev, slot, _, rid in batch:
                if rid is not None:
                    self._rec.record("batch/error", rid, service=self.name,
                                     error=type(e).__name__)
                slot["error"] = e
                ev.set()


class PredictionService:
    """Concurrent inference over one model (see the module docstring)."""

    def __init__(self, model: torch.nn.Module, num_threads: int = 4,
                 max_batch: Optional[int] = None,
                 batch_timeout_ms: float = 2.0,
                 sample_ndim: Optional[int] = None,
                 registry=None, service_name: str = "prediction",
                 submit_timeout_s: Optional[float] = None):
        model.evaluate()
        self.model = model
        # requests go to the model's device (the host for a model that
        # holds no tensor)
        self._device = (model_device(model) if any(
            True for _ in itertools.chain(model.parameters(),
                                          model.buffers()))
            else torch.device("cpu"))
        self._sem = threading.Semaphore(num_threads)
        self.num_threads = num_threads
        self.sample_ndim = sample_ndim
        self.service_name = service_name
        self._ins = serving_instruments(service_name, registry)
        self._lock = threading.Lock()
        self._served = 0
        self._dispatches = 0
        self._batcher = (_MicroBatcher(self._run, max_batch,
                                       batch_timeout_ms,
                                       on_batch=self._count,
                                       submit_timeout_s=submit_timeout_s,
                                       telemetry=self._ins,
                                       name=service_name)
                         if max_batch and max_batch > 1 else None)

    def _count(self, n: int) -> None:
        with self._lock:
            self._dispatches += 1
            self._served += n

    def _tensor(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self._device)

    def _run(self, activity):
        """One forward of ``activity`` (an array or a Table of them) on
        the model's device; the output stays there."""
        if isinstance(activity, Table):
            x = Table()
            for k, v in activity.items():
                x[k] = self._tensor(np.asarray(v))
        else:
            x = self._tensor(np.asarray(activity))
        with torch.inference_mode():
            return self.model(x)

    def predict(self, request):
        """Activity in, host Activity out; bytes in, bytes out through
        the codec. Errors return the error tensor."""
        if isinstance(request, (bytes, bytearray)):
            return self._predict_bytes(bytes(request))
        ins = self._ins
        ins.requests_total.inc()
        with ins.inflight.track(), self._sem:
            batchable = False
            try:
                batchable = (self._batcher is not None
                             and not isinstance(request, Table)
                             and (self.sample_ndim is None
                                  or np.asarray(request).ndim
                                  == self.sample_ndim))
                if batchable:
                    # a failure inside the batch is counted by the
                    # micro-batcher's telemetry
                    out = self._batcher.submit(
                        request, request_id=next_request_id("pred"))
                else:
                    self._count(1)
                    ins.dispatches_total.inc()
                    ins.batch_occupancy.observe(1)
                    with trace.span("serve/dispatch",
                                    histogram=ins.dispatch_seconds):
                        out = self._run(request)
            except Exception as e:
                if not batchable:
                    ins.errors_total.inc()
                return _error_tensor("running forward", e)
            try:
                if isinstance(out, Table):
                    host = Table()
                    for k, v in out.items():
                        host[k] = _host(v)
                    return host
                return _host(out)
            except Exception as e:
                ins.errors_total.inc()
                return _error_tensor("Clone Result", e)

    def stats(self) -> dict:
        """Requests served, forwards dispatched and mean requests a
        dispatch since construction (the JAX keys)."""
        with self._lock:
            served, disp = self._served, self._dispatches
        return {"served": served, "dispatches": disp,
                "mean_batch_occupancy": round(served / disp, 3)
                if disp else 0.0}

    def _predict_bytes(self, request: bytes) -> bytes:
        try:
            activity = deserialize_activity(request)
        except Exception as e:
            # the inner predict never runs: count the request here, or a
            # flood of malformed payloads scrapes as an idle service
            self._ins.requests_total.inc()
            self._ins.errors_total.inc()
            return serialize_activity(_error_tensor("DeSerialize Input", e))
        out = self.predict(activity)
        try:
            return serialize_activity(out)
        except Exception as e:
            self._ins.errors_total.inc()
            return serialize_activity(_error_tensor("Serialize Output", e))
