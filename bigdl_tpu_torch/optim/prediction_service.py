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
program; eager PyTorch compiles nothing, so a batch here holds exactly
the requests that arrived.

The bytes protocol is the JAX package's npz codec (keys ``a:0`` for a
bare tensor, ``t:<repr(key)>`` for Table slots, ``allow_pickle=False``),
so bytes written by either package decode in the other. A failure at
any stage returns the error tensor (a unicode scalar naming the stage)
and never raises. Outputs come back as host numpy arrays (bf16 as f32:
numpy has no bf16). ``stats()`` gives the JAX keys (``served``,
``dispatches``, ``mean_batch_occupancy``) from the service's own
counters; ``registry`` and ``service_name`` are accepted and unused:
the metric registry, its instruments and the flight recorder wait for
ROADMAP.md, Queue 1 item 11.
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

from bigdl_tpu_torch.optim.evaluator import model_device
from bigdl_tpu_torch.utils.table import Table


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
                slot["out"] = _row(outs, i)
                ev.set()
        except Exception as e:
            for _, ev, slot in batch:
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
        self._lock = threading.Lock()
        self._served = 0
        self._dispatches = 0
        self._batcher = (_MicroBatcher(self._run, max_batch,
                                       batch_timeout_ms,
                                       on_batch=self._count,
                                       submit_timeout_s=submit_timeout_s)
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
        with self._sem:
            try:
                batchable = (self._batcher is not None
                             and not isinstance(request, Table)
                             and (self.sample_ndim is None
                                  or np.asarray(request).ndim
                                  == self.sample_ndim))
                if batchable:
                    out = self._batcher.submit(request)
                else:
                    self._count(1)
                    out = self._run(request)
            except Exception as e:
                return _error_tensor("running forward", e)
            try:
                if isinstance(out, Table):
                    host = Table()
                    for k, v in out.items():
                        host[k] = _host(v)
                    return host
                return _host(out)
            except Exception as e:
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
            return serialize_activity(_error_tensor("DeSerialize Input", e))
        out = self.predict(activity)
        try:
            return serialize_activity(out)
        except Exception as e:
            return serialize_activity(_error_tensor("Serialize Output", e))
