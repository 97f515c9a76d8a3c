"""Out-of-process replicas: one engine per worker process (port of
``bigdl_tpu/serving/fleet/worker.py``).

Each replica is a ``multiprocessing`` *spawn* worker that builds its own
model + ``ContinuousBatchingEngine`` with its own CUDA context (never a
fork: a forked child would inherit the parent's context, which CUDA
forbids; a spawned child re-imports the parent's main script as
``__mp_main__``, so that script's top level must touch no CUDA). The
parent talks to it over one duplex ``Pipe`` with a tiny message
protocol, streaming tokens one-way as they decode — never per-token
request/response:

parent -> worker   ``{op: submit|cancel|healthz|stats|ping|probe|``
                   ``trace_export|metrics_export|incident_export|``
                   ``timeseries_export|drain|resume|stop}``
worker -> parent   ``{ev: ready|accepted|token|done|error|reply|bye}``

``submit`` is answered: the parent's ``WorkerReplica.submit`` returns
once the child's engine has taken the request (``accepted``) and raises
the engine's refusal (``EngineDraining``, ``QueueFull``,
``RequestShed``, ...) itself, as an in-process replica's does. So a
submit that races a drain is refused where the supervisor can re-route
it, instead of failing later on the client's stream. The wait for that
answer is bounded: a child that stops answering control calls while a
submit waits (it is wedged) makes the submit raise
:class:`WorkerRPCTimeout`, which the supervisor re-routes.

Only plain data crosses the pipe: ints, floats, strings, lists, dicts
and numpy arrays. Never a torch tensor — a CUDA tensor pickles as an IPC
handle into the sender's context and a CPU tensor as a shared-memory
file descriptor, so tokens leave the engine as Python ints.

Fleet tracing rides this protocol: ``submit`` carries the front door's
``trace`` id into ``engine.submit(trace_id=...)`` (every child recorder
event then carries it, plus the ``replica=`` context stamped at
startup); ``ping`` answers with the child's monotonic clock for the
supervisor's min-RTT offset estimate (``sync_clock``); ``trace_export``
/ ``metrics_export`` ship the child's flight-recorder events and
registry snapshot back for the merged fleet trace and the
replica-labelled ``/metrics`` aggregation; ``probe`` reports the
child's pid, the top-level modules it imported, its environment for the
config's ``env`` keys and its torch thread count; the ``stats`` reply
adds the child's device memory (``memory``: bytes in use, the peak)
and its count of flash-kernel launches (``flash_launches``).
Control calls that miss their deadline raise :class:`WorkerRPCTimeout`
(counted in ``bdt_fleet_rpc_timeouts_total``) so a wedged child
degrades to auto-drain instead of blocking the supervisor's poll loop.

``WorkerReplica`` implements the supervisor's replica protocol;
``WorkerHandle`` mirrors the ``RequestHandle`` streaming surface
(``tokens()`` / ``result()`` / ``cancel()``) with TTFT stamped on the
PARENT's clock at first-token receipt — monotonic clocks don't agree
across processes, and the router's A/B numbers must be measured where
the client sits.

The worker config is a plain dict (spawn pickles it): ``model`` (the
``TransformerLM`` arguments), ``seed``, ``device`` (default ``"cuda"``;
a worker asked for the card on a machine without one fails ``start()``
with the child's own error and never serves on the CPU), ``dtype``
(``"float32"`` or ``"bfloat16"``), ``engine`` (the engine's keyword
arguments), ``env`` (environment variables, set before the child's
interpreter starts: the parent sets them around ``Process.start()``,
which hands the child a copy of its environment, so they precede the
child's ``import torch``; CPU tests pass ``OMP_NUM_THREADS=1``) and an
optional ``params``: the path of an ``.npz`` of numpy arrays keyed by
the JAX package's tree paths (``block0/attn/qkv/~params/weight``),
loaded with ``utils.weights.load_jax_params``. Without ``params``,
every worker built from the same config draws its weights from
``torch.Generator().manual_seed(seed)``, so same-seed replicas hold
identical parameters — the fleet's token-parity invariant.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from bigdl_tpu_torch.serving.streams import (
    EngineDraining, EngineStopped, QueueFull, RequestCancelled,
    RequestError, RequestRateLimited, RequestShed, RequestTimedOut,
)

__all__ = ["WorkerHandle", "WorkerRPCTimeout", "WorkerReplica",
           "spawn_worker_fleet"]


class WorkerRPCTimeout(EngineStopped):
    """A control round-trip (healthz/stats/ping/...) missed its
    deadline: the child process is alive but not answering — wedged.
    The supervisor counts it and auto-drains the replica."""


_ERRORS = {
    "RequestCancelled": RequestCancelled,
    "RequestTimedOut": RequestTimedOut,
    "RequestError": RequestError,
    "RequestShed": RequestShed,
    "RequestRateLimited": RequestRateLimited,
    "QueueFull": QueueFull,
    "EngineStopped": EngineStopped,
    "EngineDraining": EngineDraining,
}

#: one parent-side environment swap at a time (``WorkerReplica.start``)
_ENV_LOCK = threading.Lock()


def _params_tree(path: str) -> dict:
    """The ``.npz`` of JAX tree paths as the nested ``params_dict()``
    tree ``load_jax_params`` takes."""
    tree: dict = {}
    with np.load(path) as arrays:
        for key in arrays.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = arrays[key]
    return tree


def _build_engine(cfg: dict):
    """The worker's model and engine from its plain-data config."""
    import torch

    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.serving import ContinuousBatchingEngine
    from bigdl_tpu_torch.utils.weights import load_jax_params

    device = cfg.get("device", "cuda")
    dtype = getattr(torch, cfg.get("dtype", "float32"))
    if device == "cuda":
        # f32 replicas compute in f32, as the parent's lone engine does
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model = TransformerLM(**cfg["model"], seed=cfg.get("seed", 7),
                          device=device, dtype=dtype)
    if cfg.get("params"):
        load_jax_params(model, _params_tree(cfg["params"]))
    model.evaluate()
    return ContinuousBatchingEngine(
        model, service_name=cfg.get("service", "worker"),
        **(cfg.get("engine") or {}))


def _memory_block() -> dict:
    """This process's device memory for the ``stats`` reply: bytes in
    use and the peak (summed over its cards; None on the CPU) and the
    engine's registered pool bytes."""
    from bigdl_tpu_torch.observability.memory import default_monitor

    snap = default_monitor().sample()
    peaks = [d["peak_bytes"] for d in snap["devices"]
             if d["peak_bytes"] is not None]
    return {"bytes_in_use": snap["bytes_in_use"],
            "peak_bytes": sum(peaks) if peaks else None,
            "pool_bytes_total": snap["pool_bytes_total"]}


def _worker_main(conn, cfg: dict) -> None:
    """Worker entry point (spawn target — must stay top-level).

    Applies ``cfg["env"]`` (already in this process's environment when
    ``WorkerReplica.start`` spawned it), builds the model + engine,
    acks ``ready``, then serves the op loop until ``stop``/EOF."""
    for k, v in (cfg.get("env") or {}).items():
        os.environ[k] = str(v)

    send_lock = threading.Lock()

    def send(msg: dict) -> None:
        with send_lock:
            try:
                conn.send(msg)
            except (OSError, EOFError, BrokenPipeError):
                pass

    try:
        from bigdl_tpu_torch.observability.events import default_recorder
        from bigdl_tpu_torch.observability.metrics import default_registry
        from bigdl_tpu_torch.observability.postmortem import (
            registry_snapshot,
        )

        # every event this process records carries its replica id —
        # the merged fleet trace's per-process attribution key
        default_recorder().set_context(
            replica=cfg.get("service", "worker"))
        eng = _build_engine(cfg)
        eng.start()
    except Exception as e:
        send({"ev": "ready", "error": repr(e)})
        return
    send({"ev": "ready"})

    handles: Dict[str, object] = {}
    cancelled: set = set()

    def submit_and_pump(rid: str, msg: dict) -> None:
        # runs on its own thread: a blocking put on a full admission
        # queue must never stall the op loop (healthz polls keep
        # answering mid-storm)
        toks: List[int] = []
        try:
            h = eng.submit(
                np.asarray(msg["prompt"], np.int64),
                msg["max_new"], tenant=msg.get("tenant"),
                timeout_s=msg.get("timeout_s"),
                block=msg.get("block", True),
                priority=msg.get("priority", "normal"),
                trace_id=msg.get("trace"))
        except Exception as e:
            send({"ev": "error", "rid": rid,
                  "kind": type(e).__name__, "msg": str(e),
                  "retry_after": getattr(e, "retry_after_s", None),
                  "tokens": []})
            return
        handles[rid] = h
        # the engine holds the request now: the parent's submit returns
        send({"ev": "accepted", "rid": rid})
        if rid in cancelled:  # cancel raced the blocking submit
            cancelled.discard(rid)
            h.cancel()
        try:
            for tok in h.tokens():
                toks.append(int(tok))
                send({"ev": "token", "rid": rid, "tok": int(tok)})
            send({"ev": "done", "rid": rid, "tokens": toks,
                  "timeline": h.timeline()})
        except Exception as e:
            send({"ev": "error", "rid": rid,
                  "kind": type(e).__name__, "msg": str(e),
                  "tokens": toks})
        finally:
            handles.pop(rid, None)

    def probe() -> dict:
        import torch

        return {"pid": os.getpid(),
                "modules": sorted({m.partition(".")[0]
                                   for m in list(sys.modules)}),
                "env": {k: os.environ.get(k)
                        for k in (cfg.get("env") or {})},
                "torch_threads": torch.get_num_threads()}

    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break
        op = msg.get("op")
        if op == "submit":
            threading.Thread(target=submit_and_pump,
                             args=(msg["rid"], msg),
                             daemon=True).start()
        elif op == "cancel":
            h = handles.get(msg["rid"])
            if h is not None:
                h.cancel()
            else:
                cancelled.add(msg["rid"])
        elif op == "ping":
            # the clock-sync fast path: answer with this process's
            # monotonic reading immediately (no engine call) so the
            # parent's min-RTT offset estimate stays tight
            send({"ev": "reply", "seq": msg["seq"],
                  "payload": {"mono": time.monotonic(),
                              "wall": time.time()}})
        elif op in ("healthz", "stats", "trace_export", "probe",
                    "metrics_export", "incident_export",
                    "timeseries_export"):
            try:
                if op == "healthz":
                    payload = eng.healthz()
                elif op == "stats":
                    from bigdl_tpu_torch.ops import flash_attention

                    payload = eng.stats()
                    payload["memory"] = _memory_block()
                    payload["flash_launches"] = flash_attention.launches
                elif op == "probe":
                    payload = probe()
                elif op == "trace_export":
                    # raw monotonic ts_s — the PARENT aligns them
                    # with its ping-estimated clock offset
                    payload = {
                        "service": cfg.get("service", "worker"),
                        "events": default_recorder().snapshot(
                            msg.get("last")),
                    }
                elif op == "incident_export":
                    payload = eng.debug_incidents(msg.get("n"))
                elif op == "timeseries_export":
                    # raw monotonic ts — the PARENT shifts them by
                    # its ping-estimated clock offset when merging
                    payload = eng.debug_timeseries(
                        metric=msg.get("metric"), n=msg.get("n"))
                else:
                    payload = registry_snapshot(default_registry())
                send({"ev": "reply", "seq": msg["seq"],
                      "payload": payload})
            except Exception as e:
                send({"ev": "reply", "seq": msg["seq"],
                      "kind": type(e).__name__, "error": str(e)})
        elif op in ("drain", "resume"):
            getattr(eng, op)()
            send({"ev": "reply", "seq": msg["seq"], "payload": True})
        elif op == "stop":
            try:
                eng.stop(drain=msg.get("drain", True),
                         timeout=msg.get("timeout", 10.0))
            finally:
                send({"ev": "bye"})
            break
    conn.close()


class WorkerHandle:
    """Parent-side view of one streaming request in a worker."""

    def __init__(self, rid: str, replica: "WorkerReplica"):
        self.request_id = rid
        self._replica = replica
        self._q: "queue_mod.Queue" = queue_mod.Queue()
        self.submitted_at = time.monotonic()
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self._tokens: List[int] = []
        self._timeline: Optional[dict] = None
        self._error: Optional[tuple] = None
        self._done_evt = threading.Event()
        #: set once the child's engine took the request or refused it
        self._answered = threading.Event()

    # fed by the replica's reader thread
    def _push(self, msg: dict) -> None:
        ev = msg["ev"]
        if ev == "accepted":
            self._answered.set()
            return
        if ev == "token":
            if self.first_token_at is None:
                self.first_token_at = time.monotonic()
            self._tokens.append(msg["tok"])
        elif ev == "done":
            self._timeline = msg.get("timeline")
            self.finished_at = time.monotonic()
            self._done_evt.set()
        elif ev == "error":
            self._error = (msg.get("kind", "RequestError"),
                           msg.get("msg", ""),
                           msg.get("retry_after"))
            self.finished_at = time.monotonic()
            self._done_evt.set()
            self._answered.set()
        self._q.put(msg)

    def _raise_error(self):
        kind, text, retry = self._error
        cls = _ERRORS.get(kind, RequestError)
        if retry is not None and cls in (RequestShed,
                                         RequestRateLimited):
            # re-raise with the worker engine's bucket-derived backoff
            # intact — the front door turns it into Retry-After
            raise cls(text, retry_after_s=retry)
        raise cls(text)

    def tokens(self):
        """Stream generated token ids as the worker delivers them
        (terminal errors raise after the delivered prefix, matching
        ``RequestHandle.tokens()``)."""
        i = 0
        while True:
            # replay anything already received, then block for more
            if i < len(self._tokens):
                yield self._tokens[i]
                i += 1
                continue
            if self._done_evt.is_set() and self._q.empty():
                if self._error is not None:
                    self._raise_error()
                return
            try:
                self._q.get(timeout=0.1)
            except queue_mod.Empty:
                if not self._replica.alive():
                    self._error = self._error or (
                        "EngineStopped", "worker process died", None)
                    self._done_evt.set()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until terminal; returns the GENERATED token ids (the
        parity row — prompt not included)."""
        if not self._done_evt.wait(timeout):
            raise RequestTimedOut(
                f"no terminal event within {timeout}s")
        if self._error is not None:
            self._raise_error()
        return list(self._tokens)

    def cancel(self) -> None:
        self._replica._send({"op": "cancel", "rid": self.request_id})

    def done(self) -> bool:
        return self._done_evt.is_set()

    def tokens_so_far(self) -> List[int]:
        return list(self._tokens)

    def timeline(self) -> dict:
        """The worker engine's own timeline, augmented with the
        parent-measured TTFT (``client_ttft_s``) — the number the
        fleet comparison reports, since it includes routing + IPC."""
        tl = dict(self._timeline or {})
        if self.first_token_at is not None:
            tl["client_ttft_s"] = self.first_token_at \
                - self.submitted_at
        if self.finished_at is not None:
            tl["client_total_s"] = self.finished_at - self.submitted_at
        return tl


class WorkerReplica:
    """Supervisor replica protocol over one spawn worker process."""

    def __init__(self, rid: str, cfg: dict,
                 start_timeout: float = 120.0,
                 rpc_timeout: float = 10.0):
        self.id = rid
        self._cfg = dict(cfg)
        self._cfg.setdefault("service", rid)
        self._cfg.setdefault("device", "cuda")
        self._start_timeout = start_timeout
        #: control-call deadline (healthz/ping/drain/resume; stats
        #: gets 3x — it renders percentiles). A miss raises
        #: ``WorkerRPCTimeout`` instead of blocking the caller.
        self.rpc_timeout = float(rpc_timeout)
        #: control calls that hit their deadline (the supervisor
        #: mirrors this into ``bdt_fleet_rpc_timeouts_total``)
        self.rpc_timeouts = 0
        #: ping-estimated monotonic-clock offset: add to a child
        #: timestamp to land on THIS process's monotonic timeline
        #: (None until the post-ready handshake syncs it)
        self.clock_offset_s: Optional[float] = None
        #: round trip of the winning ping sample — the offset's
        #: error bound is rtt/2
        self.clock_rtt_s: Optional[float] = None
        #: seconds from the spawn to the child's ``ready``
        self.startup_s: Optional[float] = None
        self._clock_synced_at: Optional[float] = None
        self._proc: Optional[mp.process.BaseProcess] = None
        self._t_launch = self._ready_at = 0.0
        self._up = False
        self._conn = None
        self._reader: Optional[threading.Thread] = None
        self._send_lock = threading.Lock()
        self._reply_lock = threading.Lock()
        self._replies: "queue_mod.Queue" = queue_mod.Queue()
        self._handles: Dict[str, WorkerHandle] = {}
        self._handles_lock = threading.Lock()
        self._seq = 0
        self._next_rid = 0
        self._ready = threading.Event()
        self._ready_error: Optional[str] = None

    # ------------------------------------------------------- lifecycle
    def launch(self) -> None:
        """Spawn the child without waiting for it (``start()`` waits):
        the supervisor launches every worker first, so their imports
        and model builds overlap."""
        if self._proc is not None:
            return
        self._t_launch = time.monotonic()
        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe(duplex=True)
        self._proc = ctx.Process(
            target=_worker_main, args=(child, self._cfg),
            name=f"fleet-{self.id}", daemon=True)
        env = {k: str(v) for k, v in (self._cfg.get("env") or {}).items()}
        with _ENV_LOCK:
            # the spawned interpreter starts with a copy of this
            # environment: set the worker's variables for the start
            # only, so they precede everything the child imports
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                self._proc.start()
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        child.close()
        self._reader = threading.Thread(
            target=self._read_loop, name=f"fleet-{self.id}-reader",
            daemon=True)
        self._reader.start()

    def start(self) -> None:
        if self._up and self.alive():
            return
        if self._proc is None:
            self.launch()
        deadline = self._t_launch + self._start_timeout
        while not self._ready.wait(0.2):
            if not self._proc.is_alive():
                raise EngineStopped(
                    f"worker {self.id} died during startup "
                    f"(exitcode {self._proc.exitcode})")
            if time.monotonic() > deadline:
                raise EngineStopped(
                    f"worker {self.id} did not come up within "
                    f"{self._start_timeout}s")
        if self._ready_error is not None:
            self._proc.join(timeout=10)
            raise EngineStopped(
                f"worker {self.id} failed to start: "
                f"{self._ready_error}")
        self.startup_s = self._ready_at - self._t_launch
        self._up = True
        try:
            # clock-sync handshake: part of coming up, but a failed
            # estimate must not kill an otherwise-healthy worker —
            # the supervisor's poll loop retries it
            self.sync_clock()
        except Exception:
            # graftlint: ok[resource-hygiene] — best-effort first sync; maybe_sync_clock refreshes on the poll loop
            pass

    def alive(self) -> bool:
        return self._proc is not None and self._proc.is_alive()

    def stop(self, timeout: float = 15.0) -> None:
        if self._proc is None:
            return
        try:
            self._send({"op": "stop", "drain": True,
                        "timeout": max(0.0, timeout - 5.0)})
        except Exception:
            # graftlint: ok[resource-hygiene] — best-effort goodbye on a possibly-dead pipe; join below is the real stop
            pass
        self._proc.join(timeout=timeout)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=5)
        self._fail_all("worker stopped")

    # ---------------------------------------------------------- plumbing
    def _send(self, msg: dict) -> None:
        with self._send_lock:
            if self._conn is None:
                raise EngineStopped(f"worker {self.id} not started")
            try:
                self._conn.send(msg)
            except (OSError, EOFError, BrokenPipeError) as e:
                raise EngineStopped(
                    f"worker {self.id} pipe closed") from e

    def _read_loop(self) -> None:
        while True:
            try:
                msg = self._conn.recv()
            except (EOFError, OSError):
                break
            if not self._dispatch(msg):
                break
        self._fail_all("worker pipe closed")

    def _dispatch(self, msg: dict) -> bool:
        """Route one message from the child; False at its ``bye``."""
        ev = msg.get("ev")
        if ev == "ready":
            self._ready_error = msg.get("error")
            self._ready_at = time.monotonic()
            self._ready.set()
        elif ev in ("accepted", "token", "done", "error"):
            with self._handles_lock:
                h = self._handles.get(msg["rid"])
                if ev in ("done", "error"):
                    self._handles.pop(msg["rid"], None)
            if h is not None:
                h._push(msg)
        elif ev == "reply":
            self._replies.put(msg)
        elif ev == "bye":
            return False
        return True

    def _fail_all(self, why: str) -> None:
        with self._handles_lock:
            pending, self._handles = dict(self._handles), {}
        for h in pending.values():
            h._push({"ev": "error", "kind": "EngineStopped",
                     "msg": why})

    def _call(self, op: str, timeout: float = 30.0, **extra):
        """One control round-trip (serialized: one outstanding call)."""
        with self._reply_lock:
            self._seq += 1
            seq = self._seq
            self._send({"op": op, "seq": seq, **extra})
            deadline = time.monotonic() + timeout
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self.rpc_timeouts += 1
                    raise WorkerRPCTimeout(
                        f"worker {self.id}: no {op} reply in "
                        f"{timeout}s (process alive but wedged)")
                try:
                    # graftlint: ok[lock-discipline] — _reply_lock IS the one-outstanding-call serializer; replies arrive from _read_loop, which never takes it
                    msg = self._replies.get(timeout=min(remaining, 0.5))
                except queue_mod.Empty:
                    if not self.alive():
                        raise EngineStopped(
                            f"worker {self.id} process died")
                    continue
                if msg.get("seq") != seq:
                    continue  # stale reply from a timed-out call
                if "error" in msg:
                    raise _ERRORS.get(msg.get("kind", ""),
                                      EngineStopped)(msg["error"])
                return msg.get("payload")

    # ------------------------------------------------ replica protocol
    def submit(self, prompt_ids, max_new_tokens: int,
               tenant: Optional[str] = None,
               timeout_s: Optional[float] = None,
               block: bool = True,
               priority: str = "normal",
               trace_id: Optional[str] = None) -> WorkerHandle:
        if not self.alive():
            raise EngineStopped(f"worker {self.id} process died")
        self._next_rid += 1
        rid = f"{self.id}-{self._next_rid}"
        h = WorkerHandle(rid, self)
        with self._handles_lock:
            self._handles[rid] = h
        prompt = np.asarray(prompt_ids).reshape(-1)
        self._send({"op": "submit", "rid": rid,
                    "prompt": [int(t) for t in prompt],
                    "max_new": int(max_new_tokens), "tenant": tenant,
                    "timeout_s": timeout_s, "block": block,
                    "priority": priority, "trace": trace_id})
        # wait for the child's engine to take or refuse it (a blocking
        # submit on a full queue waits here, as an in-process one
        # does). The wait lasts only while the child answers: a
        # control call that misses its deadline meanwhile (the
        # supervisor's poll, or this wait's own healthz once a full
        # rpc_timeout has passed unanswered) marks it wedged, and the
        # submit raises for the supervisor to re-route
        seen = self.rpc_timeouts
        probe_at = time.monotonic() + self.rpc_timeout
        try:
            while not h._answered.wait(0.2):
                if not self.alive():
                    raise EngineStopped(f"worker {self.id} process died")
                if self.rpc_timeouts != seen:
                    raise WorkerRPCTimeout(
                        f"worker {self.id}: wedged before it answered "
                        f"submit {rid}")
                if time.monotonic() >= probe_at:
                    self.healthz()
                    probe_at = time.monotonic() + self.rpc_timeout
        except EngineStopped:
            with self._handles_lock:
                self._handles.pop(rid, None)
            try:
                # should the child come back, it drops the request
                self._send({"op": "cancel", "rid": rid})
            except EngineStopped:
                pass  # graftlint: ok[resource-hygiene] — a dead pipe has no request left to cancel
            raise
        if h._error is not None and not h._tokens:
            h._raise_error()
        return h

    def healthz(self) -> dict:
        return self._call("healthz", timeout=self.rpc_timeout)

    def stats(self) -> dict:
        return self._call("stats", timeout=3 * self.rpc_timeout)

    def drain(self) -> None:
        self._call("drain", timeout=self.rpc_timeout)

    def resume(self) -> None:
        self._call("resume", timeout=self.rpc_timeout)

    def probe(self) -> dict:
        """The child's pid, the top-level modules it has imported, its
        values of the config's ``env`` keys and its torch thread count
        (the isolation and environment checks read these)."""
        return self._call("probe", timeout=self.rpc_timeout)

    # -------------------------------------------------- fleet tracing
    def sync_clock(self, samples: int = 8) -> float:
        """Ping the worker ``samples`` times and keep the min-RTT
        estimate of its monotonic-clock offset (``clock_offset_s``:
        add to a child timestamp to land on this process's timeline).
        Called once after ready and refreshed from the supervisor's
        poll loop (``maybe_sync_clock``) so drift never accumulates
        into the merged trace."""
        from bigdl_tpu_torch.observability.fleettrace import (
            estimate_clock_offset,
        )

        def ping() -> float:
            return self._call("ping",
                              timeout=self.rpc_timeout)["mono"]

        off, rtt = estimate_clock_offset(ping, samples=samples)
        self.clock_offset_s, self.clock_rtt_s = off, rtt
        self._clock_synced_at = time.monotonic()
        return off

    def maybe_sync_clock(self, max_age_s: float = 30.0,
                         samples: int = 4) -> Optional[float]:
        """Refresh the offset estimate when the last sync is older
        than ``max_age_s`` (the poll loop's periodic refresh); returns
        the current offset (None before any successful sync)."""
        age_ok = (self._clock_synced_at is not None
                  and time.monotonic() - self._clock_synced_at
                  < max_age_s)
        if not age_ok:
            self.sync_clock(samples=samples)
        return self.clock_offset_s

    def trace_export(self, last: Optional[int] = None) -> dict:
        """The worker's flight-recorder snapshot (raw monotonic
        ``ts_s`` — ``merge_fleet_trace`` aligns them with
        ``clock_offset_s``)."""
        return self._call("trace_export",
                          timeout=3 * self.rpc_timeout, last=last)

    def metrics_export(self) -> list:
        """The worker's metric registry as plain data
        (``registry_snapshot`` shape) — the front door renders it
        under a ``replica=`` label on ``/metrics``."""
        return self._call("metrics_export",
                          timeout=3 * self.rpc_timeout)

    def incident_export(self, n: Optional[int] = None) -> dict:
        """The worker engine's ``debug_incidents`` payload (newest-n
        bundles, counts by kind, detector states) — the supervisor
        merges these into ``/debug/fleet/incidents``."""
        return self._call("incident_export",
                          timeout=3 * self.rpc_timeout, n=n)

    def timeseries_export(self, metric: Optional[str] = None,
                          n: Optional[int] = None) -> dict:
        """The worker engine's ``debug_timeseries`` payload (the
        sampler's bounded rings, raw monotonic ``ts``) — the
        supervisor shifts each point by ``clock_offset_s`` when
        merging into ``/debug/fleet/timeseries``."""
        return self._call("timeseries_export",
                          timeout=3 * self.rpc_timeout,
                          metric=metric, n=n)

    @property
    def postmortem_path(self) -> Optional[str]:
        """Where this worker's engine writes its crash postmortem
        (``spawn_worker_fleet`` assigns one per worker) — the
        supervisor collects it on a crash drain."""
        return (self._cfg.get("engine") or {}).get("postmortem_path")


def spawn_worker_fleet(n: int, model: dict, engine: Optional[dict]
                       = None, seed: int = 7,
                       env: Optional[dict] = None,
                       prefix: str = "r",
                       rpc_timeout: float = 10.0,
                       postmortem_dir: Optional[str] = None,
                       device: str = "cuda",
                       dtype: str = "float32",
                       params: Optional[str] = None
                       ) -> List[WorkerReplica]:
    """Build (NOT start) ``n`` same-seed worker replicas — the
    supervisor's ``start()`` brings them up. Same ``model``/``seed``
    (or the same ``params`` file) in every worker means identical
    parameters, so any replica's greedy output is every replica's
    greedy output (the fleet comparison's token-parity invariant).

    Unless the engine config pins ``postmortem_path``, each worker
    gets its own under ``postmortem_dir`` (a fresh temp dir by
    default) so a child crash leaves an artifact the supervisor can
    collect from the parent."""
    import tempfile

    base_engine = dict(engine or {})
    if "postmortem_path" not in base_engine:
        postmortem_dir = postmortem_dir or tempfile.mkdtemp(
            prefix="bdt_fleet_pm_")
    cfg = {"model": dict(model), "seed": seed, "env": dict(env or {}),
           "device": device, "dtype": dtype}
    if params is not None:
        cfg["params"] = params
    fleet = []
    for i in range(n):
        rid = f"{prefix}{i}"
        eng = dict(base_engine)
        if "postmortem_path" not in eng:
            eng["postmortem_path"] = os.path.join(
                postmortem_dir, f"{rid}_postmortem.json")
        fleet.append(WorkerReplica(
            rid, dict(cfg, engine=eng, service=rid),
            rpc_timeout=rpc_timeout))
    return fleet
