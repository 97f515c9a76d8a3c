"""Replica ownership, health-aware draining, and fleet routing (port of
``bigdl_tpu/serving/fleet/supervisor.py``).

``ReplicaSupervisor`` is the fleet's control plane: it owns N replicas
(in-process ``InProcessReplica`` wrappers for tests and demos,
``multiprocessing`` ``WorkerReplica`` spawn workers, each with its own
CUDA context — anything
with the small replica protocol below), polls each one's ``healthz()``
+ load gauges on a background thread, and folds the results into the
``PrefixAffinityRouter``'s live set:

- a replica whose ``healthz()`` reports ``status: degraded`` (active
  watchdog alerts) or raises (the crashed-loop 503) is
  **drained**: ``replica.drain()`` stops new admissions, the router
  stops offering it traffic, and every request already in flight runs
  to completion;
- a drained replica whose probe comes back clean **rejoins**:
  ``replica.resume()`` + back into the ring. Operator drains
  (``supervisor.drain(rid)``) never auto-rejoin.

``submit()`` is the data plane: route (affinity or round-robin),
hand the prompt to the chosen replica, and re-route once if the
replica refuses in the drain/stop race window. Every decision lands in
the ``bdt_fleet_*`` instruments.

Replica protocol (duck-typed): ``id``, ``submit(prompt_ids,
max_new_tokens, tenant=, timeout_s=, block=) -> handle``, ``stats()``,
``healthz()`` (raising = crashed), ``drain()``, ``resume()``,
``start()``, ``stop()``.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

from bigdl_tpu_torch.observability.capacity import (
    aggregate_fleet_capacity,
)
from bigdl_tpu_torch.observability.events import default_recorder
from bigdl_tpu_torch.observability.fleettrace import (
    merge_request_timelines,
)
from bigdl_tpu_torch.observability.instruments import fleet_instruments
from bigdl_tpu_torch.observability.timeseries import (
    merge_fleet_timeseries, render_fleet_dashboard,
)
from bigdl_tpu_torch.serving.fleet.router import (
    NoLiveReplicas, PrefixAffinityRouter,
)
from bigdl_tpu_torch.serving.fleet.worker import WorkerRPCTimeout
from bigdl_tpu_torch.serving.streams import EngineDraining, EngineStopped

__all__ = ["InProcessReplica", "ReplicaSupervisor", "Routed"]

#: drain reasons the poll loop may lift again once the probe is clean
#: (rpc_timeout: the wedged child answered again)
_AUTO_REASONS = ("degraded", "crashed", "rpc_timeout")


class Routed(NamedTuple):
    """One accepted fleet submission: the replica's request handle plus
    where it landed and why (``route`` is ``affinity`` / ``spilled`` /
    ``round_robin``). ``trace_id`` is the request's distributed-trace
    id; ``route_s`` / ``rpc_submit_s`` are the supervisor-measured
    first two fleet hops (routing decision wall, replica ``submit()``
    call wall — summed across any re-route retries), which the front
    door folds into the ``bdt_fleet_hop_seconds`` breakdown."""

    handle: object
    replica: str
    route: str
    trace_id: Optional[str] = None
    route_s: float = 0.0
    rpc_submit_s: float = 0.0


class InProcessReplica:
    """One ``ContinuousBatchingEngine`` behind the replica protocol —
    the in-process deployment used by tests and the ``serve.py`` demo
    (every replica shares this process's card; a ``WorkerReplica``
    gives each its own process and CUDA context)."""

    def __init__(self, rid: str, engine):
        self.id = rid
        self.engine = engine

    def submit(self, prompt_ids, max_new_tokens: int,
               tenant: Optional[str] = None,
               timeout_s: Optional[float] = None, block: bool = True,
               priority: str = "normal",
               trace_id: Optional[str] = None):
        return self.engine.submit(prompt_ids, max_new_tokens,
                                  timeout_s=timeout_s, block=block,
                                  tenant=tenant, priority=priority,
                                  trace_id=trace_id)

    def stats(self) -> dict:
        return self.engine.stats()

    def healthz(self) -> dict:
        return self.engine.healthz()

    def drain(self) -> None:
        self.engine.drain()

    def resume(self) -> None:
        self.engine.resume()

    def start(self) -> None:
        self.engine.start()

    def stop(self) -> None:
        self.engine.stop()

    def incident_export(self, n: Optional[int] = None) -> dict:
        """The engine's ``debug_incidents`` payload — same shape as
        the worker RPC, so the supervisor's fleet merge treats both
        deployments identically."""
        return self.engine.debug_incidents(n)

    def timeseries_export(self, metric: Optional[str] = None,
                          n: Optional[int] = None) -> dict:
        """The engine's ``debug_timeseries`` payload — same shape as
        the worker RPC (an in-process replica shares the parent's
        clock, so its offset is zero by construction)."""
        return self.engine.debug_timeseries(metric=metric, n=n)


class ReplicaSupervisor:
    """Own replicas, poll health, drain/rejoin, route submissions.

    ``policy`` is ``"affinity"`` (default — the prefix-affinity ring)
    or ``"round_robin"`` (the fleet comparison's control leg). ``saturation``
    and ``spill_window`` pass through to the router; ``chunk`` should
    match the engines' ``prefill_chunk``. ``poll_interval`` paces the
    health thread; ``start()`` runs one synchronous poll before
    returning so routing never begins blind.
    """

    def __init__(self, replicas, *, policy: str = "affinity",
                 chunk: int = 16, vnodes: int = 64,
                 saturation: float = 8.0, spill_window: int = 8,
                 poll_interval: float = 0.25,
                 clock_resync_s: float = 30.0,
                 fleet_name: str = "fleet", registry=None,
                 recorder=None):
        if policy not in ("affinity", "round_robin"):
            raise ValueError(f"unknown routing policy {policy!r}")
        self.policy = policy
        self.fleet_name = fleet_name
        self.poll_interval = float(poll_interval)
        self._replicas: Dict[str, object] = {r.id: r for r in replicas}
        if not self._replicas:
            raise ValueError("a fleet needs at least one replica")
        self.router = PrefixAffinityRouter(
            self._replicas, chunk=chunk, vnodes=vnodes,
            saturation=saturation, spill_window=spill_window)
        self._ins = fleet_instruments(fleet_name, registry=registry)
        self._rec = recorder if recorder is not None \
            else default_recorder()
        self._lock = threading.RLock()
        self._loads: Dict[str, float] = {}
        self._health: Dict[str, dict] = {}
        self._drained: Dict[str, str] = {}   # rid -> reason
        self._rr_next = 0
        #: how stale a worker's ping-estimated clock offset may get
        #: before the poll loop re-syncs it (drift guard for the
        #: merged fleet trace)
        self.clock_resync_s = float(clock_resync_s)
        # finished-request hop breakdowns, newest last (the
        # /debug/fleet/requests ring)
        self._requests: "collections.deque" = collections.deque(
            maxlen=256)
        # rid -> collected crash-postmortem summary (path + error)
        self._postmortems: Dict[str, dict] = {}
        # rid -> monotonic deadline before which a wedged replica is
        # NOT re-probed (each probe of a wedged child costs a full
        # rpc_timeout — without backoff the poll loop would spend all
        # its wall blocked on the one stuck pipe)
        self._wedged_until: Dict[str, float] = {}
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started = False

    # ------------------------------------------------------- lifecycle
    def start(self) -> "ReplicaSupervisor":
        if self._started:
            return self
        for r in self._replicas.values():
            # spawn workers first, so their start-ups overlap
            if hasattr(r, "launch"):
                r.launch()
        for r in self._replicas.values():
            r.start()
        self._started = True
        self.poll_once()
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._poll_loop, name="fleet-supervisor",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        for r in self._replicas.values():
            try:
                r.stop()
            except Exception:
                # graftlint: ok[resource-hygiene] — best-effort fan-out stop; one dead replica must not block the rest
                pass
        self._started = False

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ---------------------------------------------------- health plane
    def _poll_loop(self) -> None:
        while not self._stop_evt.wait(self.poll_interval):
            try:
                self.poll_once()
            except Exception:
                # graftlint: ok[resource-hygiene] — a poll crash must not kill supervision; the next tick retries
                pass

    def poll_once(self) -> Dict[str, dict]:
        """One synchronous health sweep: probe every replica, refresh
        the router's load map and the ``bdt_fleet_*`` gauges, drain
        what degraded/crashed, rejoin what recovered. Returns the
        per-replica probe results (exception reprs for crashed ones)."""
        results: Dict[str, dict] = {}
        for rid, rep in list(self._replicas.items()):
            until = self._wedged_until.get(rid)
            if until is not None and time.monotonic() < until:
                results[rid] = {"status": "wedged", "backoff": True}
                continue
            try:
                hz = rep.healthz()
                results[rid] = hz
                self._wedged_until.pop(rid, None)
            except WorkerRPCTimeout as e:
                # alive but not answering: the wedged-child path —
                # count it and degrade to auto-drain instead of
                # letting the next poll block on it again
                self._ins.rpc_timeouts_total.labels(
                    self.fleet_name, rid).inc()
                self._wedged_until[rid] = time.monotonic() \
                    + 2 * getattr(rep, "rpc_timeout", 10.0)
                results[rid] = {"status": "wedged", "error": repr(e)}
                with self._lock:
                    self._health[rid] = results[rid]
                    self._loads.pop(rid, None)
                if self._drained.get(rid) is None:
                    self.drain(rid, reason="rpc_timeout")
                continue
            except Exception as e:
                results[rid] = {"status": "crashed", "error": repr(e)}
                with self._lock:
                    self._health[rid] = results[rid]
                    self._loads.pop(rid, None)
                if self._drained.get(rid) is None:
                    self.drain(rid, reason="crashed")
                continue
            load = float(hz.get("queue_depth", 0)
                         + hz.get("active_slots", 0))
            with self._lock:
                self._health[rid] = hz
                self._loads[rid] = load
            if hasattr(rep, "maybe_sync_clock"):
                try:
                    off = rep.maybe_sync_clock(self.clock_resync_s)
                    if off is not None:
                        self._ins.clock_offset_seconds.labels(
                            self.fleet_name, rid).set(off)
                except Exception:
                    # graftlint: ok[resource-hygiene] — a failed resync keeps the last estimate; the next poll retries
                    pass
            self._ins.replica_queue_depth.labels(
                self.fleet_name, rid).set(hz.get("queue_depth", 0))
            self._ins.replica_active_slots.labels(
                self.fleet_name, rid).set(hz.get("active_slots", 0))
            reason = self._drained.get(rid)
            if hz.get("status") == "degraded" and reason is None:
                self.drain(rid, reason="degraded")
            elif reason in _AUTO_REASONS \
                    and hz.get("status") == "ok":
                self.rejoin(rid)
        live = self.router.live_replicas()
        self._ins.replicas_live.set(len(live))
        self._ins.replicas_draining.set(
            len(self._replicas) - len(live))
        return results

    def drain(self, rid: str, reason: str = "operator") -> None:
        """Take ``rid`` out of rotation: the router routes new traffic
        away and the replica refuses new admissions while its in-flight
        requests finish. Recovered auto-drains rejoin on a clean poll;
        operator drains wait for ``rejoin()``."""
        with self._lock:
            if rid not in self._replicas:
                raise KeyError(f"unknown replica {rid!r}")
            already = rid in self._drained
            self._drained[rid] = reason
        self.router.mark_draining(rid)
        try:
            self._replicas[rid].drain()
        except Exception:
            pass  # graftlint: ok[resource-hygiene] — a crashed replica can't ack the drain; it's marked draining either way
        if not already:
            self._ins.drains_total.labels(
                self.fleet_name, reason).inc()
            pm = (self._collect_postmortem(rid)
                  if reason in ("crashed", "rpc_timeout") else None)
            extra = {"postmortem": pm["path"],
                     "postmortem_error": (pm.get("error") or {}
                                          ).get("type")} \
                if pm else {}
            self._rec.record("fleet/drain", rid, fleet=self.fleet_name,
                             replica=rid, reason=reason, **extra)

    def _collect_postmortem(self, rid: str) -> Optional[dict]:
        """Read the crashed worker's postmortem artifact (if its
        engine wrote one) into a parent-side summary — path, error
        type/message, event count — so the child's crash is
        diagnosable from the fleet ``stats()`` without shelling into
        the worker's filesystem view. Best-effort: a missing or torn
        file just means no summary."""
        with self._lock:
            rep = self._replicas.get(rid)
        path = getattr(rep, "postmortem_path", None)
        if not path or not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                pm = json.load(f)
        except (OSError, ValueError):
            return None
        err = pm.get("error") or {}
        summary = {
            "path": path,
            "schema": pm.get("schema"),
            "created_at": pm.get("created_at"),
            "error": {"type": err.get("type"),
                      "message": err.get("message")},
            "events": len(pm.get("events") or []),
            "requests": len(pm.get("requests") or []),
        }
        with self._lock:
            self._postmortems[rid] = summary
        return summary

    def rejoin(self, rid: str) -> None:
        """Return a drained replica to rotation (``resume()`` + back
        into the ring)."""
        with self._lock:
            if rid not in self._replicas:
                raise KeyError(f"unknown replica {rid!r}")
            was = self._drained.pop(rid, None)
        try:
            self._replicas[rid].resume()
        except Exception:
            # graftlint: ok[resource-hygiene] — a dead replica can't ack the resume; health polling re-drains it
            pass
        self.router.mark_live(rid)
        if was is not None:
            self._ins.rejoins_total.inc()
            self._rec.record("fleet/rejoin", rid, fleet=self.fleet_name,
                             replica=rid, was=was)

    # ------------------------------------------------------ data plane
    def submit(self, prompt_ids, max_new_tokens: int,
               tenant: Optional[str] = None,
               priority: str = "normal",
               timeout_s: Optional[float] = None,
               trace_id: Optional[str] = None) -> Routed:
        """Route one request and submit it. ``priority`` reaches the
        replica engine's admission queue (class-ordered pop,
        preemption eligibility, shed order — see the engine's QoS
        docs) and also maps to the backpressure stance here:
        ``"low"`` never blocks on a full replica queue (``QueueFull``
        propagates to the caller — the front door turns it into 429),
        everything else waits. An engine-side ``RequestShed`` /
        ``RequestRateLimited`` rejection propagates unchanged (the
        front door's 429 + Retry-After). The chosen replica refusing
        (drain/stop race with the poll thread) re-routes once per
        remaining live replica before giving up.

        ``trace_id`` (the front door's minted/forwarded id) is passed
        through to the replica — worker replicas carry it over the
        pipe into the child ``engine.submit`` so the whole
        cross-process arc shares one id. The returned ``Routed``
        carries the measured ``route_s`` / ``rpc_submit_s`` hops."""
        block = priority != "low"
        tried: set = set()
        kwargs = {} if trace_id is None else {"trace_id": trace_id}
        route_s = rpc_submit_s = 0.0
        while True:
            t0 = time.monotonic()
            rid, route = self._pick(prompt_ids, tried)
            t1 = time.monotonic()
            route_s += t1 - t0
            try:
                h = self._replicas[rid].submit(
                    prompt_ids, max_new_tokens, tenant=tenant,
                    timeout_s=timeout_s, block=block,
                    priority=priority, **kwargs)
            except (EngineDraining, EngineStopped):
                rpc_submit_s += time.monotonic() - t1
                tried.add(rid)
                self._ins.rerouted_total.inc()
                if len(tried) >= len(self._replicas):
                    raise
                continue
            rpc_submit_s += time.monotonic() - t1
            self._ins.requests_total.inc()
            self._ins.routed_total.labels(self.fleet_name, route).inc()
            req_id = getattr(h, "request_id", None)
            if trace_id is not None and req_id is not None:
                # the front-door process's side of the request carries
                # the trace too — its fleet/* events join the child's
                # arc in the merged trace
                self._rec.bind_request(req_id, trace=trace_id,
                                       replica=rid)
            self._rec.record("fleet/submitted", req_id,
                             fleet=self.fleet_name, replica=rid,
                             route=route)
            return Routed(h, rid, route, trace_id, route_s,
                          rpc_submit_s)

    def _pick(self, prompt_ids, tried) -> tuple:
        with self._lock:
            loads = dict(self._loads)
        live = [r for r in self.router.live_replicas()
                if r not in tried]
        if not live:
            raise NoLiveReplicas(
                "no live replica can take the request "
                f"(draining: {self.router.draining})")
        if self.policy == "round_robin":
            with self._lock:
                rid = live[self._rr_next % len(live)]
                self._rr_next += 1
            return rid, "round_robin"
        if tried:
            # re-route: hash owner already refused — go least-loaded
            rid = min(live, key=lambda r: (loads.get(r) or 0.0, r))
            return rid, "spilled"
        d = self.router.route(prompt_ids, loads)
        return d.replica, d.route

    # --------------------------------------------------- fleet tracing
    def note_request(self, routed: Routed, hops: Dict[str, float],
                     total_s: float, outcome: str = "finished"
                     ) -> dict:
        """Record one completed request's hop decomposition: observe
        every ``bdt_fleet_hop_seconds`` component, append the entry
        to the ``/debug/fleet/requests`` ring, and close the front-
        door process's side of the trace with a ``fleet/request_done``
        event. Called by the front door once the stream is fully
        written — ``total_s`` is the client-observed wall."""
        for hop, s in hops.items():
            self._ins.hop_seconds.labels(self.fleet_name,
                                         hop).observe(s)
        entry = {
            "request_id": getattr(routed.handle, "request_id", None),
            "trace_id": routed.trace_id,
            "replica": routed.replica,
            "route": routed.route,
            "outcome": outcome,
            "hops": {k: round(v, 6) for k, v in hops.items()},
            "hop_sum_s": round(sum(hops.values()), 6),
            "total_s": round(float(total_s), 6),
            "ts_s": time.monotonic(),
        }
        with self._lock:
            self._requests.append(entry)
        self._rec.record("fleet/request_done", entry["request_id"],
                         fleet=self.fleet_name,
                         replica=routed.replica, outcome=outcome,
                         total_s=round(float(total_s), 6))
        return entry

    def trace_exports(self, last: Optional[int] = None) -> List[dict]:
        """Per-process event exports for the fleet trace merge: the
        front-door process's own recorder (offset 0 — it IS the
        reference clock; in-process replicas share it) plus every
        worker replica's ``trace_export`` RPC, each tagged with its
        ping-estimated ``clock_offset_s``. Feed to
        ``merge_fleet_trace`` with ``wall_offset=self.wall_offset``."""
        exports: List[dict] = [{
            "process": "front-door",
            "pid": os.getpid(),
            "clock_offset_s": 0.0,
            "events": self._rec.snapshot(last),
        }]
        with self._lock:
            replicas = list(self._replicas.items())
        for rid, rep in replicas:
            export_fn = getattr(rep, "trace_export", None)
            if export_fn is None:
                continue
            try:
                payload = export_fn(last)
            except Exception as e:
                exports.append({"process": rid, "error": repr(e),
                                "events": [], "clock_offset_s": 0.0})
                continue
            exports.append({
                "process": rid,
                "clock_offset_s": getattr(rep, "clock_offset_s",
                                          None) or 0.0,
                "clock_rtt_s": getattr(rep, "clock_rtt_s", None),
                "events": payload.get("events") or [],
            })
        return exports

    @property
    def wall_offset(self) -> float:
        """The reference (front-door) monotonic→wall anchor the
        merged trace's microsecond axis uses."""
        return self._rec.wall_offset

    def fleet_requests(self, last: Optional[int] = None) -> dict:
        """The ``/debug/fleet/requests`` aggregate: the finished-
        request hop ring plus every request's per-process timeline
        joined across the fleet's trace exports (aligned first/last
        timestamps, event-kind sequences, trace ids)."""
        with self._lock:
            ring = list(self._requests)
        return {
            "fleet": self.fleet_name,
            "requests": ring,
            "timelines": merge_request_timelines(
                self.trace_exports(last)),
        }

    def metrics_snapshots(self) -> Dict[str, list]:
        """Every worker replica's registry as plain data (the
        ``metrics_export`` RPC) — the front door renders them under a
        ``replica=`` label on ``/metrics``. In-process replicas share
        the parent registry and are skipped."""
        out: Dict[str, list] = {}
        with self._lock:
            replicas = list(self._replicas.items())
        for rid, rep in replicas:
            metrics_fn = getattr(rep, "metrics_export", None)
            if metrics_fn is None:
                continue
            try:
                out[rid] = metrics_fn()
            except Exception:
                # graftlint: ok[resource-hygiene] — a dead/wedged replica just drops out of this scrape
                continue
        return out

    def incident_exports(self, n: Optional[int] = None
                         ) -> Dict[str, dict]:
        """Every replica's ``incident_export`` payload keyed by
        replica id (duck-typed, best-effort like
        ``metrics_snapshots`` — a replica without the method or with
        a dead pipe just drops out)."""
        out: Dict[str, dict] = {}
        with self._lock:
            replicas = list(self._replicas.items())
        for rid, rep in replicas:
            export_fn = getattr(rep, "incident_export", None)
            if export_fn is None:
                continue
            try:
                out[rid] = export_fn(n)
            except Exception as e:
                out[rid] = {"error": repr(e), "incidents": []}
        return out

    def fleet_incidents(self, n: Optional[int] = None) -> dict:
        """The ``/debug/fleet/incidents`` aggregate: every replica's
        bundles stamped with their replica id, fleet-wide counts by
        kind, detector states per replica, and the set of trace ids
        the bundles' exemplars reference — each resolvable in the
        merged fleet trace (``/debug/fleet/requests`` timelines)."""
        per = self.incident_exports(n)
        incidents: List[dict] = []
        by_kind: Dict[str, int] = {}
        detectors: Dict[str, dict] = {}
        trace_ids: set = set()
        for rid, payload in sorted(per.items()):
            if payload.get("error"):
                continue
            detectors[rid] = payload.get("detectors") or {}
            for kind, c in (payload.get("by_kind") or {}).items():
                by_kind[kind] = by_kind.get(kind, 0) + int(c)
            for bundle in payload.get("incidents") or []:
                stamped = dict(bundle)
                stamped["replica"] = rid
                incidents.append(stamped)
                for ex in bundle.get("exemplars") or []:
                    tid = ex.get("trace_id")
                    if tid:
                        trace_ids.add(tid)
        incidents.sort(key=lambda b: b.get("ts_s") or 0.0,
                       reverse=True)
        return {
            "fleet": self.fleet_name,
            "count": sum(by_kind.values()),
            "by_kind": by_kind,
            "detectors": detectors,
            "trace_ids": sorted(trace_ids),
            "incidents": incidents,
            "replicas": {rid: {"count": p.get("count", 0),
                               "error": p.get("error")}
                         for rid, p in sorted(per.items())},
        }

    def timeseries_exports(self, metric: Optional[str] = None,
                           n: Optional[int] = None) -> List[dict]:
        """Every replica's ``timeseries_export`` payload tagged with
        its ping-estimated clock offset — the
        ``merge_fleet_timeseries`` input (duck-typed, best-effort
        like ``incident_exports``; a replica without the method or
        with a dead pipe carries an ``error`` entry instead)."""
        exports: List[dict] = []
        with self._lock:
            replicas = list(self._replicas.items())
        for rid, rep in replicas:
            export_fn = getattr(rep, "timeseries_export", None)
            if export_fn is None:
                continue
            try:
                payload = export_fn(metric=metric, n=n)
            except Exception as e:
                exports.append({"replica": rid, "error": repr(e)})
                continue
            exports.append({
                "replica": rid,
                "clock_offset_s": getattr(rep, "clock_offset_s",
                                          None) or 0.0,
                "clock_rtt_s": getattr(rep, "clock_rtt_s", None),
                "export": payload,
            })
        return exports

    def fleet_timeseries(self, metric: Optional[str] = None,
                         n: Optional[int] = None) -> dict:
        """The ``/debug/fleet/timeseries`` aggregate: every replica's
        sampler rings merged onto the supervisor's clock (each
        point shifted by that replica's measured offset), keyed
        ``metric -> replica -> ring``, with fleet-sum/mean derived
        series."""
        return merge_fleet_timeseries(
            self.timeseries_exports(metric=metric, n=n),
            fleet=self.fleet_name)

    def fleet_capacity(self, offered_rps: Optional[float] = None
                       ) -> dict:
        """The ``/debug/fleet/capacity`` aggregate: every replica's
        ``stats()["capacity"]`` estimate folded into the fleet view
        (summed sustainable rates, fleet headroom, replicas-needed
        for the observed — or an explicit what-if — offered load),
        exported as the ``bdt_fleet_capacity_{headroom,
        replicas_needed}`` gauges."""
        per: Dict[str, Optional[dict]] = {}
        budgets: Dict[str, dict] = {}
        with self._lock:
            replicas = list(self._replicas.items())
        for rid, rep in replicas:
            try:
                s = rep.stats()
            except Exception:
                per[rid] = None
                continue
            per[rid] = s.get("capacity")
            if s.get("slo_budget"):
                budgets[rid] = s["slo_budget"]
        out = aggregate_fleet_capacity(per, offered_rps=offered_rps,
                                       fleet=self.fleet_name)
        out["slo_budget"] = budgets
        if out.get("headroom") is not None:
            self._ins.capacity_headroom.set(out["headroom"])
        if out.get("replicas_needed") is not None:
            self._ins.capacity_replicas_needed.set(
                out["replicas_needed"])
        return out

    def fleet_markers(self, n: Optional[int] = None) -> List[dict]:
        """Clock-aligned event markers for the fleet dashboard:
        drain/rejoin events from the front-door recorder (offset 0 —
        it IS the reference clock) plus every replica's captured
        incidents shifted by that replica's offset."""
        markers = []
        for ev in self._rec.snapshot():
            kind = ev.get("kind") or ""
            if kind == "fleet/drain":
                markers.append({"ts_s": ev.get("ts_s"),
                                "kind": "drain",
                                "label": "drain %s"
                                % (ev.get("request_id") or "")})
            elif kind == "fleet/rejoin":
                markers.append({"ts_s": ev.get("ts_s"),
                                "kind": "rejoin",
                                "label": "rejoin %s"
                                % (ev.get("request_id") or "")})
        with self._lock:
            replicas = list(self._replicas.items())
        offsets = {rid: getattr(rep, "clock_offset_s", None) or 0.0
                   for rid, rep in replicas}
        fi = self.fleet_incidents(n)
        for bundle in fi.get("incidents") or []:
            ts = bundle.get("ts_s")
            if ts is None:
                continue
            rid = bundle.get("replica")
            markers.append({
                "ts_s": ts + offsets.get(rid, 0.0),
                "kind": "incident",
                "label": "%s %s (%s)" % (rid, bundle.get("id"),
                                         bundle.get("kind")),
            })
        markers.sort(key=lambda m: m.get("ts_s") or 0.0)
        return markers

    def fleet_dashboard(self) -> str:
        """The ``/debug/fleet/dashboard`` page: one self-contained
        HTML document over the merged fleet timeline — one row per
        metric with per-replica overlays on the shared clock,
        incident/drain markers, per-replica SLO budget bars, and the
        fleet capacity block."""
        cap = self.fleet_capacity()
        budgets = []
        for rid, ledger in sorted((cap.get("slo_budget") or {}
                                   ).items()):
            for obj in ledger.get("objectives") or []:
                budgets.append({
                    "replica": rid,
                    "objective": obj.get("objective"),
                    "budget_remaining": obj.get("budget_remaining"),
                    "exhaustion_eta_s": obj.get("exhaustion_eta_s"),
                })
        return render_fleet_dashboard(
            self.fleet_timeseries(),
            title=self.fleet_name,
            extra={"capacity": {k: v for k, v in cap.items()
                                if k not in ("replicas",
                                             "slo_budget")},
                   "routing": self.router.snapshot()},
            markers=self.fleet_markers(),
            budgets=budgets or None)

    # ------------------------------------------------------ aggregates
    def loads(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._loads)

    def replica_ids(self) -> List[str]:
        return list(self._replicas)

    def healthz(self) -> dict:
        """Fleet-level health: ``ok`` while every replica serves,
        ``degraded`` when any is draining/crashed but at least one
        serves, raising when NOTHING can take traffic (the front
        door's 503, same convention as the engine's crashed loop)."""
        with self._lock:
            health = {rid: dict(h) for rid, h in self._health.items()}
            drained = dict(self._drained)
        live = self.router.live_replicas()
        if not live:
            raise NoLiveReplicas(
                f"no live replicas (drained: {drained})")
        return {
            "status": "ok" if not drained else "degraded",
            "fleet": self.fleet_name,
            "live": live,
            "draining": sorted(drained),
            "drain_reasons": drained,
            "replicas": health,
        }

    def stats(self) -> dict:
        """Fleet-wide ``GET /v1/stats``: per-replica ``stats()`` blocks
        plus the aggregate the router optimizes for — the fleet prefix
        hit rate (total hits over total lookups across every trie) —
        and the routing table."""
        per: Dict[str, dict] = {}
        hits = lookups = reused = prefilled = 0
        finished = 0
        with self._lock:
            replicas = list(self._replicas.items())
        for rid, rep in replicas:
            try:
                s = rep.stats()
            except WorkerRPCTimeout as e:
                self._ins.rpc_timeouts_total.labels(
                    self.fleet_name, rid).inc()
                per[rid] = {"error": repr(e), "wedged": True}
                continue
            except Exception as e:
                per[rid] = {"error": repr(e)}
                continue
            per[rid] = s
            pc = s.get("prefix_cache") or {}
            if pc.get("enabled"):
                hits += pc.get("hits", 0)
                lookups += pc.get("hits", 0) + pc.get("misses", 0)
                reused += pc.get("reused_tokens", 0)
                prefilled += pc.get("prefilled_tokens", 0)
            finished += int(s.get("finished", 0) or 0)
        # a crash postmortem may land on disk AFTER the drain (the
        # child's crash handler races the parent's poll) — re-check
        # any crashed replica we have no summary for yet
        with self._lock:
            missing = [rid for rid, why in self._drained.items()
                       if why in ("crashed", "rpc_timeout")
                       and rid not in self._postmortems]
        for rid in missing:
            self._collect_postmortem(rid)
        with self._lock:
            postmortems = dict(self._postmortems)
        denom = reused + prefilled
        return {
            "fleet": self.fleet_name,
            "policy": self.policy,
            "finished": finished,
            "replicas": per,
            "prefix_cache": {
                "hits": hits,
                "lookups": lookups,
                "hit_rate": round(hits / lookups, 4) if lookups else 0.0,
                "reused_tokens": reused,
                "prefilled_tokens": prefilled,
                "reused_fraction": (round(reused / denom, 4)
                                    if denom else 0.0),
            },
            "routing": self.router.snapshot(),
            "loads": self.loads(),
            # parent-side views of the workers: wedged-RPC tallies,
            # clock-offset estimates, and any collected crash
            # postmortems (path + error summary — satellite of the
            # fleet-tracing work; a child crash is diagnosable here)
            "rpc_timeouts": {
                rid: rep.rpc_timeouts
                for rid, rep in replicas
                if getattr(rep, "rpc_timeouts", 0)},
            "clock": {
                rid: {"offset_s": rep.clock_offset_s,
                      "rtt_s": rep.clock_rtt_s}
                for rid, rep in replicas
                if getattr(rep, "clock_offset_s", None) is not None},
            "postmortems": postmortems,
        }

    def routing_table(self) -> dict:
        return self.router.snapshot()

    def drain_wait(self, rid: str, timeout: float = 30.0) -> bool:
        """Block until ``rid`` reports zero in-flight work (drain
        completion) or ``timeout`` passes; True on fully drained."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                hz = self._replicas[rid].healthz()
            except Exception:
                return True  # crashed: nothing in flight survives it
            if hz.get("in_flight", hz.get("active_slots", 0)
                      + hz.get("queue_depth", 0)) == 0:
                return True
            time.sleep(0.01)
        return False
