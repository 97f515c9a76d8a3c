"""The port's fleet-wide distributed tracing (bigdl_tpu_torch/observability/
fleettrace.py + the fleet layer's trace plumbing), case for case with
tests/test_fleet_trace.py, and the spawn-worker hazards.

Every host-only function (trace context, hop decomposition, the min-RTT
clock offset on deterministic fake clocks, the trace merge, the request
timelines, the replica-labelled snapshot rendering with ``bdt_`` mapped
to ``bigdl_``, the recorder's context binding, the supervisor's wedged
and crash paths over fake replicas) is held equal to the JAX package's
on the same inputs. The engine cases serve weights copied from a JAX
``TransformerLM`` and hold their tokens to the JAX engine's rows.

The acceptance run is one module-scoped fleet of two spawned CPU
workers that load the JAX weights from an ``.npz`` (``params=``): one
merged Chrome trace with processes ``{front-door, r0, r1}``, no
negative duration, hops summing to each request's total within 10%,
tokens equal to the JAX engine's, children that never imported ``jax``
or ``bigdl_tpu``, the config's ``OMP_NUM_THREADS=1`` in force in each
child's torch, and only plain data (never a torch tensor) on the pipe.
Plus: a ``cuda`` worker on a machine without a GPU fails ``start()``
with ``EngineStopped`` carrying the child's own error, and a killed
child fails fast."""

import json
import os
import time
import urllib.request
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.observability import events as jevents
from bigdl_tpu.observability import exporters as jexporters
from bigdl_tpu.observability import fleettrace as jft
from bigdl_tpu.observability import metrics as jmetrics
from bigdl_tpu.observability import postmortem as jpostmortem
from bigdl_tpu.serving import ContinuousBatchingEngine as JaxEngine
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.observability import MetricRegistry
from bigdl_tpu_torch.observability.events import FlightRecorder
from bigdl_tpu_torch.observability.exporters import (
    render_prometheus, render_snapshot_prometheus,
)
from bigdl_tpu_torch.observability.fleettrace import (
    FLEET_HOPS, estimate_clock_offset, hop_breakdown,
    merge_fleet_trace, merge_request_timelines, mint_trace_id,
    parse_traceparent,
)
from bigdl_tpu_torch.observability.postmortem import registry_snapshot
from bigdl_tpu_torch.serving import ContinuousBatchingEngine, EngineStopped
from bigdl_tpu_torch.serving.fleet import (
    FleetFrontDoor, InProcessReplica, ReplicaSupervisor, WorkerReplica,
    WorkerRPCTimeout, spawn_worker_fleet,
)
from bigdl_tpu_torch.utils.weights import load_jax_params

#: the JAX two-worker test's model
MODEL = dict(vocab_size=64, embed_dim=16, num_heads=4, num_kv_heads=2,
             num_layers=2, max_len=96, use_rope=True)
ENGINE = {"max_slots": 2, "prefill_chunk": 4}
#: every (prompt, max_new) the engine cases serve
REQS = ([([1, 2, 3], 4), ([1, 2, 3, 4], 6), ([2, 3, 4], 4)]
        + [([1 + i, 2, 3, 4], 6) for i in range(4)])


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, np.asarray(v)


@pytest.fixture(scope="module")
def jax_lm():
    from bigdl_tpu.utils import random as rnd

    rnd.set_seed(7)
    jm = JaxLM(**MODEL)
    jm.evaluate()
    return jm


@pytest.fixture(scope="module")
def lm(jax_lm):
    m = TransformerLM(**MODEL, device="cpu")
    load_jax_params(m, jax.tree.map(np.asarray, jax_lm.params_dict()))
    m.evaluate()
    return m


@pytest.fixture(scope="module")
def want(jax_lm):
    """The JAX engine's generated tokens for every request in REQS."""
    with JaxEngine(jax_lm, **ENGINE) as eng:
        hs = [eng.submit(np.asarray(p, np.int32), n) for p, n in REQS]
        rows = {(tuple(p), n): np.asarray(h.result(timeout=120))[
            len(p):].tolist() for (p, n), h in zip(REQS, hs)}
    return lambda p, n: rows[(tuple(p), n)]


@pytest.fixture(scope="module")
def params_npz(jax_lm, tmp_path_factory):
    path = tmp_path_factory.mktemp("fleet") / "jax_params.npz"
    np.savez(path, **dict(_flat(jax_lm.params_dict())))
    return str(path)


# ------------------------------------------------------- trace context
def test_parse_traceparent_and_mint():
    tid = "ab" * 16
    assert parse_traceparent(f"00-{tid}-{'cd' * 8}-01") == tid
    assert parse_traceparent(tid) == tid          # bare 32-hex
    assert parse_traceparent(None) is None
    assert parse_traceparent("") is None
    assert parse_traceparent("not-a-header") is None
    assert parse_traceparent(f"00-{'0' * 32}-{'cd' * 8}-01") is None
    assert parse_traceparent(tid.upper()) == tid   # normalized
    for h in (f"00-{tid}-{'cd' * 8}-01", tid, None, "", "x", tid.upper(),
              f" 00-{tid}-{'cd' * 8}-01 ", "0" * 32, tid[:-1],
              f"00-{tid}-{'cd' * 8}"):
        assert parse_traceparent(h) == jft.parse_traceparent(h)
    minted = mint_trace_id()
    assert len(minted) == 32 and int(minted, 16) >= 0
    assert mint_trace_id() != minted
    assert jft.parse_traceparent(minted) == minted


def _plain_events(rec):
    return [{k: v for k, v in e.items()
             if k not in ("ts_s", "wall_s", "thread")}
            for e in rec.snapshot()]


def test_recorder_context_and_request_binding():
    recs = []
    for cls in (FlightRecorder, jevents.FlightRecorder):
        rec = cls(capacity=64)
        rec.set_context(replica="r7")
        rec.bind_request("req-1", trace="t-abc")
        rec.record("request/submitted", "req-1")
        rec.record("request/submitted", "req-2")       # unbound request
        rec.record("other", None, replica="explicit")  # explicit wins
        evs = rec.snapshot()
        by_kind = {e["kind"]: e for e in evs}
        e1 = [e for e in evs if e.get("request_id") == "req-1"][0]
        assert e1["replica"] == "r7" and e1["trace"] == "t-abc"
        e2 = [e for e in evs if e.get("request_id") == "req-2"][0]
        assert e2["replica"] == "r7" and "trace" not in e2
        assert by_kind["other"]["replica"] == "explicit"
        recs.append(_plain_events(rec))
        # bindings are bounded: flooding evicts the oldest first
        for i in range(rec.capacity + 5):
            rec.bind_request(f"flood-{i}", trace=str(i))
        assert rec.request_context("req-1") == {}
        assert rec.request_context(f"flood-{rec.capacity + 4}") != {}
    assert recs[0] == recs[1]


def test_engine_submit_binds_trace_to_events(lm, want):
    tid = mint_trace_id()
    with ContinuousBatchingEngine(lm, max_slots=1,
                                  prefill_chunk=4) as eng:
        h = eng.submit(np.asarray([1, 2, 3]), 4, trace_id=tid)
        row = h.result(timeout=60)
        assert h.trace_id == tid
        evs = eng._rec.for_request(h.request_id)
        assert evs, "engine recorded nothing for the request"
        assert any(e.attrs.get("trace") == tid for e in evs)
        kinds = [e.kind for e in evs if e.attrs.get("trace") == tid]
        assert "request/submitted" in kinds
    assert row[3:].tolist() == want([1, 2, 3], 4)


# ---------------------------------------------------- hop decomposition
def _hops_both(tl, **kw):
    hops = hop_breakdown(tl, **kw)
    assert hops == jft.hop_breakdown(tl, **kw)
    return hops


def test_hop_breakdown_sums_to_total_exactly():
    tl = {"queue_wait_s": 0.010, "prefill_s": 0.020,
          "decode_s": 0.050, "client_ttft_s": 0.040}
    hops = _hops_both(tl, route_s=0.001, rpc_submit_s=0.002,
                      total_s=0.100)
    assert set(hops) == set(FLEET_HOPS)
    assert tuple(hops) == FLEET_HOPS == jft.FLEET_HOPS
    assert all(v >= 0.0 for v in hops.values())
    assert sum(hops.values()) == pytest.approx(0.100, abs=1e-12)
    # first_token is the TTFT not explained by submit+queue+prefill
    assert hops["first_token"] == pytest.approx(0.008, abs=1e-12)


def test_hop_breakdown_scales_engine_phases_into_budget():
    # replica-clock phases overrun the client window (pipe jitter on
    # a short request): they are scaled, never summed past total
    tl = {"queue_wait_s": 0.02, "prefill_s": 0.03, "decode_s": 0.06,
          "client_ttft_s": 0.012}
    hops = _hops_both(tl, route_s=0.001, rpc_submit_s=0.001,
                      total_s=0.050)
    assert sum(hops.values()) == pytest.approx(0.050, abs=1e-12)
    assert all(v >= 0.0 for v in hops.values())
    # proportions of the engine phases are preserved by the scaling
    assert hops["decode"] == pytest.approx(2 * hops["prefill"],
                                           rel=1e-6)
    _hops_both({}, route_s=0.0, rpc_submit_s=0.0, total_s=0.0)
    _hops_both(tl, route_s=0.01, rpc_submit_s=0.02, total_s=0.001,
               ttft_s=0.5)


def test_hop_breakdown_in_process_fallback():
    # no client_ttft_s: the engine clock IS the client clock
    tl = {"queue_wait_s": 0.01, "prefill_s": 0.02, "decode_s": 0.03}
    hops = _hops_both(tl, route_s=0.0005, rpc_submit_s=0.0005,
                      total_s=0.070)
    assert hops["first_token"] == 0.0
    assert sum(hops.values()) == pytest.approx(0.070, abs=1e-12)
    _hops_both({"queue_wait_s": None, "prefill_s": None,
                "decode_s": None}, route_s=0.001, rpc_submit_s=0.002,
               total_s=0.01)


# ------------------------------------------------------ clock alignment
class _FakeClocks:
    """Deterministic supervisor/worker clock pair: the worker runs
    ``skew`` seconds ahead, pings cost ``rtt`` round trip."""

    def __init__(self, skew, rtt=0.001, jitter=0.0):
        self.t = 100.0
        self.skew = skew
        self.rtt = rtt
        self.jitter = jitter
        self.n = 0

    def local(self):
        self.t += 1e-6
        return self.t

    def ping(self):
        self.n += 1
        extra = self.jitter * (self.n % 3)   # asymmetric noise
        self.t += (self.rtt + extra) / 2
        remote = self.t + self.skew
        self.t += (self.rtt + extra) / 2
        return remote


@pytest.mark.parametrize("skew", [3.75, -0.5, 0.0])
def test_estimate_clock_offset_recovers_skew(skew):
    clk = _FakeClocks(skew, rtt=0.002, jitter=0.004)
    offset, rtt = estimate_clock_offset(clk.ping, samples=8,
                                        clock=clk.local)
    # remote + offset lands on the local timeline: offset == -skew,
    # within the min-RTT half-width error bound
    assert offset == pytest.approx(-skew, abs=rtt / 2 + 1e-6)
    assert rtt >= 0.002 - 1e-9
    jclk = _FakeClocks(skew, rtt=0.002, jitter=0.004)
    assert (offset, rtt) == jft.estimate_clock_offset(
        jclk.ping, samples=8, clock=jclk.local)


def test_estimate_clock_offset_tracks_drift_on_refresh():
    out = []
    for fn in (estimate_clock_offset, jft.estimate_clock_offset):
        clk = _FakeClocks(1.0, rtt=0.002)
        off1, _ = fn(clk.ping, samples=4, clock=clk.local)
        clk.skew = 1.5                      # the worker's clock drifted
        off2, rtt2 = fn(clk.ping, samples=4, clock=clk.local)
        assert off1 == pytest.approx(-1.0, abs=0.002)
        assert off2 == pytest.approx(-1.5, abs=rtt2 / 2 + 1e-6)
        out.append((off1, off2, rtt2))
    assert out[0] == out[1]


# ---------------------------------------------------------- trace merge
def _export(process, offset, reqs, pid=None):
    """Synthetic per-process export: full lifecycle per request on
    this process's own (skewed) clock."""
    evs = []
    seq = 0
    for rid, trace, t0 in reqs:
        for kind, dt in (("request/submitted", 0.0),
                         ("request/admitted", 0.010),
                         ("request/first_token", 0.030),
                         ("request/finished", 0.070)):
            seq += 1
            evs.append({"seq": seq, "ts_s": t0 + dt - offset,
                        "thread": "engine", "kind": kind,
                        "request_id": rid, "trace": trace})
    ex = {"process": process, "clock_offset_s": offset, "events": evs}
    if pid is not None:
        ex["pid"] = pid
    return ex


def test_merge_fleet_trace_invariants():
    exports = [
        _export("front-door", 0.0,
                [("req-A", "t-aa", 1.000),
                 ("req-B", "t-bb", 1.050)], pid=10),
        _export("r0", +2.5, [("req-000001", "t-aa", 1.001)], pid=20),
        _export("r1", -1.25, [("req-000001", "t-bb", 1.051)], pid=30),
    ]
    evs = merge_fleet_trace(exports, wall_offset=50.0)
    procs = {e["args"]["name"] for e in evs
             if e.get("name") == "process_name"}
    assert procs == {"front-door", "r0", "r1"}
    assert not any(e.get("ph") == "X" and e["dur"] < 0 for e in evs)
    # alignment: every instant lands on the common timeline near the
    # reference-side submit stamps (1.0s + 50s wall anchor), despite
    # per-process skews of +2.5 / -1.25 seconds
    instants = [e for e in evs if e.get("ph") == "i"]
    assert instants
    for e in instants:
        assert 50.9e6 < e["ts"] < 51.3e6
    # per-request event order survives alignment in every process
    reqs = {(e["pid"], e["args"]["request_id"]) for e in instants}
    for pid, rid in reqs:
        mine = [e["ts"] for e in instants if e["pid"] == pid
                and e["args"]["request_id"] == rid]
        assert mine == sorted(mine) and len(mine) == 4
    # derived spans: one request envelope + queue/prefill/decode
    # phases per (process, request)
    envelopes = [e for e in evs if e.get("cat") == "request"]
    assert len(envelopes) == 4
    phases = {e["name"].split()[0] for e in evs
              if e.get("cat") == "phase"}
    assert phases == {"queue", "prefill", "decode"}
    assert evs == jft.merge_fleet_trace(exports, wall_offset=50.0)
    # duplicate and missing pids get the same synthetic pids
    dup = [dict(exports[0]), dict(exports[1], pid=10),
           {"events": exports[2]["events"]}]
    assert merge_fleet_trace(dup) == jft.merge_fleet_trace(dup)


def test_merge_request_timelines_keys_by_trace():
    # both replicas minted "req-000001" — only the trace id is
    # fleet-unique, so the per-request join must key on it
    exports = [
        _export("front-door", 0.0, [("req-000001", "t-aa", 1.0),
                                    ("req-000001", "t-bb", 1.1)]),
        _export("r0", 0.0, [("req-000001", "t-aa", 1.0)]),
        _export("r1", 0.0, [("req-000001", "t-bb", 1.1)]),
    ]
    tls = merge_request_timelines(exports)
    assert set(tls) == {"t-aa", "t-bb"}
    assert set(tls["t-aa"]["processes"]) == {"front-door", "r0"}
    assert set(tls["t-bb"]["processes"]) == {"front-door", "r1"}
    for tl in tls.values():
        for p in tl["processes"].values():
            assert p["first_ts_s"] <= p["last_ts_s"]
            assert p["kinds"][0] == "request/submitted"
    assert tls == jft.merge_request_timelines(exports)
    untraced = [{"process": "p", "events": [
        {"ts_s": 1.0, "kind": "k", "request_id": "a"},
        {"ts_s": 2.0, "kind": "k", "request_id": "a",
         "attrs": {"trace": "t"}}, {"kind": "no-ts", "request_id": "b"}]}]
    assert merge_request_timelines(untraced) == \
        jft.merge_request_timelines(untraced)


# ------------------------------------------- replica-labeled /metrics
def test_render_snapshot_prometheus_labels_every_series():
    texts = []
    for registry, head, snapshot, render in (
            (MetricRegistry, "bdt", registry_snapshot,
             render_snapshot_prometheus),
            (jmetrics.MetricRegistry, "bigdl",
             jpostmortem.registry_snapshot,
             jexporters.render_snapshot_prometheus)):
        reg = registry()
        reg.counter(f"{head}_serving_requests_total", "requests",
                    labelnames=("service",)).labels("svc").inc(3)
        reg.histogram(f"{head}_serving_ttft_seconds", "ttft",
                      buckets=(0.1, 1.0)).observe(0.05)
        reg.gauge(f"{head}_g", "g").set(2.5)
        snap = snapshot(reg)
        texts.append(render({"r0": snap, "r1": snap}))
    text = texts[0]
    assert text.count("# HELP bdt_serving_requests_total") == 1
    assert ('bdt_serving_requests_total{replica="r0",'
            'service="svc"} 3') in text
    assert ('bdt_serving_requests_total{replica="r1",'
            'service="svc"} 3') in text
    assert 'le="0.1"' in text and 'le="+Inf"' in text
    assert 'bdt_serving_ttft_seconds_count{replica="r0"} 1' in text
    assert text.replace("bdt_", "bigdl_") == texts[1]
    assert render_snapshot_prometheus({}) == ""


# --------------------------------------- wedged RPC + postmortem paths
class FakeReplica:
    def __init__(self, rid, status="ok"):
        self.id = rid
        self.status = status      # str, or an Exception to raise
        self.calls = []

    def healthz(self):
        if isinstance(self.status, Exception):
            raise self.status
        return {"status": self.status, "alerts": [], "draining": False,
                "queue_depth": 0, "active_slots": 0}

    def stats(self):
        return {"finished": 0}

    def drain(self):
        self.calls.append("drain")

    def resume(self):
        self.calls.append("resume")

    def start(self):
        self.calls.append("start")

    def stop(self):
        self.calls.append("stop")


def _ns(port: bool):
    if port:
        return SimpleNamespace(
            sup=ReplicaSupervisor, registry=MetricRegistry,
            recorder=FlightRecorder, timeout=WorkerRPCTimeout,
            render=render_prometheus, head="bdt")
    from bigdl_tpu.serving.fleet import ReplicaSupervisor as JSup
    from bigdl_tpu.serving.fleet import WorkerRPCTimeout as JTimeout

    return SimpleNamespace(
        sup=JSup, registry=jmetrics.MetricRegistry,
        recorder=jevents.FlightRecorder, timeout=JTimeout,
        render=jexporters.render_prometheus, head="bigdl")


def test_wedged_replica_drains_with_counter_and_backoff():
    seen = []
    for ns in (_ns(True), _ns(False)):
        reg, rec = ns.registry(), ns.recorder(capacity=64)
        r0, r1 = FakeReplica("r0"), FakeReplica("r1")
        sup = ns.sup([r0, r1], poll_interval=999.0,
                     registry=reg, recorder=rec, chunk=4)
        with sup:
            r0.status = ns.timeout("healthz deadline (10.0s)")
            res = sup.poll_once()
            assert res["r0"]["status"] == "wedged"
            assert sup.healthz()["drain_reasons"] == {"r0": "rpc_timeout"}
            assert "drain" in r0.calls
            text = ns.render(reg)
            assert (f'{ns.head}_fleet_rpc_timeouts_total{{fleet="fleet",'
                    'replica="r0"} 1') in text
            # backoff: the wedged child is NOT re-probed next sweep
            # (each probe would block a full rpc_timeout)
            r0.status = Exception("must not be probed")
            assert sup.poll_once()["r0"] == {"status": "wedged",
                                            "backoff": True}
            assert (f'{ns.head}_fleet_rpc_timeouts_total{{fleet="fleet",'
                    'replica="r0"} 1') in ns.render(reg)
            # recovery: once the backoff lapses, a clean probe rejoins
            r0.status = "ok"
            sup._wedged_until["r0"] = 0.0
            sup.poll_once()
            assert sup.healthz()["status"] == "ok"
            assert "resume" in r0.calls
            seen.append([list(r0.calls), sup.healthz(),
                         [(e["kind"], e.get("reason"), e.get("was"))
                          for e in rec.snapshot()]])
    assert seen[0] == seen[1]


def test_crash_drain_collects_postmortem(tmp_path):
    pm_path = tmp_path / "r0_postmortem.json"
    pm_path.write_text(json.dumps({
        "schema": "bigdl_postmortem/1",
        "error": {"type": "Boom", "message": "loop crashed"},
        "events": [{"kind": "x"}] * 3,
        "requests": [{"request_id": "req-000001"}],
    }))
    seen = []
    for ns in (_ns(True), _ns(False)):
        reg, rec = ns.registry(), ns.recorder(capacity=64)
        r0, r1 = FakeReplica("r0"), FakeReplica("r1")
        r0.postmortem_path = str(pm_path)
        sup = ns.sup([r0, r1], poll_interval=999.0,
                     registry=reg, recorder=rec, chunk=4)
        with sup:
            r0.status = RuntimeError("dead pipe")
            sup.poll_once()
            st = sup.stats()
            pm = st["postmortems"]["r0"]
            assert pm["path"] == str(pm_path)
            assert pm["error"]["type"] == "Boom"
            assert pm["events"] == 3 and pm["requests"] == 1
            drains = [e for e in rec.tail() if e.kind == "fleet/drain"]
            assert drains and drains[-1].attrs["postmortem"] == str(pm_path)
            assert drains[-1].attrs["postmortem_error"] == "Boom"
            seen.append([pm, drains[-1].attrs, st["replicas"]])
    assert seen[0] == seen[1]


# ------------------------------------------------ front door, in-process
def _post(url, body, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=60)


def test_frontdoor_trace_roundtrip_and_hop_reconciliation(lm, want):
    reg = MetricRegistry()
    reps = [InProcessReplica(
        f"r{i}", ContinuousBatchingEngine(lm, **ENGINE))
        for i in range(2)]
    sent = mint_trace_id()
    with ReplicaSupervisor(reps, registry=reg, chunk=4,
                           poll_interval=999.0) as sup, \
            FleetFrontDoor(sup, registry=reg) as door:
        base = f"http://{door.host}:{door.port}"
        r = _post(base + "/v1/generate",
                  {"prompt_ids": [1, 2, 3, 4], "max_new_tokens": 6,
                   "stream": False},
                  headers={"traceparent":
                           f"00-{sent}-{'cd' * 8}-01"})
        assert r.headers["X-Trace-Id"] == sent
        out = json.loads(r.read())
        assert out["trace_id"] == sent
        assert out["tokens"] == want([1, 2, 3, 4], 6)
        assert r.headers["X-Request-Id"] == out["request_id"]
        assert set(out["hops"]) == set(FLEET_HOPS)
        hop_sum = sum(out["hops"].values())
        assert abs(hop_sum - out["total_s"]) <= 0.10 * out["total_s"]
        # a request WITHOUT traceparent gets a minted id
        r2 = _post(base + "/v1/generate",
                   {"prompt_ids": [2, 3, 4], "max_new_tokens": 4,
                    "stream": False})
        assert len(r2.headers["X-Trace-Id"]) == 32
        assert r2.headers["X-Trace-Id"] != sent
        assert json.loads(r2.read())["tokens"] == want([2, 3, 4], 4)
        # the merged trace serves, spans are sane, the request ring
        # and hop histograms reflect both requests
        tr = json.loads(urllib.request.urlopen(
            base + "/debug/fleet/trace", timeout=30).read())
        evs = tr["traceEvents"]
        assert {e["args"]["name"] for e in evs
                if e.get("name") == "process_name"} == {"front-door"}
        assert not any(e.get("ph") == "X" and e["dur"] < 0
                       for e in evs)
        assert any(e.get("args", {}).get("trace") == sent
                   for e in evs)
        fr = json.loads(urllib.request.urlopen(
            base + "/debug/fleet/requests", timeout=30).read())
        assert len(fr["requests"]) == 2
        assert {e["trace_id"] for e in fr["requests"]} >= {sent}
        assert all(abs(e["hop_sum_s"] - e["total_s"])
                   <= 0.10 * e["total_s"] + 1e-6
                   for e in fr["requests"])
        text = urllib.request.urlopen(
            base + "/metrics", timeout=30).read().decode()
        assert 'bdt_fleet_hop_seconds_bucket' in text
        assert 'hop="prefill"' in text


# ----------------------------------------- multi-process acceptance run
class RecordingReplica(WorkerReplica):
    """A worker replica that keeps every message it sends down the pipe
    and every message it receives from the child."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.wire = []

    def _send(self, msg):
        self.wire.append(msg)
        super()._send(msg)

    def _dispatch(self, msg):
        self.wire.append(msg)
        return super()._dispatch(msg)


_PLAIN = (int, float, str, bool, type(None), np.ndarray, np.generic)


def _non_plain(obj, path="msg"):
    """Paths of every value in ``obj`` that is not plain data."""
    if isinstance(obj, dict):
        return [p for k, v in obj.items()
                for p in ([f"{path} key {k!r}"] if not isinstance(
                    k, (str, int)) else []) + _non_plain(v, f"{path}.{k}")]
    if isinstance(obj, (list, tuple)):
        return [p for i, v in enumerate(obj)
                for p in _non_plain(v, f"{path}[{i}]")]
    return [] if isinstance(obj, _PLAIN) and not isinstance(
        obj, torch.Tensor) else [f"{path}: {type(obj).__name__}"]


@pytest.fixture(scope="module")
def worker_fleet(params_npz):
    """Two spawned CPU workers holding the JAX weights, behind one
    supervisor and front door (one fleet for the module)."""
    reps = [RecordingReplica(r.id, r._cfg, rpc_timeout=r.rpc_timeout)
            for r in spawn_worker_fleet(
                2, MODEL, engine=ENGINE, seed=7, device="cpu",
                params=params_npz, env={"OMP_NUM_THREADS": "1"})]
    reg = MetricRegistry()
    with ReplicaSupervisor(reps, poll_interval=0.1,
                           registry=reg) as sup, \
            FleetFrontDoor(sup, registry=reg) as door:
        yield reps, sup, door


def test_two_worker_fleet_merged_trace_end_to_end(worker_fleet, want):
    """A hermetic 2-replica worker fleet produces ONE merged Chrome
    trace with spans from the front door AND both worker processes,
    aligned (no negative durations), and every finished request's hops
    sum to the client total within 10%; the workers' tokens are the JAX
    engine's."""
    reps, sup, door = worker_fleet
    base = f"http://{door.host}:{door.port}"
    for rep in reps:
        assert rep.clock_offset_s is not None
        assert rep.clock_rtt_s >= 0.0
        assert rep.startup_s > 0.0
    outs = [json.loads(_post(
        base + "/v1/generate",
        {"prompt_ids": [1 + i, 2, 3, 4], "max_new_tokens": 6,
         "stream": False}).read()) for i in range(4)]
    assert {o["replica"] for o in outs} == {"r0", "r1"}
    for i, o in enumerate(outs):
        assert o["tokens"] == want([1 + i, 2, 3, 4], 6)
        s = sum(o["hops"].values())
        assert abs(s - o["total_s"]) <= 0.10 * o["total_s"]
    tr = json.loads(urllib.request.urlopen(
        base + "/debug/fleet/trace", timeout=60).read())
    evs = tr["traceEvents"]
    procs = {e["args"]["name"] for e in evs
             if e.get("name") == "process_name"}
    assert procs == {"front-door", "r0", "r1"}
    assert not any(e.get("ph") == "X" and e["dur"] < 0
                   for e in evs)
    fr = json.loads(urllib.request.urlopen(
        base + "/debug/fleet/requests", timeout=60).read())
    multi = [t for t in fr["timelines"].values()
             if len(t["processes"]) >= 2]
    assert len(multi) >= 4       # every request, in both procs
    text = urllib.request.urlopen(
        base + "/metrics", timeout=60).read().decode()
    assert 'replica="r0"' in text and 'replica="r1"' in text
    assert "bdt_fleet_clock_offset_seconds" in text
    assert "bigdl_" not in text
    # each worker's own stats() reports its memory
    st = sup.stats()
    for rid in ("r0", "r1"):
        assert st["replicas"][rid]["memory"]["pool_bytes_total"] > 0


def test_workers_import_no_jax_and_take_their_env(worker_fleet):
    """The children never imported ``jax`` or ``bigdl_tpu`` (the
    parent, this test process, has both), and the config's
    ``OMP_NUM_THREADS=1`` reached each child before its torch."""
    import sys

    assert "jax" in sys.modules and "bigdl_tpu" in sys.modules
    reps, sup, _ = worker_fleet
    pids = set()
    for rep in reps:
        pr = rep.probe()
        pids.add(pr["pid"])
        mods = set(pr["modules"])
        assert "bigdl_tpu_torch" in mods and "torch" in mods
        assert not mods & {"jax", "jaxlib", "bigdl_tpu", "flax"}, mods
        assert pr["env"] == {"OMP_NUM_THREADS": "1"}
        assert pr["torch_threads"] == 1
    assert len(pids) == 2 and os.getpid() not in pids


def test_no_torch_tensor_crosses_the_pipe(worker_fleet):
    """Every message of the module's run, both ways, is plain data;
    tokens are Python ints and prompts lists of them."""
    reps, sup, _ = worker_fleet
    rt = sup.submit(np.asarray([5, 6, 7]), 4)
    rt.handle.result(timeout=60)
    sup.stats()
    sup.fleet_timeseries()
    sup.fleet_incidents()
    n_tokens = 0
    for rep in reps:
        assert rep.wire
        for msg in rep.wire:
            assert not _non_plain(msg), _non_plain(msg)
            if msg.get("ev") == "token":
                assert type(msg["tok"]) is int
                n_tokens += 1
            if msg.get("op") == "submit":
                assert all(type(t) is int for t in msg["prompt"])
            if msg.get("ev") == "done":
                assert all(type(t) is int for t in msg["tokens"])
    assert n_tokens >= 4


def test_submit_racing_a_drain_is_refused_and_rerouted(worker_fleet, lm):
    """A worker's submit is answered: a child whose engine drains before
    the supervisor's poll has seen it refuses the request at
    ``submit`` (``EngineDraining``), where the supervisor re-routes it,
    instead of failing on the client's stream later."""
    from bigdl_tpu_torch.serving import EngineDraining

    reps, sup, _ = worker_fleet
    r0 = reps[0]
    p = next(np.asarray([i, i + 1, 2, 3]) for i in range(64)
             if sup.router.owner(sup.router.key_for([i, i + 1, 2, 3]))
             == r0.id)
    rerouted = sup._ins.rerouted_total.get()
    r0.drain()                      # behind the supervisor's back
    try:
        with pytest.raises(EngineDraining):
            r0.submit(p, 3)
        rt = sup.submit(p, 3)
        assert rt.replica == reps[1].id and rt.route == "spilled"
        assert sup._ins.rerouted_total.get() == rerouted + 1
        assert rt.handle.result(timeout=60) == \
            lm.generate(p, 3)[0, len(p):].tolist()
    finally:
        r0.resume()


class _LiveProc:
    def is_alive(self):
        return True


def _wedged_worker(rid, rpc_timeout, answer_healthz=False):
    """A ``WorkerReplica`` whose child is a thread on the other end of
    its pipe: it takes every op and answers no submit, and answers
    ``healthz`` only when ``answer_healthz`` (an engine that is alive
    but holds the submit on a full queue). Returns the replica and
    the ops the child received; the replica's pipe closes on stop."""
    import multiprocessing as mp
    import threading

    rep = WorkerReplica(rid, {"model": MODEL, "device": "cpu"},
                        rpc_timeout=rpc_timeout)
    rep._conn, child = mp.Pipe(duplex=True)
    rep._proc, rep._up = _LiveProc(), True
    rep._reader = threading.Thread(target=rep._read_loop, daemon=True)
    rep._reader.start()
    ops = []

    def play():
        while True:
            try:
                msg = child.recv()
            except (EOFError, OSError):
                return
            ops.append(msg.get("op"))
            if msg.get("op") == "healthz" and answer_healthz:
                child.send({"ev": "reply", "seq": msg["seq"],
                            "payload": {"status": "ok",
                                        "queue_depth": 1,
                                        "active_slots": 2}})
            elif msg.get("op") == "submit" and answer_healthz:
                rep._held = (child, msg["rid"])

    threading.Thread(target=play, daemon=True).start()
    return rep, ops


class _ServingFake(FakeReplica):
    def submit(self, prompt_ids, max_new_tokens, **kw):
        self.calls.append("submit")
        return SimpleNamespace(request_id=f"{self.id}-1")


def test_submit_to_a_wedged_worker_raises_and_reroutes():
    """The worker's submit handshake is bounded: a child that is alive
    but wedged before it answers a submit makes ``submit`` raise
    ``WorkerRPCTimeout`` (on its own healthz probe after one
    ``rpc_timeout``, or at once when another control call, such as the
    supervisor's poll, times out meanwhile), cancels the request in the
    child and forgets its handle; the supervisor re-routes it. A child
    that answers its healthz but holds the submit (a full queue) keeps
    the blocking submit waiting until it accepts."""
    import threading

    # own probe: one rpc_timeout unanswered, then a healthz that times out
    rep, ops = _wedged_worker("r0", rpc_timeout=0.3)
    t0 = time.monotonic()
    with pytest.raises(WorkerRPCTimeout, match="wedged"):
        rep.submit([1, 2, 3], 4)
    assert time.monotonic() - t0 < 5
    assert rep.rpc_timeouts == 1 and rep._handles == {}
    time.sleep(0.1)
    assert ops == ["submit", "healthz", "cancel"]

    # another caller's timed-out control call ends the wait at once
    rep, ops = _wedged_worker("r0", rpc_timeout=60.0)
    poll = threading.Thread(
        target=lambda: pytest.raises(
            WorkerRPCTimeout, rep._call, "healthz", timeout=0.3))
    t0 = time.monotonic()
    poll.start()
    with pytest.raises(WorkerRPCTimeout):
        rep.submit([1, 2, 3], 4)
    poll.join()
    assert time.monotonic() - t0 < 5 and rep.rpc_timeouts == 1

    # alive, answering healthz, holding the submit: no timeout
    rep, ops = _wedged_worker("r0", rpc_timeout=0.2,
                              answer_healthz=True)
    t = threading.Timer(1.0, lambda: rep._held[0].send(
        {"ev": "accepted", "rid": rep._held[1]}))
    t.start()
    h = rep.submit([1, 2, 3], 4)
    t.join()
    assert h.request_id == rep._held[1] and rep.rpc_timeouts == 0
    assert ops.count("healthz") >= 2

    # behind a supervisor: the wedged owner refuses, r1 takes it
    r0, _ = _wedged_worker("r0", rpc_timeout=0.3)
    r1 = _ServingFake("r1")
    sup = ReplicaSupervisor([r0, r1], poll_interval=999.0,
                            registry=MetricRegistry(),
                            recorder=FlightRecorder(capacity=64),
                            chunk=4)
    p = next([i, i + 1, 2, 3] for i in range(64)
             if sup.router.owner(sup.router.key_for([i, i + 1, 2, 3]))
             == "r0")
    rt = sup.submit(np.asarray(p), 3)
    assert rt.replica == "r1" and rt.route == "spilled"
    assert sup._ins.rerouted_total.get() == 1 and r1.calls == ["submit"]


def test_cuda_worker_without_a_gpu_fails_start_no_fallback():
    """A worker asked for the card on a machine without one fails
    ``start()`` with ``EngineStopped`` carrying the child's own error;
    nothing serves on the CPU."""
    assert not torch.cuda.is_available()
    (rep,) = spawn_worker_fleet(1, MODEL, engine=ENGINE,
                                env={"OMP_NUM_THREADS": "1"})
    assert rep._cfg["device"] == "cuda"
    t0 = time.monotonic()
    with pytest.raises(EngineStopped) as ei:
        rep.start()
    assert "failed to start" in str(ei.value)
    assert "CUDA is not available" in str(ei.value)
    assert time.monotonic() - t0 < 60
    rep._proc.join(timeout=10)
    assert not rep.alive()
    with pytest.raises(EngineStopped):
        rep.submit([1, 2, 3], 2)


def test_killed_worker_fails_fast_and_drains(worker_fleet):
    """A dead child never hangs a caller: its control calls and submits
    raise ``EngineStopped`` at once and the next poll drains it as
    crashed; the other replica keeps serving."""
    reps, sup, _ = worker_fleet
    victim = reps[1]
    victim._proc.kill()
    victim._proc.join(timeout=10)
    t0 = time.monotonic()
    with pytest.raises(EngineStopped):
        victim.healthz()
    with pytest.raises(EngineStopped):
        victim.submit([1, 2, 3], 2)
    assert time.monotonic() - t0 < 5
    res = sup.poll_once()
    assert res[victim.id]["status"] == "crashed"
    assert sup.healthz()["drain_reasons"] == {victim.id: "crashed"}
    rt = sup.submit(np.asarray([3, 3, 3]), 3)
    assert rt.replica == reps[0].id
    assert len(rt.handle.result(timeout=60)) == 3
