"""The port's serving fleet (bigdl_tpu_torch/serving/fleet/): supervisor,
engine drain lifecycle and the HTTP front door, case for case with
tests/test_fleet.py.

Host-only parts are held to the JAX package exactly: each supervisor
case runs the same script over fake replicas through the port's
``ReplicaSupervisor`` and the JAX one and compares every observation
(drain sets, health dicts, routes, stats). Parts with an engine compare
tokens: the port's engines and in-process fleet serve the small f32
model of tests/test_fleet.py with weights copied from a JAX
``TransformerLM`` by ``load_jax_params``, and every row must equal the
JAX engine's greedy row for the same request, exactly (one JAX engine
run serves every request of the file)."""

import json
import socket
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.serving import ContinuousBatchingEngine as JaxEngine
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.observability import MetricRegistry
from bigdl_tpu_torch.serving import (
    ContinuousBatchingEngine, EngineDraining,
)
from bigdl_tpu_torch.serving.fleet import (
    FleetFrontDoor, InProcessReplica, NoLiveReplicas, ReplicaSupervisor,
)
from bigdl_tpu_torch.utils.weights import load_jax_params

VOCAB = 32
CFG = dict(vocab_size=VOCAB, embed_dim=16, num_heads=4, num_kv_heads=2,
           num_layers=2, max_len=48, use_rope=True)


def _requests():
    """Every (prompt, max_new) the engine cases of this file serve."""
    r3 = np.random.RandomState(3)
    routing = [(r3.randint(0, VOCAB, (t0,)), n)
               for t0, n in [(5, 6), (9, 4), (3, 8), (7, 5), (5, 6),
                             (9, 4)]]
    r8 = np.random.RandomState(8)
    drain = [(r8.randint(0, VOCAB, (6,)), 10) for _ in range(4)]
    return {
        "routing": routing,
        "drain": drain,
        "misc": [(np.asarray([5, 1, 2, 3]), 12), (np.asarray([2, 4]), 4),
                 (drain[0][0], 4), (np.asarray([3, 1, 4, 1, 5]), 8),
                 (np.asarray([3, 1, 4, 1, 5]), 6),
                 (np.asarray([4, 4, 2]), 6)],
    }


def _key(p, n):
    return (tuple(int(t) for t in np.asarray(p)), int(n))


@pytest.fixture(scope="module")
def lms():
    from bigdl_tpu.utils import random as rnd

    rnd.set_seed(21)
    jm = JaxLM(**CFG)
    jm.evaluate()
    tm = TransformerLM(**CFG, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    tm.evaluate()
    return jm, tm


@pytest.fixture(scope="module")
def lm(lms):
    return lms[1]


@pytest.fixture(scope="module")
def want(lms):
    """The JAX engine's greedy row for every request of the file."""
    jm, _ = lms
    reqs = {_key(p, n): (p, n)
            for group in _requests().values() for p, n in group}
    with JaxEngine(jm, max_slots=2, prefill_chunk=4) as eng:
        hs = {k: eng.submit(np.asarray(p, np.int32), n)
              for k, (p, n) in reqs.items()}
        rows = {k: np.asarray(h.result(timeout=120))
                for k, h in hs.items()}

    def row(p, n):
        return rows[_key(p, n)]
    return row


# --------------------------------------------------------------- engine
def test_engine_healthz_is_machine_readable(lm):
    with ContinuousBatchingEngine(lm, max_slots=1,
                                  prefill_chunk=4) as eng:
        hz = eng.healthz()
        assert hz["status"] == "ok"
        assert hz["draining"] is False
        assert hz["alerts"] == []
        assert hz["in_flight"] == 0
        h = eng.submit(np.asarray([1, 2, 3]), 4)
        assert eng.healthz()["in_flight"] >= 1
        h.result(timeout=60)
        assert eng.healthz()["in_flight"] == 0


def test_engine_drain_refuses_new_lets_inflight_finish(lm, want):
    p = np.asarray([5, 1, 2, 3])
    with ContinuousBatchingEngine(lm, max_slots=1,
                                  prefill_chunk=4) as eng:
        h = eng.submit(p, 12)
        eng.drain()
        assert eng.draining and eng.healthz()["draining"] is True
        with pytest.raises(EngineDraining):
            eng.submit(np.asarray([1, 2]), 4)
        # the in-flight request is untouched by the drain
        np.testing.assert_array_equal(h.result(timeout=60), want(p, 12))
        eng.drain()   # idempotent
        eng.resume()
        assert not eng.draining
        h2 = eng.submit(np.asarray([2, 4]), 4)
        np.testing.assert_array_equal(
            h2.result(timeout=60), want(np.asarray([2, 4]), 4))


# ----------------------------------------------------------- supervisor
def _ns(port: bool):
    """One package's supervisor surface."""
    if port:
        return SimpleNamespace(sup=ReplicaSupervisor,
                               draining=EngineDraining,
                               nolive=NoLiveReplicas,
                               registry=MetricRegistry)
    from bigdl_tpu.observability import MetricRegistry as JReg
    from bigdl_tpu.serving import EngineDraining as JDraining
    from bigdl_tpu.serving.fleet import (
        NoLiveReplicas as JNoLive, ReplicaSupervisor as JSup,
    )

    return SimpleNamespace(sup=JSup, draining=JDraining, nolive=JNoLive,
                           registry=JReg)


class FakeReplica:
    """Replica-protocol stub: scripted health, recorded lifecycle
    calls, optional submit refusal — the supervisor's control plane
    tested with no engines at all."""

    def __init__(self, rid, status="ok"):
        self.id = rid
        self.status = status      # str, or an Exception to raise
        self.calls = []
        self.submitted = []
        self.refuse = None        # exception submit() should raise

    def healthz(self):
        if isinstance(self.status, Exception):
            raise self.status
        return {"status": self.status, "alerts": [], "draining": False,
                "queue_depth": 0, "active_slots": len(self.submitted)}

    def submit(self, prompt_ids, max_new_tokens, tenant=None,
               timeout_s=None, block=True, priority="normal"):
        if self.refuse is not None:
            raise self.refuse
        self.submitted.append([int(t) for t in np.asarray(prompt_ids)])
        return f"handle-{self.id}-{len(self.submitted)}"

    def stats(self):
        return {"finished": len(self.submitted)}

    def drain(self):
        self.calls.append("drain")

    def resume(self):
        self.calls.append("resume")

    def start(self):
        self.calls.append("start")

    def stop(self):
        self.calls.append("stop")


def _fake_fleet(ns, n=2, **kw):
    reps = [FakeReplica(f"r{i}") for i in range(n)]
    kw.setdefault("poll_interval", 999.0)  # poll_once() drives tests
    kw.setdefault("registry", ns.registry())
    kw.setdefault("chunk", 4)
    return reps, ns.sup(reps, **kw)


def _both(script):
    """Run ``script(ns)`` on the port and on JAX; their observation
    lists must be equal."""
    ours = script(_ns(True))
    theirs = script(_ns(False))
    assert ours == theirs
    return ours


def test_supervisor_auto_drains_degraded_and_rejoins():
    def script(ns):
        (r0, r1), sup = _fake_fleet(ns)
        seen = []
        with sup:
            assert sup.healthz()["status"] == "ok"
            r0.status = "degraded"
            seen.append(sup.poll_once())
            assert sup.router.draining == ["r0"]
            assert "drain" in r0.calls
            hz = sup.healthz()
            assert hz["status"] == "degraded"
            assert hz["drain_reasons"] == {"r0": "degraded"}
            seen.append(hz)
            r0.status = "ok"
            seen.append(sup.poll_once())
            assert sup.router.draining == []
            assert "resume" in r0.calls
            seen += [sup.healthz(), list(r0.calls), sup.routing_table()]
        return seen

    _both(script)


def test_supervisor_drains_crashed_probe_and_recovers():
    def script(ns):
        (r0, r1), sup = _fake_fleet(ns)
        with sup:
            r0.status = RuntimeError("decode loop died")
            res = sup.poll_once()
            assert res["r0"]["status"] == "crashed"
            assert sup.healthz()["drain_reasons"] == {"r0": "crashed"}
            r0.status = "ok"
            sup.poll_once()
            assert sup.healthz()["status"] == "ok"
            return [res, sup.healthz(), list(r0.calls)]

    _both(script)


def test_operator_drain_never_auto_rejoins():
    def script(ns):
        (r0, r1), sup = _fake_fleet(ns)
        with sup:
            sup.drain("r0")
            sup.poll_once()   # probe is clean, but the drain was manual
            assert sup.router.draining == ["r0"]
            seen = [sup.healthz()]
            sup.rejoin("r0")
            assert sup.router.draining == []
            seen.append(list(r0.calls))
        with pytest.raises(KeyError):
            sup.drain("nope")
        return seen

    _both(script)


def test_submit_reroutes_when_the_target_refuses():
    def script(ns):
        (r0, r1), sup = _fake_fleet(ns)
        with sup:
            # find a prompt whose ring owner is r0, then make r0 refuse
            p = next([i, i + 1, 2, 3] for i in range(64)
                     if sup.router.owner(
                         sup.router.key_for([i, i + 1, 2, 3])) == "r0")
            r0.refuse = ns.draining("draining")
            routed = sup.submit(p, 4)
            assert routed.replica == "r1" and routed.route == "spilled"
            assert r1.submitted and not r0.submitted
            # both refusing exhausts the fleet: the error propagates
            r1.refuse = ns.draining("draining")
            with pytest.raises(ns.draining):
                sup.submit(p, 4)
            return [p, routed.handle, routed.replica, routed.route,
                    r1.submitted]

    _both(script)


def test_all_drained_raises_no_live_replicas():
    def script(ns):
        (r0, r1), sup = _fake_fleet(ns)
        with sup:
            sup.drain("r0")
            sup.drain("r1")
            with pytest.raises(ns.nolive):
                sup.submit([1, 2, 3], 4)
            with pytest.raises(ns.nolive):
                sup.healthz()
            return [r0.calls, r1.calls, sup.router.draining]

    _both(script)


def test_round_robin_policy_cycles():
    def script(ns):
        (r0, r1), sup = _fake_fleet(ns, policy="round_robin")
        with sup:
            seen = [sup.submit([9, 9, 9], 2).replica for _ in range(4)]
            assert seen == ["r0", "r1", "r0", "r1"]
            rt = sup.submit([1, 2], 2)
            assert rt.route == "round_robin"
            return seen + [rt.replica, rt.handle]

    _both(script)


def test_fake_fleet_stats_aggregate():
    def script(ns):
        (r0, r1), sup = _fake_fleet(ns)
        with sup:
            routed = sup.submit([1, 2, 3], 2)
            st = sup.stats()
            assert st["finished"] == 1
            assert set(st["replicas"]) == {"r0", "r1"}
            assert "routing" in st and "prefix_cache" in st
            return [routed.replica, routed.route, st]

    _both(script)


# ----------------------------------------------- in-process fleet + HTTP
def _engine_fleet(lm, n=2, **eng_kw):
    eng_kw.setdefault("max_slots", 2)
    eng_kw.setdefault("prefill_chunk", 4)
    reps = [InProcessReplica(
        f"r{i}", ContinuousBatchingEngine(lm, **eng_kw))
        for i in range(n)]
    return reps, ReplicaSupervisor(
        reps, chunk=4, poll_interval=0.05, registry=MetricRegistry())


def test_fleet_routing_never_changes_tokens(lm, want):
    reqs = _requests()["routing"]
    reps, sup = _engine_fleet(lm)
    with sup:
        routed = [sup.submit(p, n) for p, n in reqs]
        for (p, n), rt in zip(reqs, routed):
            np.testing.assert_array_equal(
                rt.handle.result(timeout=60), want(p, n))
    # affinity: requests sharing a ring key always land on one replica
    by_key = {}
    for (p, n), rt in zip(reqs, routed):
        if rt.route == "affinity":
            by_key.setdefault(sup.router.key_for(p), set()).add(
                rt.replica)
    assert all(len(v) == 1 for v in by_key.values())


def test_drain_mid_flight_loses_nothing(lm, want):
    reqs = _requests()["drain"]
    reps, sup = _engine_fleet(lm, max_slots=1)
    with sup:
        routed = [sup.submit(p, n) for p, n in reqs]
        victim = routed[0].replica
        sup.drain(victim, reason="degraded")   # requests in flight
        for (p, n), rt in zip(reqs, routed):
            np.testing.assert_array_equal(
                rt.handle.result(timeout=60), want(p, n))
        assert sup.drain_wait(victim, timeout=30)
        sup.rejoin(victim)
        rt = sup.submit(reqs[0][0], 4)
        np.testing.assert_array_equal(
            rt.handle.result(timeout=60), want(reqs[0][0], 4))


def _post(base, payload):
    req = urllib.request.Request(
        f"{base}/v1/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=60)


def _read_sse(resp):
    events = []
    event = None
    for raw in resp:
        ln = raw.decode().strip()
        if ln.startswith("event: "):
            event = ln[7:]
        elif ln.startswith("data: "):
            events.append((event, json.loads(ln[6:])))
            event = None
    return events


def test_front_door_sse_round_trip(lm, want):
    p = [3, 1, 4, 1, 5]
    reps, sup = _engine_fleet(lm)
    with sup, FleetFrontDoor(sup) as door:
        base = f"http://127.0.0.1:{door.port}"
        with _post(base, {"prompt_ids": p, "max_new_tokens": 8,
                          "tenant": "t0"}) as resp:
            assert resp.headers["Content-Type"] == "text/event-stream"
            events = _read_sse(resp)
        assert events[0][0] == "meta"
        assert events[0][1]["replica"] in ("r0", "r1")
        assert events[0][1]["route"] in ("affinity", "spilled")
        toks = [e[1]["token"] for e in events if e[0] is None]
        assert events[-1][0] == "done"
        assert events[-1][1]["tokens"] == len(toks) == 8
        assert toks == want(p, 8)[len(p):].tolist()

        # non-streaming: one JSON body, generated tokens only
        with _post(base, {"prompt_ids": p, "max_new_tokens": 6,
                          "stream": False}) as resp:
            out = json.loads(resp.read())
        assert out["tokens"] == want(p, 6)[len(p):].tolist()

        # stats + replicas + healthz round-trip
        st = json.loads(urllib.request.urlopen(
            f"{base}/v1/stats", timeout=30).read())
        assert st["finished"] >= 2 and "prefix_cache" in st
        table = json.loads(urllib.request.urlopen(
            f"{base}/v1/replicas", timeout=30).read())
        assert table["replicas"] == ["r0", "r1"]
        hz = json.loads(urllib.request.urlopen(
            f"{base}/healthz", timeout=30).read())
        assert hz["status"] == "ok"


def test_front_door_maps_errors_to_http_codes(lm):
    reps, sup = _engine_fleet(lm)
    with sup, FleetFrontDoor(sup) as door:
        base = f"http://127.0.0.1:{door.port}"
        for payload in ({"prompt_ids": []},
                        {"prompt_ids": "nope"},
                        {"prompt_ids": [1, 2], "max_new_tokens": "x"}):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base, payload)
            assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/nope", timeout=30)
        assert ei.value.code == 404
        # every replica draining -> 503 on generate AND on healthz
        sup.drain("r0")
        sup.drain("r1")
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, {"prompt_ids": [1, 2], "max_new_tokens": 2})
        assert ei.value.code == 503
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/healthz", timeout=30)
        assert ei.value.code == 503
        sup.rejoin("r0")
        sup.rejoin("r1")


def test_client_disconnect_mid_decode_cancels_and_frees_slot(lm, want):
    """The SSE regression: a client that vanishes mid-stream must cost
    the fleet nothing — the failed write cancels the request, the
    engine records the cancellation, and the (only) slot is reusable
    immediately."""
    reps, sup = _engine_fleet(lm, n=1, max_slots=1)
    eng = reps[0].engine
    with sup, FleetFrontDoor(sup) as door:
        body = json.dumps({"prompt_ids": [2, 7, 1], "max_new_tokens": 40,
                           "stream": True})
        raw = (f"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
               f"Content-Type: application/json\r\n"
               f"Content-Length: {len(body)}\r\n\r\n{body}")
        s = socket.create_connection(("127.0.0.1", door.port),
                                     timeout=30)
        s.sendall(raw.encode())
        buf = b""
        while buf.count(b"data: ") < 3:   # provably mid-decode
            chunk = s.recv(4096)
            assert chunk, f"stream ended early: {buf!r}"
            buf += chunk
        # hard disconnect: RST on close so the server's next write fails
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     b"\x01\x00\x00\x00\x00\x00\x00\x00")
        s.close()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if eng.stats().get("cancelled", 0) >= 1:
                break
            time.sleep(0.05)
        else:
            pytest.fail("disconnect never cancelled the request")
        # the slot is free again: a fresh request completes correctly
        p = np.asarray([4, 4, 2])
        rt = sup.submit(p, 6)
        np.testing.assert_array_equal(rt.handle.result(timeout=60),
                                      want(p, 6))


def test_front_door_low_priority_maps_queue_full_to_429(lm):
    reps, sup = _engine_fleet(lm, n=1, max_slots=1, queue_capacity=1)
    with sup, FleetFrontDoor(sup) as door:
        base = f"http://127.0.0.1:{door.port}"
        # one request provably IN the slot (first token streamed)...
        slot = sup.submit(np.asarray([1, 2, 3, 4]), 20)
        next(slot.handle.tokens())
        # ...one filling the only queue row...
        queued = sup.submit(np.asarray([2, 2, 2]), 4)
        # ...so a low-priority arrival cannot be admitted
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, {"prompt_ids": [5, 6], "max_new_tokens": 2,
                         "priority": "low"})
        assert ei.value.code == 429
        for h in (slot, queued):
            h.handle.result(timeout=60)
