"""The port's request-scoped flight recorder
(bigdl_tpu_torch/observability/events.py), Chrome trace export, /debug
endpoints and crash postmortems, case for case with
tests/test_flight_recorder.py; the engine cases run the port's engine on
the CPU beside the JAX engine on the same weights and requests.

The contract under test: every request served by the continuous-
batching engine leaves a complete, ordered event timeline in the
recorder (submitted → queued → admitted → prefill → first token →
per-token decode → finished); the same timelines export as schema-valid
Chrome trace JSON and serve over ``/debug/*``; an injected decode-step
crash writes a postmortem carrying the in-flight request states and
flips ``/healthz`` to 503; and a disabled recorder records nothing
while the engine keeps serving correct tokens.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from bigdl_tpu import observability as jobs
from bigdl_tpu.serving import ContinuousBatchingEngine as JaxEngine
from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch.observability.events import (
    FlightRecorder, percentile_summary,
)
from bigdl_tpu_torch.serving import ContinuousBatchingEngine, EngineStopped


@pytest.fixture()
def reg():
    """Fresh registry installed as the process default (swap BEFORE
    constructing services — they capture instruments at construction)."""
    r = obs.MetricRegistry()
    prev = obs.set_default_registry(r)
    try:
        yield r
    finally:
        obs.set_default_registry(prev)
        obs.enable()


@pytest.fixture()
def rec():
    """Fresh flight recorder installed as the process default."""
    r = FlightRecorder()
    prev = obs.set_default_recorder(r)
    try:
        yield r
    finally:
        obs.set_default_recorder(prev)


@pytest.fixture(scope="module")
def lms():
    """(JAX LM, the port's LM on its weights, CPU)."""
    import jax

    from bigdl_tpu.models.transformer import TransformerLM as JaxLM
    from bigdl_tpu.utils import random as rnd
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.utils.weights import load_jax_params

    rnd.set_seed(23)
    jm = JaxLM(32, embed_dim=16, num_heads=4, num_kv_heads=2,
               num_layers=2, max_len=48, use_rope=True)
    jm.evaluate()
    tm = TransformerLM(32, embed_dim=16, num_heads=4, num_kv_heads=2,
                       num_layers=2, max_len=48, use_rope=True,
                       device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    tm.evaluate()
    return jm, tm


@pytest.fixture(scope="module")
def lm(lms):
    return lms[1]


# ------------------------------------------------------------ ring buffer
class TestRecorder:
    def test_ring_bounds_and_total(self):
        r = FlightRecorder(capacity=8)
        for i in range(20):
            r.record("k", "req-x", i=i)
        assert len(r) == 8
        assert r.total == 20
        # the ring keeps the NEWEST events
        assert [e.attrs["i"] for e in r.tail()] == list(range(12, 20))
        assert [e.attrs["i"] for e in r.tail(3)] == [17, 18, 19]
        assert r.tail(0) == []  # not out[-0:] == everything

    def test_concurrent_writers_lose_nothing(self):
        r = FlightRecorder(capacity=10000)
        n_threads, per = 8, 500

        def writer(t):
            for i in range(per):
                r.record("w", f"req-{t}", i=i)

        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert r.total == n_threads * per
        assert len(r) == n_threads * per
        # seq is a gap-free total order even under contention
        seqs = [e.seq for e in r.tail()]
        assert sorted(seqs) == list(range(1, n_threads * per + 1))
        # per-writer order is preserved through the shared ring
        for t in range(n_threads):
            idx = [e.attrs["i"] for e in r.for_request(f"req-{t}")]
            assert idx == list(range(per))

    def test_disabled_recorder_is_noop(self):
        r = FlightRecorder(capacity=8, enabled=False)
        assert r.record("k") is None
        assert len(r) == 0 and r.total == 0
        r.enable()
        assert r.record("k").seq == 1
        r.disable()
        r.record("k2")
        assert r.total == 1

    def test_obs_disable_covers_default_recorder(self, rec):
        obs.disable()
        try:
            obs.record("k", "req-1")
            assert len(rec) == 0
        finally:
            obs.enable()
        obs.record("k", "req-1")
        assert len(rec) == 1

    def test_jsonl_roundtrip(self, tmp_path):
        r = FlightRecorder()
        r.record("a", "req-1", x=1)
        r.record("b")
        p = str(tmp_path / "events.jsonl")
        text = r.to_jsonl(p)
        lines = [json.loads(ln) for ln in text.splitlines()]
        assert [ln["kind"] for ln in lines] == ["a", "b"]
        assert lines[0]["request_id"] == "req-1" and lines[0]["x"] == 1
        assert "request_id" not in lines[1]
        with open(p) as f:
            assert f.read() == text

    def test_percentile_summary(self):
        s = percentile_summary([])
        assert s["count"] == 0 and s["p99"] is None
        s = percentile_summary([0.1, None, 0.3, 0.2])
        assert s["count"] == 3
        assert s["p50"] == pytest.approx(0.2)
        assert s["mean"] == pytest.approx(0.2)
        assert s["p99"] == pytest.approx(0.3)


# -------------------------------------------------- engine event timelines
def _run_mixed(lm, rec_or_none=None, engine_cls=ContinuousBatchingEngine,
               **engine_kw):
    r = np.random.RandomState(3)
    reqs = [(r.randint(0, 32, (t0,)), n)
            for t0, n in [(5, 5), (9, 3), (3, 6), (7, 4)]]
    with engine_cls(lm, max_slots=2, prefill_chunk=4, **engine_kw) as eng:
        handles = [eng.submit(p, n) for p, n in reqs]
        rows = [h.result(timeout=120) for h in handles]
        stats = eng.stats()
        debug = eng.debug_requests()
    return reqs, handles, rows, stats, debug


def test_event_ordering_per_request(lms, reg, rec):
    """Each request's recorded arc, and the same arcs (kinds in order)
    and rows as the JAX engine's for the same requests and weights."""
    jm, lm = lms
    jrec = jobs.FlightRecorder()
    _, jhandles, jrows, jstats, _ = _run_mixed(
        jm, engine_cls=JaxEngine, recorder=jrec,
        registry=jobs.MetricRegistry())
    reqs, handles, rows, stats, _ = _run_mixed(lm)
    for a, b in zip(rows, jrows):
        np.testing.assert_array_equal(a, b)
    for h, jh in zip(handles, jhandles):
        assert [e.kind for e in rec.for_request(h.request_id)] == \
            [e.kind for e in jrec.for_request(jh.request_id)]
    for k in ("admitted", "finished", "evicted", "timed_out",
              "cancelled"):
        assert stats[k] == jstats[k], k
    assert stats["finished"] == len(reqs)
    for h, (p, n) in zip(handles, reqs):
        evs = rec.for_request(h.request_id)
        kinds = [e.kind for e in evs]
        # lifecycle arc: submitted first, finished last, phases between
        # in submission order
        assert kinds[0] == "request/submitted"
        assert kinds[-1] == "request/finished"
        order = [kinds.index("request/submitted"),
                 kinds.index("request/queued"),
                 kinds.index("request/admitted"),
                 kinds.index("request/prefill_chunk"),
                 kinds.index("request/first_token")]
        assert order == sorted(order)
        assert kinds.count("request/prefill_chunk") == -(-len(p) // 4)
        assert kinds.count("request/decode_token") == n - 1
        # timestamps are monotonically ordered within the request
        ts = [(e.ts, e.seq) for e in evs]
        assert ts == sorted(ts)
        # the handle surfaces the final breakdown
        tl = h.timeline()
        assert tl["tokens"] == n
        for phase in ("queue_wait_s", "prefill_s", "ttft_s",
                      "decode_s", "total_s"):
            assert tl[phase] is not None and tl[phase] >= 0.0
        assert tl["ttft_s"] == pytest.approx(
            tl["queue_wait_s"] + tl["prefill_s"])
    # stats() percentiles are fed by the same timelines
    lat = stats["latency"]
    assert lat["ttft"]["count"] == len(reqs)
    assert lat["ttft"]["p50"] > 0.0
    assert lat["queue_wait"]["count"] == len(reqs)


def test_recorder_disabled_engine_still_serves(lm, reg, rec):
    rec.disable()
    reqs, handles, rows, stats, _ = _run_mixed(lm)
    assert len(rec) == 0
    # the recorder going dark must not take the timelines with it —
    # handle timestamps (and stats percentiles) are recorder-independent
    assert stats["latency"]["ttft"]["count"] == len(reqs)
    for h, (p, n) in zip(handles, reqs):
        assert h.timeline()["tokens"] == n


# ------------------------------------------------------- chrome trace JSON
def test_chrome_trace_schema(lm, reg, rec, tmp_path):
    _run_mixed(lm)
    evs = obs.chrome_trace_events()
    assert evs, "trace must not be empty after a serving run"
    phases = {e["ph"] for e in evs}
    assert "M" in phases and "X" in phases and "i" in phases
    tid_names = {}
    for e in evs:
        # required fields, schema-checked (no wall-clock assertions)
        assert isinstance(e["name"], str) and e["name"]
        assert e["ph"] in ("M", "X", "i")
        assert isinstance(e["pid"], int)
        assert isinstance(e["tid"], int)
        if e["ph"] == "M":
            if e["name"] == "thread_name":
                tid_names[e["tid"]] = e["args"]["name"]
            continue
        assert isinstance(e["ts"], float)
        if e["ph"] == "X":
            assert e["dur"] >= 0.0
        if e["ph"] == "i":
            assert e["s"] == "t"
    # every non-meta event's track is named
    assert {e["tid"] for e in evs if e["ph"] != "M"} <= set(tid_names)
    # the engine's spans and the per-request instants are both present
    names = {e["name"] for e in evs}
    assert "serving/iteration" in names
    assert "request/submitted" in names
    # request ids ride in args and the file round-trips as JSON
    rids = {e["args"].get("request_id") for e in evs
            if e["ph"] == "i" and e["name"].startswith("request/")}
    assert any(r for r in rids)
    path = str(tmp_path / "trace.json")
    obs.write_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    assert doc["traceEvents"] and doc["displayTimeUnit"] == "ms"


# ----------------------------------------------------- /debug/* endpoints
def test_debug_endpoints_roundtrip(lm, reg, rec):
    r = np.random.RandomState(3)
    reqs = [(r.randint(0, 32, (t0,)), n)
            for t0, n in [(5, 5), (9, 3), (3, 6), (7, 4)]]
    with ContinuousBatchingEngine(lm, max_slots=2,
                                  prefill_chunk=4) as eng:
        for p, n in reqs:
            eng.submit(p, n).result(timeout=120)
        h = eng.submit(np.arange(1, 6, dtype=np.int32), 4)
        h.result(timeout=120)
        with obs.start_http_server(
                host="127.0.0.1", healthz=eng.healthz,
                debug_requests=eng.debug_requests) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            hz = json.loads(urllib.request.urlopen(
                f"{base}/healthz").read())
            assert hz["status"] == "ok" and hz["loop_alive"]

            dbg = json.loads(urllib.request.urlopen(
                f"{base}/debug/requests").read())
            assert dbg["service"] == "engine"
            assert dbg["recent"][-1]["request_id"] == h.request_id
            assert dbg["recent"][-1]["outcome"] == "finished"
            # the /debug TTFT breakdown agrees with the bdt_serving_*
            # TTFT histogram (same requests, same clock)
            ttft = dbg["latency"]["ttft"]
            hist = reg.get("bdt_serving_ttft_seconds") \
                .labels("engine").get()
            _, h_sum, h_count = hist
            assert ttft["count"] == h_count == len(reqs) + 1
            assert ttft["mean"] == pytest.approx(h_sum / h_count,
                                                 rel=0.02)

            evs = json.loads(urllib.request.urlopen(
                f"{base}/debug/events?n=10").read())
            assert len(evs["events"]) == 10
            assert evs["total"] == rec.total
            assert all("kind" in e and "ts_s" in e
                       for e in evs["events"])

            tr = json.loads(urllib.request.urlopen(
                f"{base}/debug/trace").read())
            assert any(e.get("name") == "request/finished"
                       for e in tr["traceEvents"])


def test_debug_requests_shows_in_flight(lm, reg, rec):
    with ContinuousBatchingEngine(lm, max_slots=1,
                                  prefill_chunk=4) as eng:
        h = eng.submit(np.arange(1, 5, dtype=np.int32), 24)
        # wait until it decodes, then snapshot mid-flight
        it = h.tokens()
        next(it)
        dbg = eng.debug_requests()
        states = {r["request_id"]: r for r in dbg["in_flight"]}
        assert h.request_id in states
        assert states[h.request_id]["state"] == "decoding"
        assert states[h.request_id]["tokens_delivered"] >= 1
        h.result(timeout=120)


# --------------------------------------------------- crash -> postmortem
def test_postmortem_on_injected_decode_crash(lm, reg, rec, tmp_path):
    pm_path = str(tmp_path / "pm.json")
    eng = ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                   postmortem_path=pm_path)

    def boom(*a, **k):
        raise RuntimeError("injected decode fault")

    eng._p_step = boom
    h = eng.submit(np.arange(1, 6, dtype=np.int32), 6)
    with pytest.raises(EngineStopped):
        h.result(timeout=120)

    with open(pm_path) as f:
        pm = json.load(f)
    assert pm["schema"] == "bigdl_postmortem/1"
    assert pm["error"]["type"] == "RuntimeError"
    assert "injected decode fault" in pm["error"]["message"]
    assert "injected decode fault" in pm["error"]["traceback"]
    # the in-flight request states were captured BEFORE teardown
    states = {r["request_id"]: r for r in pm["requests"]}
    assert h.request_id in states
    assert states[h.request_id]["state"] == "decoding"
    # the event tail tells the story up to the crash
    kinds = [e["kind"] for e in pm["events"]]
    assert "request/submitted" in kinds and "engine/crash" in kinds
    assert kinds.index("request/submitted") \
        < kinds.index("engine/crash")
    # metrics snapshot rode along
    assert any(m["name"] == "bdt_serving_admitted_total"
               for m in pm["metrics"])
    # the handle's terminal event says crashed
    assert [e.kind for e in rec.for_request(h.request_id)][-1] \
        == "request/crashed"

    # a crashed engine flips /healthz to 503
    with pytest.raises(EngineStopped):
        eng.healthz()
    with obs.start_http_server(host="127.0.0.1",
                               healthz=eng.healthz) as srv:
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz")
        assert exc.value.code == 503
        body = json.loads(exc.value.read())
        assert body["status"] == "unhealthy"
        assert "injected decode fault" in body["error"]

    # the pretty-printer renders the port's postmortem too
    import importlib.util
    import io
    import os
    import sys

    spec = importlib.util.spec_from_file_location(
        "dump_postmortem", os.path.join(
            os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))),
            "scripts", "dump_postmortem.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    old = sys.stdout
    sys.stdout = buf
    try:
        assert mod.main([pm_path]) == 0
    finally:
        sys.stdout = old
    text = buf.getvalue()
    assert "RuntimeError: injected decode fault" in text
    assert h.request_id in text


# ----------------------------------------------- tracer thread reclamation
def test_tracer_reclaims_short_lived_thread_stacks():
    tr = obs.Tracer(max_roots=512)

    def worker(i):
        with tr.span(f"req/{i}"):
            with tr.span("inner"):
                pass

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(64)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # one thread per request must not grow per-thread state forever:
    # every stack was dropped when its last span closed
    assert tr._live == {}
    assert tr.open_spans() == []
    assert len(tr.roots()) == 64

    # open spans ARE visible while a thread is inside one
    gate = threading.Event()
    release = threading.Event()

    def holder():
        with tr.span("held"):
            gate.set()
            release.wait(5)

    t = threading.Thread(target=holder)
    t.start()
    assert gate.wait(5)
    names = [sp.name for sp in tr.open_spans()]
    assert "held" in names
    release.set()
    t.join()
    assert tr.open_spans() == []


# ----------------------------------------- batch services share the ids
def test_generation_service_timelines_and_batch_tags(lm, reg, rec):
    from bigdl_tpu_torch.optim import GenerationService

    svc = GenerationService(lm, max_batch=2, batch_timeout_ms=20.0,
                            bucket_tokens=4, prompt_bucket=4)
    r = np.random.RandomState(5)
    rows = [None] * 3
    errs = []

    def worker(i, p):
        try:
            rows[i] = svc.generate(p, 4)
        except Exception as e:  # pragma: no cover - surfaced below
            errs.append(e)

    threads = [threading.Thread(target=worker,
                                args=(i, r.randint(0, 32, (5,))))
               for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    s = svc.stats()
    assert s["served"] == 3
    lat = s["latency"]
    assert lat["ttft"]["count"] == 3 and lat["ttft"]["p50"] > 0
    assert lat["queue_wait"]["count"] == 3
    # every request's events arc submitted -> enqueue -> dispatch ->
    # finished under ONE id (the engine's vocabulary)
    rids = {e.request_id for e in rec.tail()
            if e.kind == "request/submitted"}
    assert len(rids) == 3
    for rid in rids:
        kinds = [e.kind for e in rec.for_request(rid)]
        assert kinds == ["request/submitted", "batch/enqueue",
                        "batch/dispatch", "request/finished"]


# ---------------------------------------------------- the port's hazards
def test_sticky_cuda_error_is_reraised_after_the_postmortem(lm, reg, rec,
                                                            tmp_path,
                                                            monkeypatch):
    """A CUDA error in a dispatch (sticky on the card) still writes the
    postmortem and the crash incident from host state, fails the
    handles and answers 503 — and then leaves the loop thread as an
    exception instead of being swallowed."""
    import threading as _threading

    seen = []
    monkeypatch.setattr(_threading, "excepthook",
                        lambda args: seen.append(args.exc_value))
    pm_path = str(tmp_path / "pm.json")
    eng = ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                   postmortem_path=pm_path,
                                   incident_dir=str(tmp_path / "inc"))

    def boom(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    eng._p_step = boom
    h = eng.submit(np.arange(1, 6, dtype=np.int32), 6)
    with pytest.raises(EngineStopped):
        h.result(timeout=120)
    eng._thread.join(timeout=30)
    assert not eng._thread.is_alive()
    assert [type(e) for e in seen] == [RuntimeError]
    assert "illegal memory access" in str(seen[0])
    with open(pm_path) as f:
        assert "illegal memory access" in json.load(f)["error"]["message"]
    inc = eng.debug_incidents()
    assert inc["by_kind"].get("crash") == 1
    with pytest.raises(EngineStopped):
        eng.healthz()
    # a plain fault is not re-raised: the loop ends quietly
    seen.clear()
    eng2 = ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                    postmortem_path=pm_path)
    eng2._p_step = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("plain fault"))
    with pytest.raises(EngineStopped):
        eng2.submit(np.arange(1, 6, dtype=np.int32), 3).result(timeout=120)
    eng2._thread.join(timeout=30)
    assert seen == []


def test_debug_readers_race_the_loop(lm, reg, rec):
    """/debug readers on other threads while the loop writes: the
    timeline ring's lock and the recorder's hold (no reader raises, the
    ring never tears), under a short switch interval."""
    import sys

    errors = []
    stop = threading.Event()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                      recent_timelines=4) as eng:
            def reader():
                while not stop.is_set():
                    try:
                        eng.debug_requests()
                        eng.stats()
                        rec.snapshot(64)
                        obs.chrome_trace_events(recorder=rec)
                    except Exception as e:   # surfaced below
                        errors.append(e)
                        return

            readers = [threading.Thread(target=reader) for _ in range(4)]
            for t in readers:
                t.start()
            r = np.random.RandomState(8)
            hs = [eng.submit(r.randint(0, 32, (5,)), 4) for _ in range(12)]
            for h in hs:
                h.result(timeout=120)
            stop.set()
            for t in readers:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in readers)
            assert len(eng.debug_requests()["recent"]) == 4
    finally:
        sys.setswitchinterval(old)
        stop.set()
    assert errors == []
