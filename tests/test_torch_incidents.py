"""The port's incident autopilot (bigdl_tpu_torch/observability/anomaly.py
and incidents.py): online anomaly detectors, phase-attributed exemplars,
incident bundles, and the engine/HTTP wiring, case for case with the
non-fleet cases of tests/test_incidents.py (the JAX engine cases are
marked slow there; the port's run here, on a small model), plus the
detectors and the classifier against the JAX package's on the same
inputs, and the chaos burn's synthetic budget spend."""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

import torch

from bigdl_tpu.observability import anomaly as janomaly
from bigdl_tpu.observability import incidents as jincidents
from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch.observability.anomaly import (
    DetectorBank, EwmaZScoreDetector, RateOfChangeDetector,
    StallDetector, ThresholdDetector,
)
from bigdl_tpu_torch.observability.incidents import (
    IncidentManager, classify_timeline, load_incident,
)
from bigdl_tpu_torch.serving import (
    ChaosInjector, ContinuousBatchingEngine, EngineStopped,
)


@pytest.fixture()
def reg():
    """A fresh registry installed as the process default for the test
    (integrations resolve the default at use time)."""
    r = obs.MetricRegistry()
    prev = obs.set_default_registry(r)
    try:
        yield r
    finally:
        obs.set_default_registry(prev)
        obs.enable()


@pytest.fixture()
def rec():
    """A fresh flight recorder installed as the process default."""
    r = obs.FlightRecorder(capacity=256)
    prev = obs.set_default_recorder(r)
    try:
        yield r
    finally:
        obs.set_default_recorder(prev)


def _tiny_model():
    from bigdl_tpu_torch.models.transformer import TransformerLM

    torch.manual_seed(0)
    m = TransformerLM(64, embed_dim=32, num_heads=4, num_layers=2,
                      max_len=64, device="cpu")
    m.evaluate()
    return m


# ------------------------------------------------------------- detectors
class TestDetectors:
    def test_threshold_warmup_suppresses_early_breaches(self):
        d = ThresholdDetector("q", threshold=5.0, sustain=1, warmup=3)
        # the first `warmup` samples never fire, breach or not
        assert d.observe(1.0, 100.0) is None
        assert d.observe(2.0, 100.0) is None
        assert d.observe(3.0, 100.0) is None
        t = d.observe(4.0, 100.0)
        assert t is not None and t["kind"] == "anomaly"

    def test_threshold_sustain_needs_consecutive_breaches(self):
        d = ThresholdDetector("q", threshold=5.0, sustain=3)
        assert d.observe(1.0, 9.0) is None
        assert d.observe(2.0, 9.0) is None
        t = d.observe(3.0, 9.0)
        assert t is not None
        # a calm sample resets the streak
        d2 = ThresholdDetector("q", threshold=5.0, sustain=3)
        d2.observe(1.0, 9.0)
        d2.observe(2.0, 1.0)
        d2.observe(3.0, 9.0)
        assert d2.observe(4.0, 9.0) is None

    def test_hysteresis_clears_after_consecutive_calm(self):
        d = ThresholdDetector("q", threshold=5.0, sustain=1,
                              clear_after=2, cooldown_s=0.0)
        assert d.observe(1.0, 9.0) is not None
        assert d.state == "firing"
        d.observe(2.0, 1.0)
        assert d.state == "firing"  # one calm sample is not enough
        d.observe(3.0, 1.0)
        assert d.state == "ok"
        # the next breach is a fresh rising edge
        assert d.observe(4.0, 9.0) is not None

    def test_detector_cooldown_dedupes_rising_edges(self):
        d = ThresholdDetector("q", threshold=5.0, sustain=1,
                              clear_after=1, cooldown_s=1000.0)
        assert d.observe(1.0, 9.0) is not None
        d.observe(2.0, 1.0)          # clears
        assert d.state == "ok"
        # re-fires inside the cooldown: edge detected but suppressed
        assert d.observe(3.0, 9.0) is None
        assert d.state == "firing"

    def test_ewma_zscore_fires_on_spike_not_on_steady(self):
        d = EwmaZScoreDetector("mfu", threshold=4.0, warmup=10)
        for i in range(40):
            assert d.observe(float(i), 10.0 + 0.1 * (i % 3)) is None
        t = d.observe(41.0, 500.0)
        assert t is not None and t["kind"] == "anomaly"
        assert t["score"] > 4.0

    def test_rate_of_change(self):
        d = RateOfChangeDetector("depth", max_rate=10.0, warmup=2)
        assert d.observe(1.0, 0.0) is None
        assert d.observe(2.0, 1.0) is None   # warmup
        assert d.observe(3.0, 2.0) is None   # 1/s, calm
        t = d.observe(4.0, 500.0)
        assert t is not None and t["kind"] == "anomaly"
        assert t["score"] > 10.0

    def test_non_finite_samples_are_skipped(self):
        d = ThresholdDetector("q", threshold=5.0, sustain=1, warmup=0)
        assert d.observe(1.0, float("nan")) is None
        assert d.observe(2.0, float("inf")) is None
        assert d.state == "ok"  # skipped samples never transition

    def test_stall_detector_fires_once_per_freeze(self):
        d = StallDetector(threshold=3, cooldown_s=1000.0)
        fired = []
        for i in range(10):
            fired.extend(d.observe_iteration(
                float(i), live=[0], advanced=[]))
        assert len(fired) == 1
        assert fired[0]["kind"] == "stall"
        # progress resets the streak and the state
        d.observe_iteration(11.0, live=[0], advanced=[0])
        assert d.state == "ok"

    def test_bank_routes_alerts_and_dedupes(self):
        bank = DetectorBank(alert_cooldown_s=1000.0)
        a = {"alert": "slo:ttft_burn", "severity": "critical"}
        t1 = bank.alert_triggers([a], now=1.0)
        assert len(t1) == 1 and t1[0]["kind"] == "slo"
        assert bank.alert_triggers([a], now=2.0) == []  # cooldown
        r = {"alert": "recompile_storm", "severity": "warning"}
        t2 = bank.alert_triggers([r], now=3.0)
        assert len(t2) == 1 and t2[0]["kind"] == "recompile"

    def test_bank_observe_drain(self):
        bank = DetectorBank([ThresholdDetector(
            "q", threshold=5.0, sustain=1)])
        bank.observe("other_metric", 1.0, 99.0)  # not subscribed
        bank.observe("q", 2.0, 99.0)
        drained = bank.drain()
        assert len(drained) == 1
        assert bank.drain() == []


# ------------------------------------------------------ classification
class TestClassify:
    def test_flags_outrank_durations(self):
        assert classify_timeline(
            {"preempted": 1, "queue_wait_s": 9.0}) == "preempted"
        assert classify_timeline(
            {"page_waited": True, "decode_s": 9.0}) == "page_wait-bound"

    def test_dominant_phase_wins(self):
        assert classify_timeline(
            {"queue_wait_s": 5.0, "prefill_s": 1.0,
             "decode_s": 0.5}) == "queue-bound"
        assert classify_timeline(
            {"queue_wait_s": 0.1, "prefill_s": 5.0,
             "decode_s": 0.5}) == "prefill-bound"
        assert classify_timeline(
            {"queue_wait_s": 0.1, "prefill_s": 0.2,
             "decode_s": 5.0}) == "decode-bound"

    def test_empty_timeline_defaults_decode(self):
        assert classify_timeline({}) == "decode-bound"


# ---------------------------------------------------- incident manager
class TestIncidentManager:
    def _trigger(self, kind="slo"):
        return {"detector": "t", "metric": "m", "kind": kind,
                "reason": "r", "ts_s": 1.0, "value": 9.0, "score": 2.0}

    def test_capture_dedupe_and_counts(self, reg, rec):
        im = IncidentManager("svc", cooldown_s=1000.0)
        b = im.capture(self._trigger())
        assert b is not None and b["kind"] == "slo"
        assert im.capture(self._trigger()) is None  # same-kind cooldown
        assert im.capture(self._trigger("stall")) is not None
        assert im.counts_by_kind() == {"slo": 1, "stall": 1}
        assert im.total == 2
        # every trigger (even the deduped one) is in the history
        assert len(im.history()) == 3
        # the counter instrument matches
        fam = {m.name: m for m in reg.collect()}
        assert "bdt_serving_incidents_total" in fam

    def test_exemplars_ranked_and_attributed(self, reg, rec):
        im = IncidentManager("svc", exemplars=2)
        tls = [{"request_id": f"r{i}", "total_s": float(i),
                "queue_wait_s": 0.1, "prefill_s": float(i),
                "decode_s": 0.1, "tokens": 4} for i in range(5)]
        b = im.capture(self._trigger(), timelines=tls)
        exs = b["exemplars"]
        assert [e["request_id"] for e in exs] == ["r4", "r3"]
        assert all(e["phase"] == "prefill-bound" for e in exs)

    def test_disk_ring_bounded_and_loadable(self, reg, rec, tmp_path):
        d = str(tmp_path / "inc")
        im = IncidentManager("svc", dirpath=d, capacity=2,
                             cooldown_s=0.0)
        for i in range(4):
            assert im.capture(self._trigger(f"k{i}")) is not None
        files = sorted(n for n in os.listdir(d)
                       if n.startswith("incident-"))
        assert len(files) == 2  # pruned to capacity
        bundle = load_incident(os.path.join(d, files[-1]))
        assert bundle["kind"] == "k3"
        assert bundle["schema"] == obs.INCIDENT_SCHEMA
        # the JSONL index keeps the full history
        with open(os.path.join(d, "incidents.jsonl")) as f:
            assert len(f.readlines()) == 4

    def test_windowed_event_slice(self, reg, rec):
        rec.record("old/event")
        time.sleep(0.25)
        rec.record("new/event")
        # window covers the fresh event but not the 0.25s-old one
        im = IncidentManager("svc", window_s=0.1)
        b = im.capture(self._trigger())
        kinds = [e["kind"] for e in b["events"]]
        assert "new/event" in kinds and "old/event" not in kinds

    def test_config_digest_stable(self, reg, rec):
        im = IncidentManager("svc", config={"max_slots": 2, "a": 1})
        im2 = IncidentManager("svc", config={"a": 1, "max_slots": 2})
        b1 = im.capture(self._trigger())
        b2 = im2.capture(self._trigger())
        assert b1["config_digest"]["sha256"] \
            == b2["config_digest"]["sha256"]


# ----------------------------------------------------- recorder window
class TestRecorderWindow:
    def test_window_filters_by_time(self, rec):
        rec.record("a")
        time.sleep(0.02)
        t0 = time.monotonic()
        rec.record("b")
        rec.record("c")
        kinds = [e.kind for e in rec.window(t0)]
        assert kinds == ["b", "c"]
        snap = rec.window_snapshot(t0, limit=1)
        assert [e["kind"] for e in snap] == ["c"]  # newest kept

    def test_postmortem_window_param(self, reg, rec):
        rec.record("early")
        time.sleep(0.25)
        rec.record("late")
        pm = obs.build_postmortem(
            recorder=rec, registry=reg, window_s=0.1)
        assert [e["kind"] for e in pm["events"]] == ["late"]
        # window_s=None keeps the old last-N behavior
        pm2 = obs.build_postmortem(recorder=rec, registry=reg)
        assert len(pm2["events"]) == 2


# ------------------------------------------------------- engine wiring
class TestEngineIncidents:
    def test_chaos_burn_captures_slo_incident(self, reg, rec):
        chaos = ChaosInjector()
        model = _tiny_model()
        with ContinuousBatchingEngine(
                model, max_slots=1, max_len=64, prefill_chunk=8,
                chaos=chaos, service_name="t-inc") as eng:
            eng.submit(np.arange(1, 7), 2).result(timeout=120)
            chaos.force_burn(active=True, severe=True)
            eng.submit(np.arange(1, 9), 4).result(timeout=120)
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                if eng.debug_incidents()["count"]:
                    break
                time.sleep(0.1)
            chaos.force_burn(active=False)
            d = eng.debug_incidents()
            assert d["by_kind"].get("slo") == 1
            b = d["incidents"][0]
            assert b["service"] == "t-inc"
            assert b["trigger"]["kind"] == "slo"
            assert all(e["phase"] in
                       ("queue-bound", "prefill-bound",
                        "page_wait-bound", "preempted", "decode-bound")
                       for e in b["exemplars"])
            # stats() and the dashboard surface the tally
            assert eng.stats()["incidents"]["count"] == 1
            assert "incident" in eng.dashboard()
            threads = [eng._thread, eng._ts._thread]
        # no leaked sampler/loop threads after stop() (held by identity:
        # other tests' engines may share the process)
        time.sleep(0.2)
        assert [t.name for t in threads] == ["serving-engine",
                                             "bdt-timeseries"]
        assert not any(t.is_alive() for t in threads)

    def test_freeze_captures_stall_incident(self, reg, rec):
        chaos = ChaosInjector()
        model = _tiny_model()
        with ContinuousBatchingEngine(
                model, max_slots=1, max_len=64, prefill_chunk=8,
                chaos=chaos, service_name="t-stall",
                anomaly_detectors=DetectorBank(
                    stall=StallDetector(threshold=5))) as eng:
            chaos.freeze_slot(0, iterations=15)
            eng.submit(np.arange(1, 9), 4).result(timeout=120)
            d = eng.debug_incidents()
            assert d["by_kind"].get("stall") == 1
            assert "not advancing" in d["incidents"][0]["reason"]

    def test_crash_captures_crash_incident(self, reg, rec):
        chaos = ChaosInjector()
        model = _tiny_model()
        with ContinuousBatchingEngine(
                model, max_slots=1, max_len=64, prefill_chunk=8,
                chaos=chaos, service_name="t-crash") as eng:
            chaos.fail_dispatch(nth=1)
            h = eng.submit(np.arange(1, 9), 4)
            with pytest.raises(EngineStopped):
                h.result(timeout=120)
        d = eng.debug_incidents()
        assert d["by_kind"].get("crash") == 1
        assert d["incidents"][0]["error"]["type"] == "ChaosFault"

    def test_disabled_registry_is_a_noop(self, reg, rec):
        """With the registry disabled the sampler never appends, so
        sampler-driven detectors never observe — even one that would
        fire on its very first sample stays silent."""
        reg.disable()
        hair_trigger = ThresholdDetector(
            "queue_depth", threshold=-1.0, sustain=1, warmup=0,
            name="always-on")
        model = _tiny_model()
        with ContinuousBatchingEngine(
                model, max_slots=1, max_len=64, prefill_chunk=8,
                anomaly_detectors=DetectorBank([hair_trigger]),
                service_name="t-off") as eng:
            eng.submit(np.arange(1, 9), 4).result(timeout=120)
            time.sleep(1.5)  # would be plenty for a capture when on
            assert eng.debug_incidents()["count"] == 0
            assert hair_trigger._seen == 0  # never even sampled

    def test_debug_incidents_http_roundtrip(self, reg, rec):
        chaos = ChaosInjector()
        model = _tiny_model()
        with ContinuousBatchingEngine(
                model, max_slots=1, max_len=64, prefill_chunk=8,
                chaos=chaos, service_name="t-http") as eng:
            chaos.force_burn(active=True, severe=True)
            eng.submit(np.arange(1, 9), 4).result(timeout=120)
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                if eng.debug_incidents()["count"]:
                    break
                time.sleep(0.1)
            chaos.force_burn(active=False)
            srv = obs.start_http_server(
                port=0, registry=reg,
                debug_incidents=eng.debug_incidents)
            try:
                body = json.loads(urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}"
                    "/debug/incidents?n=1", timeout=10).read())
            finally:
                srv.close()
            assert body["count"] >= 1
            assert len(body["incidents"]) == 1
            assert body["incidents"][0]["kind"] == "slo"


# --------------------------------------------------- against the JAX code
def test_detectors_match_jax_on_the_same_samples():
    """The four detectors and the bank, fed one seeded sample stream,
    fire the JAX package's triggers at the same samples (kinds, scores
    within 1e-9) and end in the same states."""
    rs = np.random.RandomState(7)
    xs = np.concatenate([rs.normal(10.0, 0.3, 60), [80.0, 90.0],
                         rs.normal(10.0, 0.3, 30), [np.nan, 500.0]])

    def build(mod):
        return [mod.ThresholdDetector("q", threshold=12.0, sustain=2,
                                      clear_after=3, cooldown_s=0.0),
                mod.EwmaZScoreDetector("q", threshold=4.0, warmup=10,
                                       cooldown_s=0.0),
                mod.RateOfChangeDetector("q", max_rate=20.0, warmup=2,
                                         cooldown_s=0.0)]

    ours, theirs = build(obs), build(janomaly)
    for i, x in enumerate(xs):
        for a, b in zip(ours, theirs):
            ta, tb = a.observe(float(i), float(x)), b.observe(float(i),
                                                              float(x))
            assert (ta is None) == (tb is None), (i, a.name)
            if ta is not None:
                assert ta["kind"] == tb["kind"]
                assert ta["score"] == pytest.approx(tb["score"], abs=1e-9)
    assert [d.state for d in ours] == [d.state for d in theirs]
    st, jst = StallDetector(threshold=3), janomaly.StallDetector(
        threshold=3)
    for i in range(8):
        adv = [0] if i % 5 == 4 else []
        assert len(st.observe_iteration(float(i), live=[0], advanced=adv)) \
            == len(jst.observe_iteration(float(i), live=[0],
                                         advanced=adv))
    alerts = [{"alert": "slo:ttft", "severity": "critical"},
              {"alert": "recompile_storm", "severity": "warning"}]
    ta = DetectorBank().alert_triggers(alerts, now=1.0)
    tb = janomaly.DetectorBank().alert_triggers(alerts, now=1.0)
    assert [t["kind"] for t in ta] == [t["kind"] for t in tb]
    assert sorted(obs.default_detector_bank().states()) == sorted(
        janomaly.default_detector_bank().states())


@pytest.mark.parametrize("tl", [
    {"preempted": 1, "queue_wait_s": 9.0},
    {"page_waited": True, "decode_s": 9.0},
    {"queue_wait_s": 5.0, "prefill_s": 1.0, "decode_s": 0.5},
    {"queue_wait_s": 0.1, "prefill_s": 5.0, "decode_s": 0.5},
    {"queue_wait_s": 0.1, "prefill_s": 0.2, "decode_s": 5.0},
    {"queue_wait_s": None, "prefill_s": 0.2},
    {},
])
def test_classify_matches_jax(tl):
    assert classify_timeline(tl) == jincidents.classify_timeline(tl)


def test_chaos_burn_spends_the_error_budget(reg, rec):
    """A chaos burn drill spends the TTFT objective's error budget
    synthetically (``SloBudgetTracker.sample(forced=True)``): the budget
    left falls below 1 and the gauge carries it, while no request
    violated the objective."""
    chaos = ChaosInjector()
    model = _tiny_model()
    with ContinuousBatchingEngine(
            model, max_slots=1, max_len=64, prefill_chunk=8, chaos=chaos,
            service_name="t-budget",
            slo_objectives=[dict(name="ttft_slo", metric="ttft",
                                 threshold_s=60.0, target=0.9,
                                 window_s=600.0, min_count=1)]) as eng:
        eng.submit(np.arange(1, 7), 2).result(timeout=120)
        gauge = reg.get("bdt_slo_budget_remaining").labels(
            "ttft_slo", "t-budget")
        chaos.force_burn(active=True, severe=True)
        # the drill spends budget per second of burn: keep it burning
        # across requests until the spend shows in the state block's
        # 4 decimals (a fast host serves one request in milliseconds)
        deadline = time.monotonic() + 60.0
        while True:
            eng.submit(np.arange(1, 9), 6).result(timeout=120)
            if gauge.get() < 1.0 - 1e-3 or time.monotonic() > deadline:
                break
        chaos.force_burn(active=False)
        state = eng.stats()["slo_budget"]
    row = [o for o in state["objectives"] if o["objective"] == "ttft_slo"]
    assert row and row[0]["budget_remaining"] < 1.0, state
    # the state block rounds to 4 decimals, the gauge does not
    assert gauge.get() == pytest.approx(
        row[0]["budget_remaining"], abs=1e-4)
