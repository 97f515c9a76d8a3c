"""The port's device-resource observability, case for case with
tests/test_resource_observability.py (its metrics-lint cases are the
tree's, run there): memory accounting + pool attribution
(``observability/memory.py``), on-demand profiler capture
(``profiler.py``), recompile/SLO watchdogs (``watchdog.py``), their
engine wiring (pools registered, queue-wait histogram, alerts in
``stats()``/degraded ``/healthz``), the ``/debug/memory`` +
``/debug/profile`` endpoints, and the metrics lint.

The acceptance arc under test: an injected recompile storm and a
synthetic SLO breach each produce a flight-recorder alert event, a
Prometheus alert gauge, and a ``degraded`` healthz body (still HTTP
200 — 503 stays reserved for a crashed loop); ``/debug/memory``
attributes HBM to the KV slot pool, prefill staging, prefix pool, and
params by name; pool gauges move when KV is donated into the prefix
pool. On the CPU the monitor's device fields are None (the CPU reports
no device memory); the pools are the same. Then the waiting cases of the
paged, tiered, quantized and speculative files that needed the registry,
the recorder or the memory pools, and the hazards: telemetry adds no
host read to the engine's iteration, a profile capture records the
loop thread's launches, the sweep's ``jit_flat``, the two-tier pools.
"""

import gc
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import torch

from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch.observability import memory as obs_memory
from bigdl_tpu_torch.observability import profiler
from bigdl_tpu_torch.observability.events import FlightRecorder
from bigdl_tpu_torch.observability.watchdog import (
    RecompileWatchdog, SloObjective, SloWatchdog,
)
from bigdl_tpu_torch.serving import ContinuousBatchingEngine


@pytest.fixture()
def reg():
    r = obs.MetricRegistry()
    prev = obs.set_default_registry(r)
    try:
        yield r
    finally:
        obs.set_default_registry(prev)
        obs.enable()


@pytest.fixture()
def rec():
    r = FlightRecorder()
    prev = obs.set_default_recorder(r)
    try:
        yield r
    finally:
        obs.set_default_recorder(prev)


@pytest.fixture(scope="module")
def lm():
    from bigdl_tpu_torch.models.transformer import TransformerLM

    torch.manual_seed(29)
    m = TransformerLM(32, embed_dim=16, num_heads=4, num_kv_heads=2,
                      num_layers=2, max_len=48, use_rope=True, device="cpu")
    m.evaluate()
    return m


# --------------------------------------------------------- pool registry
class TestPoolRegistry:
    def test_register_and_tree_bytes(self):
        tree = {"a": torch.ones((4, 8), dtype=torch.float32),
                "b": [torch.ones((2,), dtype=torch.int32), None]}
        assert obs_memory.tree_bytes(tree) == 4 * 8 * 4 + 2 * 4
        assert obs_memory.tree_bytes(None) == 0
        lin = torch.nn.Linear(3, 2)
        assert obs_memory.tree_bytes(lin) == (3 * 2 + 2) * 4
        assert obs_memory.tree_device_bytes(tree) == \
            obs_memory.tree_bytes(tree)

        name = obs_memory.register_pool("t/static", lambda: 42)
        try:
            assert "t/static" in obs_memory.registered_pools()
            assert obs_memory.pool_sizes()["t/static"] == 42
        finally:
            obs_memory.unregister_pool(name)
        assert "t/static" not in obs_memory.registered_pools()
        # a raising (or non-int) pool is skipped THIS sample but stays
        # registered — transient errors must not delete attribution
        obs_memory.register_pool("t/broken", lambda: 1 // 0)
        obs_memory.register_pool("t/notint", lambda: "nope")
        sizes = obs_memory.pool_sizes()
        assert "t/broken" not in sizes and "t/notint" not in sizes
        assert "t/broken" in obs_memory.registered_pools()
        obs_memory.unregister_pool("t/broken")
        obs_memory.unregister_pool("t/notint")
        # fn-guarded unregister: the wrong fn is a no-op
        fn = lambda: 5  # noqa: E731
        obs_memory.register_pool("t/guarded", fn)
        obs_memory.unregister_pool("t/guarded", lambda: 6)
        assert "t/guarded" in obs_memory.registered_pools()
        obs_memory.unregister_pool("t/guarded", fn)
        assert "t/guarded" not in obs_memory.registered_pools()
        with pytest.raises(ValueError):
            obs_memory.register_pool("", lambda: 0)
        with pytest.raises(TypeError):
            obs_memory.register_pool("t/x", 7)

    def test_weak_owner_pools_pruned_after_collection(self):
        class Owner:
            bytes = 99

        o = Owner()
        obs_memory.register_owned_pools(o, {"t/weak": lambda s: s.bytes})
        assert obs_memory.pool_sizes()["t/weak"] == 99
        del o
        gc.collect()
        # the registration held only a weakref: the pool self-prunes
        assert "t/weak" not in obs_memory.pool_sizes()
        assert "t/weak" not in obs_memory.registered_pools()


# --------------------------------------------------------- memory monitor
def test_memory_monitor_sample_gauges_and_watermark(reg, rec):
    mon = obs.DeviceMemoryMonitor(registry=reg, history=4)
    obs_memory.register_pool("t/mon", lambda: 1000)
    try:
        s = mon.sample()
    finally:
        obs_memory.unregister_pool("t/mon")
    assert s["devices"], "at least one local device"
    d0 = s["devices"][0]
    # the CPU reports no device memory: the device fields are None, the
    # device gauges unset; the pools are attributed all the same
    assert d0["platform"] == "cpu" and d0["source"] == "none"
    assert d0["bytes_in_use"] is None and d0["limit_bytes"] is None
    assert s["bytes_in_use"] is None
    assert s["pools"]["t/mon"] == 1000
    # gauges landed in THIS registry under the canonical names
    assert reg.get("bdt_device_hbm_bytes_in_use").children() == []
    assert reg.get("bdt_device_pool_bytes") \
        .labels("t/mon").get() == 1000
    # a pool that disappears is zeroed on the next sample, and the
    # ring + high watermark accumulate
    s2 = mon.sample()
    assert "t/mon" not in s2["pools"]
    assert reg.get("bdt_device_pool_bytes").labels("t/mon").get() == 0
    dbg = mon.debug_memory()
    # without device figures the watermark follows the pools' sum
    assert dbg["peak_bytes"] >= s["pool_bytes_total"] >= 1000
    assert dbg["peak"] is not None
    assert 1 <= len(dbg["history"]) <= 4
    assert {"ts", "bytes_in_use", "pools"} <= set(dbg["history"][0])
    # the watermark left a recorder event
    assert any(e.kind == "memory/high_watermark" for e in rec.tail())


# ------------------------------------------------------ recompile watchdog
def test_recompile_watchdog_storm_fires_and_clears(reg, rec):
    compiles = [0]
    wd = RecompileWatchdog(lambda: compiles[0], service="t",
                           warmup_growths=2, window=16, storm_growths=3,
                           clear_after=4, registry=reg, recorder=rec)
    # warmup growths are free: no alert however fast they come
    for _ in range(3):
        compiles[0] += 1
        assert wd.sample() is False
    # post-warmup growth keeps happening -> storm
    fired_at = None
    for i in range(4):
        compiles[0] += 1
        if wd.sample():
            fired_at = i
            break
    assert fired_at is not None and wd.active
    alert = wd.alert()
    assert alert["alert"] == "recompile_storm"
    assert alert["severity"] == "critical"
    assert reg.get("bdt_watchdog_alert_active") \
        .labels("recompile_storm", "t").get() == 1
    assert any(e.kind == "watchdog/recompile_storm" for e in rec.tail())
    # stable compiles for clear_after samples -> alert clears
    for _ in range(6):
        wd.sample()
    assert not wd.active and wd.alert() is None
    assert reg.get("bdt_watchdog_alert_active") \
        .labels("recompile_storm", "t").get() == 0
    assert any(e.kind == "watchdog/recompile_cleared"
               for e in rec.tail())
    # a broken probe is survivable
    bad = RecompileWatchdog(lambda: 1 // 0, registry=reg, recorder=rec)
    assert bad.sample() is False


def test_recompile_watchdog_clear_after_exceeds_window(reg, rec):
    """clear_after > window must hold the alert for the full quiet
    interval — window-pruned storm marks are detection state, not the
    clear countdown."""
    compiles = [0]
    wd = RecompileWatchdog(lambda: compiles[0], service="t2",
                           warmup_growths=0, window=4, storm_growths=2,
                           clear_after=10, registry=reg, recorder=rec)
    wd.sample()
    for _ in range(3):
        compiles[0] += 1
        wd.sample()
    assert wd.active
    # 9 quiet samples: past the window, still inside clear_after
    for _ in range(9):
        wd.sample()
    assert wd.active
    wd.sample()  # 10th quiet sample: clears
    assert not wd.active


# ------------------------------------------------------------ slo watchdog
def test_slo_watchdog_burn_rate_synthetic_timelines(reg, rec):
    hist = reg.histogram("t_latency_seconds", "t",
                         buckets=(0.01, 0.1, 1.0))
    wd = SloWatchdog(service="t", registry=reg, recorder=rec)
    wd.watch(SloObjective("ttft_p90", threshold_s=0.1, target=0.9,
                          window_s=60.0, burn_threshold=2.0,
                          min_count=10), hist._only())
    t = 1000.0
    wd.sample(now=t)
    # healthy traffic: 5% violations < budget*burn_threshold (20%)
    for i in range(40):
        hist.observe(0.5 if i % 20 == 0 else 0.02)
    assert wd.sample(now=t + 10) is False
    # SLO-violating timelines: half the observations blow the threshold
    for i in range(40):
        hist.observe(0.5 if i % 2 == 0 else 0.02)
    assert wd.sample(now=t + 20) is True
    (alert,) = wd.alerts()
    assert alert["alert"] == "slo:ttft_p90"
    assert alert["burn_rate"] >= 2.0
    assert reg.get("bdt_watchdog_alert_active") \
        .labels("slo:ttft_p90", "t").get() == 1
    assert reg.get("bdt_watchdog_slo_burn_rate") \
        .labels("ttft_p90", "t").get() == pytest.approx(
            alert["burn_rate"], rel=0.01)
    assert any(e.kind == "watchdog/slo_burn" for e in rec.tail())
    # the violating window ages out under good traffic -> clears
    for _ in range(200):
        hist.observe(0.02)
    assert wd.sample(now=t + 100) is False
    assert wd.alerts() == []
    assert any(e.kind == "watchdog/slo_cleared" for e in rec.tail())
    assert reg.get("bdt_watchdog_alert_active") \
        .labels("slo:ttft_p90", "t").get() == 0


def test_slo_threshold_between_bucket_edges_rounds_pessimistic(reg, rec):
    """A threshold that is not a bucket edge must round DOWN to the
    previous edge (over-alerting), never up — a watchdog that counts
    2.2s observations as 'good' against a 2.0s objective would sit
    silent through a full breach."""
    hist = reg.histogram("t_mid_seconds", "t", buckets=(1.0, 2.5, 5.0))
    wd = SloWatchdog(service="t", registry=reg, recorder=rec)
    wd.watch(SloObjective("mid", threshold_s=2.0, target=0.9,
                          window_s=60.0, burn_threshold=2.0,
                          min_count=10), hist._only())
    wd.sample(now=500.0)
    for _ in range(20):
        hist.observe(2.2)  # violates the 2.0s objective
    assert wd.sample(now=510.0) is True
    assert wd.alerts()[0]["alert"] == "slo:mid"


def test_slo_objective_validation():
    with pytest.raises(ValueError):
        SloObjective("x", threshold_s=0.1, target=1.0)
    with pytest.raises(ValueError):
        SloObjective("x", threshold_s=0.0)
    with pytest.raises(ValueError):
        SloObjective("x", threshold_s=0.1, window_s=0)


# ------------------------------------------------- engine integration
@pytest.fixture(scope="module")
def engine_run(lm):
    """ONE shared engine + request mix for the integration assertions:
    a hair-trigger TTFT objective (every real request violates 1µs)
    makes the synthetic SLO breach, pools register at construction,
    donations populate the prefix pool."""
    mreg = obs.MetricRegistry()
    prev_reg = obs.set_default_registry(mreg)
    mrec = FlightRecorder()
    prev_rec = obs.set_default_recorder(mrec)
    eng = ContinuousBatchingEngine(
        lm, max_slots=2, prefill_chunk=4, service_name="resobs",
        slo_objectives=[dict(name="ttft_p99", metric="ttft",
                             threshold_s=1e-6, target=0.99,
                             window_s=600.0, min_count=2)])
    try:
        with eng:
            r = np.random.RandomState(11)
            handles = [eng.submit(r.randint(0, 32, (t0,)), n)
                       for t0, n in [(5, 4), (9, 3), (6, 4)]]
            for h in handles:
                h.result(timeout=120)
            yield eng, mreg, mrec, handles
    finally:
        obs.set_default_registry(prev_reg)
        obs.set_default_recorder(prev_rec)


def test_engine_pool_attribution_moves_on_donation(engine_run):
    eng, mreg, mrec, handles = engine_run
    sizes = obs_memory.pool_sizes()
    kv = sizes["serving/resobs/kv_slots"]
    assert kv == obs_memory.tree_bytes(eng._caches) > 0
    assert sizes["serving/resobs/prefill_staging"] \
        == obs_memory.tree_bytes(eng._staging) > 0
    assert sizes["serving/resobs/params"] > 0
    assert sizes["serving/resobs/prefix_pool"] == 2 * kv  # 2x slot rows
    # finished slots DONATED their KV: occupied prefix bytes moved off 0
    in_use = sizes["serving/resobs/prefix_kv_in_use"]
    assert in_use == eng._prefix.bytes_in_use > 0
    assert in_use <= sizes["serving/resobs/prefix_pool"]
    # and the monitor publishes the attribution as gauges
    mon = obs.DeviceMemoryMonitor(registry=mreg)
    mon.sample()
    assert mreg.get("bdt_device_pool_bytes") \
        .labels("serving/resobs/prefix_kv_in_use").get() == in_use


def test_engine_queue_wait_histogram(engine_run):
    eng, mreg, _, handles = engine_run
    _, total, count = mreg.get("bdt_serving_queue_wait_seconds") \
        .labels("resobs").get()
    assert count == len(handles)
    assert total >= 0.0


def test_engine_slo_breach_degrades_healthz(engine_run):
    eng, mreg, mrec, _ = engine_run
    alerts = eng.stats()["alerts"]
    slo = [a for a in alerts if a["alert"] == "slo:ttft_p99"]
    assert slo, alerts
    assert slo[0]["burn_rate"] >= 2.0
    hz = eng.healthz()
    assert hz["status"] == "degraded" and hz["alerts"]
    assert mreg.get("bdt_watchdog_alert_active") \
        .labels("slo:ttft_p99", "resobs").get() == 1
    assert any(e.kind == "watchdog/slo_burn" for e in mrec.tail())
    # degraded is 200-with-detail on the endpoint; 503 stays reserved
    # for a crashed loop
    with obs.start_http_server(host="127.0.0.1",
                               healthz=eng.healthz) as srv:
        resp = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/healthz")
        assert resp.status == 200
        body = json.loads(resp.read())
        assert body["status"] == "degraded"
        assert body["alerts"][0]["alert"] == "slo:ttft_p99"
    assert eng.debug_requests()["alerts"]


def test_debug_memory_endpoint_roundtrip(engine_run):
    eng, mreg, _, _ = engine_run
    mon = obs.DeviceMemoryMonitor(registry=mreg)
    with obs.start_http_server(host="127.0.0.1",
                               debug_memory=mon.debug_memory) as srv:
        doc = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/debug/memory").read())
    assert doc["now"]["devices"]
    assert doc["now"]["pools"]["serving/resobs/kv_slots"] \
        == obs_memory.tree_bytes(eng._caches)
    assert doc["peak_bytes"] >= 0 and doc["history"]
    # the default-monitor route answers too (no explicit monitor wired)
    with obs.start_http_server(host="127.0.0.1") as srv:
        doc = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/debug/memory").read())
        assert "now" in doc and doc["now"]["devices"]


def test_engine_injected_recompile_storm(engine_run):
    """Last in the shared-engine arc: swap in a hair-trigger watchdog
    over an injected ever-growing compile counter — post-warmup growth
    across loop iterations must raise the storm alert, its gauge, its
    recorder event, and degrade healthz."""
    eng, mreg, mrec, _ = engine_run
    fake = {"n": 0}

    def probe():
        fake["n"] += 1  # "every iteration compiled something new"
        return fake["n"]

    eng._recompile_wd = RecompileWatchdog(
        probe, service="resobs", warmup_growths=1, window=16,
        storm_growths=3, clear_after=1000, registry=mreg, recorder=mrec)
    h = eng.submit(np.arange(1, 6, dtype=np.int32), 8)
    h.result(timeout=120)
    alerts = eng.stats()["alerts"]
    storm = [a for a in alerts if a["alert"] == "recompile_storm"]
    assert storm, alerts
    assert eng.healthz()["status"] == "degraded"
    assert mreg.get("bdt_watchdog_alert_active") \
        .labels("recompile_storm", "resobs").get() == 1
    assert any(e.kind == "watchdog/recompile_storm"
               for e in mrec.tail())


def test_fresh_engine_stats_latency_never_raises(lm, reg, rec):
    """The percentile façade on a just-constructed engine (no requests,
    loop never started) reports count-0/None summaries instead of
    raising — and a fresh GenerationService does the same."""
    from bigdl_tpu_torch.optim import GenerationService

    eng = ContinuousBatchingEngine(lm, max_slots=1, prefill_chunk=4)
    s = eng.stats()
    for phase in ("queue_wait", "prefill", "ttft", "decode", "total"):
        assert s["latency"][phase]["count"] == 0
        assert s["latency"][phase]["p99"] is None
    assert s["alerts"] == []
    assert eng.debug_requests()["latency"]["ttft"]["p50"] is None
    svc = GenerationService(lm, max_batch=2)
    lat = svc.stats()["latency"]
    assert all(v["count"] == 0 and v["p50"] is None
               for v in lat.values())


# ---------------------------------------------------------- profiler
def test_profiler_capture_and_endpoint(reg, rec, tmp_path):
    try:
        path = profiler.capture(0.05, out_dir=str(tmp_path / "prof"))
    except profiler.ProfilerUnavailable as e:
        pytest.skip(f"profiler capture unsupported here: {e}")
    import os
    assert os.path.isdir(path)
    traces = [f for f in os.listdir(path) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    with open(os.path.join(path, traces[0])) as f:
        assert json.load(f)["traceEvents"] is not None
    kinds = [e.kind for e in rec.tail()]
    assert "profiler/capture_start" in kinds
    assert "profiler/capture_done" in kinds
    assert not profiler.capturing()

    with obs.start_http_server(host="127.0.0.1") as srv:
        base = f"http://127.0.0.1:{srv.port}"
        try:
            doc = json.loads(urllib.request.urlopen(
                f"{base}/debug/profile?seconds=0.05").read())
            assert os.path.isdir(doc["artifact"])
        except urllib.error.HTTPError as e:
            assert e.code in (501, 409), e.code
        # POST works; hostile seconds is a 400, not a 500
        req = urllib.request.Request(
            f"{base}/debug/profile?seconds=0.05", data=b"",
            method="POST")
        try:
            doc = json.loads(urllib.request.urlopen(req).read())
            assert os.path.isdir(doc["artifact"])
        except urllib.error.HTTPError as e:
            assert e.code in (501, 409), e.code
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"{base}/debug/profile?seconds=nope")
        assert exc.value.code == 400

    with pytest.raises(ValueError):
        profiler.capture(0)


def test_profiler_busy_is_exclusive(tmp_path):
    try:
        profiler.start_capture(str(tmp_path / "p1"))
    except profiler.ProfilerUnavailable as e:
        pytest.skip(f"profiler capture unsupported here: {e}")
    try:
        with pytest.raises(profiler.ProfilerBusy):
            profiler.start_capture(str(tmp_path / "p2"))
    finally:
        assert profiler.stop_capture() is not None
    # idempotent soft stop for timer/finally races
    assert profiler.stop_capture(strict=False) is None
    with pytest.raises(profiler.ProfilerBusy):
        profiler.stop_capture(strict=True)




# ------------------------------------- waiting cases of the other files
def _direct(lm, prompt, n):
    return lm.generate(np.asarray(prompt), n)[0].numpy()


@pytest.fixture(scope="module")
def int8_draft(lm):
    """The model's int8 clone: a draft that mostly agrees with it."""
    from bigdl_tpu_torch.nn.quantized import Quantizer

    d = Quantizer.quantize(lm)
    d.evaluate()
    return d


def test_debug_memory_attributes_pool_and_occupancy(lm):
    """(tests/test_paged_kv.py) /debug/memory answers both "how big is
    the page pool" (its tensors' bytes) and "how full" (live refcounted
    bytes), keyed by service name."""
    p = np.asarray([3, 1, 4, 1, 5], np.int32)
    with ContinuousBatchingEngine(lm, max_slots=1, prefill_chunk=4,
                                  page_size=4, max_pages=15,
                                  prefix_cache_rows=0,
                                  service_name="paged_dbg") as eng:
        sizes = obs_memory.pool_sizes()
        cap_key = "serving/paged_dbg/kv_page_pool"
        live_key = "serving/paged_dbg/kv_pages_in_use"
        assert cap_key in sizes and live_key in sizes
        assert sizes[cap_key] == obs_memory.tree_bytes(eng._kv_pool)
        assert sizes[cap_key] >= eng._pages.capacity_bytes
        assert sizes[live_key] == 0
        h = eng.submit(p, 30)
        next(h.tokens())
        mid = obs_memory.pool_sizes()[live_key]
        assert mid > 0 and mid == eng._pages.bytes_in_use
        h.result(timeout=120)
    assert eng._pages.bytes_in_use == 0


def test_paged_preemption_no_leak_jit_flat(lm, reg, rec):
    """(tests/test_paged_kv.py) One slot, a low-class decode in it, a
    high-class arrival forcing preemption: both rows match a lone
    generate, the dispatch signatures never grow, every page is freed
    after stop, and the page-pool gauges say so."""
    victim = np.asarray([7, 3, 1, 4, 1, 5], np.int32)
    urgent = np.asarray([2, 6, 2, 6], np.int32)
    with ContinuousBatchingEngine(lm, max_slots=1, prefill_chunk=4,
                                  page_size=4, preempt_slack_s=0.002,
                                  prefix_cache_rows=4,
                                  service_name="paged_preempt") as eng:
        eng.submit(victim, 2, priority="low").result(timeout=60)
        eng.submit(urgent, 2, priority="high").result(timeout=60)
        jit_warm = eng.stats()["jit_compiles"]
        h_low = eng.submit(victim, 40, priority="low", tenant="batch")
        next(h_low.tokens())
        h_high = eng.submit(urgent, 4, priority="high",
                            tenant="interactive")
        np.testing.assert_array_equal(h_high.result(timeout=120),
                                      _direct(lm, urgent, 4))
        np.testing.assert_array_equal(h_low.result(timeout=120),
                                      _direct(lm, victim, 40))
        assert h_low.preempted >= 1
        st = eng.stats()
        assert st["jit_compiles"] == jit_warm
        assert h_low.usage()["kv_byte_seconds"] > 0
    pool = eng._pages.stats()
    assert pool["pages_in_use"] == 0, pool
    assert pool["allocated_total"] == pool["freed_total"]
    g = reg.get("bdt_serving_page_pool_pages_in_use")
    assert sum(c.get() for _, c in g.children()) == 0
    assert reg.get("bdt_serving_page_allocated_total").labels(
        "paged_preempt").get() == pool["allocated_total"]
    assert reg.get("bdt_serving_page_freed_total").labels(
        "paged_preempt").get() == pool["freed_total"]
    assert reg.get("bdt_serving_preempted_total").labels(
        "paged_preempt", "low", "batch").get() == h_low.preempted
    assert any(e.kind == "request/preempted"
               for e in rec.for_request(h_low.request_id))


def test_memory_pool_attributes_both_tiers(lm):
    """(tests/test_tiered_prefix_cache.py) The host-tier pool appears
    beside the device pools and tracks the demoted rows' bytes."""
    r = np.random.RandomState(34)
    tpls = [r.randint(0, 32, (8,)) for _ in range(3)]
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                  prefix_cache_rows=1,
                                  prefix_host_rows=4,
                                  service_name="tier_mem") as eng:
        for tpl in tpls:
            eng.submit(np.concatenate([tpl, r.randint(0, 32, (2,))]),
                       3).result(timeout=60)
        sizes = obs_memory.pool_sizes()
        pc = eng.stats()["prefix_cache"]
        assert sizes["serving/tier_mem/prefix_kv_in_use"] == pc["bytes"]
        assert sizes["serving/tier_mem/prefix_host_kv"] == \
            pc["host_bytes"]
        assert pc["host_bytes"] > 0
        assert pc["host_bytes"] <= pc["host_capacity_bytes"]


def test_ledger_conservation_with_promotions_in_flight(lm, reg):
    """(tests/test_tiered_prefix_cache.py) Per-tenant device-second sums
    conserve the measured busy total through host-tier promotions, and
    the host-tier counters and gauges follow the cache's figures."""
    r = np.random.RandomState(35)
    tpls = [r.randint(0, 32, (8,)) for _ in range(3)]
    reqs = [(np.concatenate([tpls[i % 3], r.randint(0, 32, (2,))]), 3)
            for i in range(6)]
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                  prefix_cache_rows=1,
                                  prefix_host_rows=8,
                                  service_name="tier_usage") as eng:
        for i, (p, n) in enumerate(reqs):
            eng.submit(p, n, tenant=f"t{i % 2}").result(timeout=120)
        usage = eng.stats()["usage"]
        busy = eng._usage.device_time()
        pc = eng.stats()["prefix_cache"]
    assert pc["promotions"] >= 1, pc
    assert busy["total"] > 0
    tenant_sum = sum(a["device_s"] for a in usage["tenants"].values())
    assert tenant_sum == pytest.approx(busy["total"], rel=1e-6, abs=1e-9)

    def get(name):
        return reg.get(name).labels("tier_usage").get()

    assert get("bdt_serving_prefix_host_promoted_total") \
        == pc["promotions"]
    assert get("bdt_serving_prefix_host_demoted_total") == pc["demotions"]
    assert get("bdt_serving_prefix_host_hits_total") == pc["host_hits"]
    assert get("bdt_serving_prefix_host_cache_bytes") == pc["host_bytes"]
    assert get("bdt_serving_prefix_hits_total") == pc["hits"]


def test_capacity_doubles_at_equal_byte_budget(lm):
    """(tests/test_quantized_serving.py, its memory-pool half) At the
    same byte budget the int8 engine's slot pool is registered at its
    honest bytes (scales included): two rows of ``kv_row_bytes``, the
    tensors' own ``nbytes``; the gauges say which numerics run."""
    reg = obs.MetricRegistry()
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                  kv_dtype="int8", registry=reg,
                                  service_name="q_cap_q8") as q_eng:
        qz = q_eng.stats()["quantization"]
        sizes = obs_memory.pool_sizes()
        assert sizes["serving/q_cap_q8/kv_slots"] == \
            obs_memory.tree_device_bytes(q_eng._caches)
        assert sizes["serving/q_cap_q8/kv_slots"] == \
            2 * qz["kv_row_bytes"]
    assert qz["row_bytes_ratio"] == 0.5
    assert reg.get("bdt_serving_quantized_kv").labels("q_cap_q8").get() \
        == 1
    assert reg.get("bdt_serving_kv_row_bytes").labels("q_cap_q8").get() \
        == qz["kv_row_bytes"]


def test_spec_instruments_and_stats_consistency(lm, int8_draft):
    """(tests/test_speculative_engine.py) The speculation instruments
    match ``stats()``; the acceptance-ratio histogram is observed once a
    round; the dispatch signatures stay flat after the first request
    (the round's programs are registered at construction)."""
    reg = obs.MetricRegistry()
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                  draft=int8_draft, spec_gamma=3,
                                  registry=reg,
                                  service_name="spec_ins") as eng:
        p = np.random.RandomState(4).randint(0, 32, (7,))
        eng.submit(p, 9).result(timeout=60)
        jit0 = eng.stats()["jit_compiles"]
        eng.submit(p[:5], 11).result(timeout=60)
        st = eng.stats()
    ins = obs.serving_engine_instruments("spec_ins", reg)
    sp = st["speculation"]
    assert ins.spec_proposed_tokens_total.get() == sp["proposed_tokens"]
    assert ins.spec_accepted_tokens_total.get() == sp["accepted_tokens"]
    assert sp["accepted_tokens"] <= sp["proposed_tokens"]
    _, ratio_sum, ratio_n = ins.spec_acceptance_ratio.get()
    assert ratio_n == st["decode_steps"]
    assert 0.0 <= ratio_sum / ratio_n <= 1.0
    assert sp["acceptance_rate"] == pytest.approx(
        sp["accepted_tokens"] / sp["proposed_tokens"], abs=1e-4)
    assert st["jit_compiles"] == jit0


def test_decode_token_events_are_bursts(lm, int8_draft):
    """(tests/test_speculative_engine.py) One ``request/decode_token``
    event per round per row carrying ``accepted=n``: the counts sum to
    the delivered decode tokens, and some round is a real burst."""
    rec = FlightRecorder(capacity=4096)
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                  draft=int8_draft, spec_gamma=4,
                                  recorder=rec,
                                  service_name="spec_ev") as eng:
        p = np.random.RandomState(3).randint(0, 32, (6,))
        h = eng.submit(p, 11)
        row = h.result(timeout=60)
    np.testing.assert_array_equal(row, _direct(lm, p, 11))
    evs = [e for e in rec.for_request(h.request_id)
           if e.kind == "request/decode_token"]
    assert evs
    assert all(e.attrs and "accepted" in e.attrs for e in evs)
    assert sum(e.attrs["accepted"] for e in evs) == 10
    assert max(e.attrs["accepted"] for e in evs) > 1
    assert len(evs) < 10
    ns = [e.attrs["n"] for e in evs]
    assert ns == sorted(ns)


# ------------------------------------------------------------- hazards
_HOST_READS = ("tolist", "item", "cpu", "numpy")


def _count_host_reads(monkeypatch, counts):
    """Count the host reads of a device tensor (and synchronizes) the
    calling thread makes."""
    for name in _HOST_READS:
        orig = getattr(torch.Tensor, name)

        def wrap(self, *a, _orig=orig, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, wrap)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: counts.__setitem__(
                            "sync", counts.get("sync", 0) + 1))


def test_telemetry_adds_no_host_read_to_an_iteration(lm, reg,
                                                     monkeypatch):
    """The engine is host-bound: telemetry may read only what the
    iteration's own host read produced. The loop is driven by hand on
    this thread, the same requests with observability enabled and with
    ``disable()``: the tensor reads (``tolist`` / ``item`` / ``cpu`` /
    ``numpy``) and synchronizes are the same, and each iteration makes at
    most one read a dispatch kind."""
    r = np.random.RandomState(9)
    reqs = [(r.randint(0, 32, (t0,)), n) for t0, n in
            [(5, 6), (9, 4), (3, 7), (6, 5)]]

    def drive():
        eng = ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                       prefill_rows=2,
                                       service_name="no_sync")
        eng.start = lambda: eng        # no loop thread: this one drives
        hs = [eng.submit(p, n) for p, n in reqs]
        counts, per_iter = {}, []
        with monkeypatch.context() as m:
            _count_host_reads(m, counts)
            with torch.inference_mode():
                for _ in range(200):
                    before = sum(counts.values())
                    eng._iterate()
                    per_iter.append(sum(counts.values()) - before)
                    if all(h.done() for h in hs):
                        break
        assert all(h.done() for h in hs)
        return counts, per_iter, [h.result() for h in hs], eng.stats()

    on_counts, on_iter, on_rows, on_stats = drive()
    obs.disable()
    try:
        off_counts, off_iter, off_rows, _ = drive()
    finally:
        obs.enable()
    for a, b in zip(on_rows, off_rows):
        np.testing.assert_array_equal(a, b)
    assert on_counts == off_counts and on_iter == off_iter
    assert "sync" not in on_counts
    assert max(on_iter) <= 2           # a finishing prefill + a decode
    assert sum(on_iter) <= on_stats["decode_steps"] \
        + on_stats["prefill_rounds"]
    # and the registry did move with observability on
    assert reg.get("bdt_serving_decode_tokens_total").labels(
        "no_sync").get() == sum(n - 1 for _, n in reqs)


def test_profile_capture_while_the_loop_serves(lm, reg, rec, tmp_path):
    """``/debug/profile`` on an HTTP thread while the engine serves on
    its loop thread returns the trace's directory and releases the lock
    (whether the CUDA kernels of the loop thread land in it is checked
    on the card by ``chip_smoke.py``'s ``obs_serving``)."""
    import os
    import threading

    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4) as eng:
        stop = threading.Event()

        def load():
            r = np.random.RandomState(12)
            while not stop.is_set():
                eng.submit(r.randint(0, 32, (6,)), 6).result(timeout=60)

        t = threading.Thread(target=load)
        t.start()
        try:
            with obs.start_http_server(host="127.0.0.1") as srv:
                doc = json.loads(urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/debug/profile"
                    "?seconds=0.2").read())
        finally:
            stop.set()
            t.join(timeout=60)
        assert not t.is_alive()
    assert any(f.endswith(".pt.trace.json")
               for f in os.listdir(doc["artifact"]))
    assert not profiler.capturing()
    kinds = [e.kind for e in rec.tail()]
    assert kinds.count("profiler/capture_done") == 1


def test_perf_traced_takes_the_capture_lock(tmp_path):
    """``models/perf.py``'s ``traced`` and a ``/debug/profile`` capture
    share one lock: while one runs the other is refused, so two
    profiler sessions never overlap."""
    from bigdl_tpu_torch.models.perf import traced

    path = profiler.start_capture(str(tmp_path / "p"))
    try:
        with pytest.raises(profiler.ProfilerBusy):
            with traced(str(tmp_path / "t"), torch.device("cpu"), "x"):
                pass
    finally:
        assert profiler.stop_capture() == path
    with traced(str(tmp_path / "t"), torch.device("cpu"), "x"):
        with pytest.raises(profiler.ProfilerBusy):
            profiler.start_capture(str(tmp_path / "p2"))
    assert not profiler.capturing()
