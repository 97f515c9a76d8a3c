"""The port's dispatch-level cost model, loop-phase attribution and live
time-series dashboard (bigdl_tpu_torch/observability/costmodel.py +
timeseries.py + their serving-engine wiring), case for case with
tests/test_cost_model.py (its perf-gate case belongs to the benchmark,
not ported yet).

The acceptance arc under test: ``stats()["cost"]`` reports per-kind
FLOPs/bytes, achieved rates, MFU, and a roofline class from the analytic
transformer formulas (the port has no compiler cost analysis), equal to
the JAX package's analytic fallback within 1e-6 relative; pricing adds
no dispatch signature; the peak table has the H100 rows;
``stats()["loop"]`` phase fractions sum to 1.0 and its device-busy
seconds reconcile exactly with the usage ledger's device-seconds
(same walls, same call sites); the ``TimeSeriesSampler`` keeps bounded
rings with monotonic timestamps across wrap, is a no-op under a
disabled registry, and its thread dies with ``engine.stop()``; and
every documented HTTP route — ``/metrics``, ``/healthz``, the full
``/debug/*`` inventory including ``/debug/timeseries`` and the
self-contained ``/debug/dashboard`` HTML — answers with its documented
status and parses against a live engine.
"""

import json
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu.observability import costmodel as jcostmodel
from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch.observability import costmodel
from bigdl_tpu_torch.observability.costmodel import (
    DispatchCostModel, LoopPhaseAccumulator, device_peaks,
)
from bigdl_tpu_torch.observability.events import FlightRecorder
from bigdl_tpu_torch.observability.timeseries import (
    TimeSeriesSampler, render_dashboard,
)


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
def lms():
    """(JAX LM, the port's LM on its weights, CPU)."""
    from bigdl_tpu.models.transformer import TransformerLM as JaxLM
    from bigdl_tpu.utils import random as rnd
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.utils.weights import load_jax_params

    rnd.set_seed(29)
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


def _engine(lm, reg, **kw):
    from bigdl_tpu_torch.serving import ContinuousBatchingEngine

    kw.setdefault("max_slots", 2)
    kw.setdefault("prefill_chunk", 4)
    kw.setdefault("registry", reg)
    return ContinuousBatchingEngine(lm, **kw)


def _serve(eng, n_requests=4, tokens=4):
    r = np.random.RandomState(11)
    hs = [eng.submit(r.randint(0, 32, (4 + i % 5,)), tokens,
                     tenant="t%d" % (i % 2))
          for i in range(n_requests)]
    for h in hs:
        h.result(timeout=120)
    return hs


# ------------------------------------------------------ peaks & units
def test_device_peaks_table_match_and_env_override(monkeypatch):
    """The table by longest substring (the JAX package's rows priced as
    there), the H100 rows (the SXM part, "NVIDIA H100 80GB HBM3", and
    the PCIe part), the CPU when there is no card, the env overrides."""
    monkeypatch.delenv(costmodel.ENV_PEAK_FLOPS, raising=False)
    monkeypatch.delenv(costmodel.ENV_PEAK_HBM_GBPS, raising=False)
    dev = "TPU v5 lite"
    p = device_peaks(dev)
    # longest-substring match: "tpu v5 lite" must win over "tpu v5"
    assert p["flops_per_s"] == 197e12 and p["source"] == "table"
    p5 = device_peaks("TPU v5")
    assert p5["flops_per_s"] == 459e12
    for kind in ("TPU v5 lite", "TPU v5", "TPU v4", "TPU v6e", "cpu"):
        assert device_peaks(kind)["flops_per_s"] == jcostmodel.device_peaks(
            types.SimpleNamespace(device_kind=kind))["flops_per_s"]
    sxm = device_peaks("NVIDIA H100 80GB HBM3")
    assert (sxm["flops_per_s"], sxm["hbm_bytes_per_s"],
            sxm["source"]) == (989e12, 3.35e12, "table")
    pcie = device_peaks("NVIDIA H100 PCIe")
    assert (pcie["flops_per_s"], pcie["hbm_bytes_per_s"]) == \
        (756e12, 2.0e12)
    cpu = device_peaks(torch.device("cpu"))
    assert cpu["device_kind"] == "cpu" and cpu["source"] == "table"
    unknown = device_peaks("FPGA x9")
    assert unknown["source"] == "default"
    assert (unknown["flops_per_s"], unknown["hbm_bytes_per_s"]) \
        == costmodel.DEFAULT_PEAKS
    # env overrides win over the table, bandwidth given in GB/s
    monkeypatch.setenv(costmodel.ENV_PEAK_FLOPS, "123e12")
    monkeypatch.setenv(costmodel.ENV_PEAK_HBM_GBPS, "800")
    p = device_peaks(dev)
    assert p["source"] == "env"
    assert p["flops_per_s"] == 123e12
    assert p["hbm_bytes_per_s"] == pytest.approx(800e9)


def test_dispatch_cost_model_rates_and_roofline():
    peaks = {"device_kind": "unit", "flops_per_s": 1000.0,
             "hbm_bytes_per_s": 100.0, "source": "test"}
    cm = DispatchCostModel(peaks, devices=1)
    cm.set_program_cost("decode", 100.0, 50.0, "xla")
    cm.charge("decode", 0.5)
    cm.charge("decode", 0.5)
    cm.charge("decode", 0.3, warm=False)   # cold: excluded entirely
    cm.charge("prefill", 0.2)              # walls without a cost: no rate
    s = cm.summary()
    d = s["kinds"]["decode"]
    assert d["dispatches"] == 2 and d["wall_s"] == pytest.approx(1.0)
    assert d["achieved_flops_per_s"] == pytest.approx(200.0)
    assert d["mfu"] == pytest.approx(0.2)
    assert d["membw_util"] == pytest.approx(1.0)
    # intensity 2 FLOP/B vs ridge 10 -> memory-bound
    assert d["arithmetic_intensity"] == pytest.approx(2.0)
    assert d["ridge_intensity"] == pytest.approx(10.0)
    assert d["roofline"] == "memory-bound"
    assert s["kinds"]["prefill"]["mfu"] is None
    assert cm.rates("decode") == (d["mfu"], d["membw_util"])
    # compute-bound side of the ridge
    cm2 = DispatchCostModel(peaks)
    cm2.set_program_cost("prefill", 2000.0, 10.0, "analytic")
    cm2.charge("prefill", 1.0)
    p = cm2.summary()["kinds"]["prefill"]
    assert p["roofline"] == "compute-bound"
    assert p["flops_source"] == "analytic"
    # mesh-aware: achieved rates are per device
    cm4 = DispatchCostModel(peaks, devices=4)
    cm4.set_program_cost("decode", 100.0, 0.0, "xla")
    cm4.charge("decode", 1.0)
    assert cm4.summary()["kinds"]["decode"][
        "achieved_flops_per_s"] == pytest.approx(25.0)


def test_loop_phase_accumulator_fractions_and_idle():
    lo = LoopPhaseAccumulator()
    lo.add("sweep", 0.1)
    lo.add("admission", 0.2)
    lo.dispatch("prefill_dispatch", 0.3)              # warm -> busy
    lo.dispatch("decode_dispatch", 0.4, warm=False)   # cold -> phase only
    lo.add("deliver", 0.0)                            # ignored
    lo.iteration()
    s = lo.summary()
    assert s["iterations"] == 1
    assert s["accounted_s"] == pytest.approx(1.0)
    assert sum(s["fractions"].values()) == pytest.approx(1.0, abs=1e-5)
    assert s["fractions"]["decode_dispatch"] == pytest.approx(0.4)
    assert s["device_busy_s"] == pytest.approx(0.3)
    assert s["device_busy_fraction"] == pytest.approx(0.3)
    assert s["device_idle_fraction"] == pytest.approx(0.7)
    assert s["device_idle_fraction"] == pytest.approx(
        1.0 - s["device_busy_fraction"])


# ------------------------------------------------- timeseries sampler
def test_sampler_bounded_ring_and_monotonic_across_wrap():
    ts = TimeSeriesSampler(interval_s=999.0, capacity=5)
    vals = iter(range(100))
    ts.add_source("g", lambda: next(vals))
    for i in range(12):
        ts.sample(now=float(i))
    snap = ts.snapshot()
    pts = snap["metrics"]["g"]["points"]
    assert len(pts) == 5                       # bounded: wrapped 12 -> 5
    stamps = [p[0] for p in pts]
    assert stamps == sorted(stamps)            # monotonic across wrap
    assert stamps[0] == 7.0 and stamps[-1] == 11.0
    assert snap["metrics"]["g"]["last"] == 11.0
    # metric= filters, n= trims to the newest points
    one = ts.snapshot(metric="g", n=2)
    assert list(one["metrics"]) == ["g"]
    assert len(one["metrics"]["g"]["points"]) == 2
    assert ts.snapshot(metric="absent")["metrics"] == {}


def test_sampler_rate_mode_and_none_and_raising_sources():
    ts = TimeSeriesSampler(capacity=10)
    total = {"v": 0.0}
    ts.add_source("tok_rate", lambda: total["v"], rate=True)
    ts.add_source("skips", lambda: None)
    boom = lambda: (_ for _ in ()).throw(RuntimeError("x"))  # noqa: E731
    ts.add_source("raises", boom)
    ts.sample(now=0.0)     # primes the rate baseline, stores nothing
    total["v"] = 10.0
    ts.sample(now=2.0)
    m = ts.snapshot()["metrics"]
    assert m["tok_rate"]["points"] == [[2.0, pytest.approx(5.0)]]
    assert m["skips"]["points"] == []    # None readers skip the point
    assert m["raises"]["points"] == []   # reader exceptions swallowed


def test_sampler_disabled_registry_noop_and_lifecycle():
    r = obs.MetricRegistry()
    ts = TimeSeriesSampler(interval_s=0.01, capacity=8, registry=r)
    ts.add_source("g", lambda: 1.0)
    r.disable()
    assert not ts.enabled
    ts.sample(now=0.0)
    assert ts.snapshot()["metrics"]["g"]["points"] == []
    r.enable()
    ts.sample(now=1.0)
    assert len(ts.snapshot()["metrics"]["g"]["points"]) == 1
    # start/stop are idempotent; the thread carries the documented name
    # (held by identity: other tests' samplers may share the process)
    assert not ts.running
    ts.start()
    thread = ts._thread
    ts.start()
    assert ts.running and ts._thread is thread
    assert thread.name == "bdt-timeseries" and thread.is_alive()
    ts.stop()
    ts.stop()
    assert not ts.running
    assert not thread.is_alive()


def test_render_dashboard_self_contained():
    ts = TimeSeriesSampler(capacity=8)
    seq = iter([1.0, 3.0, 2.0])
    ts.add_source("mfu", lambda: next(seq))
    for i in range(3):
        ts.sample(now=float(i))
    page = render_dashboard(ts.snapshot(), title="unit <svc>",
                            extra={"cost": {"roofline": "memory-bound"},
                                   "skipped": None})
    assert page.startswith("<!doctype html>")
    assert "<svg" in page and "polyline" in page
    assert "unit &lt;svc&gt;" in page        # titles are escaped
    assert "memory-bound" in page            # extra blocks inlined
    assert "skipped" not in page             # None blocks dropped
    # no external assets: no src/href fetches anywhere in the page
    assert "src=" not in page and "href=" not in page
    # an empty ring renders the placeholder, not a broken polyline
    empty = render_dashboard(
        TimeSeriesSampler().add_source("x", lambda: 0).snapshot())
    assert "no data yet" in empty


# ------------------------------------------------- engine integration
def test_engine_cost_block_xla_path_and_flat_jit(lms, reg, rec):
    """The port prices every dispatch kind by the analytic formulas
    (there is no compiler cost analysis to ask); the live block has
    rates, MFU and a roofline class, re-pricing launches nothing and
    adds no dispatch signature, and the per-kind gauges carry the
    numbers to the scrape."""
    _, lm = lms
    with _engine(lm, reg, service_name="cost_eng") as eng:
        _serve(eng)
        st = eng.stats()
        jit0 = st["jit_compiles"]
        cost = st["cost"]
        assert cost["devices"] == 1
        assert cost["peak_flops_per_s"] > 0
        assert cost["peak_source"] in ("table", "default", "env")
        for kind in ("prefill", "decode"):
            k = cost["kinds"][kind]
            assert k["dispatches"] > 0 and k["wall_s"] > 0
            assert k["flops_per_dispatch"] > 0
            assert k["flops_source"] == "analytic"
            assert k["achieved_flops_per_s"] > 0
            assert 0 < k["mfu"] < 1
            assert k["roofline"] in ("compute-bound", "memory-bound")
        assert 0 < cost["overall"]["mfu"] < 1
        eng._price_programs()
        assert eng.stats()["jit_compiles"] == jit0
        body = obs.render_prometheus(reg)
        assert ('bdt_serving_mfu{service="cost_eng",kind="decode"}'
                in body)
        assert ('bdt_serving_membw_util{service="cost_eng",'
                'kind="prefill"}' in body)


def test_engine_cost_block_analytic_fallback(lms, reg, rec, monkeypatch):
    """The port's prices equal the JAX engine's analytic fallback (forced
    there as the JAX test forces it) within 1e-6 relative, per kind, for
    the dense engine and with a draft."""
    from bigdl_tpu.models.transformer import TransformerLM as JaxLM
    from bigdl_tpu.serving import ContinuousBatchingEngine as JaxEngine
    from bigdl_tpu.utils import random as rnd
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.utils.weights import load_jax_params

    jm, lm = lms
    rnd.set_seed(30)
    jd = JaxLM(32, embed_dim=16, num_heads=4, num_kv_heads=2, num_layers=1,
               max_len=48, use_rope=True)
    jd.evaluate()
    td = TransformerLM(32, embed_dim=16, num_heads=4, num_kv_heads=2,
                       num_layers=1, max_len=48, use_rope=True,
                       device="cpu")
    load_jax_params(td, jax.tree.map(np.asarray, jd.params_dict()))
    monkeypatch.setattr("bigdl_tpu.serving.engine.program_cost",
                        lambda *a, **k: None)
    for kw, jkw in (({}, {}), ({"draft": td, "spec_gamma": 3},
                               {"draft": jd, "spec_gamma": 3})):
        jeng = JaxEngine(jm, max_slots=2, prefill_chunk=4,
                         registry=__import__(
                             "bigdl_tpu.observability",
                             fromlist=["x"]).MetricRegistry(), **jkw)
        eng = _engine(lm, reg, service_name="cost_ana", **kw)
        with eng:
            _serve(eng, n_requests=2)
            cost = eng.stats()["cost"]
        jcost = jeng.stats()["cost"]
        for kind in ("prefill", "decode"):
            k, jk = cost["kinds"][kind], jcost["kinds"][kind]
            assert k["flops_source"] == jk["flops_source"] == "analytic"
            assert k["flops_per_dispatch"] == pytest.approx(
                jk["flops_per_dispatch"], rel=1e-6)
            assert k["bytes_per_dispatch"] == pytest.approx(
                jk["bytes_per_dispatch"], rel=1e-6)
            assert k["mfu"] is not None and k["mfu"] > 0
            assert k["roofline"] in ("compute-bound", "memory-bound")


def test_engine_loop_fractions_sum_and_ledger_reconciliation(lm, reg,
                                                             rec):
    with _engine(lm, reg, service_name="loop_eng") as eng:
        _serve(eng)
        st = eng.stats()
        lp = st["loop"]
        assert lp["iterations"] > 0 and lp["accounted_s"] > 0
        assert sum(lp["fractions"].values()) == pytest.approx(
            1.0, abs=1e-4)
        assert lp["device_idle_fraction"] == pytest.approx(
            1.0 - lp["device_busy_fraction"], abs=1e-6)
        # the loop's device-busy pool is fed by the SAME warm walls, at
        # the same call sites, as the usage ledger's device-seconds
        ledger_busy = st["usage"]["goodput"]["device_seconds"]["total"]
        assert lp["device_busy_s"] == pytest.approx(
            ledger_busy, rel=1e-6, abs=1e-9)
        body = obs.render_prometheus(reg)
        assert ('bdt_serving_loop_device_idle_fraction'
                '{service="loop_eng"}' in body)
        assert ('bdt_serving_loop_phase_seconds_total'
                '{service="loop_eng",phase="decode_dispatch"}' in body)


def test_engine_sampler_lifecycle_and_debug_timeseries(lm, reg, rec):
    eng = _engine(lm, reg, service_name="ts_eng",
                  timeseries_interval_s=0.02, timeseries_capacity=32)
    assert not eng._ts.running
    with eng:
        assert eng._ts.running
        thread = eng._ts._thread
        _serve(eng, n_requests=2)
        got = eng.debug_timeseries()
        assert got["service"] == "ts_eng" and got["running"]
        assert got["capacity"] == 32
        assert {"mfu", "tokens_per_sec", "slot_occupancy",
                "queue_depth", "alerts"} <= set(got["metrics"])
        one = eng.debug_timeseries(metric="mfu", n=3)
        assert list(one["metrics"]) in ([], ["mfu"])
        page = eng.dashboard()
        assert page.startswith("<!doctype html>") and "<svg" in page
    # engine.stop() joins the sampler thread — nothing leaks
    assert not eng._ts.running
    assert thread.name == "bdt-timeseries" and not thread.is_alive()


# ------------------------------------------------ HTTP route inventory
def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=30) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_http_route_inventory_against_live_engine(lm, reg, rec):
    """Every documented route answers its documented status and parses
    — the ops-surface smoke a deploy checklist would run."""
    with _engine(lm, reg, service_name="routes") as eng, \
            obs.start_http_server(
                host="127.0.0.1", registry=reg,
                healthz=eng.healthz,
                debug_requests=eng.debug_requests,
                debug_usage=eng.debug_usage,
                debug_timeseries=eng.debug_timeseries,
                dashboard=eng.dashboard,
                debug_incidents=eng.debug_incidents,
                debug_capacity=eng.debug_capacity) as srv:
        _serve(eng, n_requests=2)
        eng._ts.sample()  # at least one point regardless of timing
        base = f"http://127.0.0.1:{srv.port}"

        status, headers, body = _get(base, "/metrics")
        assert status == 200
        assert "bdt_serving_mfu" in body.decode()

        status, _, body = _get(base, "/healthz")
        assert status == 200
        assert json.loads(body)["status"] == "ok"

        for path, keys in (
                ("/debug/events?n=16", {"events", "total"}),
                ("/debug/requests", {"in_flight", "recent"}),
                ("/debug/memory", {"now"}),
                ("/debug/usage?n=2", {"tenants", "goodput"}),
                ("/debug/timeseries", {"metrics", "running"}),
                ("/debug/timeseries?metric=mfu&n=2", {"metrics"}),
                ("/debug/incidents?n=2", {"incidents", "count"}),
                ("/debug/capacity", {"capacity", "slo_budget"}),
        ):
            status, _, body = _get(base, path)
            assert status == 200, path
            got = json.loads(body)
            assert keys <= set(got), path

        status, _, body = _get(base, "/debug/trace")
        assert status == 200
        assert isinstance(json.loads(body), (dict, list))

        # profile: 200 with an artifact where the backend can capture,
        # 501 where it cannot — both are documented outcomes
        status, _, body = _get(base, "/debug/profile?seconds=0.05")
        assert status in (200, 501)
        got = json.loads(body)
        assert ("artifact" in got) == (status == 200)

        status, headers, body = _get(base, "/debug/dashboard")
        assert status == 200
        assert headers.get("Content-Type", "").startswith("text/html")
        page = body.decode()
        assert page.startswith("<!doctype html>") and "<svg" in page
        assert "routes" in page              # the engine's service name

        status, _, _ = _get(base, "/debug/nonexistent")
        assert status == 404

    # absent sources answer with a note, never a 500
    with obs.start_http_server(host="127.0.0.1", registry=reg) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        status, _, body = _get(base, "/debug/timeseries")
        assert status == 200 and "note" in json.loads(body)
        status, _, body = _get(base, "/debug/dashboard")
        assert status == 200 and b"no dashboard source" in body


def test_engine_loop_fractions_sum_within_1e6(lm, reg, rec):
    """The loop-phase fractions ``chip_smoke.py``'s ``obs_serving`` holds
    to 1e-6: the summary's rounding keeps their sum within it."""
    with _engine(lm, reg, service_name="loop_sum") as eng:
        _serve(eng, n_requests=3)
        lp = eng.stats()["loop"]
    assert abs(sum(lp["fractions"].values()) - 1.0) <= 1e-5
    assert lp["device_busy_fraction"] + lp["device_idle_fraction"] == \
        pytest.approx(1.0, abs=1e-6)
