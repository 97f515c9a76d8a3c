"""The port's fleet telemetry plane: clock-aligned time-series merge, SLO
error budgets and the capacity/what-if model, case for case with
tests/test_fleet_telemetry.py and against the JAX package on the same
inputs.

Every host-only case runs the port's function and the JAX one on the
same inputs (sampler readings, exports, budget samples, capacity
summaries) and holds the port's output equal to JAX's, besides the JAX
file's own assertions; the fleet dashboard equals JAX's page up to the
package name in its title. The front-door case serves a hermetic
in-process fleet of the port. Plus the ``__all__`` check: every name a
module of ``bigdl_tpu_torch.observability`` or ``bigdl_tpu_torch.serving``
exports exists (``import *`` of each succeeds)."""

import importlib
import json
import pkgutil
import time
import urllib.request

import numpy as np
import pytest

from bigdl_tpu.observability import capacity as jcapacity
from bigdl_tpu.observability import metrics as jmetrics
from bigdl_tpu.observability import slo_budget as jslo
from bigdl_tpu.observability import timeseries as jts
from bigdl_tpu.observability import watchdog as jwatchdog
from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch.observability import MetricRegistry
from bigdl_tpu_torch.observability.capacity import (
    aggregate_fleet_capacity, estimate_capacity, replicas_needed,
)
from bigdl_tpu_torch.observability.slo_budget import SloBudgetTracker
from bigdl_tpu_torch.observability.timeseries import (
    TimeSeriesSampler, merge_fleet_timeseries, render_fleet_dashboard,
)
from bigdl_tpu_torch.observability.watchdog import SloObjective
from bigdl_tpu_torch.serving import ContinuousBatchingEngine
from bigdl_tpu_torch.serving.fleet import (
    FleetFrontDoor, InProcessReplica, ReplicaSupervisor,
)

VOCAB = 32


@pytest.fixture()
def reg():
    r = MetricRegistry()
    prev = obs.set_default_registry(r)
    try:
        yield r
    finally:
        obs.set_default_registry(prev)


@pytest.fixture(scope="module")
def lm():
    from bigdl_tpu_torch.models.transformer import TransformerLM

    m = TransformerLM(VOCAB, embed_dim=16, num_heads=4, num_kv_heads=2,
                      num_layers=2, max_len=48, use_rope=True, seed=23,
                      device="cpu")
    m.evaluate()
    return m


# ------------------------------------------------------- __all__ names
def _modules(pkg):
    yield pkg.__name__
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        yield info.name


def test_every_all_name_exists():
    """``from <module> import *`` succeeds for every module of the
    port's observability and serving packages: each name a module lists
    in ``__all__`` is defined there."""
    import bigdl_tpu_torch.observability as tobs
    import bigdl_tpu_torch.serving as tserving

    checked = 0
    for pkg in (tobs, tserving):
        for name in _modules(pkg):
            mod = importlib.import_module(name)
            missing = [n for n in getattr(mod, "__all__", ())
                       if not hasattr(mod, n)]
            assert not missing, (name, missing)
            exec(f"from {name} import *", {})
            checked += 1
    assert checked >= 30


# ------------------------------------------------------ sampler guards
def _reset_samplers():
    """The port's sampler on a port registry and the JAX sampler on a
    JAX registry, each fed 0, 10, 3, 8 as a rate source (10 -> 3 is a
    reset)."""
    out = []
    for sampler, registry in ((TimeSeriesSampler, MetricRegistry),
                              (jts.TimeSeriesSampler,
                               jmetrics.MetricRegistry)):
        s = sampler(interval_s=1.0, registry=registry())
        vals = iter([0.0, 10.0, 3.0, 8.0])
        s.add_source("reqs_rate", lambda vals=vals: next(vals), rate=True)
        for t in (1.0, 2.0, 3.0, 4.0):
            s.sample(now=t)
        out.append(s)
    return out


def test_counter_reset_reprimes_and_never_goes_negative(reg):
    s, js = _reset_samplers()
    pts = s.snapshot()["metrics"]["reqs_rate"]["points"]
    # first sample primes, the reset drops, the post-reset baseline
    # re-primes so 3 -> 8 yields 5.0/s
    assert pts == [[2.0, 10.0], [4.0, 5.0]]
    assert s.counter_resets == 1
    assert all(v >= 0.0 for _, v in pts)
    assert s.snapshot() == js.snapshot()
    assert s.counter_resets == js.counter_resets


def test_counter_reset_no_negative_rate_fleet_side(reg):
    s, js = _reset_samplers()
    merged = merge_fleet_timeseries(
        [{"replica": "r0", "clock_offset_s": 0.25,
          "export": s.snapshot()}])
    rep = merged["metrics"]["reqs_rate"]["replicas"]["r0"]
    assert all(v >= 0.0 for _, v in rep["points"])
    for series in merged["metrics"]["reqs_rate"]["fleet"].values():
        assert all(v >= 0.0 for _, v in series)
    assert merged == jts.merge_fleet_timeseries(
        [{"replica": "r0", "clock_offset_s": 0.25,
          "export": js.snapshot()}])


def test_broken_source_counted_not_propagated(reg):
    def boom():
        raise RuntimeError("torn getter")

    snaps = []
    for sampler, registry in ((TimeSeriesSampler, MetricRegistry),
                              (jts.TimeSeriesSampler,
                               jmetrics.MetricRegistry)):
        s = sampler(interval_s=1.0, registry=registry())
        s.add_source("bad", boom).add_source("good", lambda: 1.0)
        for t in (1.0, 2.0):
            s.sample(now=t)  # must not raise
        assert s.source_errors == 2
        assert len(s.snapshot()["metrics"]["good"]["points"]) == 2
        assert s.snapshot()["metrics"]["bad"]["points"] == []
        snaps.append(s.snapshot())
    assert snaps[0] == snaps[1]


# ------------------------------------------------------- fleet merge
def _export(points):
    return {"interval_s": 1.0,
            "metrics": {"queue_depth": {
                "points": points,
                "last": points[-1][1] if points else None}}}


def _exports(with_error=True):
    out = [
        {"replica": "r0", "clock_offset_s": 0.0,
         "export": _export([[10.0, 2.0], [11.0, 4.0]])},
        {"replica": "r1", "clock_offset_s": 0.5,
         "export": _export([[9.5, 6.0], [10.5, 8.0]])},
    ]
    if with_error:
        out.append({"replica": "r2",
                    "error": "WorkerRPCTimeout('stats')"})
    return out


def test_merge_applies_clock_offsets_monotonic():
    # r1's clock runs 0.5s behind the supervisor's: its raw stamps sit
    # in the past and the offset shifts them forward onto the common
    # timeline
    merged = merge_fleet_timeseries(_exports())
    assert merged["replicas"] == ["r0", "r1"]
    assert "r2" in merged["errors"]
    assert merged["clock"] == {"r0": 0.0, "r1": 0.5}
    reps = merged["metrics"]["queue_depth"]["replicas"]
    assert reps["r1"]["points"] == [[10.0, 6.0], [11.0, 8.0]]
    for rid in ("r0", "r1"):
        ts = [t for t, _ in reps[rid]["points"]]
        assert ts == sorted(ts)
    # aligned stamps land in shared bins: sum and mean are derived
    fleet = merged["metrics"]["queue_depth"]["fleet"]
    assert [v for _, v in fleet["sum"]] == [8.0, 12.0]
    assert [v for _, v in fleet["mean"]] == [4.0, 6.0]
    assert merged == jts.merge_fleet_timeseries(_exports())
    # torn points, None and non-finite values drop on both sides
    torn = _exports(False) + [{"replica": "r3", "export": {
        "interval_s": 2.0, "metrics": {"queue_depth": {"points": [
            [1.0, None], [2.0, float("nan")], ["x", 1.0], [3.0],
            [4.0, 1.5]]}}}}]
    assert merge_fleet_timeseries(torn, fleet="f") == \
        jts.merge_fleet_timeseries(torn, fleet="f")


def test_fleet_dashboard_renders_every_replica():
    merged = merge_fleet_timeseries(_exports(False))
    kw = dict(markers=[{"ts": 10.5, "kind": "drain", "label": "r1"}],
              budgets=[{"objective": "ttft", "budget_remaining": 0.8}])
    html = render_fleet_dashboard(merged, **kw)
    assert "<svg" in html and "queue_depth" in html
    assert "r0" in html and "r1" in html
    assert "SLO error budgets" in html
    theirs = jts.render_fleet_dashboard(
        jts.merge_fleet_timeseries(_exports(False)), **kw)
    assert html == theirs.replace("bigdl_tpu fleet", "bigdl_tpu_torch fleet")
    extra = {"capacity": {"ready": True}, "routing": {"replicas": ["r0"]}}
    with_errors = merge_fleet_timeseries(_exports())
    assert render_fleet_dashboard(
        with_errors, title="t", extra=extra) == jts.render_fleet_dashboard(
        jts.merge_fleet_timeseries(_exports()), title="t",
        extra=extra).replace("bigdl_tpu fleet", "bigdl_tpu_torch fleet")


# -------------------------------------------------------- slo budget
def _burn_states(reg, jreg):
    """The forced-burn script through the port's tracker and JAX's."""
    out = []
    for tracker, objective, registry in (
            (SloBudgetTracker, SloObjective, reg),
            (jslo.SloBudgetTracker, jwatchdog.SloObjective, jreg)):
        hist = registry.histogram("t_ttft_seconds", "t",
                                  buckets=(0.01, 0.1, 1.0))
        tr = tracker(service="t", budget_window_s=120.0,
                     forced_burn_rate=12.0, registry=registry)
        tr.watch(objective("ttft", threshold_s=0.1, target=0.9,
                           window_s=30.0, min_count=5, metric="ttft"),
                 hist._only())
        t = 1000.0
        states = []
        tr.sample(now=t)
        for _ in range(20):
            hist.observe(0.02)  # calm: everything under threshold
        tr.sample(now=t + 10)
        states.append(tr.state())
        for i in range(20):
            hist.observe(0.02)
            tr.sample(now=t + 11 + i, forced=True)
        states.append(tr.state())
        for i in range(10):
            hist.observe(0.02)
            tr.sample(now=t + 40 + (i + 1) * 30.0)
        states.append(tr.state())
        out.append(states)
    return out


def test_slo_budget_exhausts_under_forced_burn_and_recovers(reg):
    jreg = jmetrics.MetricRegistry()
    ours, theirs = _burn_states(reg, jreg)
    calm, burnt, recovered = ours
    assert calm["objectives"][0]["budget_remaining"] == pytest.approx(1.0)
    assert calm["remaining_min"] == pytest.approx(1.0)
    # forced chaos burn: spends budget_window/forced_burn_rate worth
    # of budget per wall second -> exhausted well within 20 samples
    assert burnt["forced_burn_active"] is True
    ob = burnt["objectives"][0]
    assert ob["exhausted"] and ob["budget_remaining"] == 0.0
    assert ob["windows"]["fast"]["burn_rate"] >= 12.0
    # the synthetic spend ages out of the 120s budget window under
    # calm traffic: the budget recovers without a reset
    assert recovered["forced_burn_active"] is False
    assert recovered["objectives"][0]["budget_remaining"] == \
        pytest.approx(1.0)
    assert recovered["objectives"][0]["exhausted"] is False
    assert ours == theirs
    assert reg.get("bdt_slo_budget_remaining").labels(
        "ttft", "t").get() == jreg.get("bigdl_slo_budget_remaining"
                                       ).labels("ttft", "t").get()


def test_slo_budget_per_class_ledger(reg):
    states = []
    for tracker, objective, registry in (
            (SloBudgetTracker, SloObjective, reg),
            (jslo.SloBudgetTracker, jwatchdog.SloObjective,
             jmetrics.MetricRegistry())):
        hist = registry.histogram("t2_ttft_seconds", "t2",
                                  buckets=(0.01, 0.1, 1.0))
        tr = tracker(service="t2", budget_window_s=120.0,
                     registry=registry)
        tr.watch(objective("ttft", threshold_s=0.1, target=0.9,
                           window_s=30.0, min_count=5, metric="ttft"),
                 hist._only())
        t = 2000.0
        tr.sample(now=t)
        for _ in range(20):
            tr.observe_class("high", 0.02)   # all good
            tr.observe_class("low", 0.5)     # all bad
        tr.sample(now=t + 10)
        cls = tr.state()["classes"]
        assert cls["high"]["budget_remaining"] == pytest.approx(1.0)
        assert cls["low"]["budget_remaining"] == 0.0
        assert cls["low"]["bad"] == 20
        states.append(tr.state())
    assert states[0] == states[1]


# ---------------------------------------------------------- capacity
def _summaries(requests=20, wall_s=10.0, device_s=4.0, host_s=1.0):
    loop = {"wall_s": wall_s, "device_busy_s": device_s,
            "phases": {"sweep": host_s + device_s}}
    cost = {"kinds": {
        "prefill": {"wall_s": 3.0, "roofline": "compute-bound",
                    "mfu": 0.4, "membw_util": 0.2},
        "decode": {"wall_s": 1.0, "roofline": "memory-bound",
                   "mfu": 0.05, "membw_util": 0.6}}}
    usage = {"totals": {"requests": requests, "device_s": device_s,
                        "prefill_tokens": 400, "decode_tokens": 100}}
    return loop, cost, usage


def test_estimate_capacity_prices_device_and_host_seconds():
    loop, cost, usage = _summaries()
    cap = estimate_capacity(loop, cost, usage, max_slots=4,
                            service="t")
    assert cap["ready"]
    # 4s device + 1s non-overlapped host over 20 requests = 0.25s/req
    assert cap["sustainable_rps"] == pytest.approx(4.0)
    assert cap["observed_rps"] == pytest.approx(2.0)
    assert cap["utilization"] == pytest.approx(0.5)
    assert cap["headroom"] == pytest.approx(0.5)
    assert cap["roles"]["bound"] == "prefill"
    assert cap["roles"]["prefill"]["wall_fraction"] == \
        pytest.approx(0.75)
    # serializing 75% of device wall bounds disaggregation at 1/0.75
    assert cap["roles"]["disaggregation_speedup_bound"] == \
        pytest.approx(1.333, abs=1e-3)
    assert cap == jcapacity.estimate_capacity(loop, cost, usage,
                                              max_slots=4, service="t")


def test_capacity_not_ready_before_traffic():
    cap = estimate_capacity({}, {}, {}, service="t")
    assert cap["ready"] is False and "reason" in cap
    assert cap == jcapacity.estimate_capacity({}, {}, {}, service="t")


def test_replicas_needed_moves_with_offered_load():
    loop, cost, usage = _summaries()
    per = {"r0": estimate_capacity(loop, cost, usage),
           "r1": estimate_capacity(loop, cost, usage)}
    fleet = aggregate_fleet_capacity(per)
    assert fleet["ready"] and fleet["replicas_ready"] == ["r0", "r1"]
    assert fleet["sustainable_rps"] == pytest.approx(8.0)
    base = fleet["replicas_needed"]
    doubled = aggregate_fleet_capacity(
        per, offered_rps=2 * fleet["observed_rps"])
    assert doubled["replicas_needed"] >= base
    # the what-if helper agrees with the aggregate
    assert replicas_needed(fleet, 9.0) == 3
    assert replicas_needed(fleet, 0.5) == 1
    assert fleet == jcapacity.aggregate_fleet_capacity(per)
    for offered in (None, 0.0, 0.5, 9.0, 2 * fleet["observed_rps"]):
        assert aggregate_fleet_capacity(
            per, offered_rps=offered, fleet="f") == \
            jcapacity.aggregate_fleet_capacity(
                per, offered_rps=offered, fleet="f")


def test_aggregate_skips_unready_replicas():
    loop, cost, usage = _summaries()
    per = {"r0": estimate_capacity(loop, cost, usage),
           "r1": estimate_capacity({}, {}, {}),
           "r2": None}
    fleet = aggregate_fleet_capacity(per)
    assert fleet["replicas_ready"] == ["r0"]
    assert fleet["replicas"]["r1"]["ready"] is False
    assert fleet["replicas"]["r2"]["ready"] is False
    assert fleet["sustainable_rps"] == pytest.approx(4.0)
    assert fleet == jcapacity.aggregate_fleet_capacity(per)
    assert aggregate_fleet_capacity({"r0": None}) == \
        jcapacity.aggregate_fleet_capacity({"r0": None})


# ------------------------------------------- hermetic fleet over HTTP
def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        ctype = r.headers.get("Content-Type", "")
        body = r.read().decode()
    return ctype, body


def test_front_door_serves_timeseries_capacity_dashboard(lm):
    reps = [InProcessReplica(
        f"r{i}", ContinuousBatchingEngine(
            lm, max_slots=2, prefill_chunk=4,
            timeseries_interval_s=0.05,
            slo_objectives=[dict(name="ttft", metric="ttft",
                                 threshold_s=5.0, target=0.9,
                                 window_s=30.0, min_count=3)]))
        for i in range(2)]
    sup = ReplicaSupervisor(reps, chunk=4, poll_interval=0.05,
                            registry=MetricRegistry())
    r = np.random.RandomState(5)
    with sup, FleetFrontDoor(sup) as door:
        base = f"http://127.0.0.1:{door.port}"
        routed = [sup.submit(r.randint(0, VOCAB, (6,)), 6)
                  for _ in range(6)]
        for rt in routed:
            rt.handle.result(timeout=60)
        time.sleep(0.3)  # a few sampler ticks past the last finish

        ctype, body = _get(base, "/debug/fleet/timeseries")
        assert ctype.startswith("application/json")
        ts = json.loads(body)
        assert sorted(ts["replicas"]) == ["r0", "r1"]
        assert ts["errors"] == {}
        assert set(ts["clock"]) == {"r0", "r1"}
        assert ts["metrics"], "no sampler rings shipped"
        for slot in ts["metrics"].values():
            assert set(slot) == {"replicas", "fleet"}
            for rep in slot["replicas"].values():
                stamps = [t for t, _ in rep["points"]]
                assert stamps == sorted(stamps)
        # the metric filter narrows without changing the schema
        one = json.loads(_get(
            base, "/debug/fleet/timeseries?metric=queue_depth&n=4")[1])
        assert set(one["metrics"]) <= {"queue_depth"}

        ctype, body = _get(base, "/debug/fleet/capacity")
        assert ctype.startswith("application/json")
        cap = json.loads(body)
        assert cap["ready"] and sorted(cap["replicas_ready"]) == ["r0", "r1"]
        assert set(cap["replicas"]) == {"r0", "r1"}
        assert cap["replicas_needed"] >= 1
        assert set(cap["slo_budget"]) == {"r0", "r1"}
        for ledger in cap["slo_budget"].values():
            assert ledger["objectives"][0]["objective"] == "ttft"
        # the what-if: double the offered load, never fewer replicas
        what_if = json.loads(_get(
            base, "/debug/fleet/capacity?offered="
            f"{2 * cap['offered_rps']}")[1])
        assert what_if["replicas_needed"] >= cap["replicas_needed"]

        ctype, body = _get(base, "/debug/fleet/dashboard")
        assert ctype.startswith("text/html")
        assert "<svg" in body and "r0" in body and "r1" in body
        assert "SLO error budgets" in body
        assert "src=" not in body and "href=" not in body
