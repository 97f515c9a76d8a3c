"""QoS in the port's ContinuousBatchingEngine (bigdl_tpu_torch/serving/):
burn-rate load shedding and per-tenant token buckets (the engine cases of
tests/test_serving_qos.py; its queue and bucket units are held by
tests/test_torch_serving_scheduler.py, and its two front-door cases wait
for the fleet, ROADMAP.md Queue 1 item 11), and the SLO watchdog that
drives the shedding, held to the JAX package's.

The contract: under a TTFT burn (synthetic through the chaos injector,
or real through the SloWatchdog) ``submit`` refuses the shed classes
with ``RequestShed`` (low first, normal too only when severe), and
``high`` never sheds; a tenant past its device-second bucket is refused
with ``RequestRateLimited``; both carry ``retry_after_s > 0``; every
submission ends in exactly one counted outcome. Where the JAX tests read
flight-recorder events (the port has no recorder yet), these read the
finished-timeline ring's outcomes.
"""

import time

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import observability as jobs
from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.observability.instruments import TIME_BUCKETS as J_BUCKETS
from bigdl_tpu.observability.watchdog import SloObjective as JaxObjective
from bigdl_tpu.observability.watchdog import SloWatchdog as JaxWatchdog
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.observability import (
    TIME_BUCKETS, Histogram, SloObjective, SloWatchdog,
)
from bigdl_tpu_torch.serving import (
    ChaosInjector, ContinuousBatchingEngine, RequestRateLimited,
    RequestShed,
)
from bigdl_tpu_torch.utils.weights import load_jax_params

CFG = dict(vocab_size=32, embed_dim=16, num_heads=4, num_kv_heads=2,
           num_layers=2, max_len=48, use_rope=True)


@pytest.fixture(scope="module")
def lm():
    from bigdl_tpu.utils import random as rnd

    rnd.set_seed(21)
    jm = JaxLM(**CFG)
    tm = TransformerLM(**CFG, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    tm.evaluate()
    return tm


def _outcomes(eng):
    with eng._timelines_lock:
        return [t["outcome"] for t in eng._timelines]


# ------------------------------------------------- engine shed gates
def test_chaos_burn_sheds_low_then_normal_never_high(lm):
    """The synthetic burn drill: active → only low sheds; severe →
    normal sheds too; high ALWAYS admits. Clearing the burn restores
    admission, and every rejection is terminal and counted."""
    chaos = ChaosInjector()
    p = np.asarray([1, 2, 3])
    with ContinuousBatchingEngine(lm, max_slots=2,
                                  shed_classes=("low", "normal"),
                                  chaos=chaos) as eng:
        chaos.force_burn(active=True)
        with pytest.raises(RequestShed) as ei:
            eng.submit(p, 2, priority="low")
        assert ei.value.retry_after_s > 0
        eng.submit(p, 2, priority="normal").result(timeout=60)
        chaos.force_burn(active=True, severe=True)
        with pytest.raises(RequestShed) as ei:
            eng.submit(p, 2, priority="normal")
        assert ei.value.retry_after_s > 0
        eng.submit(p, 2, priority="high").result(timeout=60)
        chaos.force_burn(active=False)
        eng.submit(p, 2, priority="low").result(timeout=60)
        qos = eng.stats()["qos"]
        assert qos["shed"] == 2
        assert qos["chaos"]["burn"] is False
    # the rejections are the requests' terminal outcomes, billed
    assert _outcomes(eng).count("shed") == 2
    assert eng.stats()["usage"]["totals"]["requests"] == 5


def test_real_slo_burn_drives_shedding(lm):
    """The non-synthetic path: a hair-trigger TTFT objective (every
    observation is bad) trips the SloWatchdog after ``min_count``
    requests and admission starts shedding with a ``slo:`` source."""
    p = np.asarray([1, 2, 3])
    with ContinuousBatchingEngine(
            lm, max_slots=2,
            slo_objectives=[{"name": "ttft_burn", "metric": "ttft",
                             "threshold_s": 1e-4, "target": 0.9,
                             "window_s": 30.0, "min_count": 2}],
            shed_classes=("low",)) as eng:
        for _ in range(2):
            eng.submit(p, 2, priority="high").result(timeout=60)
        shed = None
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and shed is None:
            try:
                # each non-shed probe adds another bad observation
                eng.submit(p, 2, priority="low").result(timeout=60)
            except RequestShed as e:
                shed = e
        assert shed is not None, "SLO burn never tripped shedding"
        assert shed.retry_after_s > 0
        st = eng.stats()
        qos = st["qos"]
        assert qos["shedding"]["source"] == "slo:ttft_burn"
        assert qos["shedding"]["burn_rate"] >= 2.0
        assert qos["shed"] >= 1
        alerts = st["alerts"]
        assert [a["alert"] for a in alerts] == ["slo:ttft_burn"]
        assert eng.alerts() == alerts


def test_tenant_token_bucket_rate_limits(lm):
    """A tenant past its device-second budget gets ``RequestRateLimited``
    with the refill-derived retry hint; other tenants are untouched; the
    bucket state is in ``stats()["qos"]["rate_limits"]``."""
    p = np.asarray([1, 2, 3, 4, 5, 6, 7, 8])
    with ContinuousBatchingEngine(
            lm, max_slots=2,
            tenant_rate_limits={"greedy": (0.001, 0.0005)}) as eng:
        eng.submit(p, 12, tenant="greedy").result(timeout=60)
        limited = None
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and limited is None:
            # the debit is post-paid on the loop thread: retry until it
            # lands and the bucket goes negative
            try:
                eng.submit(p, 12, tenant="greedy").result(timeout=60)
            except RequestRateLimited as e:
                limited = e
        assert limited is not None, "bucket never went negative"
        assert limited.retry_after_s > 0
        # an unmetered tenant sails through while greedy is throttled
        eng.submit(p, 2, tenant="polite").result(timeout=60)
        qos = eng.stats()["qos"]
        assert qos["rate_limited"] >= 1
        assert qos["rate_limits"]["greedy"]["level_device_s"] < 0
        assert set(qos["rate_limits"]) == {"greedy"}
    assert "rate_limited" in _outcomes(eng)


def test_concurrent_submit_meets_the_unsettled_bill(lm):
    """The bucket is debited when a request ends, so a request in flight
    has not been debited yet; the port counts what it has been metered so
    far against the balance. While the tenant's first request is still
    decoding with more than the burst metered, its second submit is
    refused with the refill-derived retry hint, and the first is debited
    in full when it ends. (The JAX engine admits that second submit:
    ROADMAP.md Queue 3.)"""
    p = np.asarray([1, 2, 3, 4, 5, 6, 7, 8])
    with ContinuousBatchingEngine(
            lm, max_slots=2,
            tenant_rate_limits={"greedy": (0.001, 0.0005)}) as eng:
        # every program's first call is unbilled: warm them unmetered
        eng.submit(p, 4, tenant="polite").result(timeout=60)
        bucket = eng._tenant_bucket("greedy")
        h = eng.submit(p, 40, tenant="greedy")
        deadline = time.monotonic() + 30
        while h._usage.device_s <= 0.0005 and time.monotonic() < deadline:
            time.sleep(0.0005)
        with pytest.raises(RequestRateLimited) as e:
            eng.submit(p, 2, tenant="greedy")
        # still streaming after the refusal: nothing was debited at the
        # gate, the refusal came from the unsettled bill
        assert not h.done(), "the request ended before the second submit"
        assert bucket.level() > 0
        assert e.value.retry_after_s > 0
        h.result(timeout=60)
        assert bucket.level() <= 0.0005 - h._usage.device_s + 1e-3
        assert eng._unsettled["greedy"] == set()
        assert eng.stats()["qos"]["rate_limited"] == 1


def test_rate_limit_dict_form_and_default_bucket(lm):
    """``{"rate": , "burst": }`` and the ``"*"`` default: a tenant with
    no entry of its own gets a bucket from ``"*"``."""
    with ContinuousBatchingEngine(
            lm, max_slots=1,
            tenant_rate_limits={"*": {"rate": 2.0, "burst": 3.0},
                                "vip": (5.0, 7.0)}) as eng:
        eng.submit(np.asarray([1, 2]), 2, tenant="anyone").result(60)
        rl = eng.stats()["qos"]["rate_limits"]
    assert rl["vip"]["burst_device_s"] == 7.0
    assert rl["anyone"]["rate_device_s_per_s"] == 2.0
    assert rl["anyone"]["burst_device_s"] == 3.0


def test_no_silent_drops_every_submit_is_conserved(lm):
    """Across finished, shed, rate-limited and cancelled submissions, the
    engine's terminal counts equal the number of submits."""
    chaos = ChaosInjector()
    p = np.asarray([1, 2, 3])
    submits = client_terminal = 0
    with ContinuousBatchingEngine(
            lm, max_slots=2, shed_classes=("low",),
            tenant_rate_limits={"greedy": (0.0001, 0.0001)},
            chaos=chaos) as eng:
        for _ in range(3):
            submits += 1
            eng.submit(p, 2).result(timeout=60)
            client_terminal += 1
        chaos.force_burn(active=True)
        for _ in range(2):
            submits += 1
            with pytest.raises(RequestShed):
                eng.submit(p, 2, priority="low")
            client_terminal += 1
        chaos.force_burn(active=False)
        submits += 1
        eng.submit(p, 2, tenant="greedy").result(timeout=60)
        client_terminal += 1
        deadline = time.monotonic() + 30
        limited = False
        while time.monotonic() < deadline and not limited:
            submits += 1
            try:
                eng.submit(p, 2, tenant="greedy").result(timeout=60)
            except RequestRateLimited:
                limited = True
            client_terminal += 1
        assert limited
        submits += 1
        h = eng.submit(p, 40)
        h.cancel()
        client_terminal += 1
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not h.done():
            time.sleep(0.01)
        st = eng.stats()
        qos = st["qos"]
        engine_terminal = (st["finished"] + qos["shed"]
                           + qos["rate_limited"] + st["cancelled"]
                           + st["timed_out"])
        assert engine_terminal == submits == client_terminal
        # the ledger billed every one of them too
        assert st["usage"]["totals"]["requests"] == submits
        assert st["usage"]["totals"]["in_flight"] == 0


def test_stats_qos_block_shape(lm):
    with ContinuousBatchingEngine(
            lm, max_slots=1, preempt_slack_s=0.5,
            shed_classes=("low", "normal"),
            tenant_rate_limits={"t": (1.0, 1.0)}) as eng:
        eng.submit(np.asarray([1, 2]), 2).result(timeout=60)
        st = eng.stats()
    qos = st["qos"]
    assert set(qos) == {"shedding", "shed_classes_configured",
                        "preempt_slack_s", "queue_by_class", "rate_limits",
                        "preempted", "shed", "rate_limited"}
    assert qos["shedding"] == {"active": False, "severe": False,
                               "burn_rate": 0.0, "source": None,
                               "classes": []}
    assert qos["shed_classes_configured"] == ["low", "normal"]
    assert qos["preempt_slack_s"] == 0.5
    assert set(qos["queue_by_class"]) == {"high", "normal", "low"}
    assert qos["preempted"] == qos["shed"] == qos["rate_limited"] == 0
    assert set(qos["rate_limits"]["t"]) == {
        "rate_device_s_per_s", "burst_device_s", "level_device_s"}
    assert st["alerts"] == []
    # the JAX engine's defaults: preemption at 0.25 s, low sheds
    eng = ContinuousBatchingEngine(lm, max_slots=1, chaos=ChaosInjector())
    qos = eng.stats()["qos"]
    assert qos["preempt_slack_s"] == 0.25
    assert qos["shed_classes_configured"] == ["low"]
    assert set(qos["chaos"]) == {"burn", "burn_severe", "fail_dispatch_in",
                                 "frozen_slots", "dispatches_seen",
                                 "iterations_seen", "faults_raised"}


def test_qos_ctor_validation(lm):
    with pytest.raises(ValueError, match="preempt_slack_s"):
        ContinuousBatchingEngine(lm, preempt_slack_s=-0.1)
    with pytest.raises(ValueError, match="shed_classes"):
        ContinuousBatchingEngine(lm, shed_classes=("high",))
    with pytest.raises(ValueError, match="shed_classes"):
        ContinuousBatchingEngine(lm, shed_classes=("urgent",))
    with pytest.raises(ValueError, match="unknown engine metric"):
        ContinuousBatchingEngine(lm, slo_objectives=[
            {"name": "x", "metric": "decode", "threshold_s": 1.0}])
    with pytest.raises(ValueError, match="target"):
        ContinuousBatchingEngine(lm, slo_objectives=[
            {"name": "x", "metric": "ttft", "threshold_s": 1.0,
             "target": 1.5}])
    with pytest.raises(ValueError, match="rate_per_s"):
        ContinuousBatchingEngine(lm, tenant_rate_limits={"t": (0.0, 1.0)})
    with pytest.raises(ValueError, match="max_tenants"):
        ContinuousBatchingEngine(lm, usage_tenants=0)
    # an SloObjective instance binds as well as its keyword dict
    eng = ContinuousBatchingEngine(lm, slo_objectives=[
        SloObjective("q", 0.5, metric="queue_wait")])
    assert [o.name for o in eng._slo_wd.objectives] == ["q"]


# ------------------------------------------------------ the watchdog
_OBJECTIVES = [
    # name, threshold, target, window, burn threshold, min count
    ("between_edges", 0.003, 0.9, 10.0, 2.0, 3),
    ("below_smallest_edge", 5e-5, 0.5, 10.0, 2.0, 2),
    ("on_an_edge", 0.01, 0.8, 4.0, 1.5, 4),
    ("hair_trigger", 1e-4, 0.99, 30.0, 2.0, 1),
]


def test_slo_watchdog_burn_and_alerts_equal_the_jax_watchdog():
    """The JAX SloWatchdog over a JAX registry histogram and the port's
    over its ``Histogram``, fed the same observations on the same fake
    clock: the burn evaluation (the pessimistic good edge, the
    window_s / 256 snapshot spacing, min_count, the hysteresis) gives the
    same ``state()`` and the same alerts (but for their wall-clock
    ``since``) after every sample."""
    assert TIME_BUCKETS == J_BUCKETS
    reg = jobs.MetricRegistry()
    rec = jobs.FlightRecorder()
    jwd = JaxWatchdog("unit", registry=reg, recorder=rec)
    twd = SloWatchdog("unit")
    jhists, thists = {}, {}
    for name, thr, target, window, burn, mc in _OBJECTIVES:
        jh = reg.histogram(f"slo_test_{name}_seconds", "x",
                           labelnames=("service",),
                           buckets=J_BUCKETS).labels("unit")
        th = Histogram()
        jhists[name], thists[name] = jh, th
        jwd.watch(JaxObjective(name, thr, target=target, window_s=window,
                               burn_threshold=burn, min_count=mc), jh)
        twd.watch(SloObjective(name, thr, target=target, window_s=window,
                               burn_threshold=burn, min_count=mc), th)
    r = np.random.RandomState(4)
    now = 100.0
    raised = cleared = 0
    was = set()
    for step in range(400):
        # a calm phase, a storm of slow observations, then calm again:
        # alerts must raise in the storm and clear after it
        slow = 120 <= step < 220
        for name in jhists:
            for _ in range(int(r.randint(0, 4))):
                v = float(r.lognormal(np.log(0.05 if slow else 0.002),
                                      1.0))
                jhists[name].observe(v)
                thists[name].observe(v)
        now += float(r.uniform(0.0, 0.08))
        assert jwd.sample(now) == twd.sample(now)
        assert jwd.state() == twd.state()
        strip = [{k: v for k, v in a.items() if k != "since"}
                 for a in jwd.alerts()]
        assert strip == [{k: v for k, v in a.items() if k != "since"}
                         for a in twd.alerts()]
        now_active = {a["alert"] for a in strip}
        raised += len(now_active - was)
        cleared += len(was - now_active)
        was = now_active
    assert raised >= 2 and cleared >= 1, (raised, cleared)
    for name in thists:
        assert thists[name].get() == jhists[name].get()


def test_pop_oldest_takes_the_longest_waiting_live_handle_of_a_class():
    """``AdmissionQueue.pop_oldest`` (the port's pop after a preemption):
    the oldest live handle of the class, wherever it sits, skipping
    cancelled ones and leaving the rest in order; None when none."""
    from bigdl_tpu_torch.serving import AdmissionQueue, RequestHandle

    hist = Histogram()
    q = AdmissionQueue(capacity=8, wait_histogram=hist)
    dead = RequestHandle(np.asarray([1]), 2, priority="high")
    low = RequestHandle(np.asarray([2]), 2, priority="low")
    first = RequestHandle(np.asarray([3]), 2, priority="high")
    second = RequestHandle(np.asarray([4]), 2, priority="high")
    for h in (dead, low, first, second):
        q.put(h)
    dead.cancel()
    assert q.pop_oldest("normal") is None
    assert q.pop_oldest("high") is first
    assert q.pop_oldest("high") is second
    assert q.pop_oldest("high") is None
    assert q.snapshot() == [dead, low]
    assert hist.get()[2] == 2


# ------------------------------------------------------------ the storm
def test_qos_storm_workload_matches_jax():
    """The same seed gives the JAX package's storm: arrivals, prompts,
    decode lengths, classes and tenants."""
    from bigdl_tpu.serving.benchmark import qos_storm_workload as jax_wl
    from bigdl_tpu_torch.serving import qos_storm_workload

    for seed in (0, 3):
        ours = qos_storm_workload(24, 20.0, 32000, n_greedy=3, seed=seed)
        theirs = jax_wl(24, 20.0, 32000, n_greedy=3, seed=seed)
        assert len(ours) == len(theirs) == 27
        for a, b in zip(ours, theirs):
            assert set(a) == set(b)
            assert a["arrival_s"] == b["arrival_s"]
            np.testing.assert_array_equal(a["prompt"], b["prompt"])
            assert (a["n"], a["priority"], a["tenant"]) == \
                (b["n"], b["priority"], b["tenant"])


def test_run_qos_storm_fires_every_mechanism():
    """``run_qos_storm`` at the JAX defaults on a small model (a window
    long enough for the 96-112-token interactive prompts): the storm
    sheds, preempts and rate-limits (the greedy tenant's later requests
    meet its bucket overdrawn by its first request's bill, settled or
    still in flight, in both legs), every submit ends in one outcome,
    and the tenants'
    device-seconds conserve the busy total. One intra-op thread: on a
    shared CPU the thread pool's overhead dominates this model's ops
    (tens of ms an iteration against under one), and the storm's
    timing (the watchdog's trip, the bucket's debt) assumes the
    engine keeps up with 20 arrivals a second."""
    from bigdl_tpu_torch.serving import run_qos_storm

    m = TransformerLM(64, embed_dim=64, num_heads=4, num_kv_heads=2,
                      num_layers=2, max_len=160, use_rope=True, seed=5,
                      device="cpu")
    m.evaluate()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = run_qos_storm(m)
    finally:
        torch.set_num_threads(threads)
    assert res["shed"] > 0 and res["preempted"] > 0, res["qos"]["outcomes"]
    assert res["rate_limited"] > 0
    assert res["uncontended"]["outcomes"]["rate_limited"] > 0
    assert res["conservation_ok"] is True
    storm = res["qos"]
    assert sum(storm["outcomes"].values()) == storm["submitted"] == 27
    assert storm["tenants"]["greedy"]["requests"] == 3
    assert storm["tenants"]["greedy"]["decode_tokens"] == 16
    gp = storm["goodput"]
    assert abs(sum(t["device_s"] for t in storm["tenants"].values())
               - gp["device_seconds"]["total"]) \
        <= 1e-6 + 1e-3 * gp["device_seconds"]["total"]
    assert res["high_ttft_p50_ratio"] is not None
    assert [a["alert"] for a in storm["alerts"]] == ["slo:ttft_burn"]
