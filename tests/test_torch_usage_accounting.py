"""Per-request usage accounting in the port (bigdl_tpu_torch/observability/
accounting.py and its serving-engine wiring) against the JAX package's
(the cases of tests/test_usage_accounting.py that need no metric
registry, flight recorder or HTTP front door: those wait for ROADMAP.md
Queue 1 item 11; the metrics-lint drift case has no counterpart here).

The contract is CONSERVATION: a finished request's ledgered token counts
equal its delivered tokens exactly (``prefill + prefix_reused ==
prompt``, ``decode == timeline tokens``), and the device-seconds summed
across all tenants equal the engine's measured dispatch busy time
(every dispatch's wall splits across the rows it advanced with weights
summing to 1). The same scripted ledger calls give the JAX ledger's
``summary()`` exactly (host arithmetic). The tenant cap folds overflow
names into ``"other"``; queue-dropped requests are billed their queue
wait; a paged engine bills the pages each request holds.
"""

import sys
import threading

import jax
import numpy as np
import pytest

from bigdl_tpu import observability as jobs
from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.observability.accounting import UsageLedger as JaxLedger
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.nn.quantized import Quantizer
from bigdl_tpu_torch.observability import UsageLedger
from bigdl_tpu_torch.serving import ContinuousBatchingEngine
from bigdl_tpu_torch.utils.weights import load_jax_params

CFG = dict(vocab_size=32, embed_dim=16, num_heads=4, num_kv_heads=2,
           num_layers=2, max_len=48, use_rope=True)


@pytest.fixture(scope="module")
def lm():
    from bigdl_tpu.utils import random as rnd

    rnd.set_seed(37)
    jm = JaxLM(**CFG)
    tm = TransformerLM(**CFG, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    tm.evaluate()
    return tm


def _engine(lm, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("prefill_chunk", 4)
    return ContinuousBatchingEngine(lm, **kw)


def _conserves(summary, rel=1e-3):
    """Tenant device-second sums match the measured busy time."""
    attributed = sum(a["device_s"]
                     for a in summary["tenants"].values())
    busy = summary["goodput"]["device_seconds"]["total"]
    return abs(attributed - busy) <= 1e-6 + rel * busy


# ------------------------------------------------------- ledger units
def test_ledger_unit_conservation_and_residency():
    led = UsageLedger(service="unit", slot_row_bytes=1000,
                      staging_row_bytes=500, token_bytes=10.0)
    a = led.begin("req-a", "alice", prompt_tokens=8, max_new_tokens=4,
                  submitted_at=0.0)
    b = led.begin("req-b", None, prompt_tokens=6, max_new_tokens=4,
                  submitted_at=4.0)
    assert a.tenant == "alice" and b.tenant == "default"
    assert led.totals()["in_flight"] == 2

    # admission at t=10: queue wait closes + the reuse credit lands
    led.admitted(a, 10.0, reused_tokens=4)
    led.admitted(b, 10.0)
    assert a.queue_wait_s == 10.0 and b.queue_wait_s == 6.0
    assert a.prefix_reused_tokens == 4 and a.prefix_bytes_saved == 40

    # one prefill dispatch advancing both rows, 3:1 by tokens
    led.add_prefill(a, 4)
    led.add_prefill(b, 6)
    led.charge_dispatch("prefill", 2.0, [(a, 0.75), (b, 0.25)],
                        rows_advanced=2, capacity_rows=4)
    assert a.device_prefill_s == pytest.approx(1.5)
    assert b.device_prefill_s == pytest.approx(0.5)

    # staging held 10->12 (500 B x 2 s), slot 12->22 (1000 B x 10 s)
    led.slot_acquired(a, 12.0)
    assert a.kv_byte_seconds == pytest.approx(1000.0)
    led.delivered(a, 1)
    led.charge_dispatch("decode", 1.0, [(a, 1.0)],
                        rows_advanced=1, capacity_rows=2)
    led.finalize(a, "finished", 22.0)
    assert a.kv_byte_seconds == pytest.approx(1000.0 + 10000.0)
    # double-finalize is a no-op (the _finish_handle race contract)
    led.finalize(a, "cancelled", 99.0)
    assert a.outcome == "finished"
    led.finalize(b, "timed_out", 30.0)

    t = led.tenants()
    assert t["alice"]["requests"] == 1 and t["alice"]["finished"] == 1
    assert t["default"]["finished"] == 0
    assert led.totals()["in_flight"] == 0
    assert _conserves(led.summary())
    gp = led.goodput()
    assert gp["device_seconds"] == {"prefill": 2.0, "decode": 1.0,
                                    "total": 3.0}
    # waste: prefill round left 2/4 rows idle, decode 1/2
    assert gp["padding_waste_mean"] == pytest.approx(0.5)
    # utilization is wall-weighted: (2*2 + 1*1) / (4*2 + 2*1)
    assert gp["utilization"] == pytest.approx(0.5)
    assert gp["tokens_per_device_second"] == pytest.approx(1 / 3.0,
                                                           abs=0.01)
    assert [r["outcome"] for r in led.top_requests(5)] == \
        ["finished", "timed_out"]
    with pytest.raises(ValueError):
        led.charge_dispatch("verify", 1.0, [], 1, 1)
    with pytest.raises(ValueError):
        UsageLedger(max_tenants=0)
    with pytest.raises(ValueError):
        UsageLedger(devices=0)


def test_tenant_cardinality_cap_folds_overflow():
    led = UsageLedger(service="cap", max_tenants=2)
    assert led.resolve_tenant("a") == "a"
    assert led.resolve_tenant("b") == "b"
    # budget spent: new names fold into "other"...
    assert led.resolve_tenant("c") == "other"
    assert led.resolve_tenant("d") == "other"
    # ...while known names keep resolving to themselves (stable)
    assert led.resolve_tenant("a") == "a"
    for name in ("a", "b", "c", "d"):
        r = led.begin(f"req-{name}", name, 4, 2)
        led.delivered(r, 2)
        led.finalize(r, "finished", 1.0)
    t = led.tenants()
    assert set(t) == {"a", "b", "other"}
    assert t["other"]["requests"] == 2
    assert t["other"]["decode_tokens"] == 4


def test_scripted_ledger_summary_equals_the_jax_ledgers():
    """One scripted sequence of every ledger call on a fake clock
    (begin, admitted with reuse, add_prefill, charge_dispatch of both
    kinds with uneven shares, slot_acquired, delivered, preempted and a
    re-admission, accrue_kv, finalize of every outcome, a tenant past
    the cap) through both packages' ledgers: ``summary(top_n=)`` and
    every record's ``to_dict()`` are equal, number for number."""
    kw = dict(max_tenants=3, recent=4, slot_row_bytes=4096,
              staging_row_bytes=2048, token_bytes=12.5)
    jled = JaxLedger(service="s", registry=jobs.MetricRegistry(),
                     recorder=jobs.FlightRecorder(), **kw)
    tled = UsageLedger(service="s", **kw)
    r = np.random.RandomState(8)
    tenants = ["a", "b", None, "c", "d", "a", "e"]
    recs = {"j": [], "t": []}
    now = 0.0
    for i, ten in enumerate(tenants):
        now += float(r.uniform(0.0, 0.5))
        for key, led in (("j", jled), ("t", tled)):
            recs[key].append(led.begin(f"req-{i}", ten, 8 + i, 6,
                                       submitted_at=now))
    ops = []
    for step in range(60):
        now += float(r.uniform(0.001, 0.2))
        i = int(r.randint(len(tenants)))
        kind = int(r.randint(8))
        ops.append((now, i, kind, float(r.uniform(0.0, 0.03)),
                    int(r.randint(1, 5)), r.dirichlet(np.ones(3))))
    for key, led in (("j", jled), ("t", tled)):
        rs = recs[key]
        for now_i, i, kind, wall, n, w in ops:
            rec = rs[i]
            if rec.outcome is not None:
                continue
            if kind == 0:
                led.admitted(rec, now_i, reused_tokens=n)
            elif kind == 1:
                led.add_prefill(rec, n)
            elif kind == 2:
                others = [rs[(i + 1) % len(rs)], rs[(i + 2) % len(rs)]]
                led.charge_dispatch(
                    "prefill" if n % 2 else "decode", wall,
                    [(rec, float(w[0])), (others[0], float(w[1])),
                     (others[1], float(w[2]))],
                    rows_advanced=3, capacity_rows=4)
            elif kind == 3:
                led.slot_acquired(rec, now_i)
            elif kind == 4:
                led.delivered(rec, n)
            elif kind == 5:
                led.preempted(rec, now_i)
            elif kind == 6:
                led.accrue_kv(rec, wall * 1e6)
            elif i % 3 == 0:
                led.finalize(rec, ("finished", "cancelled",
                                   "timed_out")[n % 3], now_i)
        for rec in rs:
            led.finalize(rec, "stopped", now + 1.0)
    assert tled.summary(top_n=3) == jled.summary(top_n=3)
    assert [x.to_dict() for x in recs["t"]] == \
        [x.to_dict() for x in recs["j"]]
    assert tled.device_time() == jled.device_time()
    assert set(tled.tenants()) == {"a", "b", "default", "other"}


# -------------------------------------------------- engine integration
def test_engine_conservation_and_tenants(lm):
    r = np.random.RandomState(3)
    with _engine(lm, service_name="usage_eng") as eng:
        reqs = [(5, 6, "alice"), (9, 4, "bob"), (3, 8, None),
                (7, 5, "alice"), (6, 3, "bob")]
        handles = [eng.submit(r.randint(0, 32, (t0,)), n, tenant=t)
                   for t0, n, t in reqs]
        for h in handles:
            h.result(timeout=120)
        more = [eng.submit(r.randint(0, 32, (t0,)), n, tenant=t)
                for t0, n, t in reqs[:3]]
        for h in more:
            h.result(timeout=120)
        st = eng.stats()

        # per-request conservation against the timeline
        for h in handles + more:
            u = h.usage()
            tl = h.timeline()
            assert u["outcome"] == "finished"
            assert u["decode_tokens"] == tl["tokens"]
            assert u["prefill_tokens"] + u["prefix_reused_tokens"] \
                == u["prompt_tokens"]
            assert tl["prefix_tokens"] == u["prefix_reused_tokens"]
            assert u["kv_byte_seconds"] > 0
            assert u["device_s"] >= 0
            assert abs(u["queue_wait_s"] - tl["queue_wait_s"]) < 0.05

        # engine-level conservation: tenant sums == measured busy time
        usage = st["usage"]
        assert _conserves(usage)
        assert usage["goodput"]["device_seconds"]["total"] > 0
        tens = usage["tenants"]
        assert set(tens) == {"alice", "bob", "default"}
        assert usage["totals"]["requests"] == len(handles) + len(more)
        assert usage["totals"]["in_flight"] == 0
        want = sum(len(h._tokens) for h in handles + more)
        assert usage["totals"]["decode_tokens"] == want
        assert usage["goodput"]["tokens_delivered"] == want
        assert 0.0 < usage["goodput"]["utilization"] <= 1.0
        assert usage["max_tenants"] == 32 and usage["devices"] == 1
        # top-N is ordered by attributed device-seconds
        dbg = eng.debug_usage(3)
        assert dbg["service"] == "usage_eng"
        top = dbg["top_requests"]
        assert len(top) == 3
        assert top[0]["device_s"] >= top[1]["device_s"] \
            >= top[2]["device_s"]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_conservation_under_speculative_decode(lm, paged):
    """With a draft (the int8 clone, as the JAX test's), decode walls
    split by per-row delivered tokens: the weights still sum to 1, the
    per-request token identities survive multi-token bursts, and the
    tenant with 20 of the 24 tokens carries more device time (with
    tests/test_speculative_engine.py's
    ``test_variable_advance_usage_weighted_by_accepted``)."""
    draft = Quantizer.quantize(lm)
    draft.evaluate()
    r = np.random.RandomState(9)
    with _engine(lm, service_name="usage_spec", draft=draft,
                 spec_gamma=3, page_size=4 if paged else None) as eng:
        reqs = [(5, 9, "alice"), (8, 4, "bob"), (4, 11, "alice")]
        handles = [eng.submit(r.randint(0, 32, (t0,)), n, tenant=t)
                   for t0, n, t in reqs]
        for h in handles:
            h.result(timeout=120)
        st = eng.stats()
    usage = st["usage"]
    assert _conserves(usage)
    assert st["speculation"]["accepted_tokens"] > 0
    for h, (t0, n, _) in zip(handles, reqs):
        u = h.usage()
        assert u["decode_tokens"] == h.timeline()["tokens"] == n
        assert u["prefill_tokens"] + u["prefix_reused_tokens"] == t0
    want = {"alice": 20, "bob": 4}
    for t, tokens in want.items():
        assert usage["tenants"][t]["decode_tokens"] == tokens
    assert usage["tenants"]["alice"]["device_s"] \
        > usage["tenants"]["bob"]["device_s"]


def test_prefix_reuse_savings_credit(lm):
    head = np.arange(1, 17, dtype=np.int32) % 32
    tails = [np.asarray([7, 9], np.int32), np.asarray([3], np.int32)]
    with _engine(lm, service_name="usage_px", admission_window=1) as eng:
        eng.submit(np.concatenate([head, tails[0]]), 3,
                   tenant="warm").result(timeout=120)
        h = eng.submit(np.concatenate([head, tails[1]]), 3,
                       tenant="warm")
        h.result(timeout=120)
        u = h.usage()
        assert u["prefix_reused_tokens"] == h.prefix_tokens > 0
        assert u["prefix_bytes_saved"] == int(
            u["prefix_reused_tokens"] * eng._token_bytes)
        assert u["prefill_tokens"] + u["prefix_reused_tokens"] \
            == u["prompt_tokens"]
        pc = eng.stats()["prefix_cache"]
        assert pc["bytes_saved"] >= u["prefix_bytes_saved"] > 0
        assert eng.stats()["usage"]["tenants"]["warm"][
            "prefix_reused_tokens"] == u["prefix_reused_tokens"]


def test_concurrent_submits_ledger_consistent(lm):
    r = np.random.RandomState(5)
    names = ["t-a", "t-b", "t-c", "t-d"]  # one past the cap below
    reqs = [(r.randint(0, 32, (int(r.randint(3, 10)),)),
             int(r.randint(2, 6)), names[i % 4]) for i in range(12)]
    errs = []
    with _engine(lm, service_name="usage_cc", usage_tenants=3) as eng:
        handles = [None] * len(reqs)

        def worker(i, p, n, t):
            try:
                handles[i] = eng.submit(p, n, tenant=t)
                handles[i].result(timeout=120)
            except Exception as e:  # pragma: no cover - surfaced below
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(i, p, n, t))
                   for i, (p, n, t) in enumerate(reqs)]
        # switch threads often: a lost update in the ledger's shared
        # counters (submit threads against the loop) would show
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert not errs, errs
        usage = eng.stats()["usage"]
        # 4 names raced for 3 cap slots: whichever 3 won keep their
        # rows, the 4th folded into "other"
        tens = set(usage["tenants"])
        assert "other" in tens and len(tens) == 4
        assert len(tens & set(names)) == 3
        assert usage["totals"]["requests"] == len(reqs)
        assert usage["totals"]["in_flight"] == 0
        by_handle = [h.usage() for h in handles]
        for key in ("decode_tokens", "prefill_tokens",
                    "prefix_reused_tokens"):
            assert usage["totals"][key] == sum(u[key]
                                               for u in by_handle)
        assert usage["totals"]["device_s"] == pytest.approx(
            sum(u["device_s"] for u in by_handle), abs=1e-4)
        assert _conserves(usage)


def test_dropped_requests_still_billed(lm):
    """A request that dies in the queue is finalized with its queue wait
    billed and zero device-seconds."""
    with _engine(lm, service_name="usage_drop") as eng:
        h = eng.submit(np.asarray([1, 2, 3], np.int32), 4,
                       tenant="flaky", timeout_s=0.0)
        with pytest.raises(Exception):
            h.result(timeout=120)
        u = h.usage()
        assert u["outcome"] in ("timed_out", "cancelled")
        assert u["device_s"] == 0.0 and u["decode_tokens"] == 0
        assert u["queue_wait_s"] is not None and u["queue_wait_s"] >= 0
        agg = eng.stats()["usage"]["tenants"]["flaky"]
        assert agg["requests"] == 1 and agg["finished"] == 0


def test_paged_kv_byte_seconds_bill_held_pages(lm):
    """Paged mode bills each request's held pages (pro-rata per
    reference) instead of rows: every finished request is billed > 0,
    the rows' residency terms are zero, and the tenants' total is
    bounded by the pool's capacity over the run's wall time."""
    import time

    r = np.random.RandomState(11)
    reqs = [(r.randint(0, 32, (6,)), 8, "tenant-a"),
            (r.randint(0, 32, (9,)), 8, "tenant-b"),
            (r.randint(0, 32, (4,)), 10, "tenant-a")]
    t0 = time.monotonic()
    with _engine(lm, page_size=4) as eng:
        hs = [eng.submit(p, n, tenant=t) for p, n, t in reqs]
        for h in hs:
            h.result(timeout=120)
        wall = time.monotonic() - t0
        usage = eng.stats()["usage"]
        assert eng._usage.slot_row_bytes == 0
        assert eng._usage.staging_row_bytes == 0
        cap = eng._pages.capacity_bytes
    for h in hs:
        assert h.usage()["kv_byte_seconds"] > 0
    total = sum(a["kv_byte_seconds"] for a in usage["tenants"].values())
    assert 0 < total <= cap * wall
    assert _conserves(usage)


def test_benchmark_legs_carry_the_ledger(lm):
    """The comparisons' engine legs carry the ledger's goodput and
    tenant blocks, and the working-set sweep checks each leg's
    conservation (``ledger_conserved``, the JAX sweep's flag)."""
    from bigdl_tpu_torch.serving import run_working_set_sweep

    res = run_working_set_sweep(lm, working_sets=(2,), device_rows=2,
                                requests_per_template=2, rate_hz=40.0,
                                max_slots=2, prefill_chunk=4,
                                prefill_rows=1, template_len=8)
    assert res["headline"]["ledger_conserved"] is True
    for leg in ("tiered", "device_only", "disabled"):
        assert res["points"][0][leg]["ledger_conserved"] is True
