"""The prefix cache's host tier in the port (bigdl_tpu_torch/serving/
prefix_cache.py, paging.py and the engine's demote and promote moves)
against the JAX package's (the cases of tests/test_tiered_prefix_cache.py
that need no mesh, memory-pool registry, usage ledger or perf gate: those
wait for ROADMAP.md Queue 1 items 10 and 11).

The index: a device eviction demotes into the host tier, which has its
own budget and LRU; pins hold an entry in either tier; every tier move
bumps the generation, so a stale probe is a clean miss. The same scripted
operations give the same stats in both packages. The engine: a one-row
pool under round-robin templates demotes on every donation and promotes
on every revisit, and its rows still equal the cache-off engine's, the
lone ``generate``'s and the JAX engine's; a promotion started while the
request waits in the queue pins its entry until it lands or is dropped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.serving import ContinuousBatchingEngine as JaxEngine
from bigdl_tpu.serving import PrefixCache as JaxPrefixCache
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.nn.quantized import Quantizer
from bigdl_tpu_torch.serving import (ContinuousBatchingEngine, EngineStopped,
                                     PrefixCache, RequestHandle,
                                     run_working_set_sweep)
from bigdl_tpu_torch.utils.weights import load_jax_params

CFG = dict(vocab_size=32, embed_dim=16, num_heads=4, num_kv_heads=2,
           num_layers=2, max_len=48, use_rope=True)


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


def _direct(lm, prompt, n):
    return lm.generate(np.asarray(prompt), n)[0].numpy()


def _demote(pc, entry, buf="host-kv"):
    """Drain the pending-demotion contract as the engine does: claim
    acknowledged, copy done, buffer attached."""
    pend = pc.pop_pending_demotion()
    assert pend is not None and pend[0] is entry
    pc.complete_demotion(entry, buf)
    return pend[1]


def _cycle_requests(rstate, templates, rounds, tail=2, decode=4):
    """Round-robin template traffic: with a one-row device pool every
    revisit forces a demote and a promote."""
    reqs = []
    for i in range(rounds * len(templates)):
        tpl = templates[i % len(templates)]
        reqs.append((np.concatenate(
            [tpl, rstate.randint(0, 32, (tail + i % 2,))]),
            decode + i % 3))
    return reqs


# ---------------------------------------------------- host-tier units
@pytest.mark.parametrize("cls", [PrefixCache, JaxPrefixCache],
                         ids=["port", "jax"])
def test_host_lru_and_byte_budget(cls):
    """Device eviction demotes into the host tier; the host tier has its
    own byte budget and LRU; only attached buffers count as host bytes.
    The port's index and the JAX one, step by step."""
    pc = cls(rows=2, row_bytes=512, min_tokens=4, host_rows=2)
    ts = [np.asarray([k] * 8, np.int32) for k in range(1, 6)]
    assert pc.donate(ts[0]) is not None and pc.donate(ts[1]) is not None
    assert pc.host_capacity_bytes == 2 * 512
    assert pc.host_bytes_in_use == 0
    # third donation: the device LRU (ts[0]) demotes instead of dropping
    assert pc.donate(ts[2]) is not None
    e0, m = pc.lookup(ts[0])
    assert m == 8 and e0.tier == "host"
    assert pc.host_bytes_in_use == 0          # copy still pending
    _demote(pc, e0)
    assert pc.host_bytes_in_use == 512
    assert pc.stats()["demotions"] == 1
    # fourth: ts[1] demotes too, the host tier is at its budget
    assert pc.donate(ts[3]) is not None
    e1, _ = pc.lookup(ts[1])
    _demote(pc, e1)
    assert pc.host_bytes_in_use == 2 * 512 == pc.host_capacity_bytes
    assert pc.stats()["host_entries"] == 2
    # fifth: the host tier is full, so its LRU (ts[0]) leaves the cache
    assert pc.donate(ts[4]) is not None
    assert pc.stats()["host_evictions"] == 1
    assert pc.lookup(ts[0])[0] is None
    e, _ = pc.lookup(ts[1])
    assert e is not None and e.tier == "host"
    pc.record_hit(e, 8, host=True)
    s = pc.stats()
    assert s["host_hits"] == 1 and s["hits"] == 1
    assert s["device_hits"] == 0
    assert {sn["tier"] for sn in pc.snapshot()} == {"device", "host"}


def test_host_tier_script_matches_jax():
    """One scripted run of donations, demotions, pins, promotions and
    host evictions through both indexes: the same rows, matches, tiers
    and stats at every step."""
    def script(cls):
        pc = cls(rows=2, row_bytes=256, min_tokens=4, host_rows=2)
        out = []
        ts = [np.asarray([k] * 8 + [k + 1] * (k % 3), np.int32)
              for k in range(1, 7)]
        for i, t in enumerate(ts):
            out.append(("donate", pc.donate(t)))
            pend = pc.pop_pending_demotion()
            if pend is not None:
                out.append(("demote", pend[1]))
                pc.complete_demotion(pend[0], None if i == 4 else f"b{i}")
            e, m = pc.lookup(ts[0])
            out.append(("lookup", m, e.tier if e is not None else None))
            if e is not None and e.tier == "host" and e.host_buf:
                pc.acquire(e)
                row = pc.allocate_row()
                pend = pc.pop_pending_demotion()
                if pend is not None:
                    pc.complete_demotion(pend[0], "p")
                if row is not None:
                    pc.promote(e, row)
                pc.release(e)
                out.append(("promote", row))
            out.append(("stats", pc.stats(), pc.generation))
        return out

    assert script(PrefixCache) == script(JaxPrefixCache)


def test_pin_spans_demote_and_blocks_host_eviction():
    """A pin holds an entry in whatever tier it is in: a pinned device
    entry is never demoted, a pinned host entry never host-evicted;
    when every host row is pinned the demotion degrades to a drop."""
    pc = PrefixCache(rows=2, row_bytes=256, min_tokens=4, host_rows=1)
    t1, t2, t3, t4 = (np.asarray([k] * 8, np.int32) for k in range(1, 5))
    assert pc.donate(t1) is not None and pc.donate(t2) is not None
    e1, _ = pc.lookup(t1)
    pc.acquire(e1)
    assert pc.donate(t3) is not None      # the victim is t2, not e1
    assert e1.tier == "device"
    e2, _ = pc.lookup(t2)
    assert e2.tier == "host"
    _demote(pc, e2)
    pc.acquire(e2)                        # the pin spans the host tier
    assert pc.donate(t4) is not None      # t3 cannot spill: it drops
    assert pc.pop_pending_demotion() is None
    assert pc.stats()["host_evictions"] == 0
    assert pc.lookup(t3)[0] is None
    e2b, m = pc.lookup(t2)
    assert e2b is e2 and m == 8 and e2.host_buf == "host-kv"
    pc.release(e1)
    pc.release(e2)


def test_generation_guard_covers_host_tier():
    """Every tier move (demote, host-evict, promote, failed demotion)
    bumps ``generation``, so a probe taken before it is a clean miss."""
    pc = PrefixCache(rows=1, row_bytes=128, min_tokens=4, host_rows=1)
    t1, t2 = np.asarray([1] * 8, np.int32), np.asarray([2] * 8, np.int32)
    assert pc.donate(t1) is not None
    e1, _ = pc.lookup(t1)
    probe_gen = pc.generation
    assert pc.donate(t2) is not None
    assert pc.generation != probe_gen
    assert e1.tier == "host"
    _demote(pc, e1)
    e1b, _ = pc.lookup(t1)
    assert e1b is e1
    probe_gen = pc.generation
    t3 = np.asarray([3] * 8, np.int32)
    assert pc.donate(t3) is not None      # t2 demotes, e1 host-evicts
    assert pc.generation != probe_gen
    assert e1.host_buf is None
    with pytest.raises(RuntimeError, match="non-host"):
        pc.promote(e1, 0)
    pc.complete_demotion(e1, "stale-buffer")   # no-op after eviction
    assert e1.host_buf is None
    assert pc.lookup(t1)[0] is None
    e2, _ = pc.lookup(t2)
    assert e2 is not None and e2.tier == "host"
    gen = pc.generation
    pc.complete_demotion(e2, None)        # a failed copy drops the entry
    assert pc.generation != gen and pc.lookup(t2)[0] is None
    row = pc.allocate_row()
    assert row is not None
    pc.release_row(row)
    assert pc.allocate_row() == row


# ------------------------------------------------- engine: tiered flow
def test_demote_promote_reuse_parity(lms):
    """A one-row device pool under three-template round-robin traffic
    demotes on every donation and promotes on every revisit; every row
    equals the cache-off engine's, the lone generate's and the JAX
    tiered engine's, reuse lands, and the tier counters move as JAX's."""
    jm, lm = lms
    r = np.random.RandomState(31)
    tpls = [r.randint(0, 32, (8,)) for _ in range(3)]
    reqs = _cycle_requests(r, tpls, rounds=3)

    def run(model, engine, **kw):
        with engine(model, max_slots=2, prefill_chunk=4, **kw) as eng:
            handles = [eng.submit(p, n) for p, n in reqs[:1]]
            rows = [np.asarray(handles[0].result(timeout=120))]
            for p, n in reqs[1:]:
                handles.append(eng.submit(p, n))
                rows.append(np.asarray(handles[-1].result(timeout=120)))
            return rows, handles, eng.stats()

    rows_t, handles, st = run(lm, ContinuousBatchingEngine,
                              prefix_cache_rows=1, prefix_host_rows=8)
    rows_d, _, _ = run(lm, ContinuousBatchingEngine, prefix_cache_bytes=0)
    rows_j, _, jst = run(jm, JaxEngine, prefix_cache_rows=1,
                         prefix_host_rows=8)
    for (p, n), rt, rd, rj in zip(reqs, rows_t, rows_d, rows_j):
        want = _direct(lm, p, n)
        np.testing.assert_array_equal(rt, want)
        np.testing.assert_array_equal(rd, want)
        np.testing.assert_array_equal(rj, want)
    pc = st["prefix_cache"]
    assert pc["demotions"] >= 2 and pc["promotions"] >= 2, pc
    assert pc["host_hits"] >= 2, pc
    assert pc["hits"] == pc["host_hits"] + pc["device_hits"]
    assert any(h.prefix_tokens == 8 for h in handles)
    for key in ("hits", "misses", "demotions", "promotions", "host_hits",
                "host_evictions", "host_entries", "host_bytes"):
        assert pc[key] == jst["prefix_cache"][key], key


def test_host_tier_off_by_default(lm):
    """Without ``prefix_host_bytes`` / ``prefix_host_rows`` evictions
    drop: no demotion, no host occupancy."""
    r = np.random.RandomState(33)
    t1, t2 = r.randint(0, 32, (8,)), r.randint(0, 32, (8,))
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                  prefix_cache_rows=1) as eng:
        for t in (t1, t2, t1):
            eng.submit(np.concatenate([t, r.randint(0, 32, (2,))]),
                       3).result(timeout=60)
        pc = eng.stats()["prefix_cache"]
    assert pc["host_rows"] == 0 and pc["demotions"] == 0
    assert pc["evictions"] >= 1 and pc["host_entries"] == 0
    assert pc["host_bytes"] == 0


def test_host_budget_from_bytes(lm):
    """``prefix_host_bytes`` buys whole rows at the engine's row bytes
    (scales included under int8)."""
    for kv in (None, "int8"):
        with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                      kv_dtype=kv, prefix_cache_rows=1,
                                      prefix_host_bytes=1 << 15) as eng:
            pc = eng.stats()["prefix_cache"]
            assert pc["host_rows"] == (1 << 15) // eng._row_bytes
            assert pc["host_capacity_bytes"] == \
                pc["host_rows"] * eng._row_bytes


def test_speculative_decode_with_host_tier_parity(lm):
    """The int8 draft proposes through demote, promote and reuse cycles
    and greedy rows still equal the lone generate's."""
    draft = Quantizer.quantize(lm)
    draft.evaluate()
    r = np.random.RandomState(37)
    tpls = [r.randint(0, 32, (8,)) for _ in range(3)]
    reqs = _cycle_requests(r, tpls, rounds=2, decode=6)
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                  prefix_cache_rows=1, prefix_host_rows=8,
                                  draft=draft, spec_gamma=3) as eng:
        rows = [eng.submit(p, n).result(timeout=180) for p, n in reqs]
        st = eng.stats()
    for (p, n), row in zip(reqs, rows):
        np.testing.assert_array_equal(row, _direct(lm, p, n))
    assert st["prefix_cache"]["promotions"] >= 1
    assert st["speculation"]["proposed_tokens"] > 0


def test_scored_promotion_pins_until_it_lands_or_drops(lm):
    """A queued candidate whose lookup lands on a host entry starts its
    promotion at scoring time, pinning the entry; the admission consumes
    the record (pin released); a record left behind is dropped with its
    pin when the engine stops. Driven on this thread (the loop thread is
    never started), so every step is observable."""
    r = np.random.RandomState(38)
    tpls = [r.randint(0, 32, (8,)) for _ in range(2)]
    eng = ContinuousBatchingEngine(lm, max_slots=1, prefill_chunk=4,
                                   prefix_cache_rows=1, prefix_host_rows=4)

    def serve(prompt, n):
        h = RequestHandle(prompt, n)
        eng._queue.put(h)
        with torch.inference_mode():
            while not h.done():
                eng._iterate()
        return h

    for tpl in tpls:                       # tpl 0 demotes to host
        serve(np.concatenate([tpl, [1, 2]]), 2)
    host = [e for e in eng._prefix._host_entries]
    assert len(host) == 1 and host[0].host_buf is not None
    e0 = host[0]
    # two queued candidates on tpl 0: scoring starts ONE promotion, the
    # admission consumes it with the entry pinned while it lands
    seen = []
    real_promote_entry, real_promote = eng._promote_entry, eng._prefix.promote

    def promote_entry(entry):
        seen.append(("record", id(entry) in eng._promotions, entry.refs))
        return real_promote_entry(entry)

    def promote(entry, row):
        seen.append(("land", entry is e0, entry.refs))
        return real_promote(entry, row)

    eng._promote_entry, eng._prefix.promote = promote_entry, promote
    h1 = RequestHandle(np.concatenate([tpls[0], [3, 4]]), 2)
    h2 = RequestHandle(np.concatenate([tpls[0], [5, 6]]), 2)
    eng._queue.put(h1)
    eng._queue.put(h2)
    with torch.inference_mode():
        while not (h1.done() and h2.done()):
            eng._iterate()
    assert seen[:2] == [("record", True, 1), ("land", True, 1)], seen
    assert h1.prefix_tokens == 8 and h2.prefix_tokens == 8
    assert eng._prefix.stats()["promotions"] >= 1
    assert not eng._promotions
    assert all(e.refs == 0 for e in eng._prefix._entries
               + eng._prefix._host_entries)
    # a record whose request went away is dropped, pin and all, at stop
    serve(np.concatenate([tpls[1], [7, 8]]), 2)   # tpl 0's row demotes
    e = next(x for x in eng._prefix._host_entries if x.host_buf)
    assert e.refs == 0
    with torch.inference_mode():
        eng._begin_promotion(e)
    assert id(e) in eng._promotions and e.refs == 1
    eng.stop(drain=False)
    assert not eng._promotions and e.refs == 0


def test_admission_fault_fails_the_request_instead_of_hanging(lm):
    """A fault inside an admission (a promotion's copy that raises, say)
    crashes the loop; the request being admitted then fails with
    ``EngineStopped`` at once instead of waiting for a result that never
    comes."""
    eng = ContinuousBatchingEngine(lm, max_slots=1, prefill_chunk=4,
                                   prefix_cache_rows=1, prefix_host_rows=2)

    def fault(*_args):
        raise RuntimeError("injected admission fault")

    eng._start_admission = fault
    h = eng.submit(np.arange(6), 2)
    with pytest.raises(EngineStopped):
        h.result(timeout=30)
    eng.stop(drain=False)


def test_paged_host_tier_drains_every_page(lms):
    """The paged host tier under page pressure: entries demote page by
    page and promote back, rows equal the JAX engine's and the lone
    generate's, and after stop every page is free."""
    jm, lm = lms
    r = np.random.RandomState(41)
    tpls = [r.randint(0, 32, (8,)) for _ in range(3)]
    reqs = _cycle_requests(r, tpls, rounds=2)
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                  page_size=4, max_pages=14,
                                  prefix_cache_rows=4,
                                  prefix_host_rows=4) as eng:
        rows = [eng.submit(p, n).result(timeout=60) for p, n in reqs]
        pc = eng.stats()["prefix_cache"]
    assert pc["demotions"] >= 2 and pc["promotions"] >= 1, pc
    assert eng._pages.pages_in_use == 0
    for (p, n), row in zip(reqs, rows):
        np.testing.assert_array_equal(row, _direct(lm, p, n))
        np.testing.assert_array_equal(
            row, np.asarray(jm.generate(jnp.asarray(p)[None], n))[0])


def test_working_set_sweep_holds_the_hit_rate(lm):
    """``run_working_set_sweep``: past the pool's rows the device-only
    cache loses its hits, the host tier keeps them, both cached legs
    give the cache-off leg's rows, and no leg's dispatch signatures grew
    after its warm request (``jit_flat``: demote and promote traffic
    launches no new program signature)."""
    res = run_working_set_sweep(lm, working_sets=(2, 8), device_rows=2,
                                requests_per_template=2, rate_hz=40.0,
                                max_slots=2, prefill_chunk=4,
                                prefill_rows=1, template_len=8)
    head = res["headline"]
    assert head["token_parity"] is True
    assert all(p["token_parity"] for p in res["points"])
    assert head["tiered_hit_rate"] > head["device_only_hit_rate"]
    assert res["tiered"]["demotions"] >= 1
    assert res["tiered"]["promotions"] >= 1
    assert res["workload"]["kind"] == "working_set_sweep"
    assert head["jit_flat"] is True
    assert all(p[leg]["jit_flat"] for p in res["points"]
               for leg in ("tiered", "device_only", "disabled"))
