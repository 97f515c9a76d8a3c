"""Prefix-aware KV reuse and batched multi-row prefill in the port
(bigdl_tpu_torch/serving/prefix_cache.py and engine.py) against the JAX
package's on the same weights.

The same scripted sequence of lookups, hits, donations, acquires and
releases under byte pressure goes through both ``PrefixCache``s and must
give the same matched lengths, rows, evictions and ``stats()``. At the
engine level, with the prefix cache warm every greedy row still equals
the lone ``generate`` (port and JAX) and the JAX engine's row, token for
token: reuse changes the work, never the tokens. The workload generators
give the JAX package's arrays for a seed.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.serving import ContinuousBatchingEngine as JaxEngine
from bigdl_tpu.serving import PrefixCache as JaxPrefixCache
from bigdl_tpu.serving import benchmark as jbench
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.serving import (
    ContinuousBatchingEngine, PrefixCache, RequestTimedOut,
)
from bigdl_tpu_torch.serving import benchmark as tbench
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


def _jax_direct(jm, prompt, n):
    return np.asarray(jm.generate(jnp.asarray(prompt)[None], n))[0]


# ------------------------------------------------- the trie, scripted
def _cache_script(cls):
    """Random donations, lookups, hits/misses and pins over a 3-row pool
    with 4-token minimum: returns every observable outcome."""
    pc = cls(rows=3, row_bytes=640, min_tokens=4, token_bytes=10.0)
    r = np.random.RandomState(3)
    heads = [r.randint(0, 6, (int(n),)).astype(np.int32)
             for n in (4, 6, 8)]
    pinned, trace = [], []

    def seq():
        h = heads[r.randint(0, 3)]
        tail = r.randint(0, 6, (int(r.randint(0, 6)),)).astype(np.int32)
        return np.concatenate([h, tail])

    def ent(e):
        return None if e is None else (tuple(e.tokens.tolist()), e.row,
                                       e.refs, e.hits)

    for step in range(80):
        op = r.randint(0, 5)
        if op == 0:
            trace.append(("donate", pc.donate(seq())))
        elif op == 1:
            e, m = pc.lookup(seq())
            trace.append(("lookup", ent(e), m))
            if e is not None:
                pc.record_hit(e, (m // 4) * 4)
            else:
                pc.record_miss()
        elif op == 2:
            e, m = pc.lookup(seq())
            if e is not None and len(pinned) < 2:
                pc.acquire(e)
                pinned.append(e)
            trace.append(("acquire", ent(e)))
        elif op == 3 and pinned:
            e = pinned.pop(0)
            pc.release(e)
            trace.append(("release", ent(e)))
        else:
            e = pc.pin_covering(seq()[:4])
            trace.append(("pin_covering", ent(e)))
            if e is not None:
                pc.release(e)
        trace.append(("gen", pc.generation, len(pc), pc.bytes_in_use))
    trace.append(("stats", pc.stats()))
    trace.append(("snapshot", pc.snapshot()))
    return trace


def test_prefix_cache_script_matches_jax():
    jt, tt = _cache_script(JaxPrefixCache), _cache_script(PrefixCache)
    assert tt == jt
    stats = tt[-2][1]
    # the script reaches hits, misses, donations and evictions
    assert stats["hits"] > 0 and stats["misses"] > 0
    assert stats["donations"] > 3 and stats["evictions"] > 0


def test_radix_trie_match_semantics():
    pc = PrefixCache(rows=4, row_bytes=1000, min_tokens=4)
    t1 = np.arange(1, 9, dtype=np.int32)
    t2 = np.asarray([1, 2, 3, 4, 9, 9, 9, 9], np.int32)
    assert pc.donate(t1) is not None and pc.donate(t2) is not None
    e, m = pc.lookup(np.asarray([1, 2, 3, 4, 5, 6, 7, 8, 30], np.int32))
    assert m == 8 and np.array_equal(e.tokens, t1)
    e, m = pc.lookup(np.asarray([1, 2, 3, 4, 5, 6, 30, 30], np.int32))
    assert m == 6 and np.array_equal(e.tokens, t1)
    e, m = pc.lookup(np.asarray([1, 2, 3, 4, 9], np.int32))
    assert m == 5 and np.array_equal(e.tokens, t2)
    assert pc.lookup(np.asarray([1, 2, 3, 30], np.int32)) == (None, 0)
    assert pc.stats()["hits"] == 0 and pc.stats()["misses"] == 0
    assert pc.donate(t1[:6]) is None
    buf = np.asarray([5, 5, 5, 5, 5, 5], np.int32)
    assert pc.donate(buf) is not None
    buf[:] = 9
    e, m = pc.lookup(np.asarray([5, 5, 5, 5, 5, 5, 1], np.int32))
    assert m == 6 and np.array_equal(e.tokens, [5] * 6)


def test_lru_and_refcount_eviction_under_byte_pressure():
    pc = PrefixCache(rows=2, row_bytes=512, min_tokens=4)
    t1, t2, t3, t4 = (np.asarray([i] * 8, np.int32) for i in (1, 2, 3, 4))
    assert pc.donate(t1) is not None and pc.donate(t2) is not None
    assert pc.bytes_in_use == 2 * 512 == pc.capacity_bytes
    e1, _ = pc.lookup(t1)
    pc.record_hit(e1, 8)
    assert pc.donate(t3) is not None and pc.stats()["evictions"] == 1
    assert pc.lookup(t2)[0] is None and pc.lookup(t1)[0] is not None
    pc.acquire(e1)
    e3, _ = pc.lookup(t3)
    pc.acquire(e3)
    assert pc.donate(t4) is None             # both rows pinned
    pc.release(e3)
    assert pc.donate(t4) is not None
    assert pc.lookup(t1)[0] is e1
    pc.release(e1)
    with pytest.raises(RuntimeError, match="acquire"):
        pc.release(e1)
    with pytest.raises(ValueError, match="rows"):
        PrefixCache(rows=-1, row_bytes=8)
    with pytest.raises(ValueError, match="min_tokens"):
        PrefixCache(rows=1, row_bytes=8, min_tokens=0)
    off = PrefixCache(rows=0, row_bytes=8)
    assert off.donate(np.arange(8, dtype=np.int32)) is None
    assert off.lookup(np.arange(8, dtype=np.int32)) == (None, 0)


def test_workloads_match_jax():
    for seed in (0, 3):
        for kw in ({}, {"prompt_lens": (64, 512), "decode_lens": (16, 128)}):
            jw = jbench.poisson_workload(12, 20.0, 32000, seed=seed, **kw)
            tw = tbench.poisson_workload(12, 20.0, 32000, seed=seed, **kw)
            for a, b in zip(jw, tw):
                assert a["arrival_s"] == b["arrival_s"]
                assert (a["n"], a["tenant"]) == (b["n"], b["tenant"])
                np.testing.assert_array_equal(a["prompt"], b["prompt"])
        for order in ("random", "cycle"):
            jw = jbench.shared_prefix_workload(
                10, 30.0, 32, n_templates=3, template_len=12, seed=seed,
                template_order=order)
            tw = tbench.shared_prefix_workload(
                10, 30.0, 32, n_templates=3, template_len=12, seed=seed,
                template_order=order)
            assert [(a["arrival_s"], a["n"], a["tenant"]) for a in jw] == \
                [(b["arrival_s"], b["n"], b["tenant"]) for b in tw]
            for a, b in zip(jw, tw):
                np.testing.assert_array_equal(a["prompt"], b["prompt"])
    with pytest.raises(ValueError, match="template_order"):
        tbench.shared_prefix_workload(2, 1.0, 8, template_order="zigzag")


# --------------------------------------------------- engine: cache reuse
def test_prefix_hit_parity_and_stats(lm):
    """The second request shares an 8-token template head: it equals the
    cold oracle, with the hit on the handle, its timeline and stats()."""
    r = np.random.RandomState(7)
    tpl = r.randint(0, 32, (8,))
    pa = np.concatenate([tpl, r.randint(0, 32, (3,))])
    pb = np.concatenate([tpl, r.randint(0, 32, (4,))])
    with ContinuousBatchingEngine(lm, max_slots=2,
                                  prefill_chunk=4) as eng:
        ha = eng.submit(pa, 5)
        np.testing.assert_array_equal(ha.result(timeout=60),
                                      _direct(lm, pa, 5))
        assert ha.prefix_tokens == 0
        hb = eng.submit(pb, 5)
        np.testing.assert_array_equal(hb.result(timeout=60),
                                      _direct(lm, pb, 5))
        assert hb.prefix_tokens == 8
        assert hb.timeline()["prefix_tokens"] == 8
        s = eng.stats()["prefix_cache"]
        assert s["enabled"] and s["hits"] == 1 and s["misses"] == 1
        assert s["hit_rate"] == 0.5
        assert s["reused_tokens"] == 8 and s["reused_fraction"] > 0
        assert s["entries"] >= 1 and s["bytes"] > 0
        assert s["bytes"] <= s["capacity_bytes"]
        assert s["prefilled_tokens"] == len(pa) + len(pb) - 8


def test_greedy_parity_shared_prefix_load_vs_cold_engine(lms):
    """A shared-prefix workload through the cached engine (two staging
    rows) equals, request for request, the cache-disabled engine, the
    JAX engine with the same config, and the lone generate of both
    packages."""
    jm, tm = lms
    r = np.random.RandomState(8)
    tpls = [r.randint(0, 32, (8,)) for _ in range(2)]
    reqs = [(np.concatenate([tpls[i % 2],
                             r.randint(0, 32, (1 + i % 4,))]), 3 + i % 5)
            for i in range(8)]

    def run(cls, lm, **kw):
        with cls(lm, max_slots=3, prefill_chunk=4, prefill_rows=2,
                 **kw) as eng:
            handles = [eng.submit(p, n) for p, n in reqs]
            rows = [np.asarray(h.result(timeout=120)) for h in handles]
        return rows, eng

    warm_rows, warm_eng = run(ContinuousBatchingEngine, tm)
    cold_rows, _ = run(ContinuousBatchingEngine, tm, prefix_cache_bytes=0)
    jax_rows, jeng = run(JaxEngine, jm)
    for (p, n), wr, cr, jr in zip(reqs, warm_rows, cold_rows, jax_rows):
        want = _direct(tm, p, n)
        np.testing.assert_array_equal(wr, want)
        np.testing.assert_array_equal(cr, want)
        np.testing.assert_array_equal(jr, want)
        np.testing.assert_array_equal(want, _jax_direct(jm, p, n))
    s = warm_eng.stats()["prefix_cache"]
    assert s["hits"] >= 1 and s["reused_tokens"] >= 8
    js = jeng.stats()["prefix_cache"]
    assert (s["hits"], s["reused_tokens"]) == (js["hits"],
                                              js["reused_tokens"])


def test_multiturn_reuse_crosses_decode_kv(lm):
    """Turn 2's prompt embeds turn 1's prompt and reply: the cached head
    extends into decode-written KV and the row still equals the cold
    oracle."""
    r = np.random.RandomState(9)
    p1 = r.randint(0, 32, (6,))
    with ContinuousBatchingEngine(lm, max_slots=2,
                                  prefill_chunk=4) as eng:
        row1 = eng.submit(p1, 7).result(timeout=60)   # 13 tokens
        p2 = np.concatenate([row1, r.randint(0, 32, (2,))])
        h2 = eng.submit(p2, 4)
        np.testing.assert_array_equal(h2.result(timeout=60),
                                      _direct(lm, p2, 4))
        # donated key = prompt + generated[:-1] = 12 tokens, all of it
        # reused: past p1's 6 prompt tokens into decode-written KV
        assert h2.prefix_tokens == 12


def test_concurrent_submits_sharing_one_prefix(lm):
    r = np.random.RandomState(10)
    tpl = r.randint(0, 32, (8,))
    warm = np.concatenate([tpl, r.randint(0, 32, (2,))])
    reqs = [(np.concatenate([tpl, r.randint(0, 32, (2 + i % 3,))]),
             3 + i % 4) for i in range(6)]
    rows = [None] * len(reqs)
    errs = []
    with ContinuousBatchingEngine(lm, max_slots=3, prefill_chunk=4,
                                  prefill_rows=2) as eng:
        eng.submit(warm, 2).result(timeout=60)   # donate the template

        def worker(i, p, n):
            try:
                rows[i] = eng.submit(p, n).result(timeout=120)
            except Exception as e:
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(i, p, n))
                   for i, (p, n) in enumerate(reqs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert not errs, errs
    for (p, n), row in zip(reqs, rows):
        np.testing.assert_array_equal(row, _direct(lm, p, n))
    assert eng.stats()["prefix_cache"]["hits"] == len(reqs)


def test_engine_eviction_under_byte_pressure(lm):
    """One pool row: the second donated template evicts the first."""
    r = np.random.RandomState(12)
    t1, t2 = r.randint(0, 32, (8,)), r.randint(0, 32, (8,))
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                  prefix_cache_rows=1) as eng:
        for tpl in (t1, t2):
            p = np.concatenate([tpl, r.randint(0, 32, (2,))])
            np.testing.assert_array_equal(eng.submit(p, 3).result(60),
                                          _direct(lm, p, 3))
        s = eng.stats()["prefix_cache"]
        assert s["rows"] == 1 and s["entries"] == 1
        assert s["evictions"] >= 1
        assert s["bytes"] == s["capacity_bytes"]
    # the byte budget becomes a row budget: two rows' worth of bytes
    eng2 = ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                    prefix_cache_bytes=2 * eng._row_bytes
                                    + 1)
    assert eng2._prefix.rows == 2 and len(eng2._pool) == lm.num_layers


def test_prefix_cache_disabled(lm):
    r = np.random.RandomState(13)
    p = r.randint(0, 32, (8,))
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                  prefix_cache_bytes=0) as eng:
        np.testing.assert_array_equal(eng.submit(p, 4).result(60),
                                      _direct(lm, p, 4))
        h = eng.submit(p, 4)        # identical prompt: still no reuse
        np.testing.assert_array_equal(h.result(60), _direct(lm, p, 4))
        assert h.prefix_tokens == 0
        assert eng.stats()["prefix_cache"] == {"enabled": False}
    assert eng._pool is None


def test_engine_submit_timed_out_while_blocked(lm):
    r = np.random.RandomState(11)
    p = r.randint(0, 32, (4,))
    eng = ContinuousBatchingEngine(lm, max_slots=1, prefill_chunk=4,
                                   queue_capacity=1)
    # hold the loop at its decode step until the blocked submit has
    # timed out: the slot stays busy and the queue full however fast the
    # decode would have run
    gate = threading.Event()
    decode = eng._decode_all

    def gated(active):
        gate.wait(timeout=60)
        return decode(active)

    eng._decode_all = gated
    try:
        with eng:
            h_long = eng.submit(p, 24)
            it = h_long.tokens()
            next(it)             # admitted: slot busy, queue empty
            eng.submit(p, 4)     # fills the 1-deep queue
            with pytest.raises(RequestTimedOut):
                eng.submit(p, 4, timeout_s=0.05, queue_timeout_s=30.0)
            gate.set()
            np.testing.assert_array_equal(h_long.result(timeout=60),
                                          _direct(lm, p, 24))
    finally:
        gate.set()
    assert eng.stats()["timed_out"] >= 1


# --------------------------------------- engine: batched multi-row path
def test_multirow_prefill_parity(lm):
    """prefill_rows=3: queued admissions prefill together through the
    ragged staging call; every row equals the oracle, the template trio
    hits the cache, and the device tensors are never reallocated."""
    r = np.random.RandomState(14)
    tpl = r.randint(0, 32, (8,))
    reqs = [(r.randint(0, 32, (3 + i,)), 3 + i % 4) for i in range(3)]
    reqs += [(np.concatenate([tpl, r.randint(0, 32, (2 + i,))]), 4)
             for i in range(3)]
    with ContinuousBatchingEngine(lm, max_slots=3, prefill_chunk=4,
                                  prefill_rows=3) as eng:
        ptrs = [k.data_ptr() for tree in (eng._caches, eng._staging,
                                          eng._pool)
                for kv in tree for k in kv]
        warm_t = np.concatenate([tpl, r.randint(0, 32, (2,))])
        np.testing.assert_array_equal(eng.submit(warm_t, 2).result(60),
                                      _direct(lm, warm_t, 2))
        rounds = eng.stats()["prefill_rounds"]
        handles = [eng.submit(p, n) for p, n in reqs]
        for (p, n), h in zip(reqs, handles):
            np.testing.assert_array_equal(h.result(timeout=120),
                                          _direct(lm, p, n))
        s = eng.stats()
        assert s["prefix_cache"]["hits"] >= 1
        # 6 admissions of 1-3 chunks each: batching takes fewer rounds
        # than the 12 chunks one at a time would
        assert s["prefill_rounds"] - rounds < 12
        assert ptrs == [k.data_ptr() for tree in (eng._caches,
                                                  eng._staging, eng._pool)
                        for kv in tree for k in kv]


def test_shared_prefix_comparison_runs_on_the_cpu(lm):
    """The comparison machinery end to end at a tiny size: both legs
    serve every request, the rows agree, the cached leg hits."""
    res = tbench.run_shared_prefix_comparison(
        lm, n_requests=6, rate_hz=200.0, max_slots=2, prefill_chunk=4,
        prefill_rows=2, n_templates=2, template_len=12)
    assert res["token_parity"] is True
    assert res["cached"]["prefix_cache"]["hits"] >= 1
    assert res["uncached"]["prefix_cache"] == {"enabled": False}
    assert res["ttft_p50_speedup"] is not None
    for req, row in zip(res["requests"], res["cached"]["rows"]):
        np.testing.assert_array_equal(row, _direct(lm, req["prompt"],
                                                   req["n"]))


def test_poisson_comparison_runs_on_the_cpu(lm):
    res = tbench.run_poisson_comparison(
        lm, n_requests=5, rate_hz=200.0, max_slots=2, prefill_chunk=4,
        max_batch=4, prompt_lens=(4, 12), decode_lens=(2, 6),
        prefill_rows=2)
    eng, gen = res["engine"], res["generation_service"]
    assert eng["requests"] == gen["requests"] == 5
    assert eng["stats"]["finished"] == 5 and res["p99_speedup"] > 0
    assert eng["ttft"]["p50"] is not None
    for req, a, b in zip(res["requests"], eng["rows"], gen["rows"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, _direct(lm, req["prompt"],
                                                 req["n"]))
