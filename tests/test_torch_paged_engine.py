"""The port's ContinuousBatchingEngine in paged mode
(bigdl_tpu_torch/serving/engine.py with ``page_size``) against the JAX
engine in the same configuration, on the same weights (the engine cases
of tests/test_paged_kv.py).

Greedy rows under concurrent mixed-length load equal, token for token,
the JAX paged engine's rows and both packages' lone ``generate``: plain,
prefix-cached, and speculative with a draft. A drained and stopped
engine has freed every page (target and draft pools), and its page pool
keeps its storage through a run. A prefix hit shares the entry's pages
by refcount and copies nothing; no two live rows ever write the same
(page, offset) and no shared page is ever written; a pool too small for
two reservations makes the second request wait instead of failing. The
constructor and ``submit`` refuse what the JAX engine refuses.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.serving import ContinuousBatchingEngine as JaxEngine
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.nn import attention as tattn
from bigdl_tpu_torch.serving import ContinuousBatchingEngine, pages_needed
from bigdl_tpu_torch.utils.weights import load_jax_params

CFG = dict(vocab_size=32, embed_dim=16, num_heads=4, num_kv_heads=2,
           num_layers=2, max_len=48, use_rope=True)
PS = 4          # page_size under test
CHUNK = 4       # prefill_chunk (a page multiple)


def _pair(seed: int, **over):
    from bigdl_tpu.utils import random as rnd

    rnd.set_seed(seed)
    jm = JaxLM(**{**CFG, **over})
    jm.evaluate()
    tm = TransformerLM(**{**CFG, **over}, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    tm.evaluate()
    return jm, tm


@pytest.fixture(scope="module")
def lms():
    return _pair(21)


@pytest.fixture(scope="module")
def lm(lms):
    return lms[1]


@pytest.fixture(scope="module")
def drafts():
    """An unrelated one-layer draft over the same vocabulary."""
    return _pair(99, num_layers=1)


def _direct(lm, prompt, n):
    return lm.generate(np.asarray(prompt), n)[0].numpy()


def _jax_direct(jm, prompt, n):
    return np.asarray(jm.generate(jnp.asarray(prompt)[None], n))[0]


def _serve(eng, reqs):
    rows = [None] * len(reqs)
    errs = []

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
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    return rows


def _mixed_reqs(seed=0, vocab=32):
    r = np.random.RandomState(seed)
    lens = [(5, 6), (9, 4), (3, 9), (13, 5), (7, 7), (4, 11)]
    return [(r.randint(0, vocab, (t0,)), n) for t0, n in lens]


def _parity_run(lms, reqs, draft_pair=None, **engine_kw):
    """Mixed-length concurrent load through a 2-slot paged engine, port
    and JAX: every row equals the JAX engine's and both lone generates;
    the port's pool keeps its storage through the run and drains to
    empty (every allocated page freed)."""
    jm, tm = lms
    if draft_pair is not None:
        engine_kw["spec_gamma"] = 3
    eng = ContinuousBatchingEngine(
        tm, max_slots=2, prefill_chunk=CHUNK, page_size=PS,
        draft=draft_pair[1] if draft_pair else None, **engine_kw)
    ptrs = [t.data_ptr() for kv in eng._kv_pool for t in kv]
    with eng:
        rows = _serve(eng, reqs)
        st = eng.stats()
        pg = st["paging"]
        assert pg["page_size"] == PS
        assert pg["pool"]["allocated_total"] > 0
        assert 0.0 <= pg["fragmentation"] <= 1.0
        assert [t.data_ptr() for kv in eng._kv_pool for t in kv] == ptrs
    for pool in (eng._pages, eng._d_pages):
        if pool is not None:
            s = pool.stats()
            assert s["pages_in_use"] == 0 and s["bytes_in_use"] == 0
            assert s["allocated_total"] == s["freed_total"]
    with JaxEngine(jm, max_slots=2, prefill_chunk=CHUNK, page_size=PS,
                   draft=draft_pair[0] if draft_pair else None,
                   **engine_kw) as jeng:
        jrows = _serve(jeng, reqs)
    for (p, n), row, jrow in zip(reqs, rows, jrows):
        np.testing.assert_array_equal(row, np.asarray(jrow))
        np.testing.assert_array_equal(row, _direct(tm, p, n))
        np.testing.assert_array_equal(row, _jax_direct(jm, p, n))
    return st


def test_paged_parity_plain(lms):
    _parity_run(lms, _mixed_reqs(0), prefix_cache_rows=0)


def test_paged_parity_prefix(lms):
    reqs = _mixed_reqs(1)
    reqs += [(np.concatenate([p, [3, 1]]), 4) for p, _ in reqs[:3]]
    st = _parity_run(lms, reqs, prefix_cache_rows=4)
    assert st["prefix_cache"]["donations"] > 0


def test_paged_parity_speculative(lms, drafts):
    st = _parity_run(lms, _mixed_reqs(3), draft_pair=drafts,
                     prefix_cache_rows=0)
    assert st["speculation"]["proposed_tokens"] > 0
    assert st["paging"]["draft_pool"]["allocated_total"] > 0


def test_prefix_hit_shares_pages_zero_copy(lm):
    """A prefix hit bumps refcounts (``shared_total``) and copies nothing
    (``cow_forks_total`` stays 0; chunk alignment keeps writes off the
    shared pages), while the row stays token-identical."""
    r = np.random.RandomState(7)
    tpl = r.randint(0, 32, (8,))
    pa = np.concatenate([tpl, r.randint(0, 32, (3,))])
    pb = np.concatenate([tpl, r.randint(0, 32, (4,))])
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=CHUNK,
                                  page_size=PS, prefix_cache_rows=4) as eng:
        ha = eng.submit(pa, 5)
        np.testing.assert_array_equal(ha.result(timeout=60),
                                      _direct(lm, pa, 5))
        assert ha.prefix_tokens == 0
        shared_before = eng._pages.stats()["shared_total"]
        entry, _ = eng._prefix.lookup(pb)
        head = entry.pages[:2]
        refs = [eng._pages.refcount(p) for p in head]
        seen = []
        complete = eng._complete_admission

        def spy(a, tok):
            # the admission's table at hand-off: the entry's head pages,
            # one reference more each
            seen.append((a.table.pages[:2],
                         [eng._pages.refcount(p) for p in head]))
            return complete(a, tok)

        eng._complete_admission = spy
        hb = eng.submit(pb, 5)
        np.testing.assert_array_equal(hb.result(timeout=60),
                                      _direct(lm, pb, 5))
        assert seen == [(list(head), [c + 1 for c in refs])]
        assert hb.prefix_tokens == 8
        st = eng.stats()
        assert st["prefix_cache"]["hits"] == 1
        pool = st["paging"]["pool"]
        assert pool["shared_total"] > shared_before
        assert pool["cow_forks_total"] == 0
        # after drain, the only held pages are the index's
        held = {p for e in eng._prefix.snapshot() for p in e["pages"]}
        assert pool["pages_in_use"] == len(held) > 0
    assert eng._pages.pages_in_use == 0


def test_live_rows_never_share_a_write_and_shared_pages_stay_read_only(
        lm, drafts, monkeypatch):
    """Every scatter the engine makes through its tables, recorded at
    the call: within one call no two rows write the same (page, offset)
    off the scratch page, and no written page is shared (refcount > 1)
    at the time, under prefix hits, mid-flight admission and a draft."""
    real = tattn._write_kv_paged
    r = np.random.RandomState(9)
    head = r.randint(0, 32, (12,))
    reqs = [(np.concatenate([head, r.randint(0, 32, (k,))]), n)
            for k, n in ((3, 6), (5, 9), (1, 7), (6, 5))]
    reqs += _mixed_reqs(4)[:3]
    for draft in (None, drafts[1]):
        eng = ContinuousBatchingEngine(
            lm, max_slots=3, prefill_chunk=CHUNK, prefill_rows=2,
            page_size=PS, prefix_cache_rows=4, draft=draft, spec_gamma=3)
        layer0 = eng._kv_pool[0][0]
        refcounts = []

        def check(pool, tables, positions):
            if positions.dim() == 1:
                positions = positions[:, None]
            pages = torch.gather(tables, 1, positions // PS)
            offs = positions % PS
            seen = {}
            for row in range(pages.shape[0]):
                for pg, off in zip(pages[row].tolist(), offs[row].tolist()):
                    if pg == 0:
                        continue
                    assert seen.setdefault((pg, off), row) == row, \
                        f"rows {seen[(pg, off)]} and {row} write {pg}:{off}"
                    if pool is layer0:
                        refcounts.append(eng._pages.refcount(pg))

        def spy_checked(pool, k_t, v_t, tables, positions):
            check(pool[0], tables, positions)
            return real(pool, k_t, v_t, tables, positions)

        monkeypatch.setattr(tattn, "_write_kv_paged", spy_checked)
        with eng:
            first = eng.submit(*reqs[0]).result(timeout=60)
            rows = [first] + _serve(eng, reqs[1:])
            hits = eng.stats()["prefix_cache"]["hits"]
        for (p, n), row in zip(reqs, rows):
            np.testing.assert_array_equal(row, _direct(lm, p, n))
        assert hits >= 1
        assert refcounts and max(refcounts) == 1
        assert eng._pages.pages_in_use == 0


def test_paged_ctor_and_submit_validation(lm):
    with pytest.raises(ValueError, match="max_pages requires"):
        ContinuousBatchingEngine(lm, max_slots=1, max_pages=8)
    with pytest.raises(ValueError, match="multiple of"):
        ContinuousBatchingEngine(lm, max_slots=1, prefill_chunk=6,
                                 page_size=4)
    with pytest.raises(ValueError, match="cannot hold one"):
        ContinuousBatchingEngine(lm, max_slots=1, prefill_chunk=CHUNK,
                                 page_size=PS, max_pages=4)
    with pytest.raises(ValueError, match="page_size must be"):
        ContinuousBatchingEngine(lm, max_slots=1, prefill_chunk=CHUNK,
                                 page_size=0)
    assert pages_needed(9, PS) == 3 and pages_needed(8, PS) == 2
    eng = ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=CHUNK,
                                   page_size=PS)
    # the default pool: every slot at full length, plus as much again
    assert eng._table_len == 12
    assert eng._pages.max_pages == 1 + 2 * 2 * 12
    assert eng._caches is None and eng._staging is None
    # 12 allocatable pages hold a full 48-token window, but not the
    # window plus a draft's 4-position verify headroom
    with pytest.raises(ValueError, match="cannot hold one"):
        ContinuousBatchingEngine(lm, max_slots=1, prefill_chunk=CHUNK,
                                 page_size=PS, max_pages=13, draft=lm,
                                 spec_gamma=4)
    p = np.arange(40) % 32
    with ContinuousBatchingEngine(lm, max_slots=1, prefill_chunk=CHUNK,
                                  page_size=PS, max_pages=13) as small:
        np.testing.assert_array_equal(small.submit(p, 8).result(timeout=60),
                                      _direct(lm, p, 8))
        with pytest.raises(ValueError, match="serving window"):
            small.submit(p, 9)


def test_pool_pressure_blocks_admission_not_correctness(lm):
    """A pool sized for ONE full-length reservation under a 2-slot
    engine: the second long request cannot admit until the first frees
    its pages. The engine requeues it at the head (the page-wait latch)
    instead of deadlocking or running out of pages, and both rows stay
    token-identical."""
    r = np.random.RandomState(13)
    pa, pb = r.randint(0, 32, (8,)), r.randint(0, 32, (9,))
    eng = ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=CHUNK,
                                   page_size=PS, max_pages=13,
                                   prefix_cache_rows=0)
    # hold the loop at its first decode step until the second request
    # is queued, so the first provably holds its pages when it arrives
    gate = threading.Event()
    decode = eng._decode_all

    def gated(active):
        gate.wait(timeout=60)
        return decode(active)

    eng._decode_all = gated
    try:
        with eng:
            ha = eng.submit(pa, 30)      # reserves 10 of 12 pages
            next(ha.tokens())            # admitted, holding them
            hb = eng.submit(pb, 30)      # needs 10: must wait
            gate.set()
            np.testing.assert_array_equal(ha.result(timeout=120),
                                          _direct(lm, pa, 30))
            np.testing.assert_array_equal(hb.result(timeout=120),
                                          _direct(lm, pb, 30))
            assert eng.stats()["paging"]["page_waits"] >= 1
    finally:
        gate.set()
    assert getattr(hb, "_page_waited", False)
    assert eng._pages.pages_in_use == 0


def test_stop_mid_flight_frees_every_page(lm, drafts):
    """Stopping with requests decoding, prefilling and queued fails them
    all and returns every page of both pools."""
    r = np.random.RandomState(17)
    eng = ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=CHUNK,
                                   page_size=PS, prefix_cache_rows=4,
                                   draft=drafts[1], spec_gamma=2)
    eng.submit(r.randint(0, 32, (9,)), 3).result(timeout=60)
    hs = [eng.submit(r.randint(0, 32, (t0,)), 30) for t0 in (6, 14, 10)]
    next(hs[0].tokens())
    eng.stop(drain=False)
    assert all(h.done() for h in hs)
    assert eng._pages.pages_in_use == 0
    assert eng._d_pages.pages_in_use == 0
