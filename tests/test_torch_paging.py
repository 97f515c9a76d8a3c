"""The port's page allocator (bigdl_tpu_torch/serving/paging.py) against
the JAX package's on the same scripted operations.

The same random sequences of alloc / share / free / build / fork /
``ensure_writable`` go through both packages' ``PagePool`` and
``BlockTable`` over pools of the same geometry (the JAX pool a tree of
jax arrays, the port's a list of torch tensors), and the same donation /
lookup / hit / pin / reclaim / demote / promote sequences through both
``PagedPrefixIndex``es: every refcount, free list, flow counter,
``stats()`` and snapshot must agree, ``holder_bytes`` must conserve the
bytes in use at every step, and a copy-on-write fork must leave the
original holder's bytes untouched. The engine's ``copy_page`` copies
every layer's K and V.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.serving import paging as jpaging
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.serving import (
    SCRATCH_PAGE, BlockTable, ContinuousBatchingEngine, PagedPrefixIndex,
    PagePool,
)

CFG = dict(vocab_size=32, embed_dim=16, num_heads=4, num_kv_heads=2,
           num_layers=2, max_len=48, use_rope=True)
PS = 4


@pytest.fixture(scope="module")
def models():
    from bigdl_tpu.utils import random as rnd

    rnd.set_seed(21)
    return JaxLM(**CFG), TransformerLM(**CFG, device="cpu")


def _pools(models, max_pages):
    jm, tm = models
    return (jpaging.PagePool(jm.init_page_pool(max_pages, PS), PS),
            PagePool(tm.init_page_pool(max_pages, PS), PS))


def test_pool_geometry_and_validation_match_jax(models):
    jp, tp = _pools(models, 9)
    assert tp.stats() == jp.stats()
    assert tp.page_bytes == jp.page_bytes == 2 * 2 * 2 * PS * 4 * 4
    assert tp.free_pages == 8 and tp.capacity_bytes == 9 * tp.page_bytes
    with pytest.raises(ValueError, match="max_pages"):
        PagePool(models[1].init_page_pool(1, PS), PS)
    with pytest.raises(ValueError, match="page_size"):
        PagePool(models[1].init_page_pool(4, PS), 0)
    with pytest.raises(ValueError, match="non-empty"):
        PagePool([], PS)
    # a dict of tensors is a buffer tree too
    assert PagePool({"k": torch.zeros(3, PS, 2)}, PS).page_bytes == PS * 8


def _pool_script(pool, table_cls, seed):
    """Random alloc / share / free / build / fork / covering / as_array
    over one pool: every observable outcome, with the conservation law
    ``sum(holder_bytes) == bytes_in_use`` checked after each step."""
    r = np.random.RandomState(seed)
    tables, loose, trace = [], [], []

    def copy_page(dst, src):
        trace.append(("copy", dst, src))

    for _ in range(120):
        op = r.randint(0, 7)
        if op == 0:
            got = pool.alloc(int(r.randint(0, 4)))
            trace.append(("alloc", got))
            if got:
                loose.append(got)
        elif op == 1 and loose:
            pages = loose.pop(int(r.randint(0, len(loose))))
            pool.free(pages)
            trace.append(("free", pages))
        elif op == 2:
            head = (tables[int(r.randint(0, len(tables)))].pages[:2]
                    if tables and r.rand() < 0.5 else [])
            t = table_cls.build(pool, head, int(r.randint(0, 4)))
            trace.append(("build", None if t is None else list(t.pages)))
            if t is not None:
                tables.append(t)
        elif op == 3 and tables:
            t = tables[int(r.randint(0, len(tables)))].fork()
            tables.append(t)
            trace.append(("fork", list(t.pages)))
        elif op == 4 and tables:
            t = tables.pop(int(r.randint(0, len(tables))))
            trace.append(("table_free", list(t.pages)))
            t.free()
        elif op == 5 and tables:
            t = tables[int(r.randint(0, len(tables)))]
            if len(t) and pool.free_pages:
                i = int(r.randint(0, len(t)))
                trace.append(("cow", t.ensure_writable(i, copy_page),
                              list(t.pages)))
        elif op == 6 and tables:
            t = tables[int(r.randint(0, len(tables)))]
            n = int(r.randint(0, 4 * PS + 1))
            trace.append(("view", t.covering(n),
                          t.as_array(6).tolist()))
        held = [t.pages for t in tables] + loose
        total = sum(pool.holder_bytes(p) for p in held)
        assert total == pytest.approx(pool.bytes_in_use, abs=1e-6)
        trace.append(("state", pool.stats(),
                      [pool.refcount(p) for p in range(pool.max_pages)],
                      list(pool._free)))
    for t in tables:
        t.free()
    for pages in loose:
        pool.free(pages)
    trace.append(("drained", pool.stats()))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_and_table_script_matches_jax(models, seed):
    jp, tp = _pools(models, 10)
    jt = _pool_script(jp, jpaging.BlockTable, seed)
    tt = _pool_script(tp, BlockTable, seed)
    assert tt == jt
    kinds = {e[0] for e in tt}
    assert {"alloc", "free", "build", "fork", "cow", "table_free"} <= kinds
    assert any(e[0] == "cow" and e[1] for e in tt), "no COW copy ran"
    end = tt[-1][1]
    assert end["pages_in_use"] == 0
    assert end["allocated_total"] == end["freed_total"]


def test_loud_failures_and_atomic_build():
    pool = PagePool({"k": torch.zeros(6, PS, 2)}, PS)
    head = pool.alloc(2)
    assert SCRATCH_PAGE not in head
    assert BlockTable.build(pool, head, 4) is None       # 3 free < 4
    assert all(pool.refcount(p) == 1 for p in head)     # head untouched
    assert pool.alloc(4) is None and pool.free_pages == 3
    with pytest.raises(ValueError, match="alloc"):
        pool.alloc(-1)
    pool.free(head)
    with pytest.raises(RuntimeError, match="free"):
        pool.free([head[0]])
    with pytest.raises(RuntimeError, match="share"):
        pool.share([head[0]])
    t = BlockTable.build(pool, (), 5)
    fork = t.fork()
    with pytest.raises(RuntimeError, match="exhausted"):
        fork.ensure_writable(0, lambda dst, src: None)


def test_cow_fork_isolation_on_torch_buffers():
    """``ensure_writable`` breaks a share with one page copy, and the
    original holder's bytes are untouched when the fork writes."""
    buf = {"k": torch.zeros(6, PS, 2)}
    pool = PagePool(buf, PS)

    def copy_page(dst, src):
        buf["k"][dst].copy_(buf["k"][src])

    t1 = BlockTable.build(pool, (), 2)
    buf["k"][t1.pages[1]] = 7.0
    t2 = t1.fork()
    solo = BlockTable.build(pool, (), 1)
    assert solo.ensure_writable(0, copy_page) is False
    src = t2.pages[1]
    assert t2.ensure_writable(1, copy_page) is True
    dst = t2.pages[1]
    assert dst != src and pool.cow_forks == 1
    assert pool.refcount(src) == 1 and pool.refcount(dst) == 1
    assert torch.equal(buf["k"][dst], buf["k"][src])
    buf["k"][dst] = 9.0
    assert float(buf["k"][t1.pages[1]][0, 0]) == 7.0
    for t in (t1, t2, solo):
        t.free()
    assert pool.pages_in_use == 0


def _index_script(pool_cls, table_cls, index_cls, buffers, seed):
    """Donations of pages held by live tables, lookups with hits and
    misses, pins, reclaims under pressure (with and without a host-tier
    spill), promotions back to the device and a final ``drop_all``,
    through one ``PagedPrefixIndex``: every observable outcome."""
    pool = pool_cls(buffers, PS)
    idx = index_cls(pool, max_entries=4, min_tokens=4, token_bytes=10.0,
                    host_pages=6)
    r = np.random.RandomState(seed)
    heads = [r.randint(0, 5, (int(n),)).astype(np.int32)
             for n in (4, 7, 9)]
    tables, pinned, trace = [], [], []

    def seq():
        h = heads[r.randint(0, 3)]
        tail = r.randint(0, 5, (int(r.randint(0, 5)),)).astype(np.int32)
        return np.concatenate([h, tail])

    def spill(pages):
        return [np.full(2, p, np.float32) for p in pages]

    def ent(e):
        return None if e is None else (tuple(e.tokens.tolist()),
                                       tuple(e.pages), e.tier, e.refs)

    for _ in range(90):
        op = r.randint(0, 8)
        if op == 0:
            toks = seq()
            t = table_cls.build(pool, (), -(-toks.shape[0] // PS))
            if t is not None:
                trace.append(("donate", idx.donate_pages(toks, t.pages)))
                tables.append(t)
        elif op == 1:
            e, m = idx.lookup(seq())
            trace.append(("lookup", ent(e), m))
            if e is not None and e.tier == "device":
                idx.record_hit(e, (m // 4) * 4)
            else:
                idx.record_miss()
        elif op == 2:
            e, _ = idx.lookup(seq())
            if e is not None and len(pinned) < 2:
                idx.acquire(e)
                pinned.append(e)
            trace.append(("acquire", ent(e)))
        elif op == 3 and pinned:
            e = pinned.pop(0)
            idx.release(e)
            trace.append(("release", ent(e)))
        elif op == 4 and tables:
            tables.pop(0).free()
            trace.append(("table_free",))
        elif op == 5:
            n = int(r.randint(1, 9))
            trace.append(("reclaim", n, idx.reclaim(
                n, spill if r.rand() < 0.5 else None)))
        elif op == 6:
            hosts = [e for e in idx._host_entries if e.host_buf is not None]
            if hosts:
                e = hosts[0]
                fresh = pool.alloc(len(e.host_buf))
                if fresh is not None:
                    # the entry takes over the fresh pages' references
                    idx.promote_pages(e, fresh)
                    trace.append(("promote", ent(e)))
        else:
            trace.append(("device_pages", idx.device_pages,
                          idx.bytes_in_use, idx.host_bytes_in_use))
        trace.append(("state", idx.generation, len(idx), pool.stats()))
    trace.append(("stats", idx.stats()))
    trace.append(("snapshot", idx.snapshot()))
    for e in pinned:
        idx.release(e)
    for t in tables:
        t.free()
    idx.drop_all()
    trace.append(("dropped", pool.stats(), idx.stats()))
    return trace


@pytest.mark.parametrize("seed", [3, 4])
def test_paged_prefix_index_script_matches_jax(models, seed):
    jm, tm = models
    jt = _index_script(jpaging.PagePool, jpaging.BlockTable,
                       jpaging.PagedPrefixIndex,
                       jm.init_page_pool(12, PS), seed)
    tt = _index_script(PagePool, BlockTable, PagedPrefixIndex,
                       tm.init_page_pool(12, PS), seed)
    assert tt == jt
    stats = tt[-3][1]
    assert stats["hits"] > 0 and stats["misses"] > 0
    assert stats["donations"] > 2 and stats["evictions"] > 0
    assert stats["demotions"] > 0 and stats["promotions"] > 0
    # drop_all and freeing every table leave the pool empty
    assert tt[-1][1]["pages_in_use"] == 0


def test_paged_index_fences_the_dense_row_api(models):
    pool = PagePool(models[1].init_page_pool(8, PS), PS)
    idx = PagedPrefixIndex(pool, max_entries=2, min_tokens=4)
    with pytest.raises(RuntimeError, match="donate_pages"):
        idx.donate(np.arange(8, dtype=np.int32))
    with pytest.raises(RuntimeError, match="pages"):
        idx.allocate_row()
    with pytest.raises(ValueError, match="max_entries"):
        PagedPrefixIndex(pool, max_entries=-1)
    with pytest.raises(ValueError, match="need"):
        idx.donate_pages(np.arange(9, dtype=np.int32), [1, 2])
    assert idx.capacity_bytes == pool.capacity_bytes


def test_engine_copy_page_copies_every_layer(models):
    """The engine's single-page copy (``BlockTable.ensure_writable``'s
    callback) moves every layer's K and V of the page, checked tensor by
    tensor after a real request has filled the page."""
    tm = models[1]
    tm.evaluate()
    p = np.asarray([5, 2, 7, 1, 3], np.int32)
    with ContinuousBatchingEngine(tm, max_slots=1, prefill_chunk=4,
                                  page_size=PS, max_pages=15,
                                  prefix_cache_rows=0) as eng:
        eng.submit(p, 6).result(timeout=60)
        # LIFO free list: the request's freed pages (real KV) come first
        t = BlockTable.build(eng._pages, (), 1)
        t2 = t.fork()
        src = t2.pages[0]
        assert t2.ensure_writable(0, eng._copy_page) is True
        dst = t2.pages[0]
        for k, v in eng._kv_pool:
            for leaf in (k, v):
                assert leaf[src].abs().sum() > 0
                assert torch.equal(leaf[dst], leaf[src])
        t.free()
        t2.free()
    assert eng._pages.pages_in_use == 0
