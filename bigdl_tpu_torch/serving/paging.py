"""Paged KV cache: one refcounted block-pool under every KV surface (port
of ``bigdl_tpu/serving/paging.py``, a copy: the JAX package's module is
framework-free apart from one tree walk, but importing it would import
JAX. ``PagePool`` walks the port's own list of ``(k, v)`` tensors
instead, and takes ``page_bytes`` from ``Tensor.nbytes``).

The dense engine gives every request a full ``(cache_len, ...)`` KV row
in each of its pools (slot KV, prefill staging, prefix pool, host tier,
draft mirrors) — so a 32-token chat bills the same device memory as a
document that fills ``cache_len``, and a prefix hit *copies* a pool row
into staging before the first novel token is prefetched. This module is
the fix, BigDL's block-manager discipline (Dai et al., 2018, arxiv
1804.05839) applied at page granularity: the unit of KV storage becomes
a fixed ``page_size``-token **page** of one persistent
``(max_pages, H_kv, page_size, D)`` device buffer per layer, and every KV
surface becomes host-side bookkeeping over page ids —

* ``PagePool`` — the allocator: a free list plus per-page reference
  counts over the device tree. Pages are claimed (``alloc``), shared
  (``share``: refcount bump, never a tensor copy — the zero-copy ethos
  of "RPC Considered Harmful", arxiv 1805.08430, applied intra-engine),
  and returned (``free``: a page is reusable only when its LAST
  reference drops).
* ``BlockTable`` — one request's view: the ordered page ids whose
  concatenation is its KV row. Token position ``i`` lives at offset
  ``i % page_size`` of page ``pages[i // page_size]``. ``fork`` shares
  every page copy-on-write; ``ensure_writable`` breaks a share with a
  single-page device copy only when a writer actually lands on a page
  someone else still references.
* ``PagedPrefixIndex`` — the prefix cache re-based on pages: the radix
  trie, LRU, pin, and generation machinery is inherited unchanged from
  ``PrefixCache``; what changes is the currency. A donation SHARES the
  donor slot's pages into the entry (no slot→pool copy), a hit SHARES
  the entry's aligned pages into the new request's table (no
  pool→staging copy), and eviction / host-tier demotion are refcount
  moves plus — for demotion only — one bulk device→host spill per page.
  The engine drives the host tier: it takes ``prefix_host_bytes`` /
  ``prefix_host_rows`` (``serving/engine.py``, ported with the tier),
  demotes a page set it evicts and promotes one a lookup lands on
  (``tests/test_torch_tiered_prefix_cache.py`` drives both).

Why shared pages are never written (the COW invariant the engine
maintains): the engine requires ``prefill_chunk % page_size == 0``, so
the chunk-aligned reuse boundary ``base`` is page-aligned — a hit
shares exactly the pages covering ``[0, base)`` and the first novel
write lands at ``base``, i.e. at offset 0 of a freshly allocated page.
Decode and speculative-verify writes land at positions ``>= prompt_len
> base`` for the same reason. ``ensure_writable`` therefore never fires
on the engine's own paths; it exists (and is tested) as the safety net
for future writers — n>1 completion forks — that DO write under a
share.

Thread contract (mirrors ``PrefixCache``): the engine loop thread is
the only mutator; ``stats()`` readers may race in from HTTP/debug
threads, so counters and the free list sit behind an internal lock.
Lock order is strictly index → pool (``PagedPrefixIndex`` calls
``PagePool`` while holding its own lock; the pool never calls back), so
the two locks cannot deadlock.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch.serving.prefix_cache import PrefixCache, PrefixEntry

__all__ = ["PagePool", "BlockTable", "PagedPrefixIndex", "SCRATCH_PAGE"]

#: page id 0 is never allocated: it is the write sink for idle dispatch
#: lanes (an all-zero block table routes their junk KV writes here) and
#: the padding value of every device block-table array, so a gather
#: through padding reads initialized — if garbage — memory that the
#: causal mask then discards.
SCRATCH_PAGE = 0


def _leaves(tree) -> list:
    """The tensors of a buffer tree (a tensor, or nested lists, tuples
    and dicts of them) in order: the port's stand-in for JAX's
    ``tree_leaves``."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


class PagePool:
    """Refcounted block allocator over one persistent device KV tree.

    ``buffers`` is ``model.init_page_pool(max_pages, page_size)`` — a
    per-layer list of ``(k, v)`` tensors whose leading dim indexes
    pages; the pool never touches device memory itself, it only decides
    which page ids are live. The engine writes those tensors in place
    (decode and prefill scatters, COW copies), so ``buffers`` keeps
    naming the live storage.

    Counters are cumulative and monotonic (the engine reports them in
    ``stats()["paging"]``): ``allocated`` =
    pages handed out by ``alloc``, ``shared`` = reference bumps from
    ``share``, ``cow_forks`` = shares broken by ``ensure_writable``,
    ``freed`` = pages whose last reference dropped (so
    ``allocated - freed == pages_in_use`` at all times).
    """

    def __init__(self, buffers, page_size: int):
        leaves = _leaves(buffers)
        if not leaves:
            raise ValueError("PagePool needs a non-empty buffer tree")
        max_pages = int(leaves[0].shape[0])
        if max_pages < 2:
            raise ValueError(
                f"max_pages must be >= 2 (page 0 is the reserved "
                f"scratch page), got {max_pages}")
        if page_size < 1:
            raise ValueError(
                f"page_size must be >= 1, got {page_size}")
        self.buffers = buffers
        self.max_pages = max_pages
        self.page_size = int(page_size)
        #: device bytes one page owns across every layer's buffers —
        #: the billing unit
        self.page_bytes = sum(int(l.nbytes) for l in leaves) // max_pages
        # LIFO free list: recently freed pages are re-issued first so a
        # churning workload keeps touching the same device memory
        self._free: List[int] = list(range(max_pages - 1, 0, -1))
        self._refs = np.zeros(max_pages, np.int32)
        self._lock = threading.Lock()
        # cumulative flow
        self.allocated = 0
        self.shared = 0
        self.cow_forks = 0
        self.freed = 0

    # ------------------------------------------------------------ alloc
    def alloc(self, n: int) -> Optional[List[int]]:
        """Claim ``n`` fresh pages (refcount 1 each), all-or-nothing:
        ``None`` when fewer than ``n`` pages are free, so a caller
        never holds a partial reservation it must unwind."""
        if n < 0:
            raise ValueError(f"alloc(n={n})")
        with self._lock:
            if len(self._free) < n:
                return None
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                self._refs[p] = 1
            self.allocated += n
            return pages

    def share(self, pages: Sequence[int]) -> None:
        """Add one reference to each page — the whole of what a prefix
        hit or a table fork costs. Sharing a free page is a
        bookkeeping bug and fails loudly."""
        with self._lock:
            for p in pages:
                if self._refs[p] <= 0:
                    raise RuntimeError(
                        f"share() of free page {p}")
                self._refs[p] += 1
            self.shared += len(pages)

    def free(self, pages: Sequence[int]) -> None:
        """Drop one reference from each page; a page returns to the
        free list only when its last reference drops."""
        with self._lock:
            for p in pages:
                if self._refs[p] <= 0:
                    raise RuntimeError(
                        f"free() of free page {p}")
                self._refs[p] -= 1
                if self._refs[p] == 0:
                    self._free.append(p)
                    self.freed += 1

    def note_cow_fork(self) -> None:
        with self._lock:
            self.cow_forks += 1

    # ------------------------------------------------------------ views
    def refcount(self, page: int) -> int:
        with self._lock:
            return int(self._refs[page])

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def pages_in_use(self) -> int:
        with self._lock:
            return self.max_pages - 1 - len(self._free)

    @property
    def capacity_bytes(self) -> int:
        # graftlint: ok[lock-discipline] — max_pages and page_bytes are immutable after __init__
        return self.max_pages * self.page_bytes

    @property
    def bytes_in_use(self) -> int:
        # graftlint: ok[lock-discipline] — page_bytes is immutable after __init__ (pages_in_use takes the lock)
        return self.pages_in_use * self.page_bytes

    def holder_bytes(self, pages: Sequence[int]) -> float:
        """One holder's pro-rata device footprint: each held page's
        bytes divided by its CURRENT refcount, so a page shared by
        ``r`` holders bills ``1/r`` to each and the sum over all
        holders of a page is exactly its bytes — the conservation
        property paged KV billing rests on."""
        with self._lock:
            total = 0.0
            for p in pages:
                r = int(self._refs[p])
                if r > 0:
                    total += self.page_bytes / r
            return total

    def stats(self) -> dict:
        with self._lock:
            in_use = self.max_pages - 1 - len(self._free)
            return {
                "max_pages": self.max_pages,
                "page_size": self.page_size,
                "page_bytes": self.page_bytes,
                "pages_in_use": in_use,
                "free_pages": len(self._free),
                "bytes_in_use": in_use * self.page_bytes,
                "capacity_bytes": self.max_pages * self.page_bytes,
                "allocated_total": self.allocated,
                "shared_total": self.shared,
                "cow_forks_total": self.cow_forks,
                "freed_total": self.freed,
            }


class BlockTable:
    """One request's ordered view of pool pages: position ``i`` lives
    at offset ``i % page_size`` of ``pages[i // page_size]``. The table
    owns one reference per listed page; ``free()`` (or the engine's
    release path) drops them all."""

    __slots__ = ("pool", "pages")

    def __init__(self, pool: PagePool, pages: List[int]):
        self.pool = pool
        self.pages = pages

    @classmethod
    def build(cls, pool: PagePool, shared: Sequence[int],
              n_fresh: int) -> Optional["BlockTable"]:
        """Assemble a table from a shared prefix head plus ``n_fresh``
        newly allocated pages, atomically: on allocation failure the
        shared references are never taken and ``None`` comes back, so
        the caller (the engine's admission path) can reclaim and
        retry without unwinding anything."""
        fresh = pool.alloc(n_fresh)
        if fresh is None:
            return None
        pool.share(shared)
        return cls(pool, list(shared) + fresh)

    def __len__(self) -> int:
        return len(self.pages)

    def fork(self) -> "BlockTable":
        """Copy-on-write clone: every page shared, nothing copied —
        the n>1-completions primitive."""
        self.pool.share(self.pages)
        return BlockTable(self.pool, list(self.pages))

    def ensure_writable(self, idx: int,
                        copy_page: Callable[[int, int], None]) -> bool:
        """Break the share on ``pages[idx]`` before a write: when the
        page's refcount is > 1, allocate a fresh page, have the caller
        copy the old page's device contents into it (``copy_page(dst,
        src)`` — one in-place single-page copy), and swap the table over
        to the private copy. Returns True when a COW copy happened.
        Raises when the pool is exhausted — the engine reserves a
        request's full span at admission precisely so this cannot
        trigger mid-flight."""
        page = self.pages[idx]
        if self.pool.refcount(page) <= 1:
            return False
        fresh = self.pool.alloc(1)
        if fresh is None:
            raise RuntimeError(
                "ensure_writable: pool exhausted mid-COW")
        copy_page(fresh[0], page)
        self.pool.free([page])
        self.pages[idx] = fresh[0]
        self.pool.note_cow_fork()
        return True

    def covering(self, n_tokens: int) -> Tuple[int, ...]:
        """The page ids holding positions ``[0, n_tokens)``."""
        ps = self.pool.page_size
        return tuple(self.pages[: -(-int(n_tokens) // ps)])

    def as_array(self, table_len: int) -> np.ndarray:
        """Fixed-shape device-dispatch form: the page ids padded to
        ``table_len`` with the scratch page, so dispatch shapes depend
        only on the pool geometry, never on this request's length."""
        out = np.full(table_len, SCRATCH_PAGE, np.int32)
        out[: len(self.pages)] = self.pages
        return out

    def free(self) -> None:
        self.pool.free(self.pages)
        self.pages = []


class PagedPrefixIndex(PrefixCache):
    """``PrefixCache`` with pages as the currency instead of pool rows.

    The trie, lookup, LRU stamps, pin/unpin, ``pin_covering``, hit/miss
    accounting, and the ``generation`` stale-probe guard are inherited
    verbatim — prefix REUSE semantics are unchanged. What this subclass
    replaces is storage motion:

    * ``donate_pages(tokens, pages)`` — a finished/preempted slot's
      covering pages are SHARED into a new entry (refcount bump; the
      dense slot→pool row copy does not exist here).
    * a hit consumes ``entry.pages[: base // page_size]`` via
      ``PagePool.share`` (the engine does this; the dense pool→staging
      copy does not exist here).
    * ``reclaim(n_pages, spill)`` — eviction under allocation pressure:
      LRU unpinned entries drop their page references until the pool
      can satisfy the allocation. With a host budget and a ``spill``
      callback the victim DEMOTES instead: its pages are bulk-copied to
      pinned host buffers (one per page, outside the index lock) and
      the entry stays in the trie as a host-tier resident.
    * ``promote_pages(entry, pages)`` — the engine has allocated fresh
      pages and copied the host buffers back; the entry flips to
      device tier. Promotion is synchronous at admission in paged mode
      (page copies are small and the async overlap machinery of the
      dense tier buys little), so the dense pending-demotion handshake
      (``pop_pending_demotion``/``complete_demotion``) is unused here.

    The dense row-allocation surface (``donate``, ``allocate_row``,
    ``promote``, ``release_row``) is disabled and fails loudly — a
    paged engine must never fall back to row motion.
    """

    def __init__(self, pool: PagePool, *, max_entries: int,
                 min_tokens: int = 1, token_bytes: float = 0.0,
                 devices: int = 1, host_pages: int = 0):
        if max_entries < 0:
            raise ValueError(
                f"max_entries must be >= 0, got {max_entries}")
        # rows=max_entries keeps the base class's "rows == 0 disables"
        # convention; row_bytes=0 because bytes are per-page here (the
        # byte properties and stats() are overridden below).
        super().__init__(rows=max_entries, row_bytes=0,
                         min_tokens=min_tokens, token_bytes=token_bytes,
                         devices=devices, host_rows=0)
        self.pool = pool
        #: host-tier budget in PAGES (0 disables the tier; eviction
        #: then drops instead of demoting)
        self.host_pages = int(host_pages)
        # the engine (and _sync_prefix_gauges) gates the host tier on
        # host_rows > 0; in page currency the page budget IS that gate
        self.host_rows = self.host_pages

    # ------------------------------------------------- dense API fences
    def donate(self, tokens: np.ndarray) -> Optional[int]:
        raise RuntimeError(
            "PagedPrefixIndex: use donate_pages(), not the dense "
            "row-copy donate()")

    def allocate_row(self) -> Optional[int]:
        raise RuntimeError(
            "PagedPrefixIndex: rows do not exist; allocate pages "
            "from the PagePool")

    # --------------------------------------------------------- donation
    def donate_pages(self, tokens: np.ndarray,
                     pages: Sequence[int]) -> bool:
        """Retain a finished request's prefix by sharing the ``pages``
        that hold its KV (position order; the caller keeps its own
        references — the slot's table is freed separately). Declined
        (False) when too short, already covered by an existing entry
        (LRU-touched instead), or the entry budget is exhausted by
        pinned entries."""
        tokens = np.array(tokens, np.int32, copy=True)
        # graftlint: ok[lock-discipline] — the pool reference is immutable after __init__; page_size is a pool constant
        n_pages = -(-tokens.shape[0] // self.pool.page_size)
        with self._lock:
            if (self.rows == 0 or tokens.shape[0] < self.min_tokens
                    or n_pages == 0):
                return False
            if n_pages > len(pages):
                raise ValueError(
                    f"donate_pages: {tokens.shape[0]} tokens need "
                    f"{n_pages} pages, got {len(pages)}")
            covered = self._covering_entry(tokens)
            if covered is not None:
                self._stamp += 1
                covered.last_used = self._stamp
                return False
            if len(self._entries) >= self.rows:
                victim = self._lru_unpinned()
                if victim is None:
                    return False
                self._drop_device_entry(victim)
            held = tuple(pages[:n_pages])
            # index -> pool lock order (see module docstring): the pool
            # never calls back into the index, so this nesting is safe
            self.pool.share(held)
            self._stamp += 1
            self.generation += 1
            entry = PrefixEntry(tokens, -1, self._stamp)
            entry.pages = held
            self._insert(entry)
            self._entries.append(entry)
            self.donations += 1
            return True

    def _drop_device_entry(self, entry: PrefixEntry) -> None:
        """Evict a device-tier entry outright (lock held): drop its
        page references and remove it from the trie."""
        self._entries.remove(entry)
        self._trie_remove(entry)
        self.pool.free(entry.pages)
        entry.pages = ()
        self.evictions += 1
        self.generation += 1

    # --------------------------------------------------------- pressure
    def reclaim(self, n_pages: int,
                spill: Optional[Callable[[Tuple[int, ...]], list]]
                = None) -> bool:
        """Free pool pages for an ``n_pages`` allocation by evicting
        LRU unpinned entries; True when the pool can now satisfy it.
        With ``spill`` and host budget, victims demote: ``spill(pages)``
        returns one pinned host buffer per page (run OUTSIDE the index
        lock — it dispatches device work), or None to abandon the
        demotion and drop the victim. Note an evicted entry only frees
        the pages nobody else references — shared pages survive under
        their other holders, so reclaim can legitimately run out of
        victims before the pool has ``n_pages`` free."""
        # graftlint: ok[lock-discipline] — the pool reference is immutable and the pool has its OWN lock; calling it under the index lock would nest the two
        while self.pool.free_pages < n_pages:
            with self._lock:
                victim = self._lru_unpinned()
                if victim is None:
                    return self.pool.free_pages >= n_pages
                demote = (spill is not None and self.host_pages > 0
                          and self._make_host_page_room(
                              len(victim.pages)))
                self._entries.remove(victim)
                self.evictions += 1
                self.generation += 1
                if demote:
                    victim.tier = "host"
                    victim.row = -1
                    victim.host_buf = None
                    self._host_entries.append(victim)
                else:
                    self._trie_remove(victim)
            held = victim.pages
            if demote:
                buf = spill(held)
                with self._lock:
                    if buf is None:
                        # spill failed: degrade to a plain drop
                        if victim in self._host_entries:
                            self._host_entries.remove(victim)
                            self._trie_remove(victim)
                            self.generation += 1
                    elif victim in self._host_entries:
                        victim.host_buf = buf
                        self.demotions += 1
            # graftlint: ok[lock-discipline] — the pool reference is immutable and the pool has its OWN lock; freeing outside the index lock avoids nesting the two
            self.pool.free(held)
            victim.pages = ()
        return True

    def _make_host_page_room(self, incoming: int) -> bool:
        """Ensure the host tier can absorb ``incoming`` more pages
        (lock held), evicting host-LRU ``refs == 0`` entries past the
        page budget; False when pinned entries block it (the demotion
        then degrades to a drop — never an over-budget spill)."""
        if incoming > self.host_pages:
            return False
        while (self._host_pages_in_use_locked() + incoming
               > self.host_pages):
            cand = [e for e in self._host_entries if e.refs == 0]
            if not cand:
                return False
            hv = min(cand, key=lambda e: e.last_used)
            self._host_entries.remove(hv)
            self._trie_remove(hv)
            hv.host_buf = None
            self.host_evictions += 1
            self.generation += 1
        return True

    def _host_pages_in_use_locked(self) -> int:
        return sum(len(e.host_buf) for e in self._host_entries
                   if e.host_buf is not None)

    # -------------------------------------------------------- promotion
    def promote_pages(self, entry: PrefixEntry,
                      pages: Sequence[int]) -> None:
        """Flip a host-tier entry back to device residency over freshly
        allocated ``pages`` (the caller has already copied each host
        buffer into its page). Mirrors the base ``promote``
        contract: LRU touch, host buffer dropped, generation bump."""
        with self._lock:
            if entry.tier != "host" or entry not in self._host_entries:
                raise RuntimeError(
                    f"promote_pages() of a non-host entry: {entry!r}")
            self._host_entries.remove(entry)
            entry.tier = "device"
            entry.pages = tuple(pages)
            entry.host_buf = None
            self._entries.append(entry)
            self._stamp += 1
            entry.last_used = self._stamp
            self.promotions += 1
            self.generation += 1

    @property
    def device_pages(self) -> int:
        """Total pages referenced by device-tier entries — the upper
        bound on what a full ``reclaim`` sweep could return to the
        pool (shared pages survive under their other holders, so the
        true yield can be lower). Admission scoring input."""
        with self._lock:
            return sum(len(e.pages) for e in self._entries)

    def drop_all(self) -> None:
        """Release every retained entry's page references (engine
        stop/crash path — the leak check counts on this)."""
        with self._lock:
            for e in list(self._entries):
                self._drop_device_entry(e)
            for e in list(self._host_entries):
                self._host_entries.remove(e)
                self._trie_remove(e)
                e.host_buf = None
                self.generation += 1

    # ------------------------------------------------------------ bytes
    @property
    def bytes_in_use(self) -> int:
        """Pro-rata device bytes the retained entries hold (a page
        shared with live requests bills the index only its refcount
        share) — the honest memory attribution."""
        with self._lock:
            return int(sum(self.pool.holder_bytes(e.pages)
                           for e in self._entries))

    @property
    def capacity_bytes(self) -> int:
        # graftlint: ok[lock-discipline] — the pool reference is immutable after __init__
        return self.pool.capacity_bytes

    @property
    def host_capacity_bytes(self) -> int:
        # graftlint: ok[lock-discipline] — host_pages and the pool reference are immutable after __init__
        return self.host_pages * self.pool.page_bytes

    @property
    def host_bytes_in_use(self) -> int:
        with self._lock:
            return (self._host_pages_in_use_locked()
                    * self.pool.page_bytes)

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        with self._lock:
            looked = self.hits + self.misses
            dev_pages = sum(len(e.pages) for e in self._entries)
            host_pages = self._host_pages_in_use_locked()
            pro_rata = int(sum(self.pool.holder_bytes(e.pages)
                               for e in self._entries))
            return {
                "entries": len(self._entries),
                "rows": self.rows,
                "pages": dev_pages,
                "bytes": pro_rata,
                "capacity_bytes": self.pool.capacity_bytes,
                "devices": self.devices,
                "bytes_per_device": pro_rata // self.devices,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hits / looked, 4)
                            if looked else 0.0,
                "reused_tokens": self.reused_tokens,
                "bytes_saved": self.bytes_saved,
                "donations": self.donations,
                "evictions": self.evictions,
                # host tier (page units)
                "host_rows": self.host_pages,
                "host_entries": len(self._host_entries),
                "host_pages": host_pages,
                "host_bytes": host_pages * self.pool.page_bytes,
                "host_capacity_bytes": (self.host_pages
                                        * self.pool.page_bytes),
                "host_hits": self.host_hits,
                "device_hits": self.hits - self.host_hits,
                "demotions": self.demotions,
                "promotions": self.promotions,
                "host_evictions": self.host_evictions,
            }

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [{"length": e.length, "pages": list(e.pages),
                     "tier": e.tier, "refs": e.refs, "hits": e.hits,
                     "last_used": e.last_used}
                    for e in sorted(self._entries + self._host_entries,
                                    key=lambda e: e.last_used)]
