"""Host-side prefix index over retained KV-cache rows (port of
``bigdl_tpu/serving/prefix_cache.py``, a copy: the JAX package's module
is framework-free, but importing it would import JAX).

Real serving traffic is prefix-heavy: system prompts, few-shot
templates, and multi-turn conversations share long identical prompt
heads. Recomputing those heads through chunked prefill makes TTFT scale
with FULL prompt length no matter how redundant the work is — the same
redundant-hot-path sin BigDL's design (Dai et al., 2018, arxiv
1804.05839) existed to eliminate for data movement. ``PrefixCache`` is
the serving engine's fix: a **radix trie** over token-id prefixes whose
entries point at rows of a device-resident KV *pool*. A new request
whose prompt shares a cached prefix copies the pool row into its
staging slot (one in-place row copy) and chunk-prefills only the novel
tail — O(novel-suffix) TTFT instead of O(prompt).

This module is pure HOST bookkeeping: token keys, trie structure, LRU /
ref-count accounting, and pool-row allocation. The device copies
(pool→staging on a hit, slot→pool on donation) live in
``engine.ContinuousBatchingEngine``; correctness of reuse rests on KV
causality — the KV row at position ``i`` depends only on tokens ``0..i``
— so any entry sharing the first ``m`` tokens with a prompt yields
``m`` valid positions, even when the entry diverges afterwards
(partial match) or extends past the prompt (truncated match).

Eviction: entries are LRU-ordered; ``donate`` reclaims the
least-recently-used entry with ``refs == 0`` when every pool row is
occupied. An entry is pinned (``acquire``/``release``) for the lifetime
of any admission staging from it, so a row is never overwritten while a
copy consumer may still be in flight. The byte budget is enforced as a
row budget (``rows * row_bytes``) fixed at construction — the pool
tensors keep one shape whatever the load.

**Host tier** (``host_rows > 0``): instead of dropping the device-pool
LRU victim outright, eviction *demotes* it — the entry stays in the
trie, flips ``tier`` to ``"host"``, and parks its KV in a pinned host
buffer (one bulk device-to-host copy the ENGINE performs via
``pop_pending_demotion`` / ``complete_demotion`` before the pool row is
reused). The host tier has its own row budget and its own LRU; a
lookup landing on a host entry is the engine's cue to start an
asynchronous host-to-device copy that overlaps the request's queue
wait, then ``allocate_row`` + ``promote`` flip the entry back to device
residency so the unchanged chunk-aligned reuse path consumes it. The
total retained prefix set thus scales with host RAM, not device memory
— BigDL's spill-to-block-manager memory hierarchy recast for KV. Every
tier transition (demote, host-evict, promote) bumps ``generation``, so
the stale-probe guard covers host rows exactly like device rows. The
port's engine drives this tier: it takes ``prefix_host_bytes`` /
``prefix_host_rows`` (``serving/engine.py``) and runs the demotions and
promotions above (``tests/test_torch_tiered_prefix_cache.py`` drives
them, ``test_paged_host_tier_drains_every_page`` among its cases).

Thread contract: the engine's loop thread is the only mutator;
``stats()`` / ``snapshot()`` may be called from HTTP/debug threads (an
internal lock covers the races).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from bigdl_tpu_torch.observability import memory as obs_memory


class PrefixEntry:
    """One retained prefix: ``tokens`` (the exact token ids whose KV the
    pool row holds, positions ``0..length-1``), the pool ``row`` that
    holds them, and the LRU/ref-count bookkeeping. ``tier`` says where
    the KV currently lives: ``"device"`` (a pool row) or ``"host"``
    (``host_buf``, an engine-opaque pinned host copy of the row;
    ``row`` is ``-1`` while demoted so stale use fails loudly)."""

    __slots__ = ("tokens", "row", "refs", "last_used", "hits", "tier",
                 "host_buf", "pages")

    def __init__(self, tokens: np.ndarray, row: int, stamp: int):
        self.tokens = tokens
        self.row = row
        self.refs = 0
        self.last_used = stamp
        self.hits = 0
        self.tier = "device"
        self.host_buf = None
        #: paged mode (``serving.paging.PagedPrefixIndex``): the page-pool
        #: page ids holding this prefix's KV, in position order; ``row``
        #: stays ``-1`` so any dense-path use of a paged entry fails loudly
        self.pages: Tuple[int, ...] = ()

    @property
    def length(self) -> int:
        return int(self.tokens.shape[0])

    def __repr__(self):
        return (f"PrefixEntry(len={self.length}, row={self.row}, "
                f"tier={self.tier}, refs={self.refs}, "
                f"hits={self.hits})")


class _Node:
    """Radix-trie node: edge-compressed children keyed by first token;
    ``entry`` marks a retained prefix ending exactly here."""

    __slots__ = ("children", "entry")

    def __init__(self):
        # first_token -> (edge_tokens np.ndarray, child _Node)
        self.children: Dict[int, Tuple[np.ndarray, "_Node"]] = {}
        self.entry: Optional[PrefixEntry] = None


def _common_len(a: np.ndarray, b: np.ndarray) -> int:
    n = min(a.shape[0], b.shape[0])
    if n == 0:
        return 0
    neq = np.flatnonzero(a[:n] != b[:n])
    return int(neq[0]) if neq.size else n


class PrefixCache:
    """Radix-trie index over token-id prefixes → device KV pool rows.

    ``rows`` is the pool capacity (0 disables the cache entirely);
    ``row_bytes`` is the device footprint of one pool row across every
    layer's (k, v) buffers — ``capacity_bytes = rows * row_bytes`` is
    the configured byte budget, ``bytes_in_use`` the occupied part.

    The engine-facing flow per admission: ``lookup(prompt)`` → best
    ``(entry, matched)``; on a hit ``acquire(entry)`` pins it while the
    staged copy is consumed, ``release(entry)`` unpins. Per finished
    request: ``donate(tokens)`` returns the pool row to copy the slot's
    KV into (or None when covered / unevictable), possibly evicting an
    LRU ``refs == 0`` entry to make room.

    With ``host_rows > 0`` the evicted victim is DEMOTED instead of
    dropped: ``donate`` (or ``allocate_row``) parks it as a host-tier
    entry and records a pending demotion the engine must resolve —
    ``pop_pending_demotion()`` names the entry and the pool row still
    holding its KV, the engine bulk-copies that row to host, and
    ``complete_demotion(entry, host_buf)`` attaches the buffer (or
    drops the entry when the copy failed). The reverse move is
    ``allocate_row()`` + ``promote(entry, row)`` after the engine has
    copied the host buffer back into the pool row.
    """

    def __init__(self, rows: int, row_bytes: int,
                 min_tokens: int = 1, token_bytes: float = 0.0,
                 devices: int = 1, host_rows: int = 0):
        if rows < 0:
            raise ValueError(f"rows must be >= 0, got {rows}")
        if host_rows < 0:
            raise ValueError(
                f"host_rows must be >= 0, got {host_rows}")
        if min_tokens < 1:
            raise ValueError(
                f"min_tokens must be >= 1, got {min_tokens}")
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        self.rows = rows
        self.row_bytes = int(row_bytes)
        #: devices the pool's rows are sharded across (the serving
        #: mesh size; 1 unsharded) — ``row_bytes`` stays the LOGICAL
        #: per-row footprint, ``stats()`` derives the per-device share
        #: one device's memory pays for the occupied rows
        self.devices = int(devices)
        #: prefixes shorter than this are never matched or donated —
        #: a few shared tokens are not worth a row or a copy dispatch
        self.min_tokens = min_tokens
        #: device KV bytes one cached token position occupies
        #: (row_bytes / cache_len — the engine passes it); the
        #: exchange rate behind the ``bytes_saved`` savings credit
        self.token_bytes = float(token_bytes)
        #: host-tier row budget (0 disables the tier: eviction drops)
        self.host_rows = int(host_rows) if rows > 0 else 0
        self._root = _Node()
        self._entries: List[PrefixEntry] = []
        self._host_entries: List[PrefixEntry] = []
        self._free_rows = list(range(rows))
        #: the one demotion ``donate``/``allocate_row`` may leave open:
        #: ``(entry, pool_row)`` — the engine MUST resolve it (bulk d2h
        #: copy of ``pool_row`` + ``complete_demotion``) before the row
        #: is overwritten by the copy the allocation was made for
        self._pending_demotion: Optional[
            Tuple[PrefixEntry, int]] = None
        self._stamp = 0
        self._lock = threading.Lock()
        #: bumped on every structural change (insert/evict/demote/
        #: promote/host-evict) — lets a caller validate a cached
        #: ``lookup`` result before acting on it (a stale entry may
        #: have been evicted and its row reused, or changed tier)
        self.generation = 0
        # cumulative flow (monotonic, for stats deltas)
        self.hits = 0
        self.misses = 0
        #: subset of ``hits`` served out of the host tier (the entry
        #: needed a promotion before its row was consumable)
        self.host_hits = 0
        self.reused_tokens = 0
        #: device KV bytes reuse avoided recomputing + rewriting —
        #: the cache's cumulative savings credit (reused positions x
        #: token_bytes), per-request shares ledgered by the engine's
        #: usage accounting
        self.bytes_saved = 0
        self.donations = 0
        self.evictions = 0
        # host-tier flow
        self.demotions = 0
        self.promotions = 0
        self.host_evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def capacity_bytes(self) -> int:
        return self.rows * self.row_bytes

    @property
    def bytes_in_use(self) -> int:
        with self._lock:
            return len(self._entries) * self.row_bytes

    @property
    def host_capacity_bytes(self) -> int:
        return self.host_rows * self.row_bytes

    @property
    def host_bytes_in_use(self) -> int:
        """Host RAM the demoted rows occupy (buffers actually attached
        — a demotion pending its d2h copy holds no host bytes yet)."""
        with self._lock:
            return sum(self.row_bytes for e in self._host_entries
                       if e.host_buf is not None)

    # ------------------------------------------------------------ match
    def lookup(self, prompt: np.ndarray
               ) -> Tuple[Optional[PrefixEntry], int]:
        """Best cached prefix for ``prompt``: walk the trie as deep as
        the prompt's tokens agree, then take the better of (a) the
        deepest entry ENDING on the walked path (a full-entry match —
        every one of its tokens is a prefix of the prompt) and (b) any
        entry in the subtree below the divergence point (a PARTIAL
        match: the entry shares exactly the walked depth, then
        diverges or extends — its KV is still valid for the shared
        head, by causality). Returns ``(entry, matched_tokens)`` with
        ``matched >= min_tokens``, else ``(None, 0)``.

        PURE: no counters move and no LRU stamp is touched — the
        engine uses ``lookup`` both to probe admissions and to SCORE
        queued candidates for prefix-aware ordering, and scoring must
        not pollute the hit-rate. The engine's admission decision
        lands via ``record_hit`` / ``record_miss``."""
        prompt = np.asarray(prompt, np.int32)
        with self._lock:
            best: Optional[PrefixEntry] = None
            best_len = 0

            def consider(cand: Optional[PrefixEntry], ln: int):
                nonlocal best, best_len
                if cand is not None and ln > best_len:
                    best, best_len = cand, ln

            node, depth, off = self._root, 0, prompt
            while True:
                if node.entry is not None:
                    consider(node.entry, node.entry.length)
                if off.shape[0] == 0:
                    # prompt exhausted AT a node: entries extending
                    # below all share the full walked depth
                    consider(self._mru_below(node), depth)
                    break
                nxt = node.children.get(int(off[0]))
                if nxt is None:
                    # no child continues the prompt, but every entry
                    # below this node still shares `depth` tokens
                    consider(self._mru_below(node), depth)
                    break
                edge, child = nxt
                m = _common_len(edge, off)
                depth += m
                if m < edge.shape[0]:
                    # diverged (or prompt exhausted) mid-edge: every
                    # entry below shares exactly `depth` tokens
                    consider(self._mru_below(child), depth)
                    break
                node, off = child, off[m:]
            if best is None or best_len < self.min_tokens:
                return None, 0
            return best, best_len

    def record_hit(self, entry: PrefixEntry, reused_tokens: int,
                   host: bool = False) -> None:
        """Commit an admission's hit: LRU touch, per-entry and global
        hit counts, and the chunk-aligned reused-token figure the
        engine actually skipped prefill for. ``host=True`` marks a hit
        the engine served via a host-tier promotion (the tier split
        that ``stats()`` reports as ``host_hits``)."""
        with self._lock:
            self._stamp += 1
            entry.last_used = self._stamp
            entry.hits += 1
            self.hits += 1
            if host:
                self.host_hits += 1
            self.reused_tokens += int(reused_tokens)
            self.bytes_saved += int(reused_tokens * self.token_bytes)

    def record_miss(self) -> None:
        with self._lock:
            self.misses += 1

    def _mru_below(self, node: _Node) -> Optional[PrefixEntry]:
        """Most-recently-used entry in ``node``'s subtree (entry count
        is bounded by pool rows, so the DFS is trivially cheap)."""
        best = node.entry
        for edge, child in node.children.values():
            c = self._mru_below(child)
            if c is not None and (best is None
                                  or c.last_used > best.last_used):
                best = c
        return best

    # -------------------------------------------------------- pin/unpin
    def acquire(self, entry: PrefixEntry) -> None:
        """Pin ``entry`` while an admission consumes its pool row — a
        pinned entry is never evicted, so the row cannot be overwritten
        under an in-flight copy consumer."""
        with self._lock:
            entry.refs += 1

    def release(self, entry: PrefixEntry) -> None:
        with self._lock:
            if entry.refs <= 0:
                raise RuntimeError(
                    f"release() without matching acquire(): {entry!r}")
            entry.refs -= 1

    def pin_covering(self, tokens: np.ndarray
                     ) -> Optional[PrefixEntry]:
        """Find an entry of which ``tokens`` is a (non-strict) prefix
        and PIN it (caller must ``release``); None when no such entry
        exists. The preemption path pins the entry it just donated so
        LRU pressure cannot evict — and the demote sweep cannot spill
        — the victim's KV before its automatic resume consumes it."""
        with self._lock:
            entry = self._covering_entry(
                np.asarray(tokens, np.int32))
            if entry is not None:
                entry.refs += 1
            return entry

    # --------------------------------------------------------- donation
    def donate(self, tokens: np.ndarray) -> Optional[int]:
        """Offer a finished request's cached tokens to the pool.
        Returns the pool row the caller must copy the KV into, or None
        when the donation is declined: too short, already covered by an
        existing entry (which gets an LRU touch instead), or no free
        row and every entry pinned. May evict (and reuse the row of)
        the LRU ``refs == 0`` entry — byte pressure resolves by
        recency, never by silently dropping pinned entries."""
        # own the key: np.asarray would ALIAS an int32 caller buffer,
        # and a client reusing one preallocated prompt array across
        # requests would then rewrite the trie key under an entry
        # whose pool row still holds the OLD tokens' KV — a silent
        # wrong-prefix hit later
        tokens = np.array(tokens, np.int32, copy=True)
        with self._lock:
            if self.rows == 0 or tokens.shape[0] < self.min_tokens:
                return None
            covered = self._covering_entry(tokens)
            if covered is not None:
                self._stamp += 1
                covered.last_used = self._stamp
                return None
            row = self._take_row()
            if row is None:
                return None
            self._stamp += 1
            self.generation += 1
            entry = PrefixEntry(tokens, row, self._stamp)
            self._insert(entry)
            self._entries.append(entry)
            self.donations += 1
            return row

    def _take_row(self) -> Optional[int]:
        """Claim a device pool row (lock held): a free row, else the
        LRU ``refs == 0`` device entry's — demoting the victim into
        the host tier when it has room (the entry stays in the trie,
        its d2h copy left pending for the engine), dropping it
        otherwise. Returns None when every entry is pinned."""
        if self._free_rows:
            return self._free_rows.pop()
        victim = self._lru_unpinned()
        if victim is None:
            return None
        row = victim.row
        self.evictions += 1
        if self.host_rows > 0 and self._make_host_room():
            # demote: same trie node, new tier; the engine owes the
            # bulk device->host copy of `row` before reusing it
            self._entries.remove(victim)
            victim.tier = "host"
            victim.row = -1
            victim.host_buf = None
            self._host_entries.append(victim)
            self._pending_demotion = (victim, row)
        else:
            self._remove(victim)
        return row

    def _make_host_room(self) -> bool:
        """Ensure the host tier can absorb one more entry (lock held),
        evicting host-LRU ``refs == 0`` entries past the budget.
        False when the tier is full of pinned entries — the demotion
        then degrades to a plain drop, never an over-budget spill."""
        while len(self._host_entries) >= self.host_rows:
            cand = [e for e in self._host_entries if e.refs == 0]
            if not cand:
                return False
            hv = min(cand, key=lambda e: e.last_used)
            self._host_entries.remove(hv)
            self._trie_remove(hv)
            hv.host_buf = None
            self.host_evictions += 1
            # a probe (or in-flight promotion) that captured `hv`
            # re-validates and resolves to a clean miss
            self.generation += 1
        return True

    # ------------------------------------------------- tier transitions
    def pop_pending_demotion(
            self) -> Optional[Tuple[PrefixEntry, int]]:
        """The demotion the last ``donate``/``allocate_row`` left open:
        ``(entry, pool_row)`` — ``pool_row`` still holds the demoted
        entry's KV and is about to be overwritten, so the caller must
        d2h-copy it NOW and then ``complete_demotion``. Clears the
        pending slot."""
        with self._lock:
            pend, self._pending_demotion = self._pending_demotion, None
            return pend

    def complete_demotion(self, entry: PrefixEntry,
                          host_buf) -> None:
        """Attach the bulk-copied host buffer to a demoted entry. A
        ``None`` buffer means the copy was not performed (transfer
        failed / tier raced away) — the entry is dropped so a later
        promotion can never read uninitialized host memory."""
        with self._lock:
            if host_buf is None:
                if entry in self._host_entries:
                    self._host_entries.remove(entry)
                    self._trie_remove(entry)
                    self.generation += 1
                return
            if entry not in self._host_entries:
                return  # host-evicted (or promoted) since the demote
            entry.host_buf = host_buf
            self.demotions += 1

    def allocate_row(self) -> Optional[int]:
        """Claim a device pool row for a promotion (free row, else
        evict-or-demote the device LRU — exactly ``donate``'s row
        discipline, without inserting anything). May leave a pending
        demotion the caller must resolve; bumps ``generation`` so any
        probe taken before the eviction re-validates."""
        with self._lock:
            if self.rows == 0:
                return None
            row = self._take_row()
            if row is not None:
                self.generation += 1
            return row

    def promote(self, entry: PrefixEntry, row: int) -> None:
        """Flip a host-tier entry back to device residency in pool row
        ``row`` (the caller has already copied the host buffer into
        that row). Drops the host buffer, LRU-touches the entry,
        and bumps ``generation`` — probes that captured the entry as
        host-tier re-validate before acting."""
        with self._lock:
            if entry.tier != "host" or entry not in self._host_entries:
                raise RuntimeError(
                    f"promote() of a non-host entry: {entry!r}")
            self._host_entries.remove(entry)
            entry.tier = "device"
            entry.row = int(row)
            entry.host_buf = None
            self._entries.append(entry)
            self._stamp += 1
            entry.last_used = self._stamp
            self.promotions += 1
            self.generation += 1

    def release_row(self, row: int) -> None:
        """Return an ``allocate_row`` row unused (the promotion it was
        claimed for fell through after the claim)."""
        with self._lock:
            self._free_rows.append(int(row))

    def _covering_entry(self, tokens: np.ndarray
                        ) -> Optional[PrefixEntry]:
        """An existing entry of which ``tokens`` is a (non-strict)
        prefix — any future prompt matches it at least as deeply as it
        would match ``tokens``, so the donation adds nothing."""
        node, off = self._root, tokens
        while True:
            if off.shape[0] == 0:
                return self._mru_below(node)
            nxt = node.children.get(int(off[0]))
            if nxt is None:
                return None
            edge, child = nxt
            m = _common_len(edge, off)
            if m == off.shape[0]:
                return self._mru_below(child)
            if m < edge.shape[0]:
                return None
            node, off = child, off[m:]

    def _lru_unpinned(self) -> Optional[PrefixEntry]:
        cand = [e for e in self._entries if e.refs == 0]
        return min(cand, key=lambda e: e.last_used) if cand else None

    # ---------------------------------------------------- trie plumbing
    def _insert(self, entry: PrefixEntry) -> None:
        node, off = self._root, entry.tokens
        while off.shape[0] > 0:
            nxt = node.children.get(int(off[0]))
            if nxt is None:
                child = _Node()
                node.children[int(off[0])] = (off, child)
                child.entry = entry
                return
            edge, child = nxt
            m = _common_len(edge, off)
            if m < edge.shape[0]:
                # split the edge at the divergence point
                mid = _Node()
                node.children[int(off[0])] = (edge[:m], mid)
                mid.children[int(edge[m])] = (edge[m:], child)
                node, off = mid, off[m:]
            else:
                node, off = child, off[m:]
        node.entry = entry

    def _remove(self, entry: PrefixEntry) -> None:
        self._entries.remove(entry)
        self._trie_remove(entry)

    def _trie_remove(self, entry: PrefixEntry) -> None:
        # walk to the entry's node, clearing the marker; structural
        # merge of pass-through nodes is skipped — the trie is bounded
        # by rows * key-length and rebuilt nodes are reused by the next
        # insert along the same path
        node, off = self._root, entry.tokens
        path: List[Tuple[_Node, int]] = []
        while off.shape[0] > 0:
            nxt = node.children.get(int(off[0]))
            if nxt is None:
                return
            edge, child = nxt
            m = _common_len(edge, off)
            if m < edge.shape[0]:
                return
            path.append((node, int(off[0])))
            node, off = child, off[m:]
        if node.entry is entry:
            node.entry = None
        # prune now-empty leaf chains so the trie cannot grow without
        # bound across many donate/evict cycles
        while path:
            parent, first = path.pop()
            edge, child = parent.children[first]
            if child.entry is None and not child.children:
                del parent.children[first]
            else:
                break

    # ------------------------------------------------------------ stats
    # --------------------------------------------------- memory account
    def register_memory_pool(self, name: str) -> str:
        """Register this cache's OCCUPIED pool bytes as a named device-
        memory pool (``observability.memory``) — the `/debug/memory`
        attribution line that separates "prefix KV actually retained"
        from the pool's fixed capacity (which the engine registers
        alongside). Weakly referenced: the registration never keeps the
        cache (or, transitively, its engine) alive. Returns the pool
        name (the unregistration token)."""
        names = obs_memory.register_owned_pools(
            self, {name: lambda c: c.bytes_in_use})
        return names[0]

    def register_host_memory_pool(self, name: str) -> str:
        """Same attribution for the HOST tier: the pinned host-RAM
        bytes the demoted rows occupy, alongside the device pools in
        the one registry — ``/debug/memory`` answers "who owns the
        spill" exactly like "who owns the HBM"."""
        names = obs_memory.register_owned_pools(
            self, {name: lambda c: c.host_bytes_in_use})
        return names[0]

    def stats(self) -> dict:
        """Operational snapshot: occupancy, byte budget, and cumulative
        hit/reuse/eviction flow (the engine's ``stats()['prefix_cache']``
        and ``/debug/requests`` both render this)."""
        with self._lock:
            looked = self.hits + self.misses
            host_bytes = sum(self.row_bytes for e in self._host_entries
                             if e.host_buf is not None)
            return {
                "entries": len(self._entries),
                "rows": self.rows,
                "bytes": len(self._entries) * self.row_bytes,
                "capacity_bytes": self.rows * self.row_bytes,
                "devices": self.devices,
                "bytes_per_device": (len(self._entries)
                                     * self.row_bytes) // self.devices,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hits / looked, 4) if looked else 0.0,
                "reused_tokens": self.reused_tokens,
                "bytes_saved": self.bytes_saved,
                "donations": self.donations,
                "evictions": self.evictions,
                # host tier
                "host_rows": self.host_rows,
                "host_entries": len(self._host_entries),
                "host_bytes": host_bytes,
                "host_capacity_bytes": self.host_rows * self.row_bytes,
                "host_hits": self.host_hits,
                "device_hits": self.hits - self.host_hits,
                "demotions": self.demotions,
                "promotions": self.promotions,
                "host_evictions": self.host_evictions,
            }

    def snapshot(self) -> List[dict]:
        """Per-entry debug view, both tiers (LRU order, oldest
        first)."""
        with self._lock:
            return [{"length": e.length, "row": e.row, "tier": e.tier,
                     "refs": e.refs, "hits": e.hits,
                     "last_used": e.last_used}
                    for e in sorted(self._entries + self._host_entries,
                                    key=lambda e: e.last_used)]
