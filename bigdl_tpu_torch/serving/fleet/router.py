"""Prefix-affinity request routing over a replica ring (port of
``bigdl_tpu/serving/fleet/router.py``: a framework-free copy, the same
SHA-1 ring hash, so both packages route a prompt to the same replica).

The fleet's placement problem: the prefix cache only pays
when template-sharing requests land on the SAME replica — spraying a
hot template round-robin across N replicas multiplies its KV footprint
by N and divides every trie's hit rate. ``PrefixAffinityRouter``
therefore consistent-hashes the first prefix-cache chunk of each
prompt onto a ring of virtual nodes: requests sharing a cacheable head
share a hash key, the key owns a stable arc of the ring, and the arc's
replica accumulates that template's KV exactly once fleet-wide.

Affinity must not become pinning, so two relief valves mirror the
admission queue's bounded-bypass pattern (``AdmissionQueue.pop_ready``):

- **saturation spill** — when the affinity target's polled load is at
  or past ``saturation``, the request spills to the least-loaded live
  replica instead of queueing behind the hot spot;
- **forced spill** — a hot template may win affinity at most
  ``spill_window`` consecutive times while a strictly-less-loaded
  replica sits available; the next request is forced to spill. One
  viral prompt therefore costs at most a bounded affinity streak
  before the rest of the fleet shares the load, exactly as one
  cache-rich admission may bypass the FCFS head only ``window`` times.

Pure host-side data structure: no engines, no I/O, no clocks — unit
testable in isolation (join/leave moves ~1/N keys; the decision table
is deterministic given the load map).
"""

from __future__ import annotations

import bisect
import hashlib
import threading
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

import numpy as np

__all__ = ["NoLiveReplicas", "PrefixAffinityRouter", "RouteDecision"]


class NoLiveReplicas(RuntimeError):
    """Every replica is draining or removed — nothing can take traffic."""


class RouteDecision(NamedTuple):
    """One routing verdict: where the request goes and why.

    ``route`` is ``"affinity"`` (the hash owner took it) or
    ``"spilled"`` (owner saturated, or the forced-spill bound fired —
    ``forced`` distinguishes the two). ``target`` is the ring owner
    the key hashed to, kept even when the request spilled so hit-rate
    forensics can see which arc overflowed."""

    replica: str
    route: str
    target: str
    key: int
    forced: bool = False


def _stable_hash(data: bytes) -> int:
    # process-independent (PYTHONHASHSEED-proof): router decisions must
    # agree between the bench parent, tests, and any future multi-node
    # front doors fed the same ring
    return int.from_bytes(hashlib.sha1(data).digest()[:8], "big")


class PrefixAffinityRouter:
    """Consistent-hash router with load-aware spill and a forced-spill
    bound.

    ``chunk`` should match the engines' ``prefill_chunk``: the hash key
    is the first chunk of prompt ids — the same head the prefix cache
    indexes — so two prompts that would share a trie entry always share
    a ring key. ``vnodes`` virtual nodes per replica smooth the arcs;
    ``saturation`` is the polled-load level (queue depth + active
    slots, by default) at which the owner stops taking new affinity
    traffic; ``spill_window`` bounds consecutive affinity wins while a
    less-loaded replica idles (0 disables the bound).

    Thread-safe: the front door routes from concurrent HTTP threads
    while the supervisor's poll loop marks replicas draining/live.
    """

    def __init__(self, replicas: Iterable[str] = (), chunk: int = 16,
                 vnodes: int = 64, saturation: float = 8.0,
                 spill_window: int = 8):
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.chunk = int(chunk)
        self.vnodes = int(vnodes)
        self.saturation = float(saturation)
        self.spill_window = int(spill_window)
        self._lock = threading.RLock()
        self._replicas: List[str] = []
        self._draining: set = set()
        self._ring: List[int] = []        # sorted hash points
        self._ring_owner: List[str] = []  # point -> replica id
        # forced-spill bound state: consecutive affinity routes to one
        # replica (any other route resets it — the ring-level analogue
        # of AdmissionQueue._head_bypasses)
        self._streak_rid: Optional[str] = None
        self._streak = 0
        self._counts = {"affinity": 0, "spilled": 0, "forced": 0}
        self._per_replica: Dict[str, Dict[str, int]] = {}
        for rid in replicas:
            self.add_replica(rid)

    # ------------------------------------------------------ membership
    def add_replica(self, rid: str) -> None:
        with self._lock:
            if rid in self._replicas:
                return
            self._replicas.append(rid)
            self._per_replica.setdefault(
                rid, {"affinity": 0, "spilled": 0})
            for v in range(self.vnodes):
                p = _stable_hash(f"{rid}#{v}".encode())
                i = bisect.bisect(self._ring, p)
                self._ring.insert(i, p)
                self._ring_owner.insert(i, rid)

    def remove_replica(self, rid: str) -> None:
        with self._lock:
            if rid not in self._replicas:
                return
            self._replicas.remove(rid)
            self._draining.discard(rid)
            keep = [(p, r) for p, r in zip(self._ring, self._ring_owner)
                    if r != rid]
            self._ring = [p for p, _ in keep]
            self._ring_owner = [r for _, r in keep]
            if self._streak_rid == rid:
                self._streak_rid, self._streak = None, 0

    def mark_draining(self, rid: str) -> None:
        """Take ``rid`` out of rotation WITHOUT moving its ring arcs:
        lookups walk past it to the next live owner, and ``mark_live``
        restores the exact prior keyspace — a drain/rejoin cycle moves
        each affected key twice and every other key zero times."""
        with self._lock:
            if rid in self._replicas:
                self._draining.add(rid)

    def mark_live(self, rid: str) -> None:
        with self._lock:
            self._draining.discard(rid)

    @property
    def replicas(self) -> List[str]:
        with self._lock:
            return list(self._replicas)

    @property
    def draining(self) -> List[str]:
        with self._lock:
            return sorted(self._draining)

    def live_replicas(self) -> List[str]:
        with self._lock:
            return [r for r in self._replicas if r not in self._draining]

    # ---------------------------------------------------------- lookup
    def key_for(self, prompt_ids: Sequence[int]) -> int:
        """The routing key: a stable hash of the first prefix-cache
        chunk of the prompt (the whole prompt when shorter)."""
        head = np.asarray(prompt_ids, np.int32).reshape(-1)[:self.chunk]
        return _stable_hash(head.tobytes())

    def owner(self, key: int) -> str:
        """The ring owner among LIVE replicas: the first live replica
        at or after the key's point, walking the ring."""
        with self._lock:
            return self._owner_locked(key)

    def _owner_locked(self, key: int) -> str:
        if not self._ring:
            raise NoLiveReplicas("router has no replicas")
        n = len(self._ring)
        i = bisect.bisect(self._ring, key) % n
        for step in range(n):
            rid = self._ring_owner[(i + step) % n]
            if rid not in self._draining:
                return rid
        raise NoLiveReplicas("all replicas are draining")

    # ----------------------------------------------------------- route
    def route(self, prompt_ids: Sequence[int],
              loads: Optional[Dict[str, float]] = None) -> RouteDecision:
        """Decide a replica for one prompt. ``loads`` maps replica id
        -> current load (the supervisor passes queue depth + active
        slots from its last poll; missing/None entries read as 0 —
        an unpolled replica is assumed idle)."""
        key = self.key_for(prompt_ids)
        loads = loads or {}
        with self._lock:
            target = self._owner_locked(key)
            load = float(loads.get(target) or 0.0)
            live = [r for r in self._replicas
                    if r not in self._draining]
            least = min(
                live, key=lambda r: (float(loads.get(r) or 0.0),
                                     r))
            least_load = float(loads.get(least) or 0.0)
            forced = (
                self.spill_window > 0
                and self._streak_rid == target
                and self._streak >= self.spill_window
                and least_load < load)
            if load >= self.saturation or forced:
                # spill to the least-loaded live replica (which may be
                # the target itself when the whole fleet is saturated
                # evenly — then the decision degrades to affinity-ish
                # placement but is still counted as a spill)
                rid, route = least, "spilled"
                self._counts["spilled"] += 1
                if forced:
                    self._counts["forced"] += 1
                self._per_replica.setdefault(
                    rid, {"affinity": 0, "spilled": 0})["spilled"] += 1
                self._streak_rid, self._streak = None, 0
            else:
                rid, route = target, "affinity"
                self._counts["affinity"] += 1
                self._per_replica.setdefault(
                    rid, {"affinity": 0, "spilled": 0})["affinity"] += 1
                if self._streak_rid == rid:
                    self._streak += 1
                else:
                    self._streak_rid, self._streak = rid, 1
            return RouteDecision(rid, route, target, key, forced)

    # ------------------------------------------------------- forensics
    def ownership(self, sample: int = 4096) -> Dict[str, float]:
        """Approximate live-keyspace share per replica (``sample``
        evenly spaced probe keys walked through ``owner``) — the demo's
        routing table."""
        with self._lock:
            if not self._ring:
                return {}
            out = {r: 0 for r in self._replicas
                   if r not in self._draining}
            span = 1 << 64
            for s in range(sample):
                out[self._owner_locked(s * span // sample)] += 1
            return {r: round(c / sample, 4) for r, c in out.items()}

    def snapshot(self) -> dict:
        """The routing table as one JSON-able dict: membership, drain
        set, decision tallies, and per-replica affinity/spill counts."""
        with self._lock:
            return {
                "replicas": list(self._replicas),
                "draining": sorted(self._draining),
                "vnodes": self.vnodes,
                "chunk": self.chunk,
                "saturation": self.saturation,
                "spill_window": self.spill_window,
                "decisions": dict(self._counts),
                "per_replica": {r: dict(c) for r, c in
                                self._per_replica.items()},
                "ownership": self.ownership(1024),
            }
