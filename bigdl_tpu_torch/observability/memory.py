"""Device-memory accounting: HBM gauges, per-pool byte attribution,
and a high-watermark history (port of ``bigdl_tpu/observability/memory.py``).

A serving or training deployment dies by HBM long before it dies
by FLOPs: the KV slot pool, the prefix-cache pool, the prefill staging
cache, the model parameters, and the optimizer slots all compete for
the same device memory, and an OOM reports none of them by name. This
module is the attribution layer:

- ``DeviceMemoryMonitor`` samples the visible CUDA devices through
  ``torch.cuda`` (``memory_allocated`` for the bytes in use,
  ``max_memory_allocated`` for the peak, ``mem_get_info`` for the
  limit) — on the CPU, which reports no device memory, the device
  fields are None — and publishes the ``bdt_device_hbm_*`` gauges
  (bytes in use, peak, limit, headroom, per device) plus one
  ``bdt_device_pool_bytes{pool=...}`` series per registered pool.
- **Pool registration** is a process-wide table:
  ``register_pool(name, fn)`` binds a name to a zero-argument callable
  returning that pool's current device bytes. The built-in
  integrations register themselves — the continuous-batching engine
  (KV slot pool, prefill staging, prefix pool, params), the prefix
  cache (occupied pool bytes), and both train loops (params, optimizer
  slots) — so ``/debug/memory`` answers "who owns the HBM" without
  any per-deployment wiring. ``register_owned_pools`` wraps the
  callables in weakrefs, so a registered pool never keeps its owner
  (and the owner's device buffers) alive.
- A bounded **history ring** of samples plus the **high-watermark
  sample** (the full per-device + per-pool picture at the worst
  moment seen) back the ``GET /debug/memory`` endpoint
  (``exporters.MetricsHTTPServer``).

Sampling is cheap: the ``torch.cuda`` reads are the caching
allocator's host counters plus one driver query, and ``tree_bytes``
reads ``nbytes`` without any device sync; none of them waits for the
device. ``monitor.start(interval_s)`` runs it on a daemon
thread; ``monitor.sample()`` is the one-shot used by tests, ``bench.py``
and the debug endpoint (which always serves a FRESH sample). The
serving engine samples from its time-series thread, never from its
loop.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional

import torch

# ---------------------------------------------------------- pool registry
_POOLS: Dict[str, Callable[[], Optional[int]]] = {}
_POOLS_LOCK = threading.Lock()


def register_pool(name: str, fn: Callable[[], Optional[int]]) -> str:
    """Register (or replace) one named device-memory pool. ``fn`` is a
    zero-argument callable returning the pool's CURRENT byte footprint
    (or None, which unregisters the pool — the weak-owner convention).
    Returns ``name`` (the unregistration token)."""
    if not name or not isinstance(name, str):
        raise ValueError(f"pool name must be a non-empty str, got {name!r}")
    if not callable(fn):
        raise TypeError(f"pool fn for {name!r} must be callable")
    with _POOLS_LOCK:
        _POOLS[name] = fn
    return name


def unregister_pool(name: str, fn: Optional[Callable] = None) -> None:
    """Remove a pool. With ``fn`` given, remove only if ``name`` still
    maps to that exact callable — a late unregister (one run's
    ``finally``) must never delete a successor's live registration
    under the same name."""
    with _POOLS_LOCK:
        if fn is None or _POOLS.get(name) is fn:
            _POOLS.pop(name, None)


def register_owned_pools(owner, pools: Dict[str, Callable]) -> List[str]:
    """Register pools whose callables take ``owner`` as their argument,
    held through a WEAK reference: once the owner is collected the
    pool reports None and is pruned on the next sample — registration
    never pins an engine's (or an optimizer's) device buffers in
    memory. Returns the registered names."""
    ref = weakref.ref(owner)
    names = []
    for name, fn in pools.items():
        def read(ref=ref, fn=fn):
            o = ref()
            return None if o is None else fn(o)

        names.append(register_pool(name, read))
    return names


@contextlib.contextmanager
def static_pools(pools: Dict[str, int]):
    """Register fixed byte sizes for the duration of a with-block —
    the train-loop pattern (params / optimizer slots are shape-derived
    constants). Registration holds plain ints, never the donated
    trees; teardown is fn-guarded, so a same-named successor
    registered meanwhile survives this block's exit."""
    fns = {name: (lambda b=int(v): b) for name, v in pools.items()}
    for name, fn in fns.items():
        register_pool(name, fn)
    try:
        yield
    finally:
        for name, fn in fns.items():
            unregister_pool(name, fn)


def registered_pools() -> List[str]:
    with _POOLS_LOCK:
        return sorted(_POOLS)


def pool_sizes() -> Dict[str, int]:
    """Current byte footprint of every registered pool. A pool whose
    callable returns None (its owner was collected — the weakref
    convention) is pruned, fn-guarded so a same-named successor's
    fresh registration survives the prune. A callable that RAISES or
    returns a non-int is merely skipped this sample: a transient
    error (a reader racing its owner's internal state) must not
    permanently delete the attribution."""
    with _POOLS_LOCK:
        snap = list(_POOLS.items())
    out: Dict[str, int] = {}
    dead = []
    for name, fn in snap:
        try:
            v = fn()
        except Exception:
            continue
        if v is None:
            dead.append((name, fn))
            continue
        try:
            out[name] = int(v)
        except Exception:
            continue
    for name, fn in dead:
        unregister_pool(name, fn)
    return out


def tree_bytes(tree) -> int:
    """Total ``nbytes`` across the tensors of a nested dict / list /
    tuple (a state dict, a KV cache list), or of an ``nn.Module``'s
    parameters and buffers (0 for None) — shape metadata only, no
    device sync."""
    if tree is None:
        return 0
    if isinstance(tree, torch.nn.Module):
        return (sum(int(p.nbytes) for p in tree.parameters())
                + sum(int(b.nbytes) for b in tree.buffers()))
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if torch.is_tensor(tree) or hasattr(tree, "nbytes"):
        return int(getattr(tree, "nbytes", 0))
    return 0


def tree_device_bytes(tree) -> int:
    """PHYSICAL bytes a tree commits on this process's device. Each
    process of a mesh holds its own shard tensors (``parallel/tp.py``),
    so its physical bytes are its tensors' ``nbytes``: ``tree_bytes``."""
    return tree_bytes(tree)


def _cuda_devices():
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class DeviceMemoryMonitor:
    """Background sampler over the local devices' memory statistics
    with per-pool byte attribution.

    ``sample()`` takes one snapshot: per-device bytes in use / peak /
    limit / headroom (``torch.cuda`` on a CUDA device; None on the
    CPU), plus every registered pool's bytes — and publishes the
    ``bdt_device_hbm_*`` and ``bdt_device_pool_bytes`` gauges.
    ``devices`` defaults to every visible CUDA device, or the CPU where
    there is none. The high watermark follows the devices' bytes in
    use, or the pools' sum where no device reports. ``start(interval_s)`` runs
    sampling on a daemon thread; ``debug_memory()`` is the
    ``GET /debug/memory`` payload (a fresh sample + the high-watermark
    sample + the recent history ring)."""

    def __init__(self, registry=None, recorder=None,
                 interval_s: float = 10.0, history: int = 256,
                 devices=None):
        from bigdl_tpu_torch.observability.events import default_recorder
        from bigdl_tpu_torch.observability.instruments import memory_instruments

        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.interval_s = float(interval_s)
        self._devices = devices
        self._ins = memory_instruments(registry)
        self._rec = recorder if recorder is not None else default_recorder()
        self._ring: collections.deque = collections.deque(maxlen=history)
        self._lock = threading.Lock()
        self._peak_bytes = 0
        self._peak_sample: Optional[dict] = None
        self._seen_pools: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ sampling
    def sample(self) -> dict:
        """One snapshot (also updates the gauges, the history ring, and
        the high watermark). Safe from any thread."""
        devices = self._devices
        if devices is None:
            devices = _cuda_devices() or [torch.device("cpu")]
        dev_rows = []
        total = None
        for i, d in enumerate(devices):
            d = torch.device(d)
            in_use = peak = limit = None
            source = "none"
            if d.type == "cuda":
                in_use = int(torch.cuda.memory_allocated(d))
                peak = int(torch.cuda.max_memory_allocated(d))
                limit = int(torch.cuda.mem_get_info(d)[1])
                source = "torch.cuda"
                total = (total or 0) + in_use
            headroom = (limit - in_use) if limit is not None else None
            lbl = str(i)
            if in_use is not None:
                self._ins.bytes_in_use.labels(lbl).set(in_use)
            if peak is not None:
                self._ins.peak_bytes.labels(lbl).set(peak)
            if limit is not None:
                self._ins.limit_bytes.labels(lbl).set(limit)
            if headroom is not None:
                self._ins.headroom_bytes.labels(lbl).set(headroom)
            dev_rows.append({
                "device": str(d), "index": i, "platform": d.type,
                "bytes_in_use": in_use, "peak_bytes": peak,
                "limit_bytes": limit, "headroom_bytes": headroom,
                "source": source,
            })

        pools = pool_sizes()
        for name, nbytes in pools.items():
            self._ins.pool_bytes.labels(name).set(nbytes)
        with self._lock:
            # zero out pools that disappeared so the scrape never shows
            # a dead pool's last value as current occupancy
            for gone in self._seen_pools - set(pools):
                self._ins.pool_bytes.labels(gone).set(0)
            self._seen_pools = set(pools)

        snap = {
            "ts": time.time(),
            "bytes_in_use": total,
            "devices": dev_rows,
            "pools": pools,
            "pool_bytes_total": sum(pools.values()),
        }
        mark = total if total is not None else snap["pool_bytes_total"]
        with self._lock:
            self._ring.append({"ts": snap["ts"], "bytes_in_use": total,
                               "pools": pools})
            if mark > self._peak_bytes:
                grew = (self._peak_bytes == 0
                        or mark > 1.1 * self._peak_bytes)
                self._peak_bytes = mark
                self._peak_sample = snap
                if grew:
                    self._rec.record("memory/high_watermark",
                                     bytes_in_use=mark,
                                     pools=dict(pools))
        return snap

    @property
    def peak_bytes(self) -> int:
        with self._lock:
            return self._peak_bytes

    def debug_memory(self) -> dict:
        """The ``GET /debug/memory`` payload: a FRESH sample, the high-
        watermark sample (the full attribution at the worst moment
        seen), and the recent sample ring."""
        now = self.sample()
        with self._lock:
            return {"now": now,
                    "peak_bytes": self._peak_bytes,
                    "peak": self._peak_sample,
                    "history": list(self._ring)}

    # ----------------------------------------------------- background loop
    def start(self, interval_s: Optional[float] = None
              ) -> "DeviceMemoryMonitor":
        """Start the daemon sampler thread (idempotent)."""
        if interval_s is not None:
            self.interval_s = float(interval_s)
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="bdt-memory-monitor",
                daemon=True)
            self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.sample()
            except Exception:
                # graftlint: ok[resource-hygiene] — a transient backend error must not kill the sampler; the next tick retries
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


_default_monitor: Optional[DeviceMemoryMonitor] = None
_default_monitor_lock = threading.Lock()


def default_monitor() -> DeviceMemoryMonitor:
    """The process-default monitor (lazily constructed against the
    default registry) — what ``/debug/memory`` serves when no explicit
    monitor is attached to the HTTP server."""
    global _default_monitor
    with _default_monitor_lock:
        if _default_monitor is None:
            _default_monitor = DeviceMemoryMonitor()
        return _default_monitor
