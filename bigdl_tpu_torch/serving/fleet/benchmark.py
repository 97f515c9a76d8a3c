"""The fleet A/B: prefix-affinity routing vs round-robin, plus the
mid-storm drain drill (port of ``bigdl_tpu/serving/fleet/benchmark.py``).

``run_fleet_comparison`` is the hermetic multi-process comparison: one
Poisson storm over shared-prefix templates is replayed through a fleet
of ``N`` spawn-worker replicas (each its own process, CUDA context,
model, engine, prefix trie) twice —

- **affinity**: the ``PrefixAffinityRouter`` hashes each prompt's
  first chunk onto the ring, so every template's KV accumulates on
  exactly one replica;
- **round_robin**: the control leg — the same storm sprayed evenly,
  every replica forced to cache every template.

Each replica's prefix pool is sized to hold its affinity SHARE of the
templates (the ring's largest per-replica template count, +1 slack —
capacity provisioned for content-aware routing), so the control leg
LRU-thrashes exactly the way a fleet of budget-bound tries does when
routing ignores content: the affinity leg wins on fleet-wide hit rate
AND on client TTFT p50 (a hit prefills only the random tail; a miss
prefills the whole template). Both legs' outputs are checked
token-identical to a single in-process reference engine replaying the
same workload on the same seed — routing must never change what anyone
decodes.

The third leg re-runs the affinity storm and, mid-storm, DRAINS one
replica (the degraded-replica drill: router routes away, in-flight
finishes) and later rejoins it — zero lost requests and the same
token parity is the acceptance bar. On one card the replicas share the
device: the comparison measures routing and prefix reuse, not scaling.

The model is JAX's recipe (``_MODEL``, f32) unless the caller passes
its own arguments and dtype (a full-width flagship in bf16, say). With
``front_door=True`` every leg's storm goes through a ``FleetFrontDoor``
as Server-Sent Events, and TTFT and inter-token gaps are stamped by the
HTTP client. Every row that parts from the reference is listed under
``mismatches`` (request, leg, first differing position, the prefix
there and both tokens), so a bf16 caller can judge each as a near tie
of the reference model; ``token_parity`` is true only with none.
"""

from __future__ import annotations

import json
import statistics
import threading
import time
from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from bigdl_tpu_torch.observability.fleettrace import (
    FLEET_HOPS, hop_breakdown,
)
from bigdl_tpu_torch.serving.benchmark import (
    _append_itl, _engine_replay, _percentiles, _replay,
    shared_prefix_workload,
)
from bigdl_tpu_torch.serving.fleet.frontdoor import FleetFrontDoor
from bigdl_tpu_torch.serving.fleet.router import PrefixAffinityRouter
from bigdl_tpu_torch.serving.fleet.supervisor import ReplicaSupervisor
from bigdl_tpu_torch.serving.fleet.worker import spawn_worker_fleet

__all__ = ["fleet_workload", "run_fleet_comparison", "sse_generate"]

#: the comparison's model recipe — every worker builds exactly this
#: (same seed => identical params => any replica's greedy output is the
#: fleet's greedy output)
_MODEL = dict(vocab_size=64, embed_dim=16, num_heads=4, num_kv_heads=2,
              num_layers=2, max_len=96, use_rope=True)


def fleet_workload(n_replicas: int, n_requests: int, rate_hz: float,
                   vocab_size: int, chunk: int, n_templates: int,
                   template_len: int, tail_lens=(2, 6),
                   decode_lens=(4, 10), seed: int = 0) -> dict:
    """A shared-prefix storm whose template heads SPREAD over the ring
    of ``n_replicas`` (each replica owns as many templates as any other,
    give or take one): the A/B measures the routing policy, not one
    seed's hash luck. Tries ``seed`` onward (the search only hashes
    prompt heads, no engine) and raises when 64 seeds give no balanced
    assignment. Returns the ``workload``, the ``seed`` it took, the
    templates each replica ``owned`` and ``prefix_rows``: the prefix
    pool a replica needs for its affinity share of the templates, +1
    slack (affinity fits its owned templates; round-robin needs ALL
    templates on every replica and thrashes its LRU)."""
    probe = PrefixAffinityRouter(
        [f"r{i}" for i in range(n_replicas)], chunk=chunk)
    for wl_seed in range(seed, seed + 64):
        workload = shared_prefix_workload(
            n_requests, rate_hz, vocab_size, n_templates=n_templates,
            template_len=template_len, tail_lens=tail_lens,
            decode_lens=decode_lens, seed=wl_seed,
            template_order="random")
        keys = {probe.key_for(req["prompt"]) for req in workload}
        owned = Counter(probe.owner(k) for k in keys)
        if (len(owned) == n_replicas
                and max(owned.values()) - min(owned.values()) <= 1):
            return {"workload": workload, "seed": wl_seed,
                    "owned": dict(owned),
                    "prefix_rows": max(owned.values()) + 1}
    raise RuntimeError(
        "no balanced template->replica assignment within 64 seeds "
        "— widen n_templates or the seed range")


def sse_generate(base: str, prompt, n: int, tenant: Optional[str] = None,
                 timeout: float = 300.0, on_meta=None) -> dict:
    """One streaming ``POST /v1/generate`` to the front door at
    ``base``: the ``meta`` event (also handed to ``on_meta``), the
    tokens with their arrival times on this process's monotonic clock,
    the ``done`` event (an ``error`` event lands under ``error``), and
    ``sent``, the clock when the request went out."""
    import urllib.request

    body = {"prompt_ids": [int(t) for t in prompt],
            "max_new_tokens": int(n)}
    if tenant is not None:
        body["tenant"] = tenant
    req = urllib.request.Request(
        base + "/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    out = {"meta": None, "tokens": [], "times": [], "done": None,
           "error": None, "sent": time.monotonic()}
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        event = None
        for raw in resp:
            ln = raw.decode().strip()
            if ln.startswith("event: "):
                event = ln[7:]
            elif ln.startswith("data: "):
                payload = json.loads(ln[6:])
                if event is None:
                    out["tokens"].append(payload["token"])
                    out["times"].append(time.monotonic())
                else:
                    out[event if event in ("meta", "done")
                        else "error"] = payload
                    if event == "meta" and on_meta is not None:
                        on_meta(payload)
                event = None
    return out


def _door_replay(sup: ReplicaSupervisor, base: str, workload,
                 on_submitted=None) -> dict:
    """``_fleet_replay`` through the front door at ``base``: each
    request is one SSE stream, TTFT and the inter-token gap are stamped
    at the HTTP client (routing + IPC + queue + prefill + the stream),
    ``on_submitted(i)`` fires as the i-th ``meta`` event arrives, and
    the hop means come from the door's request ring."""
    ttft: List[float] = []
    itl: List[float] = []
    rows: Dict[int, list] = {}
    count = {"n": 0}
    lock = threading.Lock()

    def on_meta(_meta):
        with lock:
            count["n"] += 1
            i = count["n"]
        if on_submitted is not None:
            on_submitted(i)

    def collect(req, _req):
        out = sse_generate(base, req["prompt"], req["n"],
                           tenant=req.get("tenant"), on_meta=on_meta)
        if out["done"] is None:
            raise RuntimeError(f"stream ended without done: {out}")
        t = out["times"]
        with lock:
            rows[id(req)] = [int(x) for x in out["tokens"]]
            if t:
                ttft.append(t[0] - out["sent"])
            if len(t) > 1:
                itl.append((t[-1] - t[0]) / (len(t) - 1))
        return len(out["tokens"])

    res = _replay(workload, lambda req: req, collect)
    res["ttft"] = _percentiles(ttft)
    res["inter_token"] = _percentiles(itl)
    res["rows"] = rows
    ring = sup.fleet_requests(last=1)["requests"]
    res["hops"] = {k: statistics.mean(e["hops"][k] for e in ring)
                   for k in FLEET_HOPS} if ring else None
    return res


def _control_ms(rep, n: int = 20) -> float:
    """Median ms of one control round trip (``healthz``) to ``rep``."""
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        rep.healthz()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def _mismatches(workload, rows: Dict[int, list], oracle: Dict[int, list],
                leg: str) -> List[dict]:
    """Where ``rows`` part from the reference ``oracle``: per request
    that differs, the first differing position, the prompt plus the
    agreed tokens before it (``prefix``) and both tokens there (None
    past a row's end; ``fleet_token`` None for a lost request)."""
    out = []
    for i, req in enumerate(workload):
        got, want = rows.get(id(req)), oracle[id(req)]
        if got == want:
            continue
        got = got or []
        j = next((k for k, (a, b) in enumerate(zip(got, want))
                  if a != b), min(len(got), len(want)))
        out.append({"request": i, "leg": leg, "position": j,
                    "prefix": [int(t) for t in req["prompt"]]
                    + want[:j],
                    "reference_token": want[j] if j < len(want) else None,
                    "fleet_token": got[j] if j < len(got) else None})
    return out


def _fleet_replay(sup: ReplicaSupervisor, workload,
                  on_submitted=None) -> dict:
    """Open-loop replay of ``workload`` through ``sup.submit`` (the
    shared ``_replay`` pacer). TTFT is CLIENT-side — routing + IPC +
    queue + prefill, stamped at first-token receipt in this process.
    ``on_submitted(i)`` fires after the i-th request is handed to a
    replica (the drain drill's trigger point). Each finished request
    is decomposed into the seven fleet hops (``hop_breakdown`` on the
    supervisor-measured route/rpc_submit timings plus the replica
    timeline); the leg block reports the per-hop MEANS under
    ``hops``."""
    ttft: List[float] = []
    itl: List[float] = []
    rows: Dict[int, list] = {}
    count = {"n": 0}
    t0s: Dict[int, float] = {}
    hop_sums = dict.fromkeys(FLEET_HOPS, 0.0)
    hop_n = [0]
    lock = threading.Lock()

    def submit(req):
        t0 = time.monotonic()
        routed = sup.submit(req["prompt"], req["n"],
                            tenant=req.get("tenant"))
        with lock:
            t0s[id(req)] = t0
            count["n"] += 1
            i = count["n"]
        if on_submitted is not None:
            on_submitted(i)
        return routed

    def collect(routed, req):
        toks = routed.handle.result(timeout=300)
        done = time.monotonic()
        h = routed.handle
        with lock:
            rows[id(req)] = [int(t) for t in toks]
            if h.first_token_at is not None:
                ttft.append(h.first_token_at - h.submitted_at)
            _append_itl(itl, h)
            t0 = t0s.pop(id(req), None)
            if t0 is not None:
                tl = h.timeline() if hasattr(h, "timeline") else {}
                hops = hop_breakdown(tl or {}, routed.route_s,
                                     routed.rpc_submit_s, done - t0)
                for k, v in hops.items():
                    hop_sums[k] += v
                hop_n[0] += 1
        return len(toks)

    res = _replay(workload, submit, collect)
    res["ttft"] = _percentiles(ttft)
    res["inter_token"] = _percentiles(itl)
    res["rows"] = rows
    res["hops"] = {k: (hop_sums[k] / hop_n[0]) for k in FLEET_HOPS} \
        if hop_n[0] else None
    return res


def _capacity_stamp(cap: dict) -> dict:
    """Compress ``fleet_capacity()`` into the result's capacity
    block: fleet headroom/replicas-needed plus each replica's role
    split (prefill vs decode device-wall fractions)."""
    roles = {}
    for rid, rc in (cap.get("replicas") or {}).items():
        r = rc.get("roles") or {}
        if r:
            roles[rid] = {
                "bound": r.get("bound"),
                "prefill_fraction":
                    (r.get("prefill") or {}).get("wall_fraction"),
                "decode_fraction":
                    (r.get("decode") or {}).get("wall_fraction"),
                "disaggregation_speedup_bound":
                    r.get("disaggregation_speedup_bound"),
            }
    return {
        "ready": bool(cap.get("ready")),
        "headroom": cap.get("headroom"),
        "utilization": cap.get("utilization"),
        "observed_rps": cap.get("observed_rps"),
        "sustainable_rps": cap.get("sustainable_rps"),
        "replicas_needed": cap.get("replicas_needed"),
        "roles": roles or None,
    }


def _budget_stamp(budgets: dict) -> dict:
    """Compress the per-replica SLO error-budget ledgers into the
    result's budget block: the fleet-worst remaining fraction plus the
    per-replica minima."""
    per = {rid: led.get("remaining_min")
           for rid, led in budgets.items() if isinstance(led, dict)}
    known = [v for v in per.values() if v is not None]
    return {
        "remaining_min": min(known) if known else None,
        "per_replica": per or None,
    }


def _leg(replicas, workload, policy, chunk, log, label,
         front_door: bool = False, drain_at: Optional[int] = None,
         rejoin_at: Optional[int] = None, victim: str = "r0") -> dict:
    """One fleet leg on its own worker processes (cold tries — the legs
    must not share cache state; ``run_fleet_comparison`` launches every
    leg's workers at once, so their start-ups overlap): warm each
    replica's executables outside the measurement, replay (through the
    front door with ``front_door``), aggregate, tear down."""
    sup = ReplicaSupervisor(replicas, policy=policy, chunk=chunk,
                            poll_interval=0.05,
                            fleet_name=f"bench-{label}")
    log(f"[fleet-bench] {label}: starting {len(replicas)} workers...")
    t0 = time.monotonic()
    with sup:
        startup_s = {rep.id: rep.startup_s for rep in replicas}
        spawn_s = time.monotonic() - t0
        warm = np.arange(1, 9, dtype=np.int32)
        for rep in replicas:
            rep.submit(warm, 4).result(timeout=300)

        def trigger(i):
            if drain_at is not None and i == drain_at:
                log(f"[fleet-bench] {label}: draining {victim} "
                    f"mid-storm (request {i})")
                sup.drain(victim, reason="degraded")
            if rejoin_at is not None and i == rejoin_at:
                sup.rejoin(victim)

        log(f"[fleet-bench] {label}: replaying "
            f"{len(workload)} requests...")
        hook = trigger if drain_at is not None else None
        if front_door:
            with FleetFrontDoor(sup, host="127.0.0.1", port=0) as door:
                res = _door_replay(sup, f"http://127.0.0.1:{door.port}",
                                   workload, on_submitted=hook)
        else:
            res = _fleet_replay(sup, workload, on_submitted=hook)
        stats = sup.stats()
        # capacity + error-budget read must happen before the
        # supervisor exits (workers are gone after teardown)
        cap = sup.fleet_capacity()
        budgets = cap.pop("slo_budget", None) or {}
        res["capacity"] = _capacity_stamp(cap)
        res["slo_budget"] = _budget_stamp(budgets)
        per = {rid: (s if isinstance(s, dict) else {})
               for rid, s in stats["replicas"].items()}
        res["fleet"] = {
            "policy": policy,
            "replicas": len(replicas),
            "front_door": front_door,
            "startup_s": startup_s,
            "spawn_s": round(spawn_s, 3),
            "clock": {rep.id: {"offset_s": rep.clock_offset_s,
                               "rtt_s": rep.clock_rtt_s}
                      for rep in replicas},
            "control_ms": {rep.id: _control_ms(rep)
                           for rep in replicas},
            "peak_memory_bytes": {
                rid: (s.get("memory") or {}).get("peak_bytes")
                for rid, s in per.items()},
            # each worker's own count of flash-kernel launches
            "flash_launches": {rid: s.get("flash_launches")
                               for rid, s in per.items()},
            "prefix_cache": stats["prefix_cache"],
            "hit_rate": stats["prefix_cache"]["hit_rate"],
            "routing": {k: stats["routing"][k]
                        for k in ("decisions", "per_replica",
                                  "draining")},
            "per_replica_finished": {
                rid: s.get("finished") for rid, s in per.items()},
        }
        if drain_at is not None:
            res["fleet"]["drained"] = victim
    return res


def run_fleet_comparison(n_replicas: int = 2, n_requests: int = 36,
                         rate_hz: float = 30.0,
                         n_templates: Optional[int] = None,
                         template_len: int = 48, max_slots: int = 4,
                         prefill_chunk: int = 8, prefill_rows: int = 2,
                         seed: int = 0, model_seed: int = 7,
                         drain_drill: bool = True,
                         log=print, device: str = "cuda",
                         model: Optional[dict] = None,
                         dtype: str = "float32",
                         tail_lens=(2, 6), decode_lens=(4, 10),
                         front_door: bool = False,
                         env: Optional[dict] = None,
                         rpc_timeout: float = 10.0) -> dict:
    """The fleet A/B over ``n_replicas`` spawn workers on ``device``
    (the card unless the caller asks for ``"cpu"``), each building
    ``model`` (the ``TransformerLM`` arguments; JAX's recipe
    ``_MODEL`` by default) from ``model_seed`` in ``dtype``; ``env``
    and ``rpc_timeout`` pass to ``spawn_worker_fleet``. Returns the
    affinity and round-robin leg blocks (client TTFT / latency /
    inter-token percentiles, throughput, fleet hit rate, routing
    tallies, start-up, clock and control round trip, peak memory and
    flash launches per worker), the drain-drill block, the headline
    ratios, the affinity leg's capacity/what-if stamp (fleet headroom,
    replicas-needed, per-role device-wall split) and SLO error-budget
    floor (worst ``remaining_min`` across replicas), the rows equal
    between the two legs, every row that parts from a single-replica
    reference replay (``mismatches``) and the token-parity verdict
    (none parts)."""
    import torch

    from bigdl_tpu_torch.models.transformer import TransformerLM

    if not 2 <= n_replicas <= 4:
        raise ValueError("the fleet bench runs 2-4 replicas")
    model = dict(model or _MODEL)
    if n_templates is None:
        n_templates = 2 * n_replicas
    # the chosen seed is recorded in the result's workload block
    wl = fleet_workload(
        n_replicas, n_requests, rate_hz, model["vocab_size"],
        prefill_chunk, n_templates=n_templates,
        template_len=template_len, tail_lens=tail_lens,
        decode_lens=decode_lens, seed=seed)
    workload, seed, share_rows = wl["workload"], wl["seed"], \
        wl["prefix_rows"]
    engine_cfg = dict(max_slots=max_slots, prefill_chunk=prefill_chunk,
                      prefill_rows=prefill_rows,
                      prefix_cache_rows=share_rows,
                      # generous TTFT objective: calm legs keep the
                      # error budget ~full; chaos drills are what
                      # spend it
                      slo_objectives=[dict(
                          name="ttft", metric="ttft",
                          threshold_s=5.0, target=0.9,
                          window_s=60.0, min_count=3)])
    # every leg's workers launch now, so their start-ups overlap each
    # other and the reference replay; each leg waits for its own
    legs = [("affinity", "affinity", {}),
            ("round-robin", "round_robin", {})]
    if drain_drill:
        legs.append(("drain-drill", "affinity",
                     {"drain_at": max(2, n_requests // 3),
                      "rejoin_at": max(3, (2 * n_requests) // 3)}))
    fleets = {label: spawn_worker_fleet(
        n_replicas, model, engine=engine_cfg, seed=model_seed,
        env=env, rpc_timeout=rpc_timeout, device=device, dtype=dtype)
        for label, _, _ in legs}
    for reps in fleets.values():
        for rep in reps:
            rep.launch()

    # single-replica reference on the same seed: the parity oracle for
    # every fleet leg (and the routing-never-changes-tokens contract)
    ref_model = TransformerLM(**model, seed=model_seed, device=device,
                              dtype=getattr(torch, dtype))
    ref_model.evaluate()
    ref = _engine_replay(
        ref_model, workload,
        warm_prompt=np.arange(1, 9, dtype=np.int32),
        warm_tokens=4, stats_keys=("prefix_cache",), log=log,
        label="fleet-reference", service_name="fleet-ref",
        max_slots=max_slots, prefill_chunk=prefill_chunk,
        prefill_rows=prefill_rows)
    del ref_model
    oracle = {id(req): [int(t) for t in
                        ref["rows"][id(req)][len(req["prompt"]):]]
              for req in workload}

    out = {}
    try:
        for reps in fleets.values():
            for rep in reps:
                rep.start()     # every worker is up before any storm
        for label, policy, drill in legs:
            out[label] = _leg(fleets[label], workload, policy,
                              prefill_chunk, log, label,
                              front_door=front_door, **drill)
    finally:
        for reps in fleets.values():
            for rep in reps:
                rep.stop()
    aff, rr = out["affinity"], out["round-robin"]
    mismatches = (_mismatches(workload, aff["rows"], oracle, "affinity")
                  + _mismatches(workload, rr["rows"], oracle,
                                "round_robin"))
    rows_equal = sum(aff["rows"].get(id(req)) == rr["rows"].get(id(req))
                     for req in workload)

    drain = None
    if drain_drill:
        d = out["drain-drill"]
        drill_mm = _mismatches(workload, d["rows"], oracle, "drain")
        drain = {
            "completed": d["requests"],
            "lost": n_requests - len(d["rows"]),
            "token_parity": not drill_mm,
            "mismatches": drill_mm,
            "drained": d["fleet"].get("drained"),
            "routing": d["fleet"]["routing"],
            "ttft": d["ttft"],
        }

    for leg in (aff, rr):
        leg.pop("rows", None)  # ndarray-free JSON result
    # the affinity leg is the headline: its capacity/what-if block and
    # error-budget floor become the result's capacity / slo_budget
    # (the control leg's copies add nothing)
    capacity = aff.pop("capacity", None)
    slo_budget = aff.pop("slo_budget", None)
    rr.pop("capacity", None)
    rr.pop("slo_budget", None)

    a50, r50 = aff["ttft"]["p50"], rr["ttft"]["p50"]
    ratios = {
        # > 1.0: the affinity leg's median first token lands sooner
        "ttft_p50_speedup": (round(r50 / a50, 4)
                             if a50 and r50 else None),
        # additive: round-robin's hit rate can legitimately be ~0 here
        "hit_rate_gain": round(
            aff["fleet"]["hit_rate"] - rr["fleet"]["hit_rate"], 4),
    }
    return {
        "affinity": aff,
        "round_robin": rr,
        "drain": drain,
        "capacity": capacity,
        "slo_budget": slo_budget,
        **ratios,
        "rows_equal_between_legs": rows_equal,
        "mismatches": mismatches,
        "token_parity": not mismatches,
        "workload": {
            "kind": "fleet_shared_prefix",
            "replicas": n_replicas,
            "requests": n_requests,
            "rate_hz": rate_hz,
            "templates": n_templates,
            "template_len": template_len,
            "tail_lens": list(tail_lens),
            "decode_lens": list(decode_lens),
            "owned": wl["owned"],
            "prefix_rows_per_replica": share_rows,
            "max_slots": max_slots,
            "prefill_rows": prefill_rows,
            "prefill_chunk": prefill_chunk,
            "seed": seed,
            "model": model,
            "model_seed": model_seed,
            "dtype": dtype,
            "front_door": front_door,
            "device": device,
        },
    }
