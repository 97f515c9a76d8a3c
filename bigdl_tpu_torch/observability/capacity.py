"""Capacity / what-if model: measured signals -> sustainable load (port of
``bigdl_tpu/observability/capacity.py``).

The serving tier already measures everything a capacity question
needs; this module just combines it, entirely host-side:

- the loop-phase accounting (``LoopPhaseAccumulator.summary()``) says
  where each iteration's wall went and how much was device-busy,
- the dispatch cost model (``DispatchCostModel.summary()``) says what
  roofline class each dispatch kind sits in and how hard it drives
  the device,
- the usage ledger (``UsageLedger.summary()``) prices each request in
  device-seconds and tokens.

:func:`estimate_capacity` turns those three summaries into one
JSON-ready block: per-replica sustainable request rate and tokens/s,
current utilization and headroom fraction, and a per-role projection
(prefill-bound vs decode-bound share of the wall) that quantifies the
prefill/decode disaggregation win BEFORE that split is built —
ROADMAP item 2 reads its expected speedup here. :func:`replicas_needed`
answers the what-if ("this offered load needs N replicas").

No device work: every input is an existing ``stats()`` summary, so the
model runs identically in a worker process or an offline report over a
saved dump.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

__all__ = ["aggregate_fleet_capacity", "estimate_capacity",
           "replicas_needed"]

#: loop phases that are host work serialized with dispatch — the
#: non-overlapped remainder after device-busy time prices the host's
#: share of each request
_HOST_PHASES = ("sweep", "admission", "prefill_dispatch",
                "decode_dispatch", "deliver", "observe")


def estimate_capacity(loop: Optional[dict], cost: Optional[dict],
                      usage: Optional[dict],
                      max_slots: Optional[int] = None,
                      service: Optional[str] = None) -> dict:
    """Combine the three measured summaries into one capacity block.

    Returns ``{"ready": False, "reason": ...}`` before there is
    traffic to price (the model never extrapolates from zero); once
    ready: observed/sustainable request rates, tokens/s, utilization
    and headroom fractions, per-request device/host seconds, and the
    per-role (prefill vs decode) wall split with the implied
    disaggregation speedup bound.
    """
    loop = loop or {}
    cost = cost or {}
    usage = usage or {}
    totals = usage.get("totals") or {}
    requests = int(totals.get("requests") or 0)
    wall_s = float(loop.get("wall_s") or 0.0)
    if requests <= 0 or wall_s <= 0.0:
        return {"ready": False, "service": service,
                "reason": "no completed requests measured yet",
                "requests": requests}
    device_s = float(totals.get("device_s") or 0.0)
    device_s_per_req = device_s / requests
    phases = loop.get("phases") or {}
    host_s = sum(float(phases.get(p) or 0.0) for p in _HOST_PHASES)
    device_busy_s = float(loop.get("device_busy_s") or 0.0)
    # host time the device could not hide: the serialized remainder
    # after device-busy wall is subtracted from the loop's phase wall
    host_overhead_s = max(0.0, host_s - device_busy_s)
    host_s_per_req = host_overhead_s / requests
    cost_per_req = device_s_per_req + host_s_per_req
    sustainable_rps = (1.0 / cost_per_req) if cost_per_req > 0 \
        else None
    observed_rps = requests / wall_s
    tokens = (float(totals.get("prefill_tokens") or 0.0)
              + float(totals.get("decode_tokens") or 0.0))
    tokens_per_req = tokens / requests
    utilization = (observed_rps / sustainable_rps
                   if sustainable_rps else None)
    out = {
        "ready": True,
        "service": service,
        "requests": requests,
        "observed_rps": round(observed_rps, 4),
        "sustainable_rps": (round(sustainable_rps, 4)
                            if sustainable_rps else None),
        "sustainable_tokens_per_s": (
            round(tokens_per_req * sustainable_rps, 2)
            if sustainable_rps else None),
        "tokens_per_request": round(tokens_per_req, 2),
        "device_s_per_request": round(device_s_per_req, 6),
        "host_s_per_request": round(host_s_per_req, 6),
        "utilization": (round(utilization, 4)
                        if utilization is not None else None),
        "headroom": (round(1.0 - utilization, 4)
                     if utilization is not None else None),
        "max_slots": max_slots,
    }
    kinds = cost.get("kinds") or {}
    role_wall = {k: float((kinds.get(k) or {}).get("wall_s") or 0.0)
                 for k in ("prefill", "decode")}
    total_role_wall = sum(role_wall.values())
    if total_role_wall > 0.0:
        roles = {}
        for k, w in role_wall.items():
            info = kinds.get(k) or {}
            roles[k] = {
                "wall_fraction": round(w / total_role_wall, 4),
                "roofline": info.get("roofline"),
                "mfu": info.get("mfu"),
                "membw_util": info.get("membw_util"),
            }
        bound = max(role_wall, key=role_wall.get)
        # a dedicated-role replica sheds the OTHER role's wall: its
        # device cost per request scales by the bound role's share,
        # which bounds the disaggregation speedup from above
        bound_frac = role_wall[bound] / total_role_wall
        roles["bound"] = bound
        roles["disaggregation_speedup_bound"] = (
            round(1.0 / bound_frac, 3) if bound_frac > 0 else None)
        out["roles"] = roles
    return out


def replicas_needed(capacity: dict, offered_rps: float) -> Optional[int]:
    """Replicas an ``offered_rps`` load needs at this capacity
    estimate's per-replica sustainable rate (None before ready).
    Takes either a single-replica block (``sustainable_rps`` IS the
    per-replica rate) or a fleet aggregate (whose ``sustainable_rps``
    is fleet-wide, so the mean per-replica rate wins)."""
    if not capacity or not capacity.get("ready"):
        return None
    per_replica = capacity.get("sustainable_rps_per_replica") \
        or capacity.get("sustainable_rps")
    if not per_replica or per_replica <= 0:
        return None
    return max(1, int(math.ceil(float(offered_rps) / per_replica)))


def aggregate_fleet_capacity(per_replica: Dict[str, Optional[dict]],
                             offered_rps: Optional[float] = None,
                             fleet: str = "fleet") -> dict:
    """Fold per-replica :func:`estimate_capacity` blocks into the
    fleet view: summed observed/sustainable rates, fleet headroom,
    and replicas-needed for the observed load (or an explicit
    ``offered_rps`` what-if). Replicas that are not ready (or whose
    stats read failed -> None) are listed but priced out."""
    ready = {rid: c for rid, c in per_replica.items()
             if c and c.get("ready")}
    observed = sum(c.get("observed_rps") or 0.0
                   for c in ready.values())
    sustainable = sum(c.get("sustainable_rps") or 0.0
                      for c in ready.values())
    tokens = sum(c.get("sustainable_tokens_per_s") or 0.0
                 for c in ready.values())
    utilization = (observed / sustainable) if sustainable > 0 else None
    offered = observed if offered_rps is None else float(offered_rps)
    mean_per_replica = (sustainable / len(ready)) if ready else None
    needed = (max(1, int(math.ceil(offered / mean_per_replica)))
              if mean_per_replica and mean_per_replica > 0
              and offered > 0 else (1 if ready else None))
    return {
        "fleet": fleet,
        "ready": bool(ready),
        "replicas": {rid: (c if c else {"ready": False,
                                        "reason": "stats unavailable"})
                     for rid, c in sorted(per_replica.items())},
        "replicas_ready": sorted(ready),
        "observed_rps": round(observed, 4),
        "sustainable_rps": round(sustainable, 4),
        "sustainable_tokens_per_s": round(tokens, 2),
        "utilization": (round(utilization, 4)
                        if utilization is not None else None),
        "headroom": (round(1.0 - utilization, 4)
                     if utilization is not None else None),
        "offered_rps": round(offered, 4),
        "replicas_needed": needed,
        "sustainable_rps_per_replica": (
            round(mean_per_replica, 4) if mean_per_replica else None),
    }
