"""bigdl_tpu_torch.serving.fleet — multi-replica serving behind one door
(port of ``bigdl_tpu/serving/fleet``).

The horizontal-scale layer over the continuous-batching engine: one
control plane owning N engine replicas, one data plane streaming tokens
to clients over held connections (stream one way, never per-token
request/response).

- ``PrefixAffinityRouter`` (``router``): consistent-hashes each
  prompt's first prefix-cache chunk onto a virtual-node ring so
  template-sharing requests land where the trie already holds their
  KV — every template's cache cost is paid on ONE replica fleet-wide.
  Saturated targets spill to the least-loaded replica, and a
  forced-spill bound stops one hot template from pinning its owner.
  The ring hash is the JAX package's SHA-1, so both packages route a
  prompt to the same replica.
- ``ReplicaSupervisor`` (``supervisor``): owns the replicas
  (``InProcessReplica`` wrappers or ``multiprocessing`` spawn
  ``WorkerReplica`` processes, each with its own CUDA context), polls
  ``healthz()`` + load gauges, DRAINS what degrades, crashes or stops
  answering (in-flight finishes, new traffic routes away), rejoins what
  recovers, and routes ``submit()`` calls through the ring.
  ``bdt_fleet_*`` instruments cover the whole control plane.
- ``FleetFrontDoor`` (``frontdoor``): the stdlib-only HTTP door —
  ``POST /v1/generate`` streams tokens as Server-Sent Events off the
  replica handle's iterator (client disconnect cancels the request
  and frees the slot), ``GET /v1/stats`` aggregates per-replica
  ``stats()`` plus the fleet prefix hit rate and routing table, and
  ``/debug/fleet/*`` serves the merged trace, requests, incidents,
  time series, capacity and dashboard.
- ``run_fleet_comparison`` (``benchmark``): the hermetic multi-process
  affinity-vs-round-robin storm with a drain drill and a token-parity
  verdict against a one-replica replay.

Quick start::

    from bigdl_tpu_torch.serving import ContinuousBatchingEngine
    from bigdl_tpu_torch.serving.fleet import (
        FleetFrontDoor, InProcessReplica, ReplicaSupervisor,
    )

    replicas = [InProcessReplica(f"r{i}",
                                 ContinuousBatchingEngine(model))
                for i in range(3)]
    with ReplicaSupervisor(replicas) as sup, \\
         FleetFrontDoor(sup, port=8080) as door:
        ...  # POST /v1/generate, GET /v1/stats on door.port
"""

from bigdl_tpu_torch.serving.fleet.benchmark import run_fleet_comparison
from bigdl_tpu_torch.serving.fleet.frontdoor import (
    FleetFrontDoor, start_front_door,
)
from bigdl_tpu_torch.serving.fleet.router import (
    NoLiveReplicas, PrefixAffinityRouter, RouteDecision,
)
from bigdl_tpu_torch.serving.fleet.supervisor import (
    InProcessReplica, ReplicaSupervisor, Routed,
)
from bigdl_tpu_torch.serving.fleet.worker import (
    WorkerHandle, WorkerRPCTimeout, WorkerReplica, spawn_worker_fleet,
)

__all__ = [
    "PrefixAffinityRouter", "RouteDecision", "NoLiveReplicas",
    "ReplicaSupervisor", "InProcessReplica", "Routed",
    "WorkerReplica", "WorkerHandle", "WorkerRPCTimeout",
    "spawn_worker_fleet",
    "FleetFrontDoor", "start_front_door",
    "run_fleet_comparison",
]
