"""The port's fleet A/B (bigdl_tpu_torch/serving/fleet/benchmark.py).

The workload selection is host-only and held to the JAX package's: for
the same arguments the port picks the same seed, the same prompts and
the same template ownership as the seed search inside JAX's
``run_fleet_comparison``, and raises where no seed balances the ring.
The mismatch listing is checked on hand-made rows. One run of
``run_fleet_comparison`` spawns its CPU workers (three legs of two, the
drain drill included, through the front door): every row of every leg
equals the single-replica reference replay, nothing is lost, and each
worker reports its start-up, clock, control round trip and its own
count of flash launches (0: engines launch none)."""

from collections import Counter

import numpy as np
import pytest

from bigdl_tpu.serving.benchmark import (
    shared_prefix_workload as jshared_prefix_workload,
)
from bigdl_tpu.serving.fleet import router as jrouter
from bigdl_tpu_torch.serving.fleet import run_fleet_comparison
from bigdl_tpu_torch.serving.fleet.benchmark import (
    _MODEL, _mismatches, fleet_workload,
)


def _jax_search(n_replicas, n_requests, rate_hz, chunk, n_templates,
                template_len, seed):
    """The seed search of the JAX package's ``run_fleet_comparison``."""
    probe = jrouter.PrefixAffinityRouter(
        [f"r{i}" for i in range(n_replicas)], chunk=chunk)
    for wl_seed in range(seed, seed + 64):
        workload = jshared_prefix_workload(
            n_requests, rate_hz, _MODEL["vocab_size"],
            n_templates=n_templates, template_len=template_len,
            tail_lens=(2, 6), decode_lens=(4, 10), seed=wl_seed,
            template_order="random")
        keys = {probe.key_for(req["prompt"]) for req in workload}
        owned = Counter(probe.owner(k) for k in keys)
        if (len(owned) == n_replicas
                and max(owned.values()) - min(owned.values()) <= 1):
            return workload, wl_seed, dict(owned)
    raise RuntimeError("no balanced seed")


@pytest.mark.parametrize("n_replicas,n_templates,chunk,seed", [
    (2, 4, 8, 0), (3, 6, 8, 5), (4, 8, 16, 11), (2, 2, 8, 3)])
def test_fleet_workload_matches_jax_seed_search(n_replicas, n_templates,
                                                chunk, seed):
    want, want_seed, want_owned = _jax_search(
        n_replicas, 36, 30.0, chunk, n_templates, 48, seed)
    got = fleet_workload(n_replicas, 36, 30.0, _MODEL["vocab_size"],
                         chunk, n_templates=n_templates, template_len=48,
                         seed=seed)
    assert got["seed"] == want_seed
    assert got["owned"] == want_owned
    assert got["prefix_rows"] == max(want_owned.values()) + 1
    assert len(got["workload"]) == len(want)
    for a, b in zip(got["workload"], want):
        np.testing.assert_array_equal(a["prompt"], b["prompt"])
        assert (a["n"], a["arrival_s"], a["tenant"]) == \
            (b["n"], b["arrival_s"], b["tenant"])


def test_fleet_workload_raises_without_a_balanced_seed():
    # one template can never cover two replicas
    with pytest.raises(RuntimeError, match="no balanced"):
        fleet_workload(2, 12, 30.0, _MODEL["vocab_size"], 8,
                       n_templates=1, template_len=48)
    with pytest.raises(RuntimeError):
        _jax_search(2, 12, 30.0, 8, 1, 48, 0)


def test_mismatches_name_the_first_difference():
    wl = [{"prompt": np.array([5, 6])}, {"prompt": np.array([7])},
          {"prompt": np.array([8])}, {"prompt": np.array([9])}]
    oracle = {id(wl[0]): [1, 2, 3], id(wl[1]): [4, 5],
              id(wl[2]): [6, 7], id(wl[3]): [1]}
    rows = {id(wl[0]): [1, 2, 3],        # equal
            id(wl[1]): [4, 9],           # parts at 1
            id(wl[2]): [6]}              # short; wl[3] lost
    got = _mismatches(wl, rows, oracle, "affinity")
    assert got == [
        {"request": 1, "leg": "affinity", "position": 1,
         "prefix": [7, 4], "reference_token": 5, "fleet_token": 9},
        {"request": 2, "leg": "affinity", "position": 1,
         "prefix": [8, 6], "reference_token": 7, "fleet_token": None},
        {"request": 3, "leg": "affinity", "position": 0,
         "prefix": [9], "reference_token": 1, "fleet_token": None}]
    assert _mismatches(wl[:1], rows, oracle, "x") == []


def test_run_fleet_comparison_through_the_door_on_cpu_workers():
    res = run_fleet_comparison(
        n_replicas=2, n_requests=8, rate_hz=30.0, device="cpu",
        env={"OMP_NUM_THREADS": "1"}, front_door=True, log=lambda *a: None)
    assert res["token_parity"] is True and res["mismatches"] == []
    assert res["rows_equal_between_legs"] == 8
    drain = res["drain"]
    assert drain["lost"] == 0 and drain["token_parity"], drain
    assert drain["drained"] == "r0" and drain["completed"] == 8
    wl = res["workload"]
    assert wl["front_door"] is True and wl["model"] == _MODEL
    assert wl["prefix_rows_per_replica"] == max(wl["owned"].values()) + 1
    for leg in ("affinity", "round_robin"):
        blk = res[leg]
        f = blk["fleet"]
        assert blk["requests"] == 8
        assert blk["ttft"]["p50"] > 0 and blk["inter_token"]["p50"] > 0
        assert set(blk["hops"]) == {"route", "rpc_submit", "queue",
                                    "prefill", "first_token", "decode",
                                    "stream"}
        assert f["flash_launches"] == {"r0": 0, "r1": 0}
        assert all(v > 0 for v in f["control_ms"].values())
        assert all(c["rtt_s"] > 0 for c in f["clock"].values())
        assert all(s > 0 for s in f["startup_s"].values())
        assert sum(f["per_replica_finished"].values()) == 8 + 2  # + warm
    # the ring places every request (a saturated owner may spill one)
    assert sum(res["affinity"]["fleet"]["routing"]["decisions"].values()) \
        == 8
    # round-robin sprays the storm evenly (+ each replica's warm-up)
    assert res["round_robin"]["fleet"]["per_replica_finished"] == \
        {"r0": 5, "r1": 5}
