"""The port's PrefixAffinityRouter (bigdl_tpu_torch/serving/fleet/router.py)
case for case with tests/test_fleet_router.py, and against the JAX
package's router on the same inputs.

Pure host-side: every case builds the port's router and the JAX one with
the same arguments, feeds both the same prompts, load maps, joins,
leaves and drains, and holds every decision, owner, ``ownership()`` and
``snapshot()`` of the port equal to JAX's (the ring hash is the same
SHA-1, so both packages route a prompt to the same replica), besides
the JAX file's own assertions. The JAX file's two ``perf_gate`` cases
wait for the benchmark (ROADMAP.md, Queue 1 item 11)."""

import json

import numpy as np
import pytest

from bigdl_tpu.serving.fleet import router as jrouter
from bigdl_tpu_torch.serving.fleet import (
    NoLiveReplicas, PrefixAffinityRouter,
)


def _pair(*args, **kw):
    """The port's router and the JAX one, built alike."""
    return (PrefixAffinityRouter(*args, **kw),
            jrouter.PrefixAffinityRouter(*args, **kw))


def _owners(router, keys):
    return {k: router.owner(k) for k in keys}


def _probe_keys(n=2000):
    # evenly spaced probes over the 64-bit key space: deterministic,
    # and dense enough that arc-share estimates are stable
    span = 1 << 64
    return [i * span // n for i in range(n)]


def _same(ours, theirs, keys=None):
    """Both routers agree on membership, drains, owners and tallies."""
    assert ours.snapshot() == theirs.snapshot()
    if keys is not None:
        assert _owners(ours, keys) == _owners(theirs, keys)


def _route_both(pair, prompt, loads):
    d, jd = (r.route(prompt, loads) for r in pair)
    assert tuple(d) == tuple(jd)
    return d


def test_key_is_first_chunk_only_and_process_stable():
    r, jr = _pair(["a", "b"], chunk=4)
    head = [7, 1, 3, 9]
    assert r.key_for(head + [5, 6]) == r.key_for(head + [8, 8, 8])
    assert r.key_for(head) == r.key_for(np.asarray(head, np.int32))
    assert r.key_for([7, 1, 3, 8]) != r.key_for(head)
    # sha1-derived, not hash(): stable across processes and seeds
    assert r.key_for(head) == PrefixAffinityRouter(
        ["x"], chunk=4).key_for(head)
    # and across the packages: the same key for the same head
    for p in (head, head + [5, 6], [7, 1, 3, 8], [1], list(range(40))):
        assert r.key_for(p) == jr.key_for(p)
        assert r.key_for(np.asarray(p, np.int64)) == jr.key_for(p)


def test_join_moves_about_one_over_n_keys():
    keys = _probe_keys()
    pair = _pair(["r0", "r1", "r2"], chunk=8)
    r = pair[0]
    before = _owners(r, keys)
    for x in pair:
        x.add_replica("r3")
    after = _owners(r, keys)
    moved = sum(before[k] != after[k] for k in keys) / len(keys)
    # the new replica should take ~1/4 of the keyspace — and every
    # moved key must have moved TO it (consistent hashing's whole point)
    assert 0.10 < moved < 0.45
    assert all(after[k] == "r3" for k in keys if before[k] != after[k])
    _same(*pair, keys)


def test_leave_restores_exact_prior_mapping():
    keys = _probe_keys()
    pair = _pair(["r0", "r1", "r2"], chunk=8)
    before = _owners(pair[0], keys)
    for x in pair:
        x.add_replica("r3")
        x.remove_replica("r3")
    assert _owners(pair[0], keys) == before
    _same(*pair, keys)


def test_ownership_fractions_cover_the_keyspace():
    r, jr = _pair(["r0", "r1", "r2"], chunk=8)
    own = r.ownership(sample=1024)
    assert set(own) == {"r0", "r1", "r2"}
    assert abs(sum(own.values()) - 1.0) < 1e-6
    assert all(v > 0.05 for v in own.values())
    assert own == jr.ownership(sample=1024)
    assert r.ownership() == jr.ownership()


def test_affinity_under_light_load():
    pair = _pair(["r0", "r1"], chunk=4, saturation=8.0)
    r = pair[0]
    p = [1, 2, 3, 4]
    target = r.owner(r.key_for(p))
    d = _route_both(pair, p, {"r0": 1.0, "r1": 1.0})
    assert d.replica == d.target == target
    assert d.route == "affinity" and not d.forced
    _same(*pair)


def test_saturation_spills_to_least_loaded():
    pair = _pair(["r0", "r1", "r2"], chunk=4, saturation=4.0)
    r = pair[0]
    p = [9, 9, 9, 9]
    target = r.owner(r.key_for(p))
    others = [x for x in ("r0", "r1", "r2") if x != target]
    loads = {target: 4.0, others[0]: 1.0, others[1]: 3.0}
    d = _route_both(pair, p, loads)
    assert d.route == "spilled" and not d.forced
    assert d.replica == others[0]          # the least-loaded
    assert d.target == target              # forensics keep the owner
    _same(*pair)


def test_forced_spill_bounds_an_affinity_streak():
    pair = _pair(["r0", "r1"], chunk=4, saturation=100.0, spill_window=3)
    r = pair[0]
    p = [5, 5, 5, 5]
    target = r.owner(r.key_for(p))
    other = "r1" if target == "r0" else "r0"
    loads = {target: 2.0, other: 0.0}      # other strictly less loaded
    routes = [_route_both(pair, p, loads) for _ in range(4)]
    assert [d.route for d in routes[:3]] == ["affinity"] * 3
    assert routes[3].route == "spilled" and routes[3].forced
    assert routes[3].replica == other
    # the spill reset the streak: affinity wins again
    assert _route_both(pair, p, loads).route == "affinity"
    snap = r.snapshot()
    assert snap["decisions"] == {"affinity": 4, "spilled": 1,
                                 "forced": 1}
    _same(*pair)


def test_forced_spill_needs_a_strictly_less_loaded_peer():
    pair = _pair(["r0", "r1"], chunk=4, saturation=100.0, spill_window=2)
    r = pair[0]
    p = [5, 5, 5, 5]
    target = r.owner(r.key_for(p))
    other = "r1" if target == "r0" else "r0"
    loads = {target: 1.0, other: 1.0}      # equal: no one to relieve
    assert all(_route_both(pair, p, loads).route == "affinity"
               for _ in range(6))
    _same(*pair)


def test_spill_window_zero_disables_the_bound():
    pair = _pair(["r0", "r1"], chunk=4, saturation=100.0, spill_window=0)
    r = pair[0]
    p = [5, 5, 5, 5]
    target = r.owner(r.key_for(p))
    other = "r1" if target == "r0" else "r0"
    loads = {target: 2.0, other: 0.0}
    assert all(_route_both(pair, p, loads).route == "affinity"
               for _ in range(20))
    _same(*pair)


def test_drain_walks_to_next_live_owner_and_rejoin_restores():
    keys = _probe_keys()
    pair = _pair(["r0", "r1", "r2"], chunk=8)
    r = pair[0]
    before = _owners(r, keys)
    for x in pair:
        x.mark_draining("r1")
    during = _owners(r, keys)
    assert "r1" not in set(during.values())
    _same(*pair, keys)
    # keys r1 didn't own never move during its drain
    assert all(during[k] == before[k] for k in keys
               if before[k] != "r1")
    for x in pair:
        x.mark_live("r1")
    assert _owners(r, keys) == before
    # routing a draining replica's key lands on the walked-to owner
    for x in pair:
        x.mark_draining("r1")
    p = next(k for k in keys if before[k] == "r1")
    assert r.owner(p) == during[p]
    _same(*pair, keys)


def test_no_live_replicas_raises():
    r, jr = _pair(["r0"], chunk=4)
    r.mark_draining("r0")
    jr.mark_draining("r0")
    with pytest.raises(NoLiveReplicas):
        r.owner(123)
    with pytest.raises(jrouter.NoLiveReplicas):
        jr.owner(123)
    with pytest.raises(NoLiveReplicas):
        PrefixAffinityRouter([], chunk=4).owner(123)
    with pytest.raises(NoLiveReplicas):
        r.route([1, 2, 3], {})


def test_snapshot_is_json_clean():
    pair = _pair(["r0", "r1"], chunk=4)
    for x in pair:
        x.route([1, 2, 3, 4], {"r0": 0.0, "r1": 0.0})
        x.mark_draining("r1")
    snap = json.loads(json.dumps(pair[0].snapshot()))
    assert snap["replicas"] == ["r0", "r1"]
    assert snap["draining"] == ["r1"]
    assert snap["chunk"] == 4 and snap["vnodes"] == 64
    assert set(snap["per_replica"]) <= {"r0", "r1"}
    assert snap == json.loads(json.dumps(pair[1].snapshot()))


def test_validation():
    for kw in ({"chunk": 0}, {"vnodes": 0}):
        with pytest.raises(ValueError):
            PrefixAffinityRouter(**kw)
        with pytest.raises(ValueError):
            jrouter.PrefixAffinityRouter(**kw)


def test_random_route_sequence_equals_jax():
    """A seeded stream of prompts, load maps, joins, leaves and drains
    through both routers: every decision and the final table equal."""
    rs = np.random.RandomState(11)
    pair = _pair(["r0", "r1", "r2"], chunk=4, saturation=6.0,
                 spill_window=3)
    pool = [rs.randint(0, 64, (rs.randint(1, 12),)).tolist()
            for _ in range(12)]
    for step in range(300):
        live = pair[0].live_replicas()
        op = rs.randint(0, 20)
        if op == 0 and "r3" not in pair[0].replicas:
            for x in pair:
                x.add_replica("r3")
        elif op == 1 and "r3" in pair[0].replicas:
            for x in pair:
                x.remove_replica("r3")
        elif op == 2 and len(live) > 1:
            rid = live[rs.randint(0, len(live))]
            for x in pair:
                x.mark_draining(rid)
        elif op == 3 and pair[0].draining:
            rid = pair[0].draining[0]
            for x in pair:
                x.mark_live(rid)
        loads = {rid: float(rs.randint(0, 9))
                 for rid in pair[0].replicas if rs.rand() < 0.8}
        _route_both(pair, pool[rs.randint(0, len(pool))], loads)
    _same(*pair, _probe_keys(500))
