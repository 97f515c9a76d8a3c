"""Tensor-parallel serving in the port: ``ContinuousBatchingEngine(mesh=)``
on a model-axis mesh of gloo ranks (the port of every case of
``tests/test_tp_serving.py`` and of the tensor-parallel cases of
``test_paged_kv.py``, ``test_quantized_serving.py``,
``test_tiered_prefix_cache.py`` and ``test_serving_preemption.py``).

The engine runs in one world of 4 ranks over gloo on the CPU
(``torch_world.World``), on a 4-way mesh where the JAX case has one and
on a 2-way mesh over ranks [0, 2) where it has that; the JAX model runs
in this process on the same weights. The contract: a mesh changes where
the math runs, never the tokens. Greedy rows equal the JAX lone
``generate`` (no tolerance) wherever the JAX case asserts it; sampled,
int8 and host-tier-with-paging rows equal the unsharded port engine's
on the same weights, served here in this process. The sharded int8
layers equal the unsharded ones exactly (one activation scale over the
whole input, integer sums), so the int8 rows are equal, not close.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_jobs_tp as jobs
from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.nn.quantized import Quantizer
from bigdl_tpu_torch.parallel.engine import Mesh
from bigdl_tpu_torch.serving import ContinuousBatchingEngine
from bigdl_tpu_torch.utils.weights import load_jax_params
from torch_world import World

N = 4
CFG = dict(vocab_size=32, embed_dim=32, num_heads=8, num_kv_heads=4,
           num_layers=2, max_len=48, use_rope=True)
#: ``tests/test_serving_preemption.py``'s model (its 2-way mesh)
CFG2 = dict(vocab_size=32, embed_dim=16, num_heads=4, num_kv_heads=2,
            num_layers=2, max_len=48, use_rope=True)


def _pair(cfg, seed):
    from bigdl_tpu.utils import random as rnd

    rnd.set_seed(seed)
    jm = JaxLM(**cfg)
    jm.evaluate()
    params = jax.tree.map(np.asarray, jm.params_dict())
    tm = TransformerLM(**cfg, device="cpu")
    load_jax_params(tm, params)
    tm.evaluate()
    return jm, tm, params


@pytest.fixture(scope="module")
def lms():
    return _pair(CFG, 23)


@pytest.fixture(scope="module")
def world():
    return World.shared(N)


def _direct(jm, prompt, n):
    return np.asarray(jm.generate(jnp.asarray(prompt)[None], n))[0]


def _leader(out):
    """The leader's result; the followers ran the same number of
    headers."""
    lead = out[0]
    assert lead["leader"]
    for o in out[1:]:
        if o is not None:
            assert not o["leader"] and o["headers"] == lead["headers"]
    return lead


def _unsharded(tm, reqs, draft=False, **kw):
    """The unsharded port engine's rows, served in turn."""
    if draft:
        d = Quantizer.quantize(tm)
        d.evaluate()
        kw["draft"] = d
    with ContinuousBatchingEngine(tm, **kw) as eng:
        return [eng.submit(p, k).result(timeout=60) for p, k in reqs]


def _mixed(seed, lens):
    r = np.random.RandomState(seed)
    return [(r.randint(0, 32, (t0,)), n) for t0, n in lens]


def _cycle_requests(rstate, templates, rounds, tail=2, decode=4):
    """Round-robin template traffic (``test_tiered_prefix_cache.py``'s):
    with a 1-row device pool every revisit demotes and promotes."""
    reqs = []
    for i in range(rounds * len(templates)):
        tpl = templates[i % len(templates)]
        reqs.append((np.concatenate(
            [tpl, rstate.randint(0, 32, (tail + i % 2,))]),
            decode + i % 3))
    return reqs


# ------------------------------------------------- tests/test_tp_serving
def test_sharded_parity_concurrent_mixed_load(world, lms):
    """Five mixed-length requests from five threads through two slots of
    the 4-way sharded engine: mid-flight admission recycles slots, and
    every reply equals the JAX lone ``generate``."""
    jm, _, params = lms
    reqs = _mixed(0, [(5, 6), (9, 4), (3, 8), (12, 5), (7, 7)])
    out = _leader(world.run(jobs.serve, CFG, params, reqs, N,
                            concurrent=True, max_slots=2, prefill_chunk=4,
                            service_name="tp_parity"))
    assert not out["errs"], out["errs"]
    for (p, n), row in zip(reqs, out["rows"]):
        np.testing.assert_array_equal(row, _direct(jm, p, n))


def test_prefix_hit_parity_and_pool_bytes(world, lms):
    """Template traffic: warm admissions reuse the heads-sharded prefix
    pool and stay token-identical; the pool's bytes split evenly over the
    4 shards."""
    jm, _, params = lms
    r = np.random.RandomState(1)
    tpl = r.randint(0, 32, (12,)).astype(np.int32)
    reqs = [(np.concatenate([tpl, r.randint(0, 32, (3,))]), 6)]
    reqs += [(np.concatenate([tpl, r.randint(0, 32, (2,))]), 5)
             for _ in range(3)]
    out = _leader(world.run(jobs.serve, CFG, params, reqs, N, warm=1,
                            max_slots=2, prefill_chunk=4, prefill_rows=2,
                            service_name="tp_prefix"))
    for (p, n), row in zip(reqs, out["rows"]):
        np.testing.assert_array_equal(row, _direct(jm, p, n))
    pc = out["stats"]["prefix_cache"]
    assert pc["hits"] >= 1, pc
    assert pc["devices"] == N
    assert pc["bytes_per_device"] * N == pc["bytes"] > 0


def test_speculative_parity_on_mesh(world, lms):
    """The int8-clone draft shards beside the target; proposals flow and
    are accepted, and greedy rows still equal the JAX lone ``generate``,
    cold and warm."""
    jm, _, params = lms
    reqs = _mixed(2, [(6, 8), (9, 6), (4, 7)])
    out = _leader(world.run(jobs.serve, CFG, params, reqs + reqs, N,
                            draft=True, max_slots=2, prefill_chunk=4,
                            spec_gamma=3, service_name="tp_spec"))
    for (p, n), row in zip(reqs + reqs, out["rows"]):
        np.testing.assert_array_equal(row, _direct(jm, p, n))
    sp = out["stats"]["speculation"]
    assert sp["proposed_tokens"] > 0 and sp["accepted_tokens"] > 0


def test_mesh_stats_and_pool_attribution(world, lms):
    """``stats()["mesh"]``: the topology and each pool's logical,
    physical and per-device bytes; the heads-sharded KV pools split
    evenly, the params (replicated LayerNorms and biases) hold more than
    their logical size over the mesh."""
    _, _, params = lms
    out = world.run(jobs.serve, CFG, params, [], N, stats_only=True,
                    max_slots=2, prefill_chunk=4, service_name="tp_stats")
    ms = out[0]["stats"]["mesh"]
    assert ms["enabled"] and ms["devices"] == N
    assert ms["axes"] == {"model": N}
    assert ms["model_axis"] == "model" and ms["model_shards"] == N
    assert ms["transport"] == "gloo"
    kv = ms["pools"]["kv_slots"]
    assert kv["sharded"]
    assert kv["physical_bytes"] == kv["logical_bytes"]
    assert kv["bytes_per_device"] * N == kv["physical_bytes"]
    par = ms["pools"]["params"]
    assert par["physical_bytes"] > par["logical_bytes"]
    assert all(o is None or not o["leader"] for o in out[1:])


def test_device_seconds_scale_by_mesh_and_conserve(world, lms):
    """One dispatch occupies every rank of the mesh: the ledger bills
    wall x 4 on both sides, and the tenants' device-seconds still sum to
    the busy total."""
    _, _, params = lms
    r = np.random.RandomState(3)
    reqs = [(r.randint(0, 32, (6,)), 5) for _ in range(3)]
    out = _leader(world.run(jobs.serve, CFG, params, reqs, N,
                            tenants=["a", "b", "a"], max_slots=2,
                            prefill_chunk=4, service_name="tp_usage"))
    usage = out["stats"]["usage"]
    assert usage["devices"] == N
    total_busy = out["busy"]["total"]
    assert total_busy > 0
    tenant_sum = sum(a["device_s"] for a in usage["tenants"].values())
    assert tenant_sum == pytest.approx(total_busy, rel=1e-6, abs=1e-9)


def test_kv_head_divisibility_guard():
    """KV heads that do not divide the model axis are refused before any
    message (the JAX text), for the target and for the draft."""
    mesh4 = Mesh([("model", 4)], ranks=[0, 1, 2, 3])
    bad = TransformerLM(32, embed_dim=16, num_heads=4, num_kv_heads=2,
                        num_layers=1, max_len=32, use_rope=True,
                        device="cpu")
    good = TransformerLM(**CFG, device="cpu")
    with pytest.raises(ValueError, match="num_kv_heads"):
        ContinuousBatchingEngine(bad, mesh=mesh4, service_name="tp_guard")
    with pytest.raises(ValueError, match="draft model cannot shard"):
        ContinuousBatchingEngine(good, mesh=mesh4, draft=bad)


def test_run_tp_comparison_smoke(world, lms):
    """The harness behind the sharded-vs-unsharded row: one tiny Poisson
    workload on a 2-way mesh and on the leader alone, token parity, the
    JAX row's keys, the transport; the perf-gate reader finds the
    sharded block."""
    import importlib.util
    import os

    _, _, params = lms
    out = world.run(jobs.tp_comparison, CFG, params, 2, n_requests=4,
                    rate_hz=50.0, max_slots=2, prefill_chunk=4,
                    prefill_rows=2, seed=11)
    assert out[1:] == [None] * (N - 1)
    res = out[0]
    assert res["token_parity"] is True
    assert res["workload"]["kind"] == "tensor_parallel"
    assert res["workload"]["tp"] == 2
    assert res["sharded"]["mesh"]["model_shards"] == 2
    assert res["sharded"]["ttft"]["p99"] is not None
    assert res["sharded"]["inter_token"]["p99"] is not None
    assert res["unsharded"]["mesh"]["enabled"] is False
    assert res["collectives"]["transport"] == "gloo"
    assert res["collectives"]["leader_messages"]["all_reduce"] > 0
    spec = importlib.util.spec_from_file_location(
        "perf_gate", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "scripts", "perf_gate.py"))
    pg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pg)
    row = {"metric": "serving_tp_tokens_per_sec",
           "detail": {"sharded": res["sharded"]}}
    assert pg.ttft_p99(row) == res["sharded"]["ttft"]["p99"]
    assert pg.inter_token_p99(row) == res["sharded"]["inter_token"]["p99"]


# ------------------------------------------ the other files' TP cases
def test_paged_parity_tensor_parallel(world, lms):
    """``test_paged_kv.py``: the paged engine on the 4-way mesh (one page
    pool split on heads) under concurrent mixed load equals the JAX lone
    ``generate``."""
    jm, _, params = lms
    reqs = _mixed(5, [(5, 6), (9, 4), (3, 9), (13, 5), (7, 7), (4, 11)])
    warm = [(reqs[0][0], 2)]
    out = _leader(world.run(jobs.serve, CFG, params, warm + reqs, N,
                            max_slots=2, prefill_chunk=4, page_size=4,
                            prefix_cache_rows=0, service_name="paged_tp"))
    for (p, n), row in zip(reqs, out["rows"][1:]):
        np.testing.assert_array_equal(row, _direct(jm, p, n))
    assert out["stats"]["paging"]["pool"]["pages_in_use"] >= 0


def test_tp_quantized_parity_on_mesh(world, lms):
    """``test_quantized_serving.py``: int8 KV (codes and scales split on
    the head axis) on the 4-way mesh equals the unsharded int8 engine."""
    _, tm, params = lms
    reqs = _mixed(43, [(6, 6), (9, 4), (4, 7)])
    out = _leader(world.run(jobs.serve, CFG, params, reqs, N,
                            max_slots=2, prefill_chunk=4, kv_dtype="int8",
                            service_name="q_tp"))
    want = _unsharded(tm, reqs, max_slots=2, prefill_chunk=4,
                      kv_dtype="int8")
    for a, b in zip(out["rows"], want):
        np.testing.assert_array_equal(a, b)


def test_int8_weights_parity_on_mesh(world, lms):
    """int8 weights, quantized from the full weights and then sharded,
    with int8 KV, dense and paged: the rows equal the unsharded int8
    engine's (the row-parallel layers quantize with one scale)."""
    _, tm, params = lms
    reqs = _mixed(44, [(6, 6), (9, 4), (4, 7)])
    for extra in ({}, {"page_size": 4, "prefix_cache_rows": 0}):
        kw = dict(max_slots=2, prefill_chunk=4, kv_dtype="int8",
                  weights_dtype="int8", **extra)
        out = _leader(world.run(jobs.serve, CFG, params, reqs, N, **kw))
        want = _unsharded(tm, reqs, **kw)
        for a, b in zip(out["rows"], want):
            np.testing.assert_array_equal(a, b)


def test_tp_demote_promote_parity_on_mesh(world, lms):
    """``test_tiered_prefix_cache.py``: under the 4-way mesh a demotion
    gathers the row's heads onto the leader and a promotion scatters them
    back; the cycle stays token-identical to the JAX lone
    ``generate``."""
    jm, _, params = lms
    r = np.random.RandomState(36)
    tpls = [r.randint(0, 32, (8,)) for _ in range(3)]
    reqs = _cycle_requests(r, tpls, rounds=2)
    out = _leader(world.run(jobs.serve, CFG, params, reqs, N,
                            max_slots=2, prefill_chunk=4,
                            prefix_cache_rows=1, prefix_host_rows=8,
                            service_name="tp_tiered"))
    for (p, n), row in zip(reqs, out["rows"]):
        np.testing.assert_array_equal(row, _direct(jm, p, n))
    pc = out["stats"]["prefix_cache"]
    assert pc["demotions"] >= 1 and pc["promotions"] >= 1, pc


def test_paged_host_tier_parity_on_mesh(world, lms):
    """The paged host tier on the 4-way mesh: spilled pages gathered to
    the leader, promoted pages scattered back; rows equal the unsharded
    paged host-tier engine's."""
    _, tm, params = lms
    r = np.random.RandomState(41)
    tpls = [r.randint(0, 32, (8,)) for _ in range(3)]
    reqs = _cycle_requests(r, tpls, rounds=2)
    kw = dict(max_slots=2, prefill_chunk=4, page_size=4, max_pages=14,
              prefix_cache_rows=4, prefix_host_rows=4)
    out = _leader(world.run(jobs.serve, CFG, params, reqs, N, **kw))
    want = _unsharded(tm, reqs, **kw)
    for a, b in zip(out["rows"], want):
        np.testing.assert_array_equal(a, b)
    pc = out["stats"]["prefix_cache"]
    assert pc["demotions"] >= 1 and pc["promotions"] >= 1, pc


def test_preempted_resume_token_identical_tensor_parallel(world):
    """``test_serving_preemption.py`` on a 2-way mesh: the high request
    preempts the low decode, the victim resumes from its donated KV, and
    both rows equal the JAX lone ``generate``."""
    jm, _, params = _pair(CFG2, 21)
    victim = np.asarray([7, 3, 1, 4, 1, 5], np.int32)
    urgent = np.asarray([2, 6, 2, 6], np.int32)
    out = world.run(jobs.preempt_round, CFG2, params, 2, victim, urgent)
    assert out[2:] == [None, None]
    lead = out[0]
    np.testing.assert_array_equal(lead["high"], _direct(jm, urgent, 4))
    np.testing.assert_array_equal(lead["low"], _direct(jm, victim, 40))
    assert lead["preempted"][0] >= 1 and lead["preempted"][1] == 0
    assert lead["qos_preempted"] == lead["preempted"][0]
    assert lead["finished"] == 4


def test_engine_on_a_2d_mesh(world, lms):
    """The engine over a (data 2, model 2) mesh of the 4 ranks with the
    2-D rules (each weight also split over the data axis): the data
    axis's ranks repeat their model group's work, a promoted host row
    reaches every group, and the rows equal the JAX lone
    ``generate``."""
    jm, _, params = lms
    r = np.random.RandomState(38)
    tpls = [r.randint(0, 32, (8,)) for _ in range(3)]
    reqs = _cycle_requests(r, tpls, rounds=2)
    out = _leader(world.run(jobs.serve, CFG, params, reqs, "2d",
                            max_slots=2, prefill_chunk=4,
                            prefix_cache_rows=1, prefix_host_rows=8))
    for (p, n), row in zip(reqs, out["rows"]):
        np.testing.assert_array_equal(row, _direct(jm, p, n))
    ms = out["stats"]["mesh"]
    assert ms["axes"] == {"data": 2, "model": 2}
    assert ms["devices"] == 4 and ms["model_shards"] == 2
    pc = out["stats"]["prefix_cache"]
    assert pc["demotions"] >= 1 and pc["promotions"] >= 1, pc


def test_leader_fault_and_stop_release_the_followers(world, lms):
    """A dispatch fault on the leader (chaos, raised before its header)
    crashes its loop and the followers leave theirs, flagged; a
    ``stop(drain=False)`` with a request in flight does the same without
    a crash. Nothing is stranded: the next job runs."""
    _, _, params = lms
    out = world.run(jobs.fault_and_abandon, CFG, params, N,
                    np.arange(6) % 32)
    assert out[0]["fault"] == "stopped" and out[0]["abandon"] == "stopped"
    assert all(o["crashed"] for o in out)
    assert len({o["headers"] for o in out}) == 1
    assert world.run(jobs.fetch_put_round_trip, N)[0]["index"]


@pytest.mark.parametrize("spec", [False, True])
def test_sampled_rows_equal_the_unsharded_engine(world, lms, spec):
    """Sampling stays on the leader (its generator, the gathered logits;
    a sampled draft proposal is broadcast): a sampled run on the mesh
    equals the unsharded engine's under the same seed, with a draft or
    without."""
    _, tm, params = lms
    reqs = _mixed(6, [(5, 6), (8, 5), (3, 7)])
    kw = dict(max_slots=2, prefill_chunk=4, temperature=0.8, seed=5)
    if spec:
        kw["spec_gamma"] = 3
    out = _leader(world.run(jobs.serve, CFG, params, reqs, N, draft=spec,
                            **kw))
    want = _unsharded(tm, reqs, draft=spec, **kw)
    for a, b in zip(out["rows"], want):
        np.testing.assert_array_equal(a, b)


def test_observability_is_the_leaders_alone(world, lms):
    """On a tp-2 world with every observability hook on, instruments,
    recorder, memory pools, sampler and detectors are the leader's: its
    registry holds the serving series and counts the requests, while
    each follower's process registry holds no serving series, its
    recorder no event, its pool table no engine pool and its sampler no
    point; the followers ran the leader's headers, no more, no fewer
    (no hang, no reordering), and the rows equal the unsharded
    engine's."""
    _, tm, params = lms
    reqs = _mixed(31, [(5, 4), (7, 3), (4, 5)])
    res = world.run(jobs.serve_observed, CFG, params, reqs, 2)
    out = _leader(res)
    assert any(n.startswith("bdt_serving_") for n in out["names"])
    assert out["admitted"] == out["stats"]["admitted"] == len(reqs)
    assert out["stats"]["finished"] == len(reqs)
    assert out["pools"] and out["events"] > 0 and out["sampler_ran"]
    assert out["stats"]["incidents"]["count"] == 0
    for got, want in zip(out["rows"],
                         _unsharded(tm, reqs, max_slots=2,
                                    prefill_chunk=4)):
        np.testing.assert_array_equal(got, want)
    for f in res[1:]:
        if f is None:
            continue
        assert not f["leader"]
        assert not any(n.startswith("bdt_serving_") for n in f["names"])
        assert f["events"] == 0 and f["pools"] == []
        assert not f["sampler_ran"]
