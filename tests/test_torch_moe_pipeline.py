"""Pipeline stages and mixture-of-experts held against the JAX package
(the counterparts of the 18 tests of ``tests/test_pipeline_moe.py``,
plus the MoE LM under sequence and expert parallelism).

Layers that run in one process (routing, ``MoEMLP``, the MoE
TransformerLM) compare with the JAX modules on the same weights
(``load_jax_params``); the pipeline and ``moe_spmd`` run in a world of 4
ranks over gloo against JAX's ``shard_map`` or its sequential
reference. The JAX pipeline tests take 8 stages on the conftest's 8
devices; this world has 4 ranks, so the 8-stage case is a 4-stage run
of one microbatch (all bubble but one tick). Tolerances: rtol 2e-5 /
atol 1e-6 on the pipeline (JAX's), rtol 2e-4 / atol 2e-5 on MoE (JAX's).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torch_jobs_moe as jobs
from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.nn.module import pure_apply
from bigdl_tpu.parallel import moe as jmoe
from bigdl_tpu.parallel.pipeline import pipeline_spmd as jax_pipeline
from bigdl_tpu.parallel.pipeline import stack_stage_params as jax_stack
from bigdl_tpu.utils import random as jrandom
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.parallel import moe as tmoe
from bigdl_tpu_torch.parallel.pipeline import stack_stage_params
from bigdl_tpu_torch.utils.weights import load_jax_params
from torch_world import World

MOE_TOL = dict(rtol=2e-4, atol=2e-5)
PIPE_TOL = dict(rtol=2e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """This file's port-side work is many tiny ops: one intra-op thread
    keeps it from contending with the test workers and the world's
    ranks (restored after the file)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    w = World.shared(4)
    w.run(jobs.quiet)
    return w


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------- pipeline
def _mk_stages(s, d, key):
    stages = []
    for _ in range(s):
        key, k1, k2 = jax.random.split(key, 3)
        stages.append({"w": 0.3 * jax.random.normal(k1, (d, d)),
                       "b": 0.01 * jax.random.normal(k2, (d,))})
    return stages


def _stage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _sequential(stages, x):
    h = x
    for p in stages:
        h = _stage_fn(p, h)
    return h


@pytest.mark.parametrize("s,m", [(4, 8), (4, 1), (2, 4)])
def test_pipeline_forward_matches_sequential(world, s, m):
    key = jax.random.PRNGKey(0)
    stages = _mk_stages(s, 16, key)
    x = jax.random.normal(key, (16, 16))
    want = np.asarray(_sequential(stages, x))
    res = world.run(jobs.pipeline_run, _np(jax_stack(stages)), np.asarray(x),
                    s, m)
    for r in res[:s]:
        np.testing.assert_allclose(r["y"], want, **PIPE_TOL)
    assert all(r is None for r in res[s:])


def _pipeline_grads(world, remat, seed):
    s, m = 4, 4
    key = jax.random.PRNGKey(seed)
    stages = _mk_stages(s, 8, key)
    x = jax.random.normal(key, (8, 8))

    def loss(plist, xx):
        return jnp.sum(_sequential(plist, xx) ** 2)

    g_seq, g_x = jax.grad(loss, argnums=(0, 1))(stages, x)
    res = world.run(jobs.pipeline_run, _np(jax_stack(stages)), np.asarray(x),
                    s, m, remat)
    for i, r in enumerate(res):
        for k in ("w", "b"):
            np.testing.assert_allclose(r["grads"][k], np.asarray(g_seq[i][k]),
                                       **PIPE_TOL)
    # the input's gradient reaches stage 0 only
    np.testing.assert_allclose(res[0]["dx"], np.asarray(g_x), **PIPE_TOL)


def test_pipeline_backward_matches_sequential(world):
    _pipeline_grads(world, remat=False, seed=1)


def test_pipeline_remat_backward_matches_sequential(world):
    _pipeline_grads(world, remat=True, seed=2)


def test_pipeline_matches_jax_shard_map_pipeline(world):
    """The port's schedule against JAX's ``pipeline_spmd`` itself, output
    and stage gradients."""
    s, m = 4, 4
    key = jax.random.PRNGKey(3)
    stages = _mk_stages(s, 8, key)
    stacked = jax_stack(stages)
    x = jax.random.normal(key, (8, 8))
    mesh = Mesh(np.array(jax.devices()[:s]), ("pipe",))
    fn = shard_map(lambda p, xx: jax_pipeline(_stage_fn, p, xx, "pipe", m),
                   mesh=mesh,
                   in_specs=(jax.tree.map(lambda _: P("pipe"), stacked), P()),
                   out_specs=P())
    y = np.asarray(jax.jit(fn)(stacked, x))
    g = jax.jit(jax.grad(lambda p, xx: jnp.sum(fn(p, xx) ** 2)))(stacked, x)
    res = world.run(jobs.pipeline_run, _np(stacked), np.asarray(x), s, m)
    for i, r in enumerate(res):
        np.testing.assert_allclose(r["y"], y, **PIPE_TOL)
        for k in ("w", "b"):
            np.testing.assert_allclose(r["grads"][k], np.asarray(g[k][i]),
                                       **PIPE_TOL)
    ours = stack_stage_params([{k: torch.tensor(np.asarray(v))
                                for k, v in st.items()} for st in stages])
    for k in ("w", "b"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(stacked[k]))


def test_pipeline_batch_not_divisible_raises(world):
    assert all("divisible" in msg for msg in
               world.run(jobs.pipeline_indivisible))


# --------------------------------------------------------------------- MoE
def _pair(d, h, e, **kw):
    """A JAX MoEMLP and the port's on its weights."""
    jrandom.set_seed(0)
    jm = jmoe.MoEMLP(d, h, e, **kw)
    tm = tmoe.MoEMLP(d, h, e, **kw, device="cpu")
    load_jax_params(tm, _np(jm.params_dict()))
    return jm, tm


def test_top1_dispatch_positions_and_capacity():
    gates = np.asarray([[0.9, 0.1], [0.8, 0.2], [0.7, 0.3], [0.2, 0.8]],
                       np.float32)
    dispatch, combine = tmoe._top1_dispatch(torch.tensor(gates), capacity=2)
    jd, jc = jmoe._top1_dispatch(jnp.asarray(gates), capacity=2)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
    np.testing.assert_allclose(combine.numpy(), np.asarray(jc), rtol=1e-6)
    assert float(dispatch[0, 0, 0]) == 1.0 and float(dispatch[1, 0, 1]) == 1.0
    assert float(dispatch[2].sum()) == 0.0
    assert float(dispatch[3, 1, 0]) == 1.0


def _per_token_ref(moe, x, k):
    gates = torch.softmax(x @ moe.gate_w, -1)
    ref = torch.zeros_like(x)
    for t in range(x.shape[0]):
        order = torch.argsort(-gates[t], stable=True)[:k]
        g = gates[t, order]
        w = g / g.sum() if k > 1 else g
        for e, we in zip(order.tolist(), w):
            h = torch.nn.functional.gelu(x[t] @ moe.w1[e] + moe.b1[e],
                                         approximate="tanh")
            ref[t] += (h @ moe.w2[e] + moe.b2[e]) * we
    return ref


@pytest.mark.parametrize("n_top", [1, 2])
def test_moe_matches_jax_and_per_token_reference(n_top):
    jm, tm = _pair(8, 16, 4, capacity_factor=4.0, n_top=n_top)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(2 + 3 * n_top),
                                     (12, 8)))
    want = np.asarray(jm(jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.tensor(x))
        ref = _per_token_ref(tm, torch.tensor(x), n_top)
    np.testing.assert_allclose(got.numpy(), want, **MOE_TOL)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **MOE_TOL)
    assert float(tm.l_aux) == pytest.approx(float(jm.l_aux), rel=1e-5)


def test_moe_aux_loss_balanced_vs_collapsed():
    jm, tm = _pair(4, 8, 2)
    with torch.no_grad():
        tm.gate_w.zero_()
    x = np.abs(np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                            (8, 4)))) + 0.1
    tm(torch.tensor(x))
    balanced = float(tm.l_aux)
    with torch.no_grad():
        tm.gate_w[:, 0] = 50.0
    tm(torch.tensor(x))
    collapsed = float(tm.l_aux)
    assert balanced == pytest.approx(1.0, abs=0.05)
    assert collapsed > 1.8


def test_moe_stats_report_drops_and_load():
    _, tm = _pair(4, 8, 4, capacity_factor=0.01)
    with torch.no_grad():
        tm.gate_w.zero_()
        tm.gate_w[:, 0] = 10.0
    x = np.abs(np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                            (16, 4)))) + 0.1
    tm(torch.tensor(x))
    stats = tm.last_stats
    assert float(stats["drop_rate"]) > 0.9
    np.testing.assert_allclose(stats["expert_fraction"].numpy(),
                               [1.0, 0, 0, 0], atol=1e-6)
    m = Metrics()
    tmoe.record_moe_metrics(m, stats)
    assert m.get("moe drop rate")[0] > 0.9
    assert m.get("moe max expert fraction")[0] == pytest.approx(1.0)


def test_top2_saturated_router_has_no_phantom_routes():
    t, e, cap = 6, 4, 8
    gates = np.zeros((t, e), np.float32)
    gates[:, 2] = 1.0
    dispatch, combine, stats = tmoe._topk_dispatch(torch.tensor(gates), cap,
                                                   k=2)
    jd, jc, jstats = jmoe._topk_dispatch(jnp.asarray(gates), cap, k=2)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
    np.testing.assert_allclose(combine.numpy(), np.asarray(jc), rtol=1e-6)
    d = dispatch.numpy()
    assert d[:, 0].sum() == 0 and d[:, 1].sum() == 0 and d[:, 3].sum() == 0
    assert d[:, 2].sum() == t
    assert stats["expert_fraction"][2].item() == pytest.approx(0.5)
    assert float(stats["drop_rate"]) == pytest.approx(0.5)
    assert float(jstats["drop_rate"]) == pytest.approx(0.5)


def test_topk_dispatch_ties_and_capacity_match_jax():
    """Tied gates go to the lower expert (torch.argmax's first maximum,
    as jnp.argmax); capacity drops and the stats equal JAX's."""
    rs = np.random.RandomState(7)
    gates = rs.choice([0.1, 0.2, 0.3], size=(40, 4)).astype(np.float32)
    for k, cap in ((1, 5), (2, 7), (2, 40)):
        ours = tmoe._topk_dispatch(torch.tensor(gates), cap, k)
        theirs = jmoe._topk_dispatch(jnp.asarray(gates), cap, k)
        for a, b in zip(ours[:2], theirs[:2]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        for key in ("drop_rate", "expert_fraction"):
            np.testing.assert_allclose(ours[2][key].numpy(),
                                       np.asarray(theirs[2][key]), rtol=1e-6)


@pytest.mark.parametrize("n_top", [1, 2])
def test_moe_spmd_matches_dense_and_jax(world, n_top):
    """Expert parallelism over 4 ranks (E = 8, 2 experts a rank; ample
    capacity: no drops either way) equals the dense MoE, and its
    gradients equal JAX's ``moe_spmd`` under ``shard_map``."""
    n, e, d, h, t = 4, 8, 8, 16, 32
    jm, _ = _pair(d, h, e, capacity_factor=float(e), n_top=n_top)
    x = jax.random.normal(jax.random.PRNGKey(3 + n_top), (t, d))
    dense = np.asarray(jm(x))
    mesh = Mesh(np.array(jax.devices()[:n]), ("expert",))
    params = jm.expert_params()

    def total(p, xx):
        def spmd(p, xx):
            gates = jax.nn.softmax(xx @ jm.gate_w, axis=-1)
            return jmoe.moe_spmd(p, xx, gates, "expert", jm.capacity_factor,
                                 n_top=n_top)
        out = shard_map(spmd, mesh=mesh,
                        in_specs=(jax.tree.map(lambda _: P("expert"), p),
                                  P("expert")),
                        out_specs=P("expert"))(p, xx)
        return jnp.sum(out ** 2), out

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
        total, argnums=(0, 1), has_aux=True))(params, x)
    res = world.run(jobs.moe_spmd_run, _np(params), np.asarray(x),
                    np.asarray(jm.gate_w), float(e), n_top)
    got = np.concatenate([r["out"] for r in res])
    np.testing.assert_allclose(got, dense, **MOE_TOL)
    np.testing.assert_allclose(got, np.asarray(out), **MOE_TOL)
    np.testing.assert_allclose(np.concatenate([r["dx"] for r in res]),
                               np.asarray(gx), **MOE_TOL)
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(
            np.concatenate([r["grads"][k] for r in res]), np.asarray(gp[k]),
            **MOE_TOL)
    for r in res:
        assert r["stats"]["drop_rate"] == pytest.approx(0.0, abs=1e-6)


def test_moe_spmd_rejects_indivisible_experts(world):
    assert all("not divisible" in m for m in
               world.run(jobs.moe_spmd_indivisible))


def _lm_pair(n_experts, remat, num_layers=2, **kw):
    jrandom.set_seed(0)
    jm = JaxLM(32, embed_dim=16, num_heads=2, num_layers=num_layers,
               max_len=8, n_experts=n_experts, remat=remat, **kw)
    tm = TransformerLM(32, embed_dim=16, num_heads=2, num_layers=num_layers,
                       max_len=8, n_experts=n_experts, remat=remat, **kw,
                       device="cpu")
    load_jax_params(tm, _np(jm.params_dict()))
    return jm, tm


@pytest.mark.parametrize("remat", [False, True])
def test_transformer_lm_with_moe_trains(remat):
    """The MoE LM's loss (with 0.01 l_aux) and every gradient equal JAX's;
    the router's gradient is not zero."""
    jm, tm = _lm_pair(4, remat)
    fn = pure_apply(jm)
    ids = np.arange(8)[None] % 32

    def loss(p):
        out, _ = fn(p, {}, jnp.asarray(ids), rng=jax.random.PRNGKey(0),
                    training=True)
        return jnp.sum(out ** 2) * 1e-3 + 0.01 * jm.l_aux

    g = jax.jit(jax.grad(loss))(jm.params_dict())
    out = tm(torch.tensor(ids))
    (torch.sum(out ** 2) * 1e-3 + 0.01 * tm.l_aux).backward()
    from bigdl_tpu_torch.utils.weights import jax_param_names

    for path, name in jax_param_names(tm):
        want = g
        for key in path.split("/"):
            want = want[key]
        got = dict(tm.named_parameters())[name].grad
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
        assert torch.isfinite(got).all()
    assert float(tm.block0.mlp.gate_w.grad.abs().sum()) > 0


@pytest.mark.parametrize("remat", [False, True])
def test_transformer_lm_exposes_moe_routing_stats(remat):
    jm, tm = _lm_pair(4, remat)
    ids = np.arange(8)[None] % 32
    jm(jnp.asarray(ids))
    tm(torch.tensor(ids))
    stats = tm.last_moe_stats
    assert 0.0 <= float(stats["drop_rate"]) <= 1.0
    frac = stats["expert_fraction"].detach().numpy()
    assert frac.shape == (4,) and frac.sum() == pytest.approx(1.0, abs=1e-5)
    np.testing.assert_allclose(frac, np.asarray(
        jm.last_moe_stats["expert_fraction"]), rtol=1e-6)
    assert float(tm.l_aux) == pytest.approx(float(jm.l_aux), rel=1e-5)


def test_dense_remat_model_clean_after_forward():
    _, tm = _lm_pair(0, True, num_layers=1)
    assert float(tm.l_aux) == 0.0
    out = tm(torch.arange(8)[None])
    out.sum().backward()
    tm.clone_module()
    pickle.dumps(float(tm.l_aux))
    assert tm.last_moe_stats is None


def test_moe_remat_model_saves_after_eager_forward(tmp_path):
    from bigdl_tpu_torch.utils import file as bt_file

    _, tm = _lm_pair(2, True, num_layers=1)
    ids = torch.arange(8)[None]
    out = tm(ids)
    assert np.isfinite(float(tm.l_aux))
    path = str(tmp_path / "tlm.bin")
    bt_file.save_module(tm, path, overwrite=True)
    m2 = bt_file.load_module(path, device="cpu")
    np.testing.assert_allclose(m2(ids).detach().numpy(),
                               out.detach().numpy(), rtol=1e-5, atol=1e-6)


def test_moe_aux_loss_balances_experts_in_training():
    """A few hundred steps with the aux loss keep expert use near
    uniform (the JAX test's bars)."""
    torch.manual_seed(0)
    moe = tmoe.MoEMLP(4, 8, 4, capacity_factor=2.0, n_top=2, device="cpu")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 4, generator=g)
    y = torch.randn(64, 4, generator=g)
    params = list(moe.parameters())
    for _ in range(300):
        out, aux, stats = moe.forward_with_stats(x)
        loss = ((out - y) ** 2).mean() + 0.01 * aux
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, gr in zip(params, grads):
                p -= 0.05 * gr
    frac = stats["expert_fraction"].numpy()
    assert frac.max() < 1.5 / 4, frac
    assert frac.min() > 0.05, frac
    assert float(stats["drop_rate"]) < 0.2


def test_moe_lm_sequence_parallel_matches_jax_at_the_same_sharding(world):
    """Capacity is per shard: under sequence parallelism each rank routes
    its own tokens, in JAX too, so the MoE LM is held against JAX's
    ``shard_map`` over the same 4-way sequence split, never against one
    process."""
    cfg = dict(vocab_size=32, embed_dim=16, num_heads=2, num_layers=2,
               max_len=32, n_experts=4)
    jrandom.set_seed(4)
    jm = JaxLM(**cfg, sequence_parallel="seq")
    params = jm.params_dict()
    ids = np.random.RandomState(4).randint(0, 32, (2, 32))
    fn = pure_apply(jm)
    mesh = Mesh(np.array(jax.devices()[:4]), ("seq",))

    def total(p):
        def body(p, ii):
            out, _ = fn(p, {}, ii, rng=None, training=True)
            return (jnp.sum(out ** 2) * 1e-3 + 0.01 * jm.l_aux)[None], out
        s, out = shard_map(body, mesh=mesh, in_specs=(P(), P(None, "seq")),
                           out_specs=(P("seq"), P(None, "seq")),
                           check_vma=False)(p, jnp.asarray(ids))
        return jnp.sum(s), out

    (_, logits), g = jax.jit(jax.value_and_grad(total, has_aux=True))(params)
    res = world.run(jobs.moe_lm_sp, _np(params), ids, cfg)
    np.testing.assert_allclose(
        np.concatenate([r["logits"] for r in res], axis=1),
        np.asarray(logits), **MOE_TOL)
    from bigdl_tpu_torch.utils.weights import jax_param_names

    tm = TransformerLM(**cfg, device="cpu")
    for path, name in jax_param_names(tm):
        want = g
        for key in path.split("/"):
            want = want[key]
        np.testing.assert_allclose(res[0]["grads"][name], np.asarray(want),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def test_moe_lm_expert_parallel_equals_each_ranks_dense_route(world):
    """Over an ``expert`` axis each rank routes its own rows against
    every expert (its E/n computed locally, the rest by their owners):
    the logits equal the dense MoE LM on that rank's rows alone."""
    cfg = dict(vocab_size=32, embed_dim=16, num_heads=2, num_layers=1,
               max_len=8, n_experts=4)
    jrandom.set_seed(6)
    jm = JaxLM(**cfg)
    ids = np.random.RandomState(6).randint(0, 32, (8, 8))
    res = world.run(jobs.moe_lm_expert_parallel, _np(jm.params_dict()), ids,
                    cfg)
    for r, logits in enumerate(res):
        want = np.asarray(jm(jnp.asarray(ids[2 * r:2 * r + 2])))
        np.testing.assert_allclose(logits, want, **MOE_TOL)
