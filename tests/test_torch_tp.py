"""The port's tensor-parallel rules and sharded model
(``bigdl_tpu_torch/parallel/tp.py``) held against the JAX package's
``bigdl_tpu/parallel/tp.py`` and the JAX model.

The port runs in one world of 4 ranks over gloo on the CPU
(``torch_world.World``); the JAX package runs in this process. Both
start from the same weights: the JAX test model of
``tests/test_tp_serving.py`` (vocab 32, embed 32, 8 heads, 4 KV heads, 2
layers, RoPE, seed 23) with every bias and LayerNorm parameter drawn at
random (zero biases would hide where a bias is added). Tolerances: the
sharded f32 forward within rtol 2e-4 / atol 2e-5 of the JAX forward (the
JAX test's own bound for its sharded forward); tokens identical; the
sharded int8 layer equal to the unsharded int8 layer exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_jobs_tp as jobs
from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.parallel import tp as jtp
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.parallel import tp
from bigdl_tpu_torch.parallel.engine import Mesh
from torch_world import World

N = 4
CFG = dict(vocab_size=32, embed_dim=32, num_heads=8, num_kv_heads=4,
           num_layers=2, max_len=48, use_rope=True)
RTOL, ATOL = 2e-4, 2e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jlm():
    """The JAX test model with random biases and LayerNorm affines."""
    from bigdl_tpu.utils import random as rnd

    rnd.set_seed(23)
    m = JaxLM(**CFG)
    m.evaluate()
    r = np.random.RandomState(5)

    def perturb(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = perturb(v, path + (k,))
            elif k == "bias" or (k == "weight" and any(
                    p.startswith("ln") for p in path)):
                out[k] = jnp.asarray(np.asarray(v) + r.normal(
                    0, 0.1, np.shape(v)).astype(np.float32))
            else:
                out[k] = v
        return out

    m.load_params_dict(perturb(m.params_dict()))
    return m


@pytest.fixture(scope="module")
def params(jlm):
    return _np(jlm.params_dict())


@pytest.fixture(scope="module")
def world():
    return World.shared(N)


def _ids(seed=0, shape=(2, 9)):
    return np.random.RandomState(seed).randint(0, 32, shape)


def _jax_logits(jlm, ids):
    return np.asarray(jlm(jnp.asarray(ids)))


# ------------------------------------------------------- rules and specs
@pytest.mark.parametrize("data_axis", [None, "data"])
@pytest.mark.parametrize("rope,tie", [(True, True), (False, False)])
def test_rules_and_specs_match_jax(data_axis, rope, tie):
    """``transformer_tp_rules`` / ``spec_for_params`` give the JAX
    package's spec at every param path, one axis and both axes, with a
    learned position table and an untied head too."""
    from bigdl_tpu.utils import random as rnd

    rnd.set_seed(7)
    cfg = dict(CFG, use_rope=rope, tie_embeddings=tie)
    jm = JaxLM(**cfg)
    ours = TransformerLM(**cfg, device="cpu")
    want = jtp.spec_for_params(jm.params_dict(),
                               jtp.transformer_tp_rules("model", data_axis))
    got = tp.spec_for_params(ours.params_dict(),
                             tp.transformer_tp_rules("model", data_axis))
    flat_w = dict(jtp.tree_paths(want))
    flat_g = dict(tp.tree_paths(got))
    assert flat_w.keys() == flat_g.keys()
    for path, spec in flat_w.items():
        assert tuple(flat_g[path]) == tuple(spec), path
    assert [p for p, _ in tp.tree_paths(ours.params_dict())] == \
        [p for p, _ in jtp.tree_paths(jm.params_dict())]


def test_kv_pool_spec_and_the_divisibility_guard():
    """``kv_pool_spec`` is the JAX spec; ``kv_pool_sharding`` refuses a
    mesh without the axis and heads that do not divide it, with the JAX
    messages."""
    from jax.sharding import Mesh as JaxMesh

    assert tuple(tp.kv_pool_spec("model")) == \
        tuple(jtp.kv_pool_spec("model"))
    mesh4 = Mesh([("model", 4)], ranks=[0, 1, 2, 3])
    jmesh4 = JaxMesh(np.asarray(jax.devices()[:4]), ("model",))
    sh = tp.kv_pool_sharding(mesh4, 4)
    assert tuple(sh.spec) == (None, "model", None, None)
    assert sh.shard_shape((2, 4, 6, 8)) == (2, 1, 6, 8)
    for args in ((2, "model"), (4, "seq")):
        with pytest.raises(ValueError) as want:
            jtp.kv_pool_sharding(jmesh4, *args)
        with pytest.raises(ValueError) as got:
            tp.kv_pool_sharding(mesh4, *args)
        assert str(got.value) == str(want.value)


def test_shard_params_gives_each_rank_its_own_heads(world, params):
    """Rank r's fused qkv rows are the q rows of heads [2r, 2r + 2) and
    its own K and V head, under the ``P(model)`` spec; every other leaf is
    cut as its spec says."""
    out = world.run(jobs.shard_params_rows, params, N)
    w = params["block0"]["attn"]["qkv"]["~params"]["weight"]
    e, d = 32, 4
    kv = 4 * d
    for r, got in enumerate(out):
        q = w[r * 8:(r + 1) * 8]
        k = w[e + r * d:e + (r + 1) * d]
        v = w[e + kv + r * d:e + kv + (r + 1) * d]
        np.testing.assert_array_equal(got["qkv"], np.concatenate([q, k, v]))
        np.testing.assert_array_equal(
            got["fc2"], params["block0"]["fc2"]["~params"]["weight"][
                :, r * 32:(r + 1) * 32])
        np.testing.assert_array_equal(
            got["tok_embed"], params["~params"]["tok_embed"][r * 8:
                                                             (r + 1) * 8])
        np.testing.assert_array_equal(
            got["ln"], params["block0"]["ln1"]["~params"]["weight"])
        # the plain contiguous split would hand this rank other rows
        assert not np.array_equal(got["qkv"], w[r * 16:(r + 1) * 16]) \
            or r == 0


def test_fetch_put_host_round_trip_sharded(world):
    """``fetch_to_host`` reassembles a heads-sharded tree into full host
    arrays on every rank (or on rank 0 alone), and ``put_from_host``
    lands them back, each rank receiving only its block."""
    out = world.run(jobs.fetch_put_round_trip, N)
    x = np.arange(1 * 4 * 6 * 2, dtype=np.float32).reshape(1, 4, 6, 2)
    for r, o in enumerate(out):
        assert isinstance(o["host"]["k"], np.ndarray)
        np.testing.assert_array_equal(o["host"]["k"], x)
        np.testing.assert_array_equal(o["host"]["v"], 2 * x)
        if r == 0:
            np.testing.assert_array_equal(o["host0"]["k"], x)
        else:
            assert o["host0"]["k"] is None
        np.testing.assert_array_equal(o["local"], x[:, r:r + 1])
        np.testing.assert_array_equal(o["back"]["k"], x[:, r:r + 1])
        np.testing.assert_array_equal(o["back0"]["v"], 2 * x[:, r:r + 1])


# ------------------------------------------------------ the sharded model
def test_sharded_forward_matches_jax(world, jlm, params):
    """The sharded scoring forward on 4 ranks, through the flash kernel's
    wrapper (its plain version on the CPU) on each rank's 2 query heads
    and 1 KV head, equals the JAX forward; one flash call per layer."""
    ids = _ids()
    want = _jax_logits(jlm, ids)
    out = world.run(jobs.sharded_forward, CFG, params, ids, N, True)
    for o in out:
        np.testing.assert_allclose(o["logits"], want, rtol=RTOL, atol=ATOL)
        assert o["local_heads"] == [2, 2]
        assert o["flash_calls"] == [(2, 2, 9, 4, 1)] * 2


def test_contiguous_qkv_split_gives_wrong_logits(world, jlm, params):
    """The hazard: a contiguous 4-way split of the fused qkv rows gives
    rank 0 and 1 only q rows and ranks 2 and 3 all of k and v; the
    logits are then far from the model's."""
    ids = _ids()
    want = _jax_logits(jlm, ids)
    out = world.run(jobs.contiguous_qkv_forward, CFG, params, ids, N)
    assert np.abs(out[0] - want).max() > 100 * ATOL


def test_bias_added_once_after_the_sum(world, jlm, params):
    """A row-parallel bias added on each rank before the all-reduce counts
    4 times; added after the sum it matches the JAX forward."""
    ids = _ids(1)
    want = _jax_logits(jlm, ids)
    early = world.run(jobs.bias_before_sum_forward, CFG, params, ids, N)
    assert np.abs(early[0] - want).max() > 100 * ATOL
    right = world.run(jobs.sharded_forward, CFG, params, ids, N)
    np.testing.assert_allclose(right[0]["logits"], want, rtol=RTOL,
                               atol=ATOL)


def test_int8_row_parallel_quantizes_with_one_scale(world, params):
    """The sharded int8 clone equals the unsharded clone exactly: each
    row-parallel input is quantized with the all-reduced max; a rank's
    own max (a local scale) changes the logits."""
    ids = _ids(2)
    out = world.run(jobs.int8_forward, CFG, params, ids, N)
    for o in out:
        np.testing.assert_array_equal(o["sharded"], o["whole"])
    local = world.run(jobs.int8_forward, CFG, params, ids, N, True)
    assert np.abs(local[0]["sharded"] - local[0]["whole"]).max() > 1e-3


@pytest.mark.parametrize("n", [4, 2])
def test_sharded_generate_matches_jax(world, jlm, params, n):
    """``generate(kv_cache_sharding=)`` on every rank of a 4- and a
    2-way mesh (over ranks [0, 2) of the world) equals the JAX
    ``generate``; the caches hold the rank's KV heads."""
    prompt = _ids(3, (1, 5))
    want = np.asarray(jlm.generate(jnp.asarray(prompt), 6))
    out = world.run(jobs.sharded_generate, CFG, params, prompt, 6, n)
    for r, o in enumerate(out):
        if r >= n:
            assert o is None
            continue
        np.testing.assert_array_equal(o["ids"], want)
        assert o["cache_shape"] == (1, 4 // n, 8, 4)


def test_2d_sharded_forward_matches_replicated(world):
    """``transformer_tp_rules("model", "data")`` on a (data 2, model 2)
    mesh of the 4 ranks (JAX's case takes 2 x 4 of its 8 devices): each
    rank keeps a block of every weight and the position table, gathers
    the data axis's blocks before each layer's tensor-parallel math, and
    the forward equals the JAX model's (rtol 2e-4 / atol 2e-5)."""
    from bigdl_tpu.utils import random as rnd

    rnd.set_seed(7)
    cfg = dict(vocab_size=32, embed_dim=32, num_heads=8, num_layers=2,
               max_len=16, use_rope=False)
    jm = JaxLM(**cfg)
    jm.evaluate()
    ids = np.random.RandomState(8).randint(0, 32, (4, 8))
    want = np.asarray(jm(jnp.asarray(ids)))
    out = world.run(jobs.sharded_forward_2d, cfg, _np(jm.params_dict()),
                    ids)
    for o in out:
        np.testing.assert_allclose(o["logits"], want, rtol=RTOL, atol=ATOL)
        assert o["qkv_block"] == (48, 16)       # (3 x 32) / 2 x 32 / 2
        assert o["qkv_gathered"] == (48, 32)
        assert o["pos_block"] == (8, 32)


def test_refused_combinations_name_their_item():
    """What a one-rank mesh takes and refuses: a sequence-parallel model
    whose axis the mesh lacks is a ``ValueError`` (JAX runs it only
    inside ``shard_map`` over that axis); MoE models, the int8 clone
    under 2-D rules and a cache sharded by sequence blocks (each rank
    holding T/n positions) are taken; rules over an axis the mesh lacks
    are an error; a cache split over the head dim holds D/n features; a
    page pool split other than by heads is an error."""
    from bigdl_tpu_torch.nn.attention import KVShards
    from bigdl_tpu_torch.nn.quantized import Quantizer

    mesh1 = Mesh([("model", 1)], ranks=[0])
    m = TransformerLM(**CFG, device="cpu", sequence_parallel="seq")
    with pytest.raises(ValueError, match="shard_map"):
        tp.shard_model(m, mesh1)
    moe = tp.shard_model(TransformerLM(**CFG, device="cpu", n_experts=2),
                         mesh1)
    assert moe.blocks()[0].mlp.n_experts == 2
    m = TransformerLM(**CFG, device="cpu")
    rules2d = tp.transformer_tp_rules("model", "data")
    with pytest.raises(ValueError, match="not in mesh axes"):
        tp.shard_model(m, mesh1, rules2d)
    mesh11 = Mesh([("data", 1), ("model", 1)], ranks=[0])
    q = tp.shard_model(Quantizer.quantize(m), mesh11, rules2d)
    assert q._tp is not None
    mesh4 = Mesh([("model", 4)], ranks=[0, 1, 2, 3])
    seq = tp.NamedSharding(mesh4, tp.P(None, None, "model", None))
    caches = m.init_cache(1, 8, sharding=seq)
    assert isinstance(caches[0], KVShards)
    assert caches[0][0].shape == (1, 4, 2, 4) and caches[0].total == 8
    caches = m.init_cache(1, 8, sharding=tp.NamedSharding(
        mesh4, tp.P(None, None, None, "model")))
    assert caches[0][0].shape == (1, 4, 8, 1) and caches[0].dim == 3
    with pytest.raises(ValueError, match="heads only"):
        m.init_page_pool(4, 4, sharding=seq)
    local = tp.shard_model(m, mesh1)
    assert local.init_cache(1, 8, sharding=local.kv_cache_sharding(
        mesh1))[0][0].shape == (1, 4, 8, 4)
    with pytest.raises(ValueError, match="shard the model"):
        m.init_cache(1, 8, sharding=m.kv_cache_sharding(mesh4))
