"""Ring and Ulysses attention and the sequence-parallel LM held against
the JAX package (the counterparts of ``tests/test_attention.py``'s ring,
Ulysses and sequence-parallel cases).

The port runs in a world of 4 ranks over gloo on the CPU, each rank one
contiguous block of the sequence; the JAX package runs ``shard_map``
over a ``seq`` mesh of 4 of the conftest's virtual CPU devices, its
flash ring through the Pallas kernel in interpret mode, as
``tests/test_attention.py`` runs it. The port's flash ring takes the
kernel's plain version on CPU tensors. Forward and the gradients of the
global sum(out ** 2) with respect to q, k and v (each rank's block,
gathered in rank order): f32 within rtol 2e-4 / atol 2e-5 of JAX
(``tests/test_attention.py``'s flash-ring tolerance is 5e-4 / 5e-5 on
the gradients), bf16 within 0.06 / 0.02 of the f32 full attention, as
JAX's bf16 ring test holds it.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_jobs_ring as jobs
from bigdl_tpu import models as jmodels
from bigdl_tpu.nn import attention as jattn
from bigdl_tpu.nn.attention import dot_product_attention
from bigdl_tpu.nn.module import pure_apply
from bigdl_tpu.parallel import Engine as JaxEngine
from bigdl_tpu.parallel import ring_attention, ulysses_attention
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.nn import attention as tattn
from torch_world import World

N = 4
TOL = dict(rtol=2e-4, atol=2e-5)


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
def world(tmp_path_factory):
    w = World(N, tmp_path_factory.mktemp("world"))
    w.run(jobs.seq_mesh)
    yield w
    w.close()


@pytest.fixture(scope="module")
def mesh():
    return JaxEngine.create_mesh([("seq", N)], devices=jax.devices()[:N])


def _qkv(b=1, h=4, h_kv=2, t=256, d=16, seed=0):
    r = np.random.RandomState(seed)
    q = (r.randn(b, h, t, d) * 0.3).astype(np.float32)
    k = (r.randn(b, h_kv, t, d) * 0.3).astype(np.float32)
    v = (r.randn(b, h_kv, t, d) * 0.3).astype(np.float32)
    return q, k, v


def _jax_ring(mesh, q, k, v, causal, use_flash, kind="ring"):
    spec = P(None, None, "seq", None)

    def total(q, k, v):
        def body(q, k, v):
            if kind == "ring":
                return ring_attention(q, k, v, axis_name="seq",
                                      causal=causal, use_flash=use_flash)
            return ulysses_attention(q, k, v, axis_name="seq",
                                     causal=causal)
        out = jax.shard_map(body, mesh=mesh, in_specs=spec, out_specs=spec,
                            check_vma=False)(q, k, v)
        return jnp.sum(out ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        total, argnums=(0, 1, 2), has_aux=True))(
            *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _gathered(res, key):
    return np.concatenate([r[key] for r in res], axis=2)


def _check(res, out, grads, tol=TOL):
    np.testing.assert_allclose(_gathered(res, "out"), out, **tol)
    for key, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(_gathered(res, key), g, **tol,
                                   err_msg=key)


@pytest.mark.parametrize("causal", [False, True])
def test_dense_ring_matches_jax(world, mesh, causal):
    q, k, v = _qkv(h_kv=2, t=64)
    out, grads = _jax_ring(mesh, q, k, v, causal, use_flash=False)
    res = world.run(jobs.ring_fwd_grad, q, k, v, causal, False)
    _check(res, out, grads)
    assert all(r["calls"] == [] for r in res)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_ring_matches_jax_with_gqa(world, mesh, causal):
    """The flash ring (GQA kv rotating un-expanded) against JAX's flash
    ring in interpret mode; a past block is one non-causal call, the
    diagonal one causal call and a future block none, and on CPU tensors
    no kernel launches."""
    q, k, v = _qkv(h_kv=2, t=256)
    out, grads = _jax_ring(mesh, q, k, v, causal, use_flash=True)
    res = world.run(jobs.ring_fwd_grad, q, k, v, causal, True)
    _check(res, out, grads)
    for r, got in enumerate(res):
        want = ([True] + [False] * r) if causal else [False] * N
        assert got["calls"] == want, (r, got["calls"])
        assert got["launches"] == 0
    # and against full attention over the whole sequence
    full = np.asarray(dot_product_attention(
        *(jnp.asarray(a) for a in (q, np.repeat(k, 2, 1),
                                   np.repeat(v, 2, 1))), causal=causal))
    np.testing.assert_allclose(_gathered(res, "out"), full, **TOL)


def test_bf16_ring_inputs(world):
    q, k, v = _qkv(h=4, h_kv=4, t=64)
    want = np.asarray(dot_product_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True))
    for flash in (False, True):
        res = world.run(jobs.ring_fwd_grad, q, k, v, True, flash,
                        dtype="bfloat16")
        np.testing.assert_allclose(_gathered(res, "out"), want, rtol=0.06,
                                   atol=0.02)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(world, mesh, causal):
    q, k, v = _qkv(h=8, h_kv=8, t=32)
    out, grads = _jax_ring(mesh, q, k, v, causal, False, kind="ulysses")
    res = world.run(jobs.ring_fwd_grad, q, k, v, causal, False,
                    kind="ulysses")
    _check(res, out, grads)


def _jax_lm(seed, **cfg):
    from bigdl_tpu.utils import random as jrandom

    jrandom.set_seed(seed)
    m = jmodels.TransformerLM(**cfg)
    return m, jax.tree.map(np.asarray, m.params_dict())


def _lm_loss_and_grads(model, params, ids, vocab):
    fn = pure_apply(model)

    def loss(p):
        logits, _ = fn(p, {}, jnp.asarray(ids), rng=None, training=True)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        tgt = (jnp.asarray(ids) + 1) % vocab
        return -jnp.sum(jnp.take_along_axis(logp, tgt[..., None], -1)), \
            logits

    (value, logits), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    return float(value), np.asarray(logits), g


@pytest.mark.parametrize("rope,flash,kv", [(False, False, None),
                                           (True, True, 2)])
def test_sequence_parallel_lm_matches_one_process(world, rope, flash, kv):
    """Learned positions (offset by the rank's block) or RoPE (rotated
    from rank x T), dense or flash ring: the logits and the gradients of
    the summed next-token loss equal one JAX process's."""
    cfg = dict(vocab_size=32, embed_dim=16, num_heads=4, num_layers=2,
               max_len=64, causal=True, use_rope=rope, use_flash=flash,
               num_kv_heads=kv)
    jm, params = _jax_lm(5, **{k: v for k, v in cfg.items()
                               if k != "use_flash"})
    ids = np.random.RandomState(5).randint(0, 32, (2, 64))
    value, logits, grads = _lm_loss_and_grads(jm, params, ids, 32)
    res = world.run(jobs.lm_sp, params, ids, cfg)
    np.testing.assert_allclose(
        np.concatenate([r["logits"] for r in res], axis=1), logits,
        rtol=2e-4, atol=2e-5)
    assert res[0]["loss"] == pytest.approx(value, rel=1e-5)
    names = dict(tattn_names(TransformerLM(**cfg, device="cpu")))
    for path, name in names.items():
        want = np.asarray(_at(grads, path))
        np.testing.assert_allclose(res[0]["grads"][name], want, rtol=1e-3,
                                   atol=1e-5, err_msg=name)


def tattn_names(model):
    from bigdl_tpu_torch.utils.weights import jax_param_names

    return jax_param_names(model)


def _at(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def test_attention_options_have_the_jax_names_and_defaults():
    """``sequence_parallel``, ``n_experts`` and ``expert_parallel`` exist
    on MultiHeadAttention, TransformerBlock and TransformerLM with the
    JAX defaults."""
    pairs = [(jattn.MultiHeadAttention, tattn.MultiHeadAttention,
              ["sequence_parallel"]),
             (jattn.TransformerBlock, tattn.TransformerBlock,
              ["sequence_parallel", "n_experts", "expert_parallel"]),
             (jmodels.TransformerLM, TransformerLM,
              ["sequence_parallel", "n_experts", "expert_parallel"])]
    for jcls, tcls, names in pairs:
        js = inspect.signature(jcls.__init__).parameters
        ts = inspect.signature(tcls.__init__).parameters
        for name in names:
            assert ts[name].default == js[name].default, (tcls, name)
    m = TransformerLM(32, 16, 2, 1, 8, n_experts=2, device="cpu")
    assert m.l_aux == 0.0 and m.last_moe_stats is None
    assert m.block0.mlp.w1.shape == (2, 16, 64)
