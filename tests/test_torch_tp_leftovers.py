"""The tensor-parallel leftovers of the port (bigdl_tpu_torch/parallel/
tp.py ``shard_model``): the int8 clone under 2-D ``data x model`` rules,
an ``n_experts=`` model on a model mesh and a ``sequence_parallel=``
model on a (seq x model) mesh, against the JAX package where it runs
the case.

The port runs in one world of 4 ranks over gloo on the CPU; the JAX
package runs in this process on 4 of its CPU devices. Weights are the
JAX models', drawn by numpy (``tests/jax_numpy_init.py``) and copied
with ``load_jax_params``. Tolerances:

- 2-D int8: the sharded forward EQUAL to the unsharded int8 forward
  (codes and scales follow the 1-D model split, replicated over the data
  axis; one global activation scale), its greedy tokens and the 2-D
  int8 engine's rows equal to the unsharded int8 clone's and engine's;
- MoE: JAX shards its attention with ``shard_params(
  transformer_tp_rules("model"))`` and replicates the experts (no rule
  matches them); the port's forward within rtol 2e-4 / atol 2e-5 of
  JAX's jitted sharded forward (the JAX test's own bound), its greedy
  tokens equal to JAX's sharded ``generate``;
- sequence parallel: the ``shard_map`` form of the JAX test
  ``test_sequence_parallel_lm_matches_single_device`` on a (seq 2,
  model 2) mesh; the port's ring over "seq" with its heads over "model"
  within rtol 2e-4 / atol 2e-5 of it. A mesh without the sequence axis
  is a ``ValueError``: JAX cannot run that case at all.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as JP

import torch_jobs_kv as jobs
import torch_jobs_tp
from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.nn.module import jit_inference_fn, pure_apply
from bigdl_tpu.parallel import tp as jtp
from tests.jax_numpy_init import numpy_weight_draws
from torch_world import World

N = 4
CFG = dict(vocab_size=32, embed_dim=32, num_heads=8, num_kv_heads=4,
           num_layers=2, max_len=48, use_rope=True)
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module")
def world():
    return World.shared(N)


def _jax_lm(seed, **kw):
    with numpy_weight_draws(seed):
        m = JaxLM(**dict(CFG, **kw))
    m.evaluate()
    return m


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ids(seed, shape):
    return np.random.RandomState(seed).randint(0, 32, shape)


def test_int8_clone_under_2d_rules_equals_unsharded_int8(world):
    from bigdl_tpu_torch.serving import ContinuousBatchingEngine

    params = _np(_jax_lm(31).params_dict())
    ids, prompt = _ids(1, (2, 9)), _ids(2, (2, 5))
    out = world.run(jobs.int8_2d, CFG, params, ids, prompt, 6)
    for o in out:
        np.testing.assert_array_equal(o["sharded"], o["whole"])
        np.testing.assert_array_equal(o["tokens"], o["tokens_whole"])
        assert o["qkv_codes"] == (32, 32)   # (32 + 2 x 16) / 2 rows, whole
    reqs = [(list(_ids(3 + i, (4 + i,))), 5) for i in range(3)]
    served = world.run(torch_jobs_tp.serve, CFG, params, reqs, "2d",
                       weights_dtype="int8")
    lone = ContinuousBatchingEngine(torch_jobs_tp.lm(CFG, params),
                                    weights_dtype="int8", max_slots=4)
    with lone:
        want = [np.asarray(lone.submit(p, k).result(timeout=120))
                for p, k in reqs]
    rows = [o for o in served if o["leader"]][0]["rows"]
    for got, w in zip(rows, want):
        np.testing.assert_array_equal(np.asarray(got), w)


def test_moe_model_on_model_mesh_matches_jax(world):
    m = _jax_lm(32, n_experts=4)
    params = _np(m.params_dict())
    ids, prompt = _ids(4, (2, 12)), _ids(5, (2, 5))
    mesh = JaxMesh(np.asarray(jax.devices()[:N]), ("model",))
    m.load_params_dict(jtp.shard_params(m.params_dict(), mesh,
                                        jtp.transformer_tp_rules("model")))
    want = np.asarray(jit_inference_fn(m)(m.params_dict(),
                                          m.buffers_dict(),
                                          jnp.asarray(ids)))
    want_toks = np.asarray(m.generate(jnp.asarray(prompt), 6))
    out = world.run(jobs.moe_model_mesh, dict(CFG, n_experts=4), params,
                    ids, prompt, 6)
    for o in out:
        assert o["heads"] == 8 // N and o["w1"][0] == 4   # experts whole
        np.testing.assert_allclose(o["logits"], want, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(o["tokens"], want_toks)


def test_sequence_parallel_model_on_seq_by_model_mesh_matches_jax(world):
    cfg = dict(CFG, use_rope=False, causal=True, sequence_parallel="seq")
    m = _jax_lm(33, use_rope=False, causal=True, sequence_parallel="seq")
    params, buffers = m.params_dict(), m.buffers_dict()
    ids = _ids(6, (2, 16))
    mesh = JaxMesh(np.asarray(jax.devices()[:N]).reshape(2, 2),
                   ("seq", "model"))
    apply_fn = pure_apply(m)

    def body(x):
        return apply_fn(params, buffers, x, rng=None, training=False)[0]

    want = np.asarray(jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=JP(None, "seq"),
        out_specs=JP(None, "seq", None), check_vma=False))(
            jnp.asarray(ids)))
    out = world.run(jobs.seq_parallel_model_mesh, cfg, _np(params), ids)
    for o in out:
        s = o["seq"]
        assert o["heads"] == 8 // 2
        np.testing.assert_allclose(o["logits"], want[:, 8 * s:8 * (s + 1)],
                                   rtol=RTOL, atol=ATOL)


def test_sequence_parallel_model_without_its_axis_is_refused():
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.parallel import tp
    from bigdl_tpu_torch.parallel.engine import Mesh

    cfg = dict(CFG)
    vocab = cfg.pop("vocab_size")
    m = TransformerLM(vocab, device="cpu", sequence_parallel="seq", **cfg)
    with pytest.raises(ValueError, match="unbound axis_index"):
        tp.shard_model(m, Mesh([("model", 1)], ranks=[0]))
