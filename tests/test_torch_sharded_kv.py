"""KV caches sharded by batch, by sequence blocks and by head-dim blocks
(bigdl_tpu_torch/models/transformer.py ``init_cache(sharding=)``,
nn/attention.py ``KVShards``) against the JAX package's
``test_generate_data_parallel_on_mesh`` and
``test_generate_sequence_sharded_kv_cache_on_mesh``
(``tests/test_attention.py``), on their configs: vocab 32, embed 16, 4
heads, 2 KV heads, 2 layers, max_len 16, RoPE. The JAX package has no
head-dim case; this file builds it: JAX's ``generate`` with
``kv_cache_sharding=NamedSharding(mesh, P(None, None, None, "x"))`` on 4
of its CPU devices.

The port runs in one world of 4 ranks over gloo on the CPU; the JAX
tokens are single-device ``generate`` on the same weights. Tokens must
be equal exactly, as in the JAX tests. A batch split leaves each rank
its B/4 rows (no collective); a sequence split leaves each rank T/4
cache positions, with a 5-token prompt and 6 new tokens reaching three
of the four blocks, so the last block stays empty (a dead block) and
the merge of the others decides every token; a head-dim split leaves
each rank D/4 features of every head. ``generate_ragged`` over the
sequence-sharded caches must give the unsharded ragged tokens, and an
int8 cache under either split gives the unsplit int8 cache's logits
within rtol 1e-5 / atol 1e-5 over a prefill and three decode steps (the
merge and the split dot products only reorder f32 sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_jobs_kv as jobs
from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from tests.jax_numpy_init import numpy_weight_draws
from torch_world import World

N = 4
CFG = dict(vocab_size=32, embed_dim=16, num_heads=4, num_kv_heads=2,
           num_layers=2, max_len=16, use_rope=True)


@pytest.fixture(scope="module")
def world():
    return World.shared(N)


def _jax_lm(seed):
    with numpy_weight_draws(seed):
        m = JaxLM(**CFG)
    m.evaluate()
    return m, jax.tree.map(np.asarray, m.params_dict())


def test_generate_batch_sharded_kv_cache_matches_jax(world):
    m, params = _jax_lm(14)
    prompt = np.random.RandomState(8).randint(0, 32, (8, 5))
    want = np.asarray(m.generate(jnp.asarray(prompt), 6))
    out = world.run(jobs.kv_generate, CFG, params, prompt, 6, None,
                    (("data", N),), ("data", None, None, None))
    np.testing.assert_array_equal(
        np.concatenate([o["tokens"] for o in out]), want)
    for o in out:       # each rank holds its 2 rows, the whole sequence
        assert o["cache"] == (8 // N, 2, 11, 4)


@pytest.fixture(scope="module")
def seq_case():
    """The JAX sequence-sharded test's model, prompt and single-device
    tokens, shared by the sequence and head-dim cases."""
    m, params = _jax_lm(18)
    prompt = np.random.RandomState(13).randint(0, 32, (2, 5))
    return m, params, prompt, np.asarray(m.generate(jnp.asarray(prompt), 6))


def test_generate_sequence_sharded_kv_cache_matches_jax(world, seq_case):
    _, params, prompt, want = seq_case
    lengths = np.asarray([5, 3])
    out = world.run(jobs.kv_generate, CFG, params, prompt, 6, 16,
                    (("seq", N),), (None, None, "seq", None),
                    ragged=lengths)
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o["tokens"], want)
        assert o["cache"] == (2, 2, 16 // N, 4)        # T/n positions
        assert o["start"] == r * 16 // N
        np.testing.assert_array_equal(o["ragged"], o["ragged_whole"])
        np.testing.assert_allclose(o["int8"], o["int8_whole"], rtol=1e-5,
                                   atol=1e-5)


def test_generate_head_dim_sharded_kv_cache_matches_jax(world, seq_case):
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    m, params, prompt, want = seq_case
    mesh = Mesh(np.asarray(jax.devices()[:N]), ("x",))
    got = m.generate(jnp.asarray(prompt), 6, max_len=16,
                     kv_cache_sharding=NamedSharding(
                         mesh, P(None, None, None, "x")))
    np.testing.assert_array_equal(np.asarray(got), want)
    out = world.run(jobs.kv_generate, CFG, params, prompt, 6, 16,
                    (("x", N),), (None, None, None, "x"))
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o["tokens"], want)
        assert o["cache"] == (2, 2, 16, 4 // N)        # D/n features
        assert o["start"] == r * 4 // N
        np.testing.assert_allclose(o["int8"], o["int8_whole"], rtol=1e-5,
                                   atol=1e-5)
