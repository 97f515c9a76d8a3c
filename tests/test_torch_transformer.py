"""The port's TransformerLM (bigdl_tpu_torch/models/transformer.py)
against the JAX package's on the same weights: forward logits with flash
on (the JAX side's lengths here do not tile its 128-blocks, so it takes
its dense fallback; the port runs its kernel's plain version), prefill
and decode logits, and greedy tokens, which must be identical.

Tolerance: f32 logits at rtol 2e-4 / atol 2e-5 (the JAX flash test's).
The JAX weights are drawn by numpy (``tests/jax_numpy_init.py``) and
the JAX forward, prefill and decode steps run under ``jax.jit`` (one
compile a program, not one an op).
Sampled generation cannot match the JAX package's draws (different
generators); it is checked for valid ids and for its top-k filter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import transformer as jtr
from bigdl_tpu.nn.module import jit_inference_fn
from bigdl_tpu_torch.models import transformer as ttr
from bigdl_tpu_torch.utils.weights import load_jax_params
from tests.jax_numpy_init import numpy_weight_draws

TOL = dict(rtol=2e-4, atol=2e-5)
CFG = dict(vocab_size=64, embed_dim=32, num_heads=4, num_layers=2,
           max_len=64, num_kv_heads=2, use_flash=True)


@pytest.fixture(scope="module", params=[True, False], ids=["rope", "learned"])
def lms(request):
    with numpy_weight_draws(11):
        jm = jtr.TransformerLM(**CFG, use_rope=request.param)
    jm.evaluate()
    tm = ttr.TransformerLM(**CFG, use_rope=request.param, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    return jm, tm


def _ids(b, t, seed=0):
    return np.random.RandomState(seed).randint(0, 64, (b, t)).astype(np.int32)


def test_forward_logits_match(lms):
    jm, tm = lms
    ids = _ids(2, 24)
    with torch.no_grad():
        out = tm(torch.from_numpy(ids))
    ref = jit_inference_fn(jm)(jm.params_dict(), jm.buffers_dict(),
                               jnp.asarray(ids))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_prefill_and_decode_step_logits_match(lms):
    jm, tm = lms
    ids = _ids(2, 10, seed=1)
    cj, ct = jm.init_cache(2, 16), tm.init_cache(2, 16)
    lj, cj = jax.jit(jm.prefill)(jnp.asarray(ids[:, :6]), cj)
    lt, ct = tm.prefill(ids[:, :6], ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    lj, cj = jax.jit(jm.prefill_chunk, static_argnums=2)(
        jnp.asarray(ids[:, 6:8]), cj, 6)
    lt, ct = tm.prefill_chunk(ids[:, 6:8], ct, 6)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    step = jax.jit(jm.decode_step, static_argnums=1)
    for i in (8, 9):
        lj, cj = step(jnp.asarray(ids[:, i]), i, cj)
        lt, ct = tm.decode_step(ids[:, i], i, ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    # ragged: each row at its own depth
    pos = np.array([10, 7])
    lj, _ = jax.jit(jm.decode_step)(jnp.asarray(ids[:, 0]),
                                    jnp.asarray(pos), cj)
    lt, _ = tm.decode_step(ids[:, 0], torch.from_numpy(pos), ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


@pytest.mark.parametrize("eos,chunk", [(False, None), (True, None),
                                       (False, 4)])
def test_greedy_generate_tokens_identical(lms, eos, chunk):
    jm, tm = lms
    prompt = _ids(3, 7, seed=2)
    eos_id = None
    if eos:
        # a token the greedy run emits early, so rows stop at eos
        eos_id = int(np.asarray(tm.generate(prompt, 4))[0, 9])
    ref = np.asarray(jm.generate(jnp.asarray(prompt), 12, eos_id=eos_id,
                                 prefill_chunk=chunk))
    out = tm.generate(prompt, 12, eos_id=eos_id, prefill_chunk=chunk)
    np.testing.assert_array_equal(out.numpy(), ref)
    if eos:
        row = out[0, 7:].numpy()
        first = int(np.flatnonzero(row == eos_id)[0])
        assert (row[first:] == eos_id).all()


def test_generate_ragged_tokens_identical(lms):
    jm, tm = lms
    prompts = _ids(3, 9, seed=3)
    lengths = np.array([3, 9, 5], np.int32)
    ref = np.asarray(jm.generate_ragged(jnp.asarray(prompts),
                                        jnp.asarray(lengths), 6))
    out = tm.generate_ragged(prompts, lengths, 6)
    np.testing.assert_array_equal(out.numpy(), ref)
    for i, n in enumerate(lengths):   # each row is its own lone generate
        lone = tm.generate(prompts[i, :n], 6)[0, n:]
        np.testing.assert_array_equal(out[i].numpy(), lone.numpy())


def test_sampled_generate_valid_and_honours_top_k(lms):
    _, tm = lms
    prompt = _ids(4, 5, seed=4)
    gen = torch.Generator().manual_seed(3)
    out, seen = tm.generate(prompt, 10, temperature=0.9, top_k=3,
                            generator=gen, return_logits=True)
    toks = out[:, 5:]
    assert out.shape == (4, 15) and toks.min() >= 0 and toks.max() < 64
    top3 = seen.topk(3, dim=-1).indices
    assert (top3 == toks[..., None]).any(-1).all()
    again = tm.generate(prompt, 10, temperature=0.9, top_k=3,
                        generator=torch.Generator().manual_seed(3))
    assert torch.equal(out, again)   # the explicit generator decides


@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.7),
                                         (10, 0.5), (None, 1e-6)])
def test_filter_logits_masks_match(top_k, top_p):
    logits = np.random.RandomState(5).randn(3, 64).astype(np.float32)
    ref = np.asarray(jtr._filter_logits(jnp.asarray(logits), 0.7, top_k,
                                        top_p))
    out = ttr._filter_logits(torch.from_numpy(logits), 0.7, top_k, top_p)
    np.testing.assert_array_equal(np.isinf(out.numpy()), np.isinf(ref))
    keep = ~np.isinf(ref)
    np.testing.assert_allclose(out.numpy()[keep], ref[keep], **TOL)


def test_sampling_config_validated():
    tm = ttr.TransformerLM(**CFG, device="cpu")
    with pytest.raises(ValueError, match="temperature"):
        tm.generate(_ids(1, 3), 2, top_k=3)
    with pytest.raises(ValueError, match="top_p"):
        tm.generate(_ids(1, 3), 2, temperature=1.0, top_p=1.5)
    with pytest.raises(ValueError, match="max_len"):
        tm.generate(_ids(1, 60), 10)
