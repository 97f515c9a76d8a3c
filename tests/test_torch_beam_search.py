"""The port's ``TransformerLM.beam_search`` against the JAX package's, in
both of its forms (the one-dispatch ``lax.scan`` and ``host_loop=True``),
on the same weights (a 2-layer, 64-wide f32 model): RoPE and learned
positions, with and without eos, length penalties 0, 1 and 2, the int8
KV cache form, one beam against greedy ``generate``, and a constructed
tie between candidates.

Tokens must be identical: both sides rank f32 log-prob sums of the
same weights, and the seeds give no near tie that the packages'
rounding could reorder. The tie tests build exact ties: the
candidates' order among equal scores is ``jax.lax.top_k``'s, lowest
flat index first, which ``torch.topk`` does not promise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import transformer as jtr
from bigdl_tpu_torch.models import transformer as ttr
from bigdl_tpu_torch.utils.weights import load_jax_params

CFG = dict(vocab_size=64, embed_dim=64, num_heads=4, num_layers=2,
           max_len=48, num_kv_heads=2)


@pytest.fixture(scope="module", params=[True, False], ids=["rope", "learned"])
def lms(request):
    from bigdl_tpu.utils import random as bt_random

    bt_random.set_seed(5)
    jm = jtr.TransformerLM(**CFG, use_rope=request.param)
    jm.evaluate()
    tm = ttr.TransformerLM(**CFG, use_rope=request.param, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    tm.evaluate()
    return jm, tm


def _prompt(b=2, t=6, seed=3):
    return np.random.RandomState(seed).randint(0, 64, (b, t)).astype(np.int32)


def _eos(jm, prompt):
    """A token the greedy run emits early, so beams finish."""
    out = np.asarray(jm.generate(jnp.asarray(prompt), 6))
    return int(out[0, prompt.shape[1] + 1])


@pytest.mark.parametrize("host_loop", [False, True], ids=["scan", "host"])
@pytest.mark.parametrize("penalty", [0.0, 1.0, 2.0])
@pytest.mark.parametrize("with_eos", [False, True], ids=["no_eos", "eos"])
def test_beam_search_tokens_match_jax(lms, host_loop, penalty, with_eos):
    jm, tm = lms
    prompt = _prompt()
    eos = _eos(jm, prompt) if with_eos else None
    want = np.asarray(jm.beam_search(jnp.asarray(prompt), 10, num_beams=3,
                                     length_penalty=penalty, eos_id=eos,
                                     host_loop=host_loop))
    got = tm.beam_search(prompt, 10, num_beams=3, length_penalty=penalty,
                         eos_id=eos, host_loop=host_loop).numpy()
    np.testing.assert_array_equal(got, want)
    if eos is not None:  # a finished beam only pads with eos
        for row in got[:, prompt.shape[1]:]:
            hits = np.flatnonzero(row == eos)
            if hits.size:
                assert (row[hits[0]:] == eos).all()


def test_one_beam_is_greedy(lms):
    jm, tm = lms
    prompt = _prompt(3, 5, seed=7)
    greedy = tm.generate(prompt, 9).numpy()
    np.testing.assert_array_equal(
        tm.beam_search(prompt, 9, num_beams=1).numpy(), greedy)
    np.testing.assert_array_equal(
        greedy, np.asarray(jm.beam_search(jnp.asarray(prompt), 9,
                                          num_beams=1)))


def test_int8_cache_beam_loop_matches_jax(lms):
    """The int8 KV form through both beam bodies: the JAX scan program
    given int8 caches, the port's loop given its own; codes and scales
    are reordered together, so the tokens agree."""
    jm, tm = lms
    prompt = _prompt(2, 6, seed=9)
    b, t0, n, k = 2, 6, 8, 3
    cj = jm.init_cache(b, t0 + n, kv_dtype="int8")
    lj, cj = jm.prefill(jnp.asarray(prompt), cj)
    fn = jm._beam_scan_closure(b, k, n, None)
    want = np.asarray(fn(jm.params_dict(), jm.buffers_dict(), lj,
                         jnp.int32(t0), cj, jnp.float32(1.0)))
    ct = tm.init_cache(b, t0 + n, kv_dtype="int8")
    lt, ct = tm.prefill(prompt, ct)
    got = tm._beam_loop(lt, t0, ct, k, n, None, 1.0).numpy()
    np.testing.assert_array_equal(got, want)
    # the caches hold codes and scales: 4 tensors a layer
    assert all(len(c) == 4 for c in ct)


def test_window_edge_positions(lms):
    """A beam run that fills the model's whole context reads no position
    past it."""
    _, tm = lms
    prompt = _prompt(1, 8, seed=4)
    out = tm.beam_search(prompt, CFG["max_len"] - 8, num_beams=2)
    assert out.shape == (1, CFG["max_len"])
    assert int(out.max()) < CFG["vocab_size"] and int(out.min()) >= 0


class _Uniform(ttr.TransformerLM):
    """Every step's logits equal over the vocabulary: every candidate of
    a step ties, so only the tie rule decides the beams."""

    def decode_step(self, ids_t, pos, caches):
        logits, caches = super().decode_step(ids_t, pos, caches)
        return torch.zeros_like(logits), caches


def test_tie_order_is_lowest_flat_index_first():
    """Exact ties go lowest flat index first, as in ``jax.lax.top_k``:
    after a uniform step the K survivors are beam 0's tokens 0..K-1."""
    tm = _Uniform(**CFG, use_rope=True, device="cpu")
    tm.evaluate()
    b, k, n, v = 2, 3, 4, CFG["vocab_size"]
    prompt = _prompt(b, 5, seed=1)
    _, logits, caches = tm._decode_setup(prompt, n, None)
    logits = torch.zeros_like(logits)
    logits[:, 7] = 1.0                    # one clear first choice
    got = tm._beam_loop(logits, 5, caches, k, n, None, 1.0).numpy()
    # step 0 picks 7 then the tied 0, 1; every later step ties across
    # all K * V candidates and keeps flat indices 0..K-1: beam 0
    # (token 7's lineage), tokens 0..2; the best is the first
    np.testing.assert_array_equal(got, np.tile([7, 0, 0, 0], (b, 1)))
    want = jax.lax.top_k(jnp.zeros((1, k * v)), k)[1]
    np.testing.assert_array_equal(np.asarray(want)[0], np.arange(k))
    x = torch.zeros(1, k * v)
    _, idx = ttr._top_k(x, k)
    np.testing.assert_array_equal(idx.numpy()[0], np.arange(k))


@pytest.mark.parametrize("levels", [1, 3, 17])
def test_top_k_breaks_ties_as_jax(levels):
    """Candidate rows of the flagship's shape (B 4, K 4 over a 32000
    vocabulary) whose scores take a few values, as bf16 logits do: the
    port's selection equals ``jax.lax.top_k``'s, indices included."""
    r = np.random.RandomState(levels)
    x = r.randint(0, levels, (4, 4 * 32000)).astype(np.float32) * 0.25
    vals, idx = ttr._top_k(torch.from_numpy(x), 4)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_beam_may_end_below_greedy_where_greedy_is_pruned():
    """Beam search keeps the K best prefixes by summed log-prob, so it can
    drop the greedy prefix and end below the greedy row: the JAX
    package's beam search does on this model (row 1, two beams), and the
    port gives the same tokens. Where the best beam ends below greedy,
    the greedy prefix left the beams at some step."""
    from bigdl_tpu.utils import random as bt_random

    bt_random.set_seed(1)
    jm = jtr.TransformerLM(**CFG, use_rope=True)
    jm.evaluate()
    tm = ttr.TransformerLM(**CFG, use_rope=True, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    tm.evaluate()
    prompt = np.random.RandomState(1).randint(0, 64, (4, 6)).astype(np.int32)
    n, t0 = 12, 6
    want = np.asarray(jm.beam_search(jnp.asarray(prompt), n, num_beams=2,
                                     length_penalty=0.0))
    _, logits, caches = tm._decode_setup(prompt, n, None)
    run = tm._beam_loop(logits, t0, caches, 2, n, None, 0.0,
                        with_scores=True)
    np.testing.assert_array_equal(run["tokens"].numpy(), want[:, t0:])
    greedy = tm.generate(prompt, n).numpy()[:, t0:]

    def score(gen):
        seq = torch.from_numpy(np.concatenate([prompt, gen], 1))
        with torch.no_grad():
            lp = torch.log_softmax(tm(seq)[:, t0 - 1:-1], -1)
        return lp.gather(-1, torch.from_numpy(gen)[..., None])[..., 0].sum(1)

    beam_s, greedy_s = score(want[:, t0:]), score(greedy)
    below = (beam_s < greedy_s - 1e-4).nonzero()[:, 0].tolist()
    assert below == [1], (beam_s, greedy_s)
    torch.testing.assert_close(run["score"], beam_s, rtol=1e-5, atol=1e-5)
    # the greedy prefix of row 1 is missing from the beams at some step
    first, toks, parents = (run["first"].numpy(), run["toks"].numpy(),
                            run["parents"].numpy())
    beams = [[int(first[1, j])] for j in range(2)]
    kept = [int(greedy[1, 0])] in beams
    for i in range(n - 1):
        beams = [beams[int(parents[i, 1, j])] + [int(toks[i, 1, j])]
                 for j in range(2)]
        kept = kept and greedy[1, :i + 2].tolist() in beams
    assert not kept
