"""Speculative decoding in the port (``TransformerLM.speculative_generate``,
``_spec_accept``, ``_propose`` and the ContinuousBatchingEngine with
``draft=``) against the JAX package's on the same weights (the cases of
tests/test_speculative_engine.py and the speculative part of
tests/test_attention.py).

A greedy draft must never change the output: every row equals the lone
``generate`` of both packages and the JAX speculative engine's row,
whatever the draft (a near copy of the target, an unrelated model, the
target itself), under concurrent load, mid-flight admission, prefix
hits and an eos inside an accepted burst. What the draft changes is how
many target calls a row costs. Sampled speculation cannot match JAX's
draws (Philox against threefry): the accept/residual identity is checked
empirically, and sampled serving for well-formed rows.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.serving import ContinuousBatchingEngine as JaxEngine
from bigdl_tpu_torch.models.transformer import TransformerLM, _spec_accept
from bigdl_tpu_torch.serving import (
    ContinuousBatchingEngine, SpeculationPolicy,
)
from bigdl_tpu_torch.utils.weights import load_jax_params

CFG = dict(vocab_size=32, embed_dim=16, num_heads=4, num_kv_heads=2,
           num_layers=2, max_len=48, use_rope=True)


def _pair(seed: int, noise: float = 0.0, **over):
    """A JAX model and the port's twin on its weights; with ``noise`` the
    weights are perturbed (the same perturbation on both sides)."""
    from bigdl_tpu.utils import random as rnd

    rnd.set_seed(seed)
    jm = JaxLM(**{**CFG, **over})
    params = jax.tree.map(np.asarray, jm.params_dict())
    if noise:
        r = np.random.RandomState(seed)
        params = jax.tree.map(
            lambda a: (a + noise * r.randn(*a.shape)).astype(a.dtype),
            params)
        jm.load_params_dict(jax.tree.map(jnp.asarray, params))
    jm.evaluate()
    tm = TransformerLM(**{**CFG, **over}, device="cpu")
    load_jax_params(tm, params)
    tm.evaluate()
    return jm, tm


@pytest.fixture(scope="module")
def lms():
    return _pair(21)


@pytest.fixture(scope="module")
def lm(lms):
    return lms[1]


@pytest.fixture(scope="module")
def near(lms):
    """The target's weights plus small noise: high, imperfect agreement
    (the JAX tests' int8 clone plays this part; int8 waits for its
    step)."""
    return _pair(21, noise=0.002)


@pytest.fixture(scope="module")
def other():
    """Unrelated weights: acceptance collapses."""
    return _pair(99)


def _direct(lm, prompt, n, eos=None):
    want = lm.generate(np.asarray(prompt), n, eos_id=eos)[0].numpy()
    if eos is not None:
        hits = np.flatnonzero(want[len(prompt):] == eos)
        if hits.size:
            want = want[:len(prompt) + hits[0] + 1]
    return want


def _jax_direct(jm, prompt, n):
    return np.asarray(jm.generate(jnp.asarray(prompt)[None], n))[0]


def _serve(eng, reqs):
    rows = [None] * len(reqs)
    errs = []

    def worker(i, p, n):
        try:
            rows[i] = eng.submit(p, n).result(timeout=120)
        except Exception as e:
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i, p, n))
               for i, (p, n) in enumerate(reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not errs, errs
    return rows


# -------------------------------------------------- the primitives
def test_spec_accept_identity_matches_target_distribution():
    """Proposal where accepted, residual where rejected, is distributed
    exactly as the target p (Leviathan Thm 1): 40k trials of one (p, q)
    pair, each bin within 0.02 of p (per-bin standard error < 0.25%)."""
    v, trials, temp = 8, 40000, 0.7
    r = np.random.RandomState(30)
    p_row = r.randn(v) * 1.5
    q_row = r.randn(v) * 1.5
    p_logits = torch.tensor(p_row, dtype=torch.float32).expand(trials, 2, v)
    q_logits = torch.tensor(q_row, dtype=torch.float32).expand(trials, 1, v)
    qdist = torch.softmax(torch.tensor(q_row) / temp, -1).numpy()
    props = torch.from_numpy(r.choice(v, size=(trials, 1), p=qdist))
    gen = torch.Generator().manual_seed(31)
    accept, resid, bonus = _spec_accept(p_logits, q_logits, props, temp,
                                        gen)
    assert accept.shape == resid.shape == (trials, 1)
    assert bonus.shape == (trials,)
    got = torch.where(accept[:, 0], props[:, 0], resid[:, 0]).numpy()
    freq = np.bincount(got, minlength=v) / trials
    want = torch.softmax(torch.tensor(p_row) / temp, -1).numpy()
    np.testing.assert_allclose(freq, want, atol=0.02)
    # the bonus draws from p at position g
    np.testing.assert_allclose(
        np.bincount(bonus.numpy(), minlength=v) / trials, want, atol=0.02)
    # the same generator state gives the same draws
    gen.manual_seed(31)
    again = _spec_accept(p_logits, q_logits, props, temp, gen)
    assert all(torch.equal(a, b) for a, b in zip(again,
                                                 (accept, resid, bonus)))


def test_propose_matches_jax_scan(lms, near):
    """The draft's gamma greedy steps from per-row positions: the
    proposals and step logits of JAX's ``_propose_fn`` scan."""
    jd, td = near
    r = np.random.RandomState(2)
    prompt = r.randint(0, 32, (3, 6))
    jc, tc = jd.init_cache(3, 16), td.init_cache(3, 16)
    jl, jc = jd.prefill(jnp.asarray(prompt), jc)
    tl, tc = td.prefill(prompt, tc)
    tok = np.asarray(jnp.argmax(jl, -1))
    pos = np.asarray([6, 6, 6])
    fn = jd._propose_fn(3, 4)
    jt, jq, _ = fn(jd.params_dict(), jd.buffers_dict(),
                   jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32),
                   jc, jax.random.PRNGKey(0), jnp.float32(1.0))
    tt, tq, _ = td._propose(torch.from_numpy(tok), torch.from_numpy(pos),
                            tc, 4)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("draft", ["self", "near", "other"])
def test_speculative_generate_greedy_is_exact(lms, near, other, draft):
    jm, tm = lms
    jd, td = {"self": lms, "near": near, "other": other}[draft]
    prompt = np.random.RandomState(10).randint(0, 32, (2, 5))
    want = tm.generate(prompt, 12).numpy()
    np.testing.assert_array_equal(want, np.asarray(
        jm.generate(jnp.asarray(prompt), 12)))
    got, st = tm.speculative_generate(prompt, 12, draft=td, gamma=4,
                                      return_stats=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jm.speculative_generate(jnp.asarray(prompt), 12, draft=jd,
                                gamma=4)))
    if draft == "self":
        # every proposal accepted: 1 prefill token + 3 x (4 + 1) >= 12
        assert st == {"rounds": 3, "accept_rate": 1.0}
    elif draft == "other":
        assert st["accept_rate"] < 1.0


def test_tight_context_shrinks_gamma_and_stays_exact():
    _, m = _pair(16, max_len=12)
    prompt = np.asarray([[1, 2, 3, 4]])
    want = m.generate(prompt, 8).numpy()
    # t0 + n == max_len: gamma shrinks to ctx - t0 - n + 1 = 1
    np.testing.assert_array_equal(
        m.speculative_generate(prompt, 8, draft=m, gamma=4).numpy(), want)
    np.testing.assert_array_equal(
        m.speculative_generate(prompt, 8, draft=m, gamma=0).numpy(), want)
    assert m.speculative_generate(prompt, 0, draft=m).shape == (1, 4)


def test_sampled_speculative_generate(lm, other):
    """Sampled: the self-draft accepts (nearly) everything; an unrelated
    draft serves in-vocabulary rows, the same for the same generator
    seed."""
    prompt = np.random.RandomState(16).randint(0, 32, (2, 4))
    gen = torch.Generator().manual_seed(7)
    ids, st = lm.speculative_generate(prompt, 11, draft=lm, gamma=4,
                                      temperature=0.8, generator=gen,
                                      return_stats=True)
    assert ids.shape == (2, 15)
    assert st["accept_rate"] >= 0.9 and st["rounds"] <= 3, st
    rows = [lm.speculative_generate(
        prompt, 9, draft=other[1], gamma=3, temperature=0.9,
        generator=torch.Generator().manual_seed(9)) for _ in range(2)]
    assert torch.equal(rows[0], rows[1])
    assert rows[0].shape == (2, 13)
    assert ((rows[0] >= 0) & (rows[0] < 32)).all()
    assert torch.equal(rows[0][:, :4], torch.from_numpy(prompt))


# ------------------------------------------------------- the engine
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_greedy_parity_concurrent_mixed_length_load(lms, near, paged):
    """Six mixed-length requests through three slots with a near draft:
    every row equals the JAX speculative engine's and both lone
    generates, and the draft pays (accepted proposals)."""
    jm, tm = lms
    r = np.random.RandomState(0)
    reqs = [(r.randint(0, 32, (t0,)), n)
            for t0, n in [(5, 6), (9, 4), (3, 8), (12, 5), (7, 7),
                          (4, 10)]]
    kw = dict(max_slots=3, prefill_chunk=4, spec_gamma=3,
              page_size=4 if paged else None)
    with ContinuousBatchingEngine(tm, draft=near[1], **kw) as eng:
        rows = _serve(eng, reqs)
        st = eng.stats()
    with JaxEngine(jm, draft=near[0], **kw) as jeng:
        jrows = _serve(jeng, reqs)
    for (p, n), row, jrow in zip(reqs, rows, jrows):
        np.testing.assert_array_equal(row, np.asarray(jrow))
        np.testing.assert_array_equal(row, _direct(tm, p, n))
        np.testing.assert_array_equal(row, _jax_direct(jm, p, n))
    sp = st["speculation"]
    assert sp["enabled"] and sp["gamma"] == 3
    assert 0.6 < sp["acceptance_rate"] <= 1.0


def test_unrelated_draft_still_exact(lm, other):
    r = np.random.RandomState(5)
    reqs = [(r.randint(0, 32, (t0,)), n)
            for t0, n in [(4, 8), (10, 6), (6, 9)]]
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                  draft=other[1], spec_gamma=4) as eng:
        rows = [eng.submit(p, n).result(timeout=60) for p, n in reqs]
        sp = eng.stats()["speculation"]
    for (p, n), row in zip(reqs, rows):
        np.testing.assert_array_equal(row, _direct(lm, p, n))
    assert sp["proposed_tokens"] > 0
    assert sp["acceptance_rate"] < 1.0


def test_parity_vs_nonspec_engine_and_stable_storage(lm, near):
    """The speculative engine against the plain engine on the same
    traffic: the same rows; the speculative engine's slot pools (target
    and draft) keep their storage through the run."""
    r = np.random.RandomState(1)
    reqs = [(r.randint(0, 32, (t0,)), n)
            for t0, n in [(6, 8), (11, 5), (4, 12), (8, 7)]]
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4) as ref:
        want = [ref.submit(p, n).result(timeout=60) for p, n in reqs]
    eng = ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                   draft=near[1], spec_gamma=4)
    assert eng._caches[0][0].shape[2] == 48 + 4      # the verify headroom
    tensors = [t for kv in eng._caches + eng._d_caches for t in kv]
    ptrs = [t.data_ptr() for t in tensors]
    with eng:
        got = [eng.submit(p, n).result(timeout=60) for p, n in reqs]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    assert [t.data_ptr() for t in tensors] == ptrs


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_parity_under_prefix_cache_hits_and_midflight(lm, near, paged):
    """A reused target prefix means the draft prefills its own row (the
    target's final chunk replays while the draft catches up): shared-head
    requests, one admitted mid-decode of another, stay exact, and the
    hits happen."""
    head = (np.arange(1, 13, dtype=np.int32) * 5) % 32
    tails = [np.asarray(t, np.int32) for t in
             ([7, 9], [3], [7, 9, 11], [1, 2])]
    prompts = [np.concatenate([head, t]) for t in tails]
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                  draft=near[1], spec_gamma=3,
                                  page_size=4 if paged else None) as eng:
        rows = [eng.submit(prompts[0], 8).result(timeout=60)]
        h_long = eng.submit(prompts[1], 16)
        next(h_long.tokens())
        h_mid = eng.submit(prompts[2], 4)
        rows.append(h_mid.result(timeout=60))
        rows.append(h_long.result(timeout=60))
        rows.append(eng.submit(prompts[3], 6).result(timeout=60))
        st = eng.stats()
    expect = [(prompts[0], 8), (prompts[2], 4), (prompts[1], 16),
              (prompts[3], 6)]
    for (p, n), row in zip(expect, rows):
        np.testing.assert_array_equal(row, _direct(lm, p, n))
    assert st["prefix_cache"]["hits"] >= 1
    assert st["speculation"]["accepted_tokens"] > 0


def test_eos_mid_extension_truncates(lm):
    """An eos inside an accepted burst ends the stream at (and with) the
    eos; the tokens accepted past it are dropped."""
    eos = None
    for seed in range(40):
        p = np.random.RandomState(seed).randint(0, 32, (6,))
        for cand in range(32):
            w = _direct(lm, p, 12, eos=cand)
            gen = w[len(p):]
            # the self-draft's first burst carries generated tokens 1..5:
            # an eos at 2..4 lands inside it, with tokens past it
            if 3 <= len(gen) <= 5 and gen[-1] == cand:
                eos, prompt, want = cand, p, w
                break
        if eos is not None:
            break
    assert eos is not None, "no mid-stream eos found in the scan"
    bursts = []
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                  eos_id=eos, draft=lm,
                                  spec_gamma=4) as eng:
        deliver = eng._deliver_burst

        def spy(sid, toks, now):
            bursts.append(len(toks))
            return deliver(sid, toks, now)

        eng._deliver_burst = spy
        rows = [eng.submit(prompt, 12).result(timeout=60) for _ in range(2)]
    for row in rows:
        np.testing.assert_array_equal(row, want)
    assert rows[0][-1] == eos and len(rows[0]) < len(prompt) + 12
    # the self-draft accepts everything: the eos landed inside a burst
    assert max(bursts) > 1


def test_bursts_and_stats_consistency(lm, near):
    """Each round delivers one burst a row: the bursts of one request sum
    to its decoded tokens after the first, some burst carries several
    tokens, and ``stats()`` and the handle agree on the tallies."""
    bursts = []
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                  draft=near[1], spec_gamma=4) as eng:
        deliver = eng._deliver_burst

        def spy(sid, toks, now):
            bursts.append(len(toks))
            return deliver(sid, toks, now)

        eng._deliver_burst = spy
        p = np.random.RandomState(3).randint(0, 32, (6,))
        h = eng.submit(p, 11)
        row = h.result(timeout=60)
        st = eng.stats()
    np.testing.assert_array_equal(row, _direct(lm, p, 11))
    assert sum(bursts) == 10 and max(bursts) > 1 and len(bursts) < 10
    sp = st["speculation"]
    assert sp["proposed_tokens"] == h.spec_proposed == 4 * len(bursts)
    assert sp["accepted_tokens"] == h.spec_accepted
    assert sp["accepted_tokens"] <= sp["proposed_tokens"]
    assert sp["acceptance_rate"] == pytest.approx(
        sp["accepted_tokens"] / sp["proposed_tokens"], abs=1e-4)
    tl = h.timeline()
    assert tl["spec_proposed"] == h.spec_proposed
    assert st["decode_steps"] == len(bursts)


def test_speculation_policy_and_validation(lm, near):
    """SpeculationPolicy validates gamma; the engine refuses a draft of
    another vocabulary, a draft with a shorter context and top-k/top-p
    with a draft, as the JAX engine does."""
    with pytest.raises(ValueError, match="spec_gamma"):
        SpeculationPolicy(0)
    pol = SpeculationPolicy(5)
    assert pol.verify_len == 6 and pol.kv_headroom == 5
    with pytest.raises(ValueError, match="spec_gamma"):
        ContinuousBatchingEngine(lm, draft=near[1], spec_gamma=0)
    wrong_vocab = TransformerLM(16, embed_dim=16, num_heads=4,
                                num_kv_heads=2, num_layers=1, max_len=48,
                                use_rope=True, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        ContinuousBatchingEngine(lm, draft=wrong_vocab)
    short_ctx = TransformerLM(32, embed_dim=16, num_heads=4,
                              num_kv_heads=2, num_layers=1, max_len=16,
                              use_rope=True, device="cpu")
    with pytest.raises(ValueError, match="context"):
        ContinuousBatchingEngine(lm, draft=short_ctx)
    for kw in ({"top_k": 5}, {"top_p": 0.9}):
        with pytest.raises(ValueError, match="top_k/top_p"):
            ContinuousBatchingEngine(lm, draft=near[1], temperature=0.8,
                                     **kw)
    with ContinuousBatchingEngine(lm, max_slots=1, prefill_chunk=4) as eng:
        assert eng.stats()["speculation"] == {"enabled": False}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_sampled_speculative_serves(lm, near, paged):
    """temperature > 0 with a draft: speculative sampling. Rows are not
    the plain engine's draws, but well formed: the right length, the
    prompt kept, in-vocabulary ids, proposals made."""
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                  temperature=0.8, seed=11, draft=near[1],
                                  spec_gamma=3,
                                  page_size=4 if paged else None) as eng:
        p = np.random.RandomState(6).randint(0, 32, (5,))
        rows = [eng.submit(p, 8).result(timeout=60) for _ in range(3)]
        sp = eng.stats()["speculation"]
    for row in rows:
        assert row.shape == (13,)
        assert ((row >= 0) & (row < 32)).all()
        np.testing.assert_array_equal(row[:5], p)
    assert sp["proposed_tokens"] > 0 and sp["accepted_tokens"] > 0


def test_learned_positions_at_the_window_edge():
    """Learned positions with a draft: a verify round at the window's
    last decodable position reaches past the position table; those
    rejected positions read its last row and are never attended, so the
    rows stay exact (an out-of-range index would raise here)."""
    _, tm = _pair(40, use_rope=False)
    _, td = _pair(41, use_rope=False, num_layers=1)
    r = np.random.RandomState(8)
    reqs = [(r.randint(0, 32, (40,)), 8), (r.randint(0, 32, (30,)), 18)]
    for draft in (tm, td):
        with ContinuousBatchingEngine(tm, max_slots=2, prefill_chunk=8,
                                      draft=draft, spec_gamma=4) as eng:
            rows = _serve(eng, reqs)
        for (p, n), row in zip(reqs, rows):
            np.testing.assert_array_equal(row, _direct(tm, p, n))
