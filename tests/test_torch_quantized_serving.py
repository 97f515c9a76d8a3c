"""Quantized serving in the port: ``ContinuousBatchingEngine(kv_dtype=
"int8", weights_dtype="int8")`` against the JAX engine on the same
weights (the cases of tests/test_quantized_serving.py, the int8 and
tiered paged cases of tests/test_paged_kv.py, and the int8 draft of
tests/test_attention.py).

Within the int8 regime the contract is identity: the port's rows equal
the JAX int8 engine's in the same configuration, row by row, and the
plain, prefix + host tier, paged and speculative engines give the same
rows. A demoted and promoted row (dense or paged) holds exactly the
bytes it held before it left the device: int8 codes and f32 scales are
spilled as they are. Against the float engine the contract is a bounded
drift: ``quantized_quality_report``. At an equal byte budget the int8
engine holds twice the prefix rows at head_dim 4. The mesh, memory-pool,
ledger and perf_gate cases of the JAX file wait for ROADMAP.md Queue 1
items 10 and 11.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.nn.attention import quantize_kv as jax_quantize_kv
from bigdl_tpu.nn.quantized import Quantizer as JaxQuantizer
from bigdl_tpu.serving import ContinuousBatchingEngine as JaxEngine
from bigdl_tpu.serving import benchmark as jbench
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.nn import attention as tattn
from bigdl_tpu_torch.nn.attention import dequantize_kv, quantize_kv
from bigdl_tpu_torch.nn.quantized import Quantizer
from bigdl_tpu_torch.serving import ContinuousBatchingEngine
from bigdl_tpu_torch.serving import benchmark as tbench
from bigdl_tpu_torch.utils.weights import load_jax_params

CFG = dict(vocab_size=32, embed_dim=16, num_heads=4, num_kv_heads=2,
           num_layers=2, max_len=48, use_rope=True)
INT8 = dict(kv_dtype="int8", weights_dtype="int8")


def _pair(seed, **over):
    from bigdl_tpu.utils import random as rnd

    rnd.set_seed(seed)
    jm = JaxLM(**{**CFG, **over})
    jm.evaluate()
    tm = TransformerLM(**{**CFG, **over}, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    tm.evaluate()
    return jm, tm


@pytest.fixture(scope="module")
def lms():
    return _pair(21)


@pytest.fixture(scope="module")
def lm(lms):
    return lms[1]


@pytest.fixture(scope="module")
def drafts(lms):
    """The int8 clone of the target, both packages'."""
    jd, td = JaxQuantizer.quantize(lms[0]), Quantizer.quantize(lms[1])
    jd.evaluate()
    td.evaluate()
    return jd, td


def _direct(lm, prompt, n):
    return lm.generate(np.asarray(prompt), n)[0].numpy()


def _cycle_requests(rstate, templates, rounds, tail=2, decode=4):
    """Round-robin template traffic: with a one-row pool every revisit
    forces a demote and a promote."""
    reqs = []
    for i in range(rounds * len(templates)):
        tpl = templates[i % len(templates)]
        reqs.append((np.concatenate(
            [tpl, rstate.randint(0, 32, (tail + i % 2,))]),
            decode + i % 3))
    return reqs


def _serve_in_turn(eng, reqs):
    """One request at a time: the batch each Linear sees (idle lanes
    included) is then the same in both packages."""
    return [np.asarray(eng.submit(p, n).result(timeout=120))
            for p, n in reqs]


def _serve_at_once(eng, reqs):
    rows, errs = [None] * len(reqs), []

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
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    return rows


def _host_tree(tree, row):
    return [tuple(t[row].clone() for t in layer) for layer in tree]


def _assert_same_tree(a, b):
    for la, lb in zip(a, b):
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x, y)


# ------------------------------------------------------ numerics units
def test_quantize_roundtrip_deterministic_and_bounded():
    """The roundtrip error stays within half a step of each slice's own
    scale, re-quantizing the dequantized values is a fixed point, an
    all-zero slice maps to scale 1/127, and the bytes are JAX's."""
    r = np.random.RandomState(0)
    x = torch.from_numpy(r.randn(2, 3, 5, 4).astype(np.float32)) * 3.0
    q, s = quantize_kv(x)
    assert q.dtype == torch.int8 and s.shape == (2, 3, 5, 1)
    back = dequantize_kv(q, s)
    assert (back - x).abs().max().item() <= s.max().item() * 0.5 + 1e-7
    q2, s2 = quantize_kv(back)
    assert torch.equal(q, q2) and torch.equal(s, s2)
    jq_, js = jax_quantize_kv(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    zq, zs = quantize_kv(torch.zeros(1, 1, 2, 4))
    assert zq.abs().max().item() == 0
    np.testing.assert_allclose(zs.numpy(), 1.0 / 127.0)


def test_init_cache_int8_shape_and_bytes(lms):
    """``init_cache(kv_dtype="int8")`` gives per-layer 4-tuples of JAX's
    shapes and dtypes, (D + 4) / (4 D) of the float bytes (0.5 at
    head_dim 4); an unknown kv_dtype raises."""
    jm, lm = lms
    fp = lm.init_cache(2, 16)
    q8 = lm.init_cache(2, 16, kv_dtype="int8")
    j8 = jm.init_cache(2, 16, kv_dtype="int8")
    assert len(fp[0]) == 2 and len(q8[0]) == 4
    for ours, theirs in zip(q8[0], j8[0]):
        assert tuple(ours.shape) == theirs.shape
        assert str(ours.dtype).split(".")[-1] == str(theirs.dtype)
    k_q, _, k_s, _ = q8[0]
    assert k_s.shape == k_q.shape[:-1] + (1,)
    bytes_fp = sum(t.nbytes for layer in fp for t in layer)
    bytes_q8 = sum(t.nbytes for layer in q8 for t in layer)
    d = lm.block0.attn.head_dim
    assert bytes_q8 / bytes_fp == (d + 4) / (4 * d) == 0.5
    with pytest.raises(ValueError, match="kv_dtype"):
        lm.init_cache(2, 16, kv_dtype="int4")


def test_engine_dtype_validation(lm):
    with pytest.raises(ValueError, match="kv_dtype"):
        ContinuousBatchingEngine(lm, max_slots=2, kv_dtype="fp8")
    with pytest.raises(ValueError, match="weights_dtype"):
        ContinuousBatchingEngine(lm, max_slots=2, weights_dtype="int4")


# ------------------------------------------- quality vs the float path
def test_logit_divergence_and_greedy_match(lms):
    """Teacher-forced int8 logits track the float logits within a
    scale-free ceiling, the free-running greedy prefix agrees on short
    horizons, the report is deterministic, and it is the JAX report:
    the same greedy agreement, divergences within 1e-4 (the float
    logits of the two packages differ in the last bits)."""
    jm, lm = lms
    rep = tbench.quantized_quality_report(lm, horizon=8, n_prompts=4,
                                          seed=3)
    assert rep["kv_dtype"] == "int8"
    assert rep["logit_div_rel"] < 0.2, rep
    assert rep["logit_div_max"] > 0.0          # int8 really ran
    assert rep["greedy_match_fraction"] >= 0.5, rep
    assert rep == tbench.quantized_quality_report(lm, horizon=8,
                                                  n_prompts=4, seed=3)
    rep = tbench.quantized_quality_report(lm, horizon=6, n_prompts=2,
                                          seed=3)
    jrep = jbench.quantized_quality_report(jm, horizon=6, n_prompts=2,
                                           seed=3)
    assert rep["greedy_match_fraction"] == jrep["greedy_match_fraction"]
    for key in ("logit_div_max", "logit_div_mean", "logit_div_rel"):
        assert rep[key] == pytest.approx(jrep[key], abs=1e-4), key


# ------------------------------------ engine invariants, int8 regime
def test_int8_regime_parity(lms, drafts):
    """The tentpole invariant: within the int8 regime the engine's
    machinery changes no token. One template workload through (a) the
    plain int8 engine, (b) int8 + prefix cache + host tier (hits,
    misses, donations, demotions and promotions all fire), (c) int8 +
    speculation under the int8 draft: the same rows, and (a) equals the
    JAX int8 engine row by row."""
    jm, lm = lms
    r = np.random.RandomState(41)
    tpls = [r.randint(0, 32, (8,)) for _ in range(3)]
    reqs = _cycle_requests(r, tpls, rounds=3)

    def run(model, engine, **kw):
        with engine(model, max_slots=2, prefill_chunk=4, **INT8,
                    **kw) as eng:
            rows = _serve_in_turn(eng, reqs)
            return rows, eng.stats()

    rows_plain, st_plain = run(lm, ContinuousBatchingEngine,
                               prefix_cache_bytes=0)
    rows_tier, st_tier = run(lm, ContinuousBatchingEngine,
                             prefix_cache_rows=1, prefix_host_rows=8)
    rows_spec, st_spec = run(lm, ContinuousBatchingEngine,
                             prefix_cache_bytes=0, draft=drafts[1],
                             spec_gamma=3)
    rows_jax, _ = run(jm, JaxEngine, prefix_cache_bytes=0)
    for a, b, c, j in zip(rows_plain, rows_tier, rows_spec, rows_jax):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(a, j)
    pc = st_tier["prefix_cache"]
    assert pc["demotions"] >= 2 and pc["promotions"] >= 2, pc
    assert pc["host_hits"] >= 2, pc
    assert st_spec["speculation"]["proposed_tokens"] > 0
    assert st_spec["speculation"]["accepted_tokens"] > 0
    qz = st_plain["quantization"]
    assert qz["kv_dtype"] == "int8" and qz["weights_dtype"] == "int8"


# (paged, prefix rows, host rows, kv_dtype, weights_dtype)
JAX_CASES = {
    "dense-kv": (None, 0, 0, "int8", None),
    "dense-weights": (None, 0, 0, None, "int8"),
    "dense-both-tier": (None, 1, 8, "int8", "int8"),
    "paged-both": (4, 0, 0, "int8", "int8"),
    "paged-both-prefix": (4, 4, 4, "int8", "int8"),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_int8_engine_rows_equal_the_jax_engine(lms, case):
    """The port's int8 engine against the JAX int8 engine on one
    template workload, row by row, token by token: int8 KV, int8
    weights or both, dense or paged, with the prefix cache and its host
    tier. Requests go one at a time so each batched Linear input (idle
    lanes included) is the same in both packages."""
    jm, lm = lms
    page_size, rows_cap, host, kv, wd = JAX_CASES[case]
    kw = dict(max_slots=2, prefill_chunk=4, kv_dtype=kv, weights_dtype=wd,
              page_size=page_size, prefix_cache_rows=rows_cap,
              prefix_host_rows=host)
    r = np.random.RandomState(47)
    tpls = [r.randint(0, 32, (8,)) for _ in range(2)]
    reqs = _cycle_requests(r, tpls, rounds=2)
    with ContinuousBatchingEngine(lm, **kw) as eng:
        rows = _serve_in_turn(eng, reqs)
        st = eng.stats()
    with JaxEngine(jm, **kw) as jeng:
        jrows = _serve_in_turn(jeng, reqs)
        jst = jeng.stats()
    for row, jrow in zip(rows, jrows):
        np.testing.assert_array_equal(row, jrow)
    assert st["quantization"] == jst["quantization"]
    for key in ("hits", "misses", "demotions", "promotions", "host_hits"):
        assert st["prefix_cache"].get(key) == \
            jst["prefix_cache"].get(key), key


def test_demote_promote_bit_identical(lm):
    """A quantized row spilled to host holds the int8 codes and the f32
    scales (no dequantized copy: the host bytes are the int8 row's), it
    lands back in the pool exactly as it left, and a revisit promotes
    and reuses it with the row of an engine that never demoted."""
    r = np.random.RandomState(42)
    tpls = [r.randint(0, 32, (8,)) for _ in range(2)]
    prompts = [np.concatenate([t, r.randint(0, 32, (2,))]) for t in tpls]
    p = np.concatenate([tpls[0], r.randint(0, 32, (2,))])
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                  kv_dtype="int8", prefix_cache_rows=1,
                                  prefix_host_rows=4) as eng:
        eng.submit(prompts[0], 3).result(timeout=60)
        with torch.inference_mode():
            before = _host_tree(eng._pool, 0)     # tpl 0's row, on device
        eng.submit(prompts[1], 3).result(timeout=60)
        pc = eng._prefix
        assert pc.stats()["demotions"] >= 1
        entry = next(e for e in pc._host_entries if e.host_buf is not None)
        leaves = [t for layer in entry.host_buf for t in layer]
        assert {t.dtype for t in leaves} == {torch.int8, torch.float32}
        assert sum(t.nbytes for t in leaves) == eng._row_bytes \
            < eng._fp_row_bytes
        _assert_same_tree(entry.host_buf, before)
        landed = []
        real_promote = pc.promote

        def promote(e, row):
            with torch.inference_mode():
                landed.append(_host_tree(eng._pool, row))
            return real_promote(e, row)

        pc.promote = promote
        row = eng.submit(p, 3).result(timeout=60)
        assert pc.stats()["promotions"] >= 1
        _assert_same_tree(landed[0], before)
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                  kv_dtype="int8",
                                  prefix_cache_rows=8) as ref:
        for q in prompts:
            ref.submit(q, 3).result(timeout=60)
        want = ref.submit(p, 3).result(timeout=60)
    np.testing.assert_array_equal(row, want)


def test_paged_demote_promote_bit_identical(lms):
    """Paged: a pool too small to keep every template's pages demotes
    entries page by page under reclaim and promotes them back into
    fresh pages; each promoted page holds the bytes it held before the
    spill, and every row equals an unpressured paged engine's and the
    JAX engine's (int8 KV and weights)."""
    jm, lm = lms
    r = np.random.RandomState(41)
    tpls = [r.randint(0, 32, (8,)) for _ in range(3)]
    reqs = _cycle_requests(r, tpls, rounds=3)
    kw = dict(max_slots=2, prefill_chunk=4, page_size=4, **INT8,
              prefix_cache_rows=4)
    eng = ContinuousBatchingEngine(lm, max_pages=14, prefix_host_rows=4,
                                   **kw)
    spilled, checked = {}, []
    real_spill = eng._spill
    real_promote = eng._prefix.promote_pages

    def spill(pages):
        with torch.inference_mode():
            snap = [_host_tree(eng._kv_pool, p) for p in pages]
        buf = real_spill(pages)
        if buf is not None:
            spilled[id(buf)] = snap
        return buf

    def promote_pages(entry, pages):
        snap = spilled[id(entry.host_buf)]
        with torch.inference_mode():
            for p, want in zip(pages, snap):
                _assert_same_tree(_host_tree(eng._kv_pool, p), want)
        checked.append(len(pages))
        return real_promote(entry, pages)

    eng._spill = spill
    eng._prefix.promote_pages = promote_pages
    with eng:
        rows = _serve_in_turn(eng, reqs)
        pc = eng.stats()["prefix_cache"]
    assert pc["demotions"] >= 2 and pc["promotions"] >= 2, pc
    assert len(checked) == pc["promotions"]
    assert eng._pages.pages_in_use == 0
    with ContinuousBatchingEngine(lm, **kw) as ref:
        want = _serve_in_turn(ref, reqs)
    with JaxEngine(jm, **kw) as jref:
        jwant = _serve_in_turn(jref, reqs)
    for row, a, b in zip(rows, want, jwant):
        np.testing.assert_array_equal(row, a)
        np.testing.assert_array_equal(row, b)


def test_spec_acceptance_delta_bounded(lm, drafts):
    """Quantizing the cache does not change how often the target agrees
    with its draft by much: float KV against int8 KV under the same
    int8 draft and traffic."""
    r = np.random.RandomState(44)
    motifs = [np.tile(r.randint(0, 32, (4,)), 3) for _ in range(4)]
    reqs = [(m, 8) for m in motifs for _ in range(2)]

    def acceptance(**kw):
        with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                      draft=drafts[1], spec_gamma=4,
                                      **kw) as eng:
            _serve_in_turn(eng, reqs)
            sp = eng.stats()["speculation"]
        assert sp["proposed_tokens"] > 0
        return sp["accepted_tokens"] / sp["proposed_tokens"]

    assert abs(acceptance() - acceptance(kv_dtype="int8")) < 0.25


# ----------------------------------------------- capacity and honesty
def test_capacity_doubles_at_equal_byte_budget(lm):
    """At the same ``prefix_cache_bytes`` the int8 engine holds twice the
    pool rows (head_dim 4: the row ratio is exactly 0.5), and the row
    bytes count the scales."""
    with ContinuousBatchingEngine(lm, max_slots=2,
                                  prefill_chunk=4) as fp_eng:
        fp_bytes = fp_eng.stats()["quantization"]["kv_row_bytes"]
    budget = 4 * fp_bytes
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                  prefix_cache_bytes=budget) as e2:
        fp_rows = e2.stats()["prefix_cache"]["rows"]
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                  kv_dtype="int8",
                                  prefix_cache_bytes=budget) as q_eng:
        qz = q_eng.stats()["quantization"]
        q_rows = q_eng.stats()["prefix_cache"]["rows"]
        slot_bytes = sum(t.nbytes for layer in q_eng._caches
                         for t in layer)
    assert slot_bytes == 2 * qz["kv_row_bytes"]
    assert qz["row_bytes_ratio"] == 0.5
    assert qz["kv_row_bytes"] * 2 == qz["fp_row_bytes"] == fp_bytes
    assert fp_rows == 4 and q_rows == 8


def test_weights_only_quantization(lm):
    """``weights_dtype="int8"`` alone: the engine serves the int8 clone
    (the model keeps its float weights), the KV pools stay float, and
    greedy rows repeat."""
    p = np.random.RandomState(45).randint(0, 32, (6,))
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                  weights_dtype="int8") as eng:
        qz = eng.stats()["quantization"]
        assert qz == {**qz, "kv_dtype": "fp", "weights_dtype": "int8",
                      "row_bytes_ratio": 1.0}
        assert eng.model is not lm
        assert hasattr(eng.model.block0.attn.qkv, "weight_q")
        assert eng._caches[0][0].dtype == torch.float32
        row1 = eng.submit(p, 5).result(timeout=60)
        row2 = eng.submit(p, 5).result(timeout=60)
    assert hasattr(lm.block0.attn.qkv, "weight")
    np.testing.assert_array_equal(row1, row2)


# ------------------------------------------------------------- bench
def test_run_quantized_comparison_smoke(lm):
    """The five-leg comparison: both parity flags hold (speculation never
    changes tokens within a numerics regime), the capacity block shows
    the halved row, and the cost model's pair is named as waiting."""
    res = tbench.run_quantized_comparison(lm, n_requests=6, rate_hz=50.0,
                                          max_slots=2, prefill_chunk=4,
                                          prefill_rows=2, gamma=3, seed=11)
    assert res["token_parity_spec_fp"] is True
    assert res["token_parity_spec_int8"] is True
    assert res["workload"]["kind"] == "quantized"
    assert res["capacity"]["row_bytes_ratio"] == 0.5
    assert res["capacity"]["capacity_multiplier"] == 2.0
    assert res["quality"]["logit_div_rel"] is not None
    assert res["quality"]["acceptance_delta"] is not None
    assert res["quantized"]["quantization"]["kv_dtype"] == "int8"
    assert res["fp_baseline"]["quantization"]["kv_dtype"] == "fp"
    assert res["membw_util"]["fp"] is None
    assert "item 11" in res["membw_util"]["waits_for"]
    assert len(res["quantized"]["rows"]) == 6


def test_speculative_comparison_defaults_to_the_int8_draft(lm):
    """``run_speculative_comparison`` without a draft proposes with the
    int8 clone of the model: it proposes, mostly agrees with the float
    target, and greedy speculation keeps the rows of plain decode."""
    res = tbench.run_speculative_comparison(lm, n_requests=4, rate_hz=50.0,
                                            max_slots=2, prefill_chunk=4,
                                            prefill_rows=1, gamma=3, seed=5)
    sp = res["spec"]["speculation"]
    assert sp["enabled"] and sp["proposed_tokens"] > 0
    assert res["acceptance_rate"] > 0.5
    assert res["token_parity"] is True


# --------------------------- tests/test_paged_kv.py, int8 and tiered
def _paged_parity_run(lms, reqs, **engine_kw):
    """Mixed-length concurrent load through a 2-slot paged engine, port
    and JAX: every row equals the JAX engine's and the lone generate,
    and the pool drains to empty."""
    jm, lm = lms
    kw = dict(max_slots=2, prefill_chunk=4, page_size=4, **engine_kw)
    with ContinuousBatchingEngine(lm, **kw) as eng:
        rows = _serve_at_once(eng, reqs)
    s = eng._pages.stats()
    assert s["pages_in_use"] == 0
    assert s["allocated_total"] == s["freed_total"]
    with JaxEngine(jm, **kw) as jeng:
        jrows = _serve_at_once(jeng, reqs)
    for (p, n), row, jrow in zip(reqs, rows, jrows):
        np.testing.assert_array_equal(row, np.asarray(jrow))
        np.testing.assert_array_equal(row, _direct(lm, p, n))


def _mixed_reqs(seed=0, vocab=32):
    r = np.random.RandomState(seed)
    lens = [(5, 6), (9, 4), (3, 9), (13, 5), (7, 7), (4, 11)]
    return [(r.randint(0, vocab, (t0,)), n) for t0, n in lens]


def test_paged_parity_tiered(lms):
    _paged_parity_run(lms, _mixed_reqs(2), prefix_cache_rows=4,
                      prefix_host_rows=4)


def test_paged_parity_quantized_kv(lms):
    """int8 KV pages with their scales: greedy rows stay the float
    oracle's at this model scale, and the JAX engine's."""
    _paged_parity_run(lms, _mixed_reqs(4), prefix_cache_rows=0,
                      kv_dtype="int8")


def test_int8_pool_live_rows_never_share_a_write(lm, drafts, monkeypatch):
    """The int8 page pool: every scatter the engine makes writes codes
    and scales through one (page, offset) per token, no two rows of a
    call write the same (page, offset) off the scratch page, and no
    written page is shared at the time, under prefix hits and the int8
    draft."""
    real = tattn._write_kv_paged
    r = np.random.RandomState(9)
    head = r.randint(0, 32, (12,))
    reqs = [(np.concatenate([head, r.randint(0, 32, (k,))]), n)
            for k, n in ((3, 6), (5, 9), (1, 7), (6, 5))]
    eng = ContinuousBatchingEngine(
        lm, max_slots=3, prefill_chunk=4, prefill_rows=2, page_size=4,
        prefix_cache_rows=4, draft=drafts[1], spec_gamma=3, **INT8)
    codes0 = eng._kv_pool[0][0]
    refcounts, forms = [], set()

    def spy(pool, k_t, v_t, tables, positions):
        forms.add(len(pool))
        pos = positions[:, None] if positions.dim() == 1 else positions
        pages = torch.gather(tables, 1, pos // 4)
        seen = {}
        for row in range(pages.shape[0]):
            for pg, off in zip(pages[row].tolist(), (pos[row] % 4).tolist()):
                if pg == 0:
                    continue
                assert seen.setdefault((pg, off), row) == row
                if pool[0] is codes0:
                    refcounts.append(eng._pages.refcount(pg))
        out = real(pool, k_t, v_t, tables, positions)
        # each token's codes AND scales sit at its (page, offset)
        (kq, ks), (vq, vs) = quantize_kv(k_t), quantize_kv(v_t)
        for row in range(pages.shape[0]):
            for t, (pg, off) in enumerate(zip(pages[row].tolist(),
                                              (pos[row] % 4).tolist())):
                if pg == 0:
                    continue
                for buf, blk in zip(pool, (kq, vq, ks, vs)):
                    assert torch.equal(buf[pg, :, off], blk[row, :, t])
        return out

    monkeypatch.setattr(tattn, "_write_kv_paged", spy)
    with eng:
        first = eng.submit(*reqs[0]).result(timeout=60)
        rows = [first] + _serve_at_once(eng, reqs[1:])
        hits = eng.stats()["prefix_cache"]["hits"]
    assert forms == {4}
    assert hits >= 1
    assert refcounts and max(refcounts) == 1
    assert eng._pages.pages_in_use == 0
    assert all(row.shape == (len(p) + n,) for (p, n), row in zip(reqs, rows))


def test_paged_chunk_duplicates_carry_the_last_writers_value(monkeypatch):
    """A chunk whose writes collide on one (page, offset) (an idle lane
    wrapping onto the scratch page, a padded tail past a reservation)
    hands every colliding write the value of the last writer in (row,
    position) order, so the stored result does not depend on the order
    in which the device applies duplicate writes; a decode step writes
    as it is."""
    writes = []
    real = torch.Tensor.__setitem__

    def spy(self, key, value):
        writes.append((key, value.clone()))
        return real(self, key, value)

    r = np.random.RandomState(3)
    tables = torch.tensor([[3, 4, 0, 0], [0, 0, 0, 0]])   # row 1 idle
    pool = tuple(torch.zeros(5, 2, 4, 8) for _ in range(2))
    k = torch.from_numpy(r.randn(2, 2, 12, 8).astype(np.float32))
    positions = torch.arange(12)[None].repeat(2, 1)       # row 0: tail
    monkeypatch.setattr(torch.Tensor, "__setitem__", spy)
    tattn._write_kv_paged(pool, k, k, tables, positions)
    monkeypatch.undo()
    (pg, _, off), vals = writes[0]
    seen = {}
    for target, val in zip(zip(pg.reshape(-1).tolist(),
                               off.reshape(-1).tolist()),
                           vals.reshape(-1, 2, 8)):
        assert torch.equal(seen.setdefault(target, val), val), target
    # the last writer of (page 0, offset 0): row 1, position 8
    assert torch.equal(pool[0][0, :, 0], k[1, :, 8])
    assert torch.equal(pool[0][3, :, 1], k[0, :, 1])


# -------------------- tests/test_attention.py::TestSpeculativeDecoding
class TestSpeculativeDecoding:
    def test_quantized_draft_exact(self):
        """The int8 clone as the draft of its own float model: the
        speculative rows are exactly greedy ``generate``'s."""
        from bigdl_tpu.utils import random as rnd

        rnd.set_seed(17)
        jm = JaxLM(**CFG)
        m = TransformerLM(**CFG, device="cpu")
        load_jax_params(m, jax.tree.map(np.asarray, jm.params_dict()))
        m.evaluate()
        d = Quantizer.quantize(m)
        d.evaluate()
        prompt = np.random.RandomState(12).randint(0, 32, (2, 6))
        want = m.generate(prompt, 9).numpy()
        np.testing.assert_array_equal(
            m.speculative_generate(prompt, 9, draft=d, gamma=4).numpy(),
            want)
        np.testing.assert_array_equal(
            want, np.asarray(jm.generate(jnp.asarray(prompt), 9)))
