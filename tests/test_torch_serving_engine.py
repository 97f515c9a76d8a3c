"""The port's ContinuousBatchingEngine (bigdl_tpu_torch/serving/engine.py)
against the JAX package's on the same weights (the small f32 model of
tests/test_serving_engine.py).

The contract: every greedy row the engine serves equals, token for token
and with no tolerance, the port's lone ``generate``, the JAX engine's row
and the JAX package's lone ``generate``: under concurrent mixed-length
load, through mid-flight admission into recycled slots, and with the
slot pool, staging and prefix-pool tensors the same objects before and
after a run (the port's counterpart of the JAX engine's flat jit gauge).
Plus the control paths: timeouts (queued and mid-decode), cancellation,
streaming order, backpressure, validation, sampled mode (valid ids and
the top-k filter: the port's generator never reproduces JAX's draws),
the options of later steps raising, and ``prefill_chunk_at`` against
JAX's at 1e-5 with RoPE and learned positions and ragged offsets.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.serving import ContinuousBatchingEngine as JaxEngine
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.serving import (
    ContinuousBatchingEngine, QueueFull, RequestCancelled, RequestTimedOut,
)
from bigdl_tpu_torch.utils.weights import load_jax_params

CFG = dict(vocab_size=32, embed_dim=16, num_heads=4, num_kv_heads=2,
           num_layers=2, max_len=48)


def _pair(use_rope: bool, seed: int):
    from bigdl_tpu.utils import random as rnd

    rnd.set_seed(seed)
    jm = JaxLM(**CFG, use_rope=use_rope)
    jm.evaluate()
    tm = TransformerLM(**CFG, use_rope=use_rope, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    tm.evaluate()
    return jm, tm


@pytest.fixture(scope="module")
def lms():
    return _pair(True, 21)


@pytest.fixture(scope="module")
def lm(lms):
    return lms[1]


def _direct(lm, prompt, n, eos=None):
    """The port's per-request oracle: a lone greedy generate, trimmed at
    the first eos (the engine stops there)."""
    want = lm.generate(np.asarray(prompt), n, eos_id=eos)[0].numpy()
    if eos is not None:
        hits = np.flatnonzero(want[len(prompt):] == eos)
        if hits.size:
            want = want[:len(prompt) + hits[0] + 1]
    return want


def _jax_direct(jm, prompt, n):
    return np.asarray(jm.generate(jnp.asarray(prompt)[None], n))[0]


def _serve_concurrently(eng, reqs):
    rows = [None] * len(reqs)
    errs = []

    def worker(i, p, n):
        try:
            rows[i] = eng.submit(p, n).result(timeout=60)
        except Exception as e:
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i, p, n))
               for i, (p, n) in enumerate(reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    return rows


def test_greedy_parity_concurrent_mixed_length_load_against_jax(lms):
    """Six mixed-length requests through three slots from concurrent
    client threads: every row equals the port's lone generate, the JAX
    engine's row and JAX's lone generate."""
    jm, tm = lms
    r = np.random.RandomState(0)
    reqs = [(r.randint(0, 32, (t0,)), n)
            for t0, n in [(5, 6), (9, 4), (3, 8), (12, 5), (7, 7),
                          (4, 10)]]
    with ContinuousBatchingEngine(tm, max_slots=3,
                                  prefill_chunk=4) as eng:
        rows = _serve_concurrently(eng, reqs)
    with JaxEngine(jm, max_slots=3, prefill_chunk=4) as jeng:
        jrows = _serve_concurrently(jeng, reqs)
    for (p, n), row, jrow in zip(reqs, rows, jrows):
        np.testing.assert_array_equal(row, _direct(tm, p, n))
        np.testing.assert_array_equal(row, np.asarray(jrow))
        np.testing.assert_array_equal(row, _jax_direct(jm, p, n))
    s = eng.stats()
    assert s["admitted"] == 6 and s["finished"] == 6
    assert s["evicted"] == 6 and s["active_slots"] == 0
    assert s["decode_steps"] >= 1 and s["prefill_rounds"] >= 1
    assert s["latency"]["ttft"]["count"] == 6


def test_midflight_admission_keeps_device_tensors(lm):
    """A short request admitted while a long one decodes finishes first
    (its slot turns over mid-flight), and the slot pool, staging and
    prefix-pool tensors are the same storage before and after: the loop
    writes them in place and never reallocates."""
    r = np.random.RandomState(1)
    with ContinuousBatchingEngine(lm, max_slots=2,
                                  prefill_chunk=4) as eng:
        ptrs = [k.data_ptr() for tree in (eng._caches, eng._staging,
                                          eng._pool)
                for kv in tree for k in kv]
        warm_p = r.randint(0, 32, (6,))
        np.testing.assert_array_equal(eng.submit(warm_p, 3).result(60),
                                      _direct(lm, warm_p, 3))
        long_p, short_p = r.randint(0, 32, (4,)), r.randint(0, 32, (5,))
        h_long = eng.submit(long_p, 32)
        it = h_long.tokens()
        next(it)                       # the long request is decoding
        h_short = eng.submit(short_p, 3)
        np.testing.assert_array_equal(h_short.result(timeout=60),
                                      _direct(lm, short_p, 3))
        np.testing.assert_array_equal(h_long.result(timeout=60),
                                      _direct(lm, long_p, 32))
        assert h_short.finished_at < h_long.finished_at, \
            "short request must not wait for the long one's batch"
        assert ptrs == [k.data_ptr() for tree in (eng._caches,
                                                  eng._staging, eng._pool)
                        for kv in tree for k in kv]


def test_slot_reuse_after_eviction(lms):
    """max_slots=1: each request runs only by reusing the previous one's
    slot and staging row, each shorter than the KV its predecessor left;
    that stale KV must not reach its tokens."""
    jm, tm = lms
    r = np.random.RandomState(2)
    reqs = [(r.randint(0, 32, (t0,)), n)
            for t0, n in ((12, 8), (3, 9), (9, 6), (2, 10))]
    with ContinuousBatchingEngine(tm, max_slots=1,
                                  prefill_chunk=4) as eng:
        handles = [eng.submit(p, n) for p, n in reqs]
        for h, (p, n) in zip(handles, reqs):
            row = h.result(timeout=60)
            np.testing.assert_array_equal(row, _direct(tm, p, n))
            np.testing.assert_array_equal(row, _jax_direct(jm, p, n))
    assert eng.stats()["evicted"] == len(reqs)


def test_eos_stops_row_and_frees_slot(lm):
    """With eos_id the engine stops at (and includes) the first eos: the
    row is generate's with the eos-padding tail trimmed."""
    p = np.asarray([1, 2, 3, 4])
    plain = lm.generate(p, 8)[0].numpy()
    eos = int(plain[len(p) + 1])     # the model's own 2nd greedy token
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                  eos_id=eos) as eng:
        row = eng.submit(p, 8).result(timeout=60)
    np.testing.assert_array_equal(row, _direct(lm, p, 8, eos=eos))
    assert row.shape[0] < len(p) + 8
    assert eng.stats()["active_slots"] == 0


def test_timeout_paths(lm):
    """Deadlines both in the queue (the slot never frees in time) and for
    an admitted request (evicted mid-decode, partial output kept)."""
    r = np.random.RandomState(3)
    p = r.randint(0, 32, (4,))
    with ContinuousBatchingEngine(lm, max_slots=1,
                                  prefill_chunk=4) as eng:
        h_long = eng.submit(p, 40)
        h_q = eng.submit(r.randint(0, 32, (5,)), 4, timeout_s=0.0)
        with pytest.raises(RequestTimedOut, match="queue"):
            h_q.result(timeout=60)
        assert h_long.result(timeout=60).shape == (44,)

        h_run = eng.submit(p, 40, timeout_s=600.0)
        it = h_run.tokens()
        next(it)
        h_run.deadline = time.monotonic() - 1.0
        with pytest.raises(RequestTimedOut, match="mid-decode"):
            h_run.result(timeout=60)
        assert 1 <= h_run.tokens_so_far().shape[0] < 40
    assert eng.stats()["timed_out"] == 2


def test_cancellation_queued_and_running(lm):
    r = np.random.RandomState(4)
    p = r.randint(0, 32, (4,))
    with ContinuousBatchingEngine(lm, max_slots=1,
                                  prefill_chunk=4) as eng:
        h = eng.submit(p, 40)
        it = h.tokens()
        first = next(it)
        h.cancel()
        with pytest.raises(RequestCancelled):
            for _ in it:
                pass
        assert h.tokens_so_far().shape[0] >= 1
        assert h.tokens_so_far()[0] == first

        h_long = eng.submit(p, 24)
        h_c = eng.submit(r.randint(0, 32, (6,)), 4)
        h_c.cancel()
        with pytest.raises(RequestCancelled):
            h_c.result(timeout=60)
        np.testing.assert_array_equal(h_long.result(timeout=60),
                                      _direct(lm, p, 24))
    s = eng.stats()
    assert s["cancelled"] == 2 and s["finished"] == 1


def test_streaming_iterator_ordering(lm):
    """tokens() yields exactly the generated suffix in order, and
    result() agrees with the streamed sequence."""
    p = np.asarray([3, 1, 4, 1, 5])
    with ContinuousBatchingEngine(lm, max_slots=2,
                                  prefill_chunk=4) as eng:
        h = eng.submit(p, 10, tenant="t1", priority="low", trace_id="x1")
        streamed = list(h.tokens())
        row = h.result(timeout=60)
    assert len(streamed) == 10
    assert streamed == row[len(p):].tolist()
    np.testing.assert_array_equal(row, _direct(lm, p, 10))
    assert h.first_token_at is not None \
        and h.first_token_at <= h.finished_at
    assert (h.tenant, h.priority, h.trace_id) == ("t1", "low", "x1")
    u = h.usage()
    assert (u["outcome"], u["tenant"], u["decode_tokens"]) == \
        ("finished", "t1", 10)
    assert h.request_id.startswith("req-")


def test_backpressure_queue_full(lm):
    r = np.random.RandomState(5)
    p = r.randint(0, 32, (4,))
    with ContinuousBatchingEngine(lm, max_slots=1, prefill_chunk=4,
                                  queue_capacity=1) as eng:
        h_long = eng.submit(p, 30)
        it = h_long.tokens()
        next(it)          # admitted: the queue is empty, the slot busy
        eng.submit(p, 4)  # fills the 1-deep queue
        with pytest.raises(QueueFull):
            eng.submit(p, 4, block=False)
        with pytest.raises(QueueFull):
            eng.submit(p, 4, queue_timeout_s=0.01)


def test_validation_and_sampled_mode(lm):
    eng = ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4)
    with pytest.raises(ValueError, match="1-D"):
        eng.submit(np.ones((2, 3), np.int32), 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(np.asarray([1, 2]), 0)
    with pytest.raises(ValueError, match="serving window"):
        eng.submit(np.arange(40) % 32, 20)
    with pytest.raises(ValueError, match="priority"):
        eng.submit(np.asarray([1, 2]), 2, priority="urgent")
    eng.stop(drain=False)
    with pytest.raises(ValueError, match="max_slots"):
        ContinuousBatchingEngine(lm, max_slots=0)
    with pytest.raises(ValueError, match="admission_window"):
        ContinuousBatchingEngine(lm, admission_window=0)
    with pytest.raises(ValueError, match="temperature"):
        ContinuousBatchingEngine(lm, top_k=5)
    with pytest.raises(ValueError, match="exceeds the usable context"):
        ContinuousBatchingEngine(lm, prefill_chunk=64)
    # the serving window rounds the cache up to a chunk multiple, or down
    # when that overflows the model's context
    assert ContinuousBatchingEngine(lm, max_len=30,
                                    prefill_chunk=8)._cache_len == 32
    e = ContinuousBatchingEngine(lm, prefill_chunk=10)
    assert (e._cache_len, e.max_len) == (40, 40)
    # sampled mode serves in-vocabulary rows of the right length, and
    # top_k=1 leaves only the argmax
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                  temperature=0.8, top_k=8,
                                  seed=7) as eng:
        rows = [eng.submit(np.asarray([1, 2, 3]), 5).result(timeout=60)
                for _ in range(2)]
    for row in rows:
        assert row.shape == (8,)
        assert ((row >= 0) & (row < 32)).all()
    p = np.asarray([4, 5, 6, 7])
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                  temperature=1.5, top_k=1) as eng:
        row = eng.submit(p, 6).result(timeout=60)
    np.testing.assert_array_equal(row, _direct(lm, p, 6))


@pytest.mark.parametrize("option,value,item,step", [
    ("mesh", object(), 10, "tensor-parallel serving"),
    ("tp_rules", object(), 10, "tensor-parallel serving"),
])
def test_later_options_raise_naming_their_roadmap_item(lm, option, value,
                                                       item, step):
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md, Queue 1 item {item}: .*{step}"):
        ContinuousBatchingEngine(lm, **{option: value})


def test_later_holds_only_the_tensor_parallel_options():
    """QoS (item 5) and chaos (item 6) left ``_LATER``: only the mesh
    options of item 10 still raise."""
    from bigdl_tpu_torch.serving.engine import _LATER

    assert set(_LATER) == {"mesh", "tp_rules"}
    assert {item for item, _ in _LATER.values()} == {10}


def test_high_priority_raises_and_engine_keeps_serving(lm):
    """``priority="high"`` is served since QoS was ported (it raised
    before): its row equals a lone generate, and the engine keeps
    serving; an unknown class still raises."""
    p = np.asarray([1, 2, 3])
    with ContinuousBatchingEngine(lm, max_slots=1,
                                  prefill_chunk=4) as eng:
        np.testing.assert_array_equal(
            eng.submit(p, 2, priority="high").result(60),
            _direct(lm, p, 2))
        with pytest.raises(ValueError, match="priority"):
            eng.submit(p, 2, priority="urgent")
        np.testing.assert_array_equal(eng.submit(p, 2).result(60),
                                      _direct(lm, p, 2))


def test_engine_device_rule(lm):
    """The engine runs where its model lives; asked for the card on a
    machine without one it raises as device.py does, and it never moves
    to the CPU by itself."""
    eng = ContinuousBatchingEngine(lm, max_slots=1, prefill_chunk=4)
    assert eng.device == torch.device("cpu")
    assert eng._caches[0][0].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ContinuousBatchingEngine(lm, device="cuda")
    with pytest.raises(ValueError, match="engine's device"):
        ContinuousBatchingEngine(lm, device="meta")


@pytest.mark.parametrize("use_rope", [True, False],
                         ids=["rope", "learned"])
def test_prefill_chunk_at_matches_jax(use_rope):
    """Ragged chunked prefill with a per-row last index, against JAX's
    ``prefill_chunk_at`` on the same weights and caches, at 1e-5: two
    rows at different offsets over a prefilled cache."""
    jm, tm = _pair(use_rope, 31)
    r = np.random.RandomState(5)
    head = r.randint(0, 32, (2, 8)).astype(np.int32)
    chunk = r.randint(0, 32, (2, 4)).astype(np.int32)
    pos0 = np.asarray([8, 4], np.int32)
    last = np.asarray([3, 1], np.int32)
    cj, ct = jm.init_cache(2, 16), tm.init_cache(2, 16)
    _, cj = jm.prefill(jnp.asarray(head), cj)
    _, ct = tm.prefill(head, ct)
    lj, cj = jm.prefill_chunk_at(jnp.asarray(chunk), cj, jnp.asarray(pos0),
                                 jnp.asarray(last))
    lt, ct = tm.prefill_chunk_at(chunk, ct, torch.from_numpy(pos0).long(),
                                 last)
    assert lt.shape == (2, 32)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                               atol=1e-5)
    for (jk, jv), (tk, tv) in zip(cj, ct):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-5)
    # an int offset and an offset vector of equal rows agree
    ct2 = tm.init_cache(2, 16)
    _, ct2 = tm.prefill(head, ct2)
    l_int, _ = tm.prefill_chunk_at(chunk, ct2, 8, last)
    ct3 = tm.init_cache(2, 16)
    _, ct3 = tm.prefill(head, ct3)
    l_vec, _ = tm.prefill_chunk_at(chunk, ct3, torch.tensor([8, 8]), last)
    np.testing.assert_allclose(l_int.numpy(), l_vec.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_norope_model_ragged_path():
    """Learned positions exercise the ragged position-table gather:
    parity with the port's and JAX's lone generate for a batched,
    prefix-hitting pair."""
    jm, tm = _pair(False, 22)
    r = np.random.RandomState(15)
    tpl = r.randint(0, 32, (8,))
    pa = np.concatenate([tpl, r.randint(0, 32, (2,))])
    pb = np.concatenate([tpl, r.randint(0, 32, (3,))])
    with ContinuousBatchingEngine(tm, max_slots=2, prefill_chunk=4,
                                  prefill_rows=2) as eng:
        ha = eng.submit(pa, 4)
        ra = ha.result(60)
        hb = eng.submit(pb, 4)
        rb = hb.result(60)
    assert hb.prefix_tokens == 8
    for p, row in ((pa, ra), (pb, rb)):
        np.testing.assert_array_equal(row, _direct(tm, p, 4))
        np.testing.assert_array_equal(row, _jax_direct(jm, p, 4))
