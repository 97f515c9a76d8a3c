"""The port's GenerationService (bigdl_tpu_torch/optim/generation_service.py)
against its own lone generate and the JAX package's GenerationService on
the same weights: greedy rows must be token-identical, whatever batch
they were served in."""

import threading

import jax
import numpy as np
import pytest

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.optim import GenerationService as JaxService
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.optim import GenerationService
from bigdl_tpu_torch.utils.weights import load_jax_params

CFG = dict(vocab_size=64, embed_dim=32, num_heads=4, num_layers=2,
           max_len=64, num_kv_heads=2, use_rope=True)


@pytest.fixture(scope="module")
def lms():
    from bigdl_tpu.utils import random as bt_random

    bt_random.set_seed(5)
    jm = JaxLM(**CFG)
    jm.evaluate()
    tm = TransformerLM(**CFG, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    return jm, tm


def _serve(svc, reqs):
    out = [None] * len(reqs)

    def ask(i):
        out[i] = svc.generate(*reqs[i])

    threads = [threading.Thread(target=ask, args=(i,), daemon=True)
               for i in range(len(reqs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    return out


def test_concurrent_mixed_requests_match_lone_and_jax(lms):
    jm, tm = lms
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, 64, n).astype(np.int32), k)
            for n, k in ((3, 6), (7, 4), (12, 6), (5, 5), (8, 3))]
    kw = dict(max_batch=4, batch_timeout_ms=200.0, bucket_tokens=4,
              prompt_bucket=8)
    svc = GenerationService(tm, **kw)
    rows = _serve(svc, reqs)
    ref = _serve(JaxService(jm, **kw), reqs)
    for (prompt, n), row, jrow in zip(reqs, rows, ref):
        assert row.shape == (len(prompt) + n,)
        np.testing.assert_array_equal(row[:len(prompt)], prompt)
        lone = tm.generate(prompt, n)[0].numpy()
        np.testing.assert_array_equal(row, lone)
        np.testing.assert_array_equal(row, np.asarray(jrow))
    stats = svc.stats()
    assert stats["served"] == len(reqs)
    assert 1 <= stats["dispatches"] < len(reqs)   # requests coalesced
    assert stats["tokens"] == sum(n for _, n in reqs)


def test_eos_sampling_and_validation(lms):
    _, tm = lms
    prompt = np.arange(1, 6, dtype=np.int32)
    eos = int(tm.generate(prompt, 3)[0, 6])     # the second new token
    svc = GenerationService(tm, bucket_tokens=4, eos_id=eos)
    row = svc.generate(prompt, 6)
    first = int(np.flatnonzero(row[5:] == eos)[0])
    assert row.shape == (11,) and first <= 1 and (row[5 + first:] == eos).all()
    # delivered tokens run up to and including the first eos
    assert svc.stats()["tokens"] == first + 1
    sampled = GenerationService(tm, bucket_tokens=4, temperature=0.8,
                                top_k=5, seed=3)
    row = sampled.generate(prompt, 8)
    assert row.shape == (13,) and 0 <= row.min() and row.max() < 64
    with pytest.raises(ValueError):
        GenerationService(tm, bucket_tokens=0)
    with pytest.raises(ValueError, match="temperature"):
        GenerationService(tm, top_k=5)
    with pytest.raises(ValueError, match="context"):
        GenerationService(tm).generate(np.zeros(60, np.int32), 8)
    with pytest.raises(ValueError, match="ONE request"):
        GenerationService(tm).generate(np.zeros((2, 3), np.int32), 2)
