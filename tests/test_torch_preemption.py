"""Preemption with KV donation in the port's ContinuousBatchingEngine
(bigdl_tpu_torch/serving/engine.py) against the JAX package's (the cases
of tests/test_serving_preemption.py; the tensor-parallel case waits for
ROADMAP.md Queue 1 item 10), on the same weights.

The contract: a high-class request waiting past ``preempt_slack_s`` with
no free slot evicts the lowest-class, longest-remaining victim; the
victim's prompt + generated KV is donated to the prefix cache and pinned,
the victim requeues at the head, and its resume re-prefills only what the
donated entry does not cover, so its row equals a lone ``generate`` and
the JAX engine's row in the same drill: dense, paged, with a host tier,
and with a draft. Under int8 KV the rows equal the same engine's
unpreempted rows (the int8 codes of a position do not depend on how it
was computed), which is what the port promises there; int8 weights are
not held, since the activation scale spans whatever is batched. Paged
preemption leaks no page. The victim's device-seconds stay billed, and
the tenants' device-seconds still sum to the ledger's busy total.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.serving import ContinuousBatchingEngine as JaxEngine
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.nn.quantized import Quantizer
from bigdl_tpu_torch.serving import ContinuousBatchingEngine
from bigdl_tpu_torch.utils.weights import load_jax_params

CFG = dict(vocab_size=32, embed_dim=16, num_heads=4, num_kv_heads=2,
           num_layers=2, max_len=48, use_rope=True)

_VICTIM = np.asarray([7, 3, 1, 4, 1, 5], np.int32)
_URGENT = np.asarray([2, 6, 2, 6], np.int32)


@pytest.fixture(scope="module")
def lms():
    from bigdl_tpu.utils import random as rnd

    rnd.set_seed(21)
    jm = JaxLM(**CFG)
    jm.evaluate()
    tm = TransformerLM(**CFG, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    tm.evaluate()
    return jm, tm


@pytest.fixture(scope="module")
def lm(lms):
    return lms[1]


def _direct(lm, prompt, n):
    return lm.generate(np.asarray(prompt), n)[0].numpy()


def _drill(eng):
    """One slot, a low-class long decode provably IN the slot (first
    token streamed), then a high-class arrival whose slack expires at
    once. Warms both request shapes first, as the JAX drill does.
    Returns (victim row, urgent row, victim handle, urgent handle)."""
    eng.submit(_VICTIM, 2, priority="low").result(timeout=60)
    eng.submit(_URGENT, 2, priority="high").result(timeout=60)
    h_low = eng.submit(_VICTIM, 40, priority="low", tenant="batch")
    next(h_low.tokens())
    h_high = eng.submit(_URGENT, 4, priority="high", tenant="interactive")
    row_high = np.asarray(h_high.result(timeout=120))
    row_low = np.asarray(h_low.result(timeout=120))
    return row_low, row_high, h_low, h_high


def _preempt_round(lm, **engine_kw):
    """The port's drill: both rows equal the lone generate, the victim
    was preempted (the urgent one never), the flow counters add up."""
    with ContinuousBatchingEngine(lm, max_slots=1, prefill_chunk=4,
                                  preempt_slack_s=0.002,
                                  **engine_kw) as eng:
        row_low, row_high, h_low, h_high = _drill(eng)
        np.testing.assert_array_equal(row_high, _direct(lm, _URGENT, 4))
        np.testing.assert_array_equal(row_low, _direct(lm, _VICTIM, 40))
        st = eng.stats()
        assert h_low.preempted >= 1, "the drill never preempted"
        assert h_high.preempted == 0
        assert st["qos"]["preempted"] == h_low.preempted
        assert st["finished"] == 4
        # the victim re-admits: one admission more per preemption
        assert st["admitted"] == 4 + h_low.preempted
    return eng, st, h_low


def test_preempted_resume_token_identical_plain(lm):
    _, _, h_low = _preempt_round(lm)
    tl = h_low.timeline()
    assert tl["priority"] == "low" and tl["preempted"] >= 1
    # the victim was billed both prefill legs and both queue waits
    u = h_low.usage()
    assert u["preemptions"] == h_low.preempted
    assert u["device_s"] > 0 and u["kv_byte_seconds"] > 0
    assert u["queue_wait_s"] is not None
    assert u["decode_tokens"] == 40


def test_preempted_resume_token_identical_tiered(lm):
    _preempt_round(lm, prefix_host_rows=4)


def test_preempted_resume_token_identical_speculative(lm):
    """With a draft (the int8 clone, as the JAX test's): the victim's
    draft cache re-prefills the whole effective prompt at resume."""
    draft = Quantizer.quantize(lm)
    draft.evaluate()
    _, st, _ = _preempt_round(lm, draft=draft, spec_gamma=3)
    assert st["speculation"]["proposed_tokens"] > 0


@pytest.mark.parametrize("draft", [False, True], ids=["target", "draft"])
def test_paged_preemption_no_leak(lm, draft):
    """Paged: the victim's target and draft tables go back through
    ``_free_slot_table`` (its prefix pages survive under the index's
    references and the pin); after drain the pool holds exactly the
    prefix index's pages, the draft pool none, and after stop the pool
    holds none."""
    kw = {"draft": lm, "spec_gamma": 3} if draft else {}
    eng, st, h_low = _preempt_round(lm, page_size=4, **kw)
    # __exit__ drained and stopped: every page is back
    assert eng._pages.pages_in_use == 0
    pool = eng._pages.stats()
    assert pool["allocated_total"] == pool["freed_total"]
    if draft:
        assert eng._d_pages.pages_in_use == 0
    # the paged ledger bills held pages, not rows
    assert h_low.usage()["kv_byte_seconds"] > 0

    with ContinuousBatchingEngine(lm, max_slots=1, prefill_chunk=4,
                                  preempt_slack_s=0.002, page_size=4,
                                  **kw) as eng:
        _drill(eng)
        deadline = time.monotonic() + 30
        while eng._has_work() and time.monotonic() < deadline:
            time.sleep(0.01)
        held = {p for e in eng._prefix.snapshot() for p in e["pages"]}
        assert eng._pages.pages_in_use == len(held) > 0
        assert not any(e.refs for e in eng._prefix._entries), \
            "a preemption pin outlived the resume"
        if draft:
            assert eng._d_pages.pages_in_use == 0
    assert eng._pages.pages_in_use == 0


def test_preempted_victim_row_equals_the_jax_engines(lms):
    """The same drill through the JAX engine gives the same two rows
    (the JAX rows equal JAX's own lone generate, too)."""
    jm, tm = lms
    with ContinuousBatchingEngine(tm, max_slots=1, prefill_chunk=4,
                                  preempt_slack_s=0.002) as eng:
        row_low, row_high, h_low, _ = _drill(eng)
    with JaxEngine(jm, max_slots=1, prefill_chunk=4,
                   preempt_slack_s=0.002) as jeng:
        jrow_low, jrow_high, jh_low, _ = _drill(jeng)
    assert h_low.preempted >= 1 and jh_low.preempted >= 1
    np.testing.assert_array_equal(row_low, jrow_low)
    np.testing.assert_array_equal(row_high, jrow_high)
    np.testing.assert_array_equal(
        jrow_low, np.asarray(jm.generate(jnp.asarray(_VICTIM)[None],
                                         40))[0])


def test_int8_kv_preempted_rows_equal_the_unpreempted_engine(lm):
    """int8 KV over float weights: the preempted victim's row equals the
    same engine configuration's row without a preemption (int8 KV rows
    are not a lone generate's, so that is the identity held here)."""
    kw = dict(max_slots=1, prefill_chunk=4, kv_dtype="int8")
    with ContinuousBatchingEngine(lm, preempt_slack_s=0.002,
                                  **kw) as eng:
        row_low, row_high, h_low, _ = _drill(eng)
    assert h_low.preempted >= 1
    with ContinuousBatchingEngine(lm, preempt_slack_s=None, **kw) as calm:
        want_low = calm.submit(_VICTIM, 40).result(timeout=120)
        want_high = calm.submit(_URGENT, 4).result(timeout=120)
    np.testing.assert_array_equal(row_low, want_low)
    np.testing.assert_array_equal(row_high, want_high)


def test_preemption_disabled_and_high_never_victim(lm):
    """``preempt_slack_s=None`` turns the mechanism off: the high request
    waits for the slot; and a slot held by HIGH work is never preempted
    even with the mechanism on."""
    with ContinuousBatchingEngine(lm, max_slots=1, prefill_chunk=4,
                                  preempt_slack_s=None) as eng:
        h_low = eng.submit(_VICTIM, 24, priority="low")
        next(h_low.tokens())
        h_high = eng.submit(_URGENT, 4, priority="high")
        np.testing.assert_array_equal(h_high.result(timeout=120),
                                      _direct(lm, _URGENT, 4))
        assert h_low.preempted == 0
        assert eng.stats()["qos"]["preempted"] == 0
    with ContinuousBatchingEngine(lm, max_slots=1, prefill_chunk=4,
                                  preempt_slack_s=0.002) as eng:
        h_first = eng.submit(_VICTIM, 24, priority="high")
        next(h_first.tokens())
        h_second = eng.submit(_URGENT, 4, priority="high")
        time.sleep(0.05)   # slack long expired; still no victim
        np.testing.assert_array_equal(h_second.result(timeout=120),
                                      _direct(lm, _URGENT, 4))
        assert h_first.preempted == 0
        np.testing.assert_array_equal(h_first.result(timeout=120),
                                      _direct(lm, _VICTIM, 24))


def test_preemption_ledger_conservation(lm):
    """Across a preemption the tenants' device-seconds equal the measured
    busy total, and the victim's preemption count reaches the
    aggregate."""
    _, st, h_low = _preempt_round(lm)
    usage = st["usage"]
    attributed = sum(a["device_s"] for a in usage["tenants"].values())
    busy = usage["goodput"]["device_seconds"]["total"]
    assert abs(attributed - busy) <= 1e-6 + 1e-3 * busy
    assert usage["totals"]["preemptions"] >= h_low.preempted
    assert usage["tenants"]["batch"]["preemptions"] == h_low.preempted


def test_preemption_admits_the_waiting_high_request(lm):
    """A preemption frees the slot for the high request that waited. One
    slot is held by a low decode; two low requests sit requeued at the
    queue head (as preemption victims do) and a high one behind them,
    outside an admission window of 2. The port pops the longest-waiting
    high request into the freed slot: one preemption, and the high row
    equals a lone generate. (The JAX engine pops the freed slot through
    the scored window from the head, re-admits a victim and preempts
    again: ROADMAP.md Queue 3.)"""
    import torch

    from bigdl_tpu_torch.serving import RequestHandle

    eng = ContinuousBatchingEngine(lm, max_slots=1, prefill_chunk=4,
                                   admission_window=2, preempt_slack_s=0.0)

    def iterate():
        with torch.inference_mode():
            eng._iterate()

    l0 = RequestHandle(_VICTIM, 30, priority="low")
    eng._queue.put(l0)
    while not l0._tokens:
        iterate()
    for p in (_URGENT[:3], _URGENT[1:]):
        eng._queue.requeue(RequestHandle(p, 20, priority="low"))
    hi = RequestHandle(_URGENT, 4, priority="high")
    eng._queue.put(hi)
    counts = []
    for _ in range(12):
        iterate()
        counts.append(eng._qos_counts["preempted"])
    assert hi.admitted_at is not None, counts
    assert counts[0] == 1 and counts[-1] == 1, counts
    while not hi.done():
        iterate()
    np.testing.assert_array_equal(hi.result(timeout=1),
                                  _direct(lm, _URGENT, 4))
