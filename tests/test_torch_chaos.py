"""The chaos injector in the port (bigdl_tpu_torch/serving/chaos.py) and
the engine's three hooks into it, against the JAX package's.

- the same scripted injector calls give the same ``snapshot()``s, the
  same freeze answers and the same fault in both packages;
- ``fail_dispatch`` aimed at a prefill round, and at a decode, crashes
  the loop: every handle (admitting, decoding or queued) fails with
  ``EngineStopped`` caused by the ``ChaosFault``, within a bounded wait,
  and the ledger closes every record;
- a frozen slot sits out the decode while the other slot streams, then
  resumes, and its row equals the lone ``generate``. The JAX engine's
  frozen row rides the fused step at position 0 and overwrites its own
  first KV position, so the same drill there gives another row (shown
  by the last test).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.serving import ChaosFault as JaxFault
from bigdl_tpu.serving import ChaosInjector as JaxInjector
from bigdl_tpu.serving import ContinuousBatchingEngine as JaxEngine
from bigdl_tpu.serving.streams import RequestHandle as JaxHandle
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.serving import (
    ChaosFault, ChaosInjector, ContinuousBatchingEngine, EngineStopped,
    RequestHandle,
)
from bigdl_tpu_torch.utils.weights import load_jax_params

CFG = dict(vocab_size=32, embed_dim=16, num_heads=4, num_kv_heads=2,
           num_layers=2, max_len=48, use_rope=True)

_A = np.asarray([5, 3, 9, 2, 7], np.int32)
_B = np.asarray([4, 4, 1, 8], np.int32)


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


def _script(inj, fault_cls):
    """A fixed script of control and engine-side calls; returns every
    observation (snapshots, freeze answers, where the fault landed)."""
    seen = [inj.snapshot()]
    inj.force_burn(True)
    seen.append((inj.burn_active(), inj.burn_severe(), inj.snapshot()))
    inj.force_burn(True, severe=True)
    seen.append((inj.burn_active(), inj.burn_severe()))
    inj.force_burn(False, severe=True)   # clearing clears severe too
    seen.append((inj.burn_active(), inj.burn_severe()))
    inj.freeze_slot(1, 2)
    inj.freeze_slot(3, 1)
    inj.fail_dispatch(3)
    for it in range(4):
        inj.begin_iteration()
        seen.append([inj.slot_frozen(s) for s in range(4)])
        for _ in range(2):
            try:
                inj.on_dispatch()
                seen.append("ok")
            except fault_cls as e:
                seen.append(("fault", str(e)))
        seen.append(inj.snapshot())
    for bad in (lambda: inj.fail_dispatch(0),
                lambda: inj.freeze_slot(0, 0)):
        with pytest.raises(ValueError):
            bad()
    seen.append(repr(inj))
    return seen


def test_scripted_injector_matches_jax():
    assert _script(ChaosInjector(), ChaosFault) == \
        _script(JaxInjector(), JaxFault)


def _crash_drill(lm, nth_after_warm, what):
    """An idle, warmed engine (one slot, one staging row) is armed to
    fault on its ``nth`` next dispatch; then three requests arrive (one
    admits, two queue). Returns (handles, stats before, stats after,
    seconds each handle took to fail, engine)."""
    chaos = ChaosInjector()
    eng = ContinuousBatchingEngine(lm, max_slots=1, prefill_chunk=4,
                                   chaos=chaos)
    eng.submit(_B, 2).result(timeout=60)      # warm; engine idle again
    before = eng.stats()
    chaos.fail_dispatch(nth_after_warm)
    handles, stopped_at_submit = [], 0
    for p, n in ((_B, 12), (_A, 6), (_A[:3], 6)):
        try:
            handles.append(eng.submit(p, n))
        except EngineStopped:
            stopped_at_submit += 1     # the crash beat this submit
    waits = []
    for h in handles:
        t = time.monotonic()
        with pytest.raises(EngineStopped) as ei:
            h.result(timeout=30)
        waits.append(time.monotonic() - t)
        assert isinstance(ei.value.__cause__, ChaosFault), what
    assert len(handles) + stopped_at_submit == 3
    eng.stop()
    after = eng.stats()
    return handles, before, after, waits, eng


@pytest.mark.parametrize("target", ["prefill", "decode"])
def test_fail_dispatch_crashes_the_loop_and_fails_every_handle(lms,
                                                               target):
    """Aimed at the prefill round that admits the first request (the
    first dispatch after the engine went idle), or at the decode right
    after it (the second): the loop crashes, every handle fails with
    ``EngineStopped`` at once (none hangs), the crash is in the
    timelines, and the ledger closes every record."""
    _, tm = lms
    nth = {"prefill": 1, "decode": 2}[target]
    handles, before, after, waits, eng = _crash_drill(tm, nth, target)
    assert max(waits) < 5.0, waits
    assert isinstance(eng._crashed, ChaosFault)
    assert after["qos"]["chaos"]["faults_raised"] == 1
    if target == "prefill":
        # the fault hit the round before it ran: no prefill round and no
        # decode step since the warm request, and no token delivered
        assert after["prefill_rounds"] == before["prefill_rounds"]
        assert after["decode_steps"] == before["decode_steps"]
        assert all(h.tokens_so_far().shape[0] == 0 for h in handles)
    else:
        # one prefill round ran (the first token was delivered), then
        # the decode faulted before it stepped
        assert after["prefill_rounds"] == before["prefill_rounds"] + 1
        assert after["decode_steps"] == before["decode_steps"]
        assert handles[0].tokens_so_far().shape[0] == 1
    assert all(h.done() for h in handles)
    with eng._timelines_lock:
        crashed = sum(t["outcome"] == "crashed" for t in eng._timelines)
    assert crashed == len(handles)
    usage = after["usage"]["totals"]
    assert usage["in_flight"] == 0
    assert usage["requests"] == 1 + len(handles) + (3 - len(handles))
    with pytest.raises(EngineStopped):
        eng.submit(_A, 2)


def _freeze_drill(eng, handle_cls, iterate, freeze_for=6):
    """Drive the engine on this thread: admit A and B into two slots,
    freeze A's slot once A has its first token, and step until both
    finish. Returns (A's row, B's row, A's token count at each frozen
    step, B's)."""
    ha, hb = handle_cls(_A, 20), handle_cls(_B, 10)
    eng._queue.put(ha)
    eng._queue.put(hb)
    while len(ha._tokens) < 1 or len(hb._tokens) < 1:
        iterate()
    sid = next(s for s, st in enumerate(eng._slots)
               if st is not None and st.handle is ha)
    eng._chaos.freeze_slot(sid, freeze_for)
    a_seen, b_seen = [], []
    for _ in range(freeze_for):
        iterate()
        a_seen.append(len(ha._tokens))
        b_seen.append(len(hb._tokens))
    while not (ha.done() and hb.done()):
        iterate()
    return (np.asarray(ha.result(timeout=1)),
            np.asarray(hb.result(timeout=1)), a_seen, b_seen)


@pytest.mark.parametrize("paged", [None, 4], ids=["dense", "paged"])
def test_frozen_slot_stalls_then_resumes_token_identical(lms, paged):
    jm, tm = lms
    eng = ContinuousBatchingEngine(tm, max_slots=2, prefill_chunk=4,
                                   chaos=ChaosInjector(), page_size=paged)

    def iterate():
        with torch.inference_mode():
            eng._iterate()

    row_a, row_b, a_seen, b_seen = _freeze_drill(eng, RequestHandle,
                                                 iterate)
    # A stood still while frozen, B streamed
    assert a_seen == [a_seen[0]] * len(a_seen)
    assert b_seen[-1] > b_seen[0]
    want_a = tm.generate(_A, 20)[0].numpy()
    np.testing.assert_array_equal(row_a, want_a)
    np.testing.assert_array_equal(row_b, tm.generate(_B, 10)[0].numpy())
    np.testing.assert_array_equal(
        row_a, np.asarray(jm.generate(jnp.asarray(_A)[None], 20))[0])
    assert eng._chaos.snapshot()["frozen_slots"] == {}


def test_jax_frozen_slot_stalls_while_the_other_streams(lms):
    """The JAX engine in the same drill holds the frozen row still while
    the other streams, and the streaming row equals the port's and the
    lone generate's. (Its frozen row rides the fused decode at (token 0,
    position 0) and may leave the lone generate's once resumed: ROADMAP.md
    Queue 3; the port rides a held-out row at its own position, see
    ``ContinuousBatchingEngine._ride_along``.)"""
    jm, tm = lms
    eng = JaxEngine(jm, max_slots=2, prefill_chunk=4, chaos=JaxInjector())
    _, row_b, a_seen, b_seen = _freeze_drill(eng, JaxHandle, eng._iterate)
    assert a_seen == [a_seen[0]] * len(a_seen)
    assert b_seen[-1] > b_seen[0]
    np.testing.assert_array_equal(
        row_b, np.asarray(jm.generate(jnp.asarray(_B)[None], 10))[0])
    np.testing.assert_array_equal(row_b, tm.generate(_B, 10)[0].numpy())
