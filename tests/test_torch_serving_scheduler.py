"""The port's admission control and handles (bigdl_tpu_torch/serving/
scheduler.py, streams.py, copies of the JAX package's framework-free
modules) against the JAX package's: the same scripted sequence of puts,
cancellations, deadlines and scored pops through both ``AdmissionQueue``s
must pop the same requests in the same order and drop the same ones with
the same errors; ``PrefillPolicy``, ``TokenBucket``, ``pages_needed``,
``page_fit_score`` and ``SpeculationPolicy`` must agree; plus the unit
cases of tests/test_serving_engine.py and tests/test_prefix_cache.py."""

import time

import numpy as np
import pytest

from bigdl_tpu.serving import scheduler as jsched
from bigdl_tpu.serving import streams as jstreams
from bigdl_tpu_torch.serving import scheduler as tsched
from bigdl_tpu_torch.serving import streams as tstreams

PAIRS = [(jsched, jstreams), (tsched, tstreams)]


def _queue_script(sched, streams):
    """One scripted run: a window-4 prefix scorer, a low-class head, a
    cancelled and an expired request, a requeue, FCFS pops, and the
    starvation bound. Returns the trace of every observable outcome."""
    q = sched.AdmissionQueue(capacity=16)
    score = {0: 0, 1: 8, 2: 16, 3: 4}
    trace = []

    def mk(tag, priority="normal", timeout_s=None):
        h = streams.RequestHandle(np.asarray([tag % 4, tag], np.int32), 2,
                                  timeout_s=timeout_s, priority=priority)
        h.tag = tag
        return h

    def scorer(h):
        return score[int(h.prompt[0])]

    def pop(window, with_scorer=True):
        h, dropped = q.pop_ready(scorer=scorer if with_scorer else None,
                                 window=window)
        trace.append(("pop", None if h is None else h.tag,
                      [(d.tag, type(e).__name__) for d, e in dropped]))

    hs = [mk(i, "low" if i == 0 else "normal") for i in range(10)]
    for h in hs:
        q.put(h)
    hs[3].cancel()
    expired = mk(20, timeout_s=0.0)
    q.put(expired)
    time.sleep(0.002)
    for _ in range(4):
        pop(4)
    trace.append(("depth", len(q), q.depth_by_class()))
    trace.append(("sweep", sorted((d.tag, type(e).__name__)
                                  for d, e in q.sweep())))
    back = mk(30)
    q.requeue(back)
    for _ in range(3):
        pop(2)
    pop(1, with_scorer=False)
    while len(q):
        pop(3)
    pop(3)
    trace.append(("left", [h.tag for h in q.drain()]))
    return trace


def test_admission_queue_pops_as_jax():
    jt, tt = (_queue_script(s, st) for s, st in PAIRS)
    assert tt == jt
    # the script reaches the scored reorder, the drops and the bound
    pops = [e for e in tt if e[0] == "pop"]
    assert pops[0][1] == 2 and any(e[2] for e in pops)


def test_prefill_policy_and_helpers_match_jax():
    for chunk, budget, rows in ((4, None, 1), (8, 24, 3), (16, 16, 2)):
        pols = [s.PrefillPolicy(chunk, budget, rows) for s, _ in PAIRS]
        for pol in pols:
            pol.begin_iteration()
        takes = [[pol.take_chunk() for _ in range(5)] for pol in pols]
        assert takes[0] == takes[1]
        assert [pols[0].n_chunks(t) for t in range(1, 40)] == \
            [pols[1].n_chunks(t) for t in range(1, 40)]
        assert (pols[0].budget_tokens, pols[0].prefill_rows) == \
            (pols[1].budget_tokens, pols[1].prefill_rows)
    for t, ps in ((1, 4), (17, 4), (48, 16)):
        assert jsched.pages_needed(t, ps) == tsched.pages_needed(t, ps)
    for args in ((12, 3, 5), (12, 6, 5), (0, 0, 0)):
        assert jsched.page_fit_score(*args) == tsched.page_fit_score(*args)
    js, ts = jsched.SpeculationPolicy(3), tsched.SpeculationPolicy(3)
    assert (js.verify_len, js.kv_headroom) == (ts.verify_len,
                                                ts.kv_headroom)
    now = 100.0
    jb, tb = jsched.TokenBucket(2.0, 1.0), tsched.TokenBucket(2.0, 1.0)
    for b in (jb, tb):
        assert b.try_admit(now)
        b.debit(3.0, now)
    assert jb.retry_after(now) == tb.retry_after(now) > 0
    assert jb.snapshot(now + 0.5) == tb.snapshot(now + 0.5)


def test_scheduler_units():
    q = tsched.AdmissionQueue(capacity=2)
    a = tstreams.RequestHandle(np.asarray([1]), 2)
    b = tstreams.RequestHandle(np.asarray([2]), 2)
    q.put(a)
    q.put(b)
    with pytest.raises(tstreams.QueueFull):
        q.put(tstreams.RequestHandle(np.asarray([3]), 2), block=False)
    b.cancel()
    h, dropped = q.pop_ready()
    assert h is a and not dropped
    h, dropped = q.pop_ready()
    assert h is None and len(dropped) == 1 \
        and isinstance(dropped[0][1], tstreams.RequestCancelled)
    expired = tstreams.RequestHandle(np.asarray([4]), 2, timeout_s=0.0)
    q.put(expired)
    time.sleep(0.002)
    dropped = q.sweep()
    assert len(dropped) == 1 \
        and isinstance(dropped[0][1], tstreams.RequestTimedOut)
    with pytest.raises(ValueError, match="chunk"):
        tsched.PrefillPolicy(chunk=0)
    with pytest.raises(ValueError, match="budget_tokens"):
        tsched.PrefillPolicy(chunk=8, budget_tokens=4)
    with pytest.raises(ValueError, match="prefill_rows"):
        tsched.PrefillPolicy(chunk=4, prefill_rows=0)
    pol = tsched.PrefillPolicy(chunk=8)
    assert pol.n_chunks(1) == 1 and pol.n_chunks(17) == 3
    pol.begin_iteration()
    assert pol.take_chunk() and pol.take_chunk() \
        and not pol.take_chunk()  # default budget = 2 chunks
    # a wait histogram observes each pop's queue wait
    seen = []

    class Hist:
        def observe(self, s):
            seen.append(s)

    q2 = tsched.AdmissionQueue(capacity=2, wait_histogram=Hist())
    q2.put(tstreams.RequestHandle(np.asarray([5]), 2))
    assert q2.pop_ready()[0] is not None and len(seen) == 1


def test_put_rejects_dead_deadline_at_wakeup():
    """A request whose deadline expires while blocked on a full queue is
    rejected with RequestTimedOut at wake-up, not after the put timeout."""
    q = tsched.AdmissionQueue(capacity=1)
    q.put(tstreams.RequestHandle(np.asarray([1]), 2))
    h = tstreams.RequestHandle(np.asarray([2]), 2, timeout_s=0.05)
    t0 = time.monotonic()
    with pytest.raises(tstreams.RequestTimedOut,
                       match="full admission queue"):
        q.put(h, block=True, timeout=30.0)
    assert time.monotonic() - t0 < 5.0
    h2 = tstreams.RequestHandle(np.asarray([3]), 2, timeout_s=0.0)
    time.sleep(0.002)
    with pytest.raises(tstreams.RequestTimedOut):
        q.put(h2, block=True)


def test_pop_ready_prefix_aware_window_and_starvation_bound():
    q = tsched.AdmissionQueue(capacity=8)
    score = lambda h: 10 if h.prompt[0] == 1 else 0  # noqa: E731
    RH = tstreams.RequestHandle

    plain = RH(np.asarray([9, 9]), 2)
    hit1 = RH(np.asarray([1, 1]), 2)
    q.put(plain)
    q.put(hit1)
    h, dropped = q.pop_ready(scorer=score, window=2)
    assert h is hit1 and not dropped
    assert q.snapshot() == [plain]
    hit2 = RH(np.asarray([1, 2]), 2)
    q.put(hit2)
    assert q.pop_ready(scorer=score, window=2)[0] is hit2
    hit3 = RH(np.asarray([1, 3]), 2)
    q.put(hit3)
    assert q.pop_ready(scorer=score, window=2)[0] is plain, \
        "bypass cap reached: the starved head must pop next"
    assert q.pop_ready(scorer=score, window=2)[0] is hit3
    a, b = RH(np.asarray([9]), 2), RH(np.asarray([1]), 2)
    q.put(a)
    q.put(b)
    assert q.pop_ready(scorer=score, window=1)[0] is a
    assert q.pop_ready()[0] is b


def test_handles_match_jax():
    """Handle lifecycle, errors and timelines as the JAX package's."""
    for _, streams in PAIRS:
        h = streams.RequestHandle(np.asarray([1, 2]), 3, priority="low")
        assert h.request_id.startswith("req-")
        h._deliver(7, time.monotonic())
        h._deliver(8, time.monotonic())
        assert h._finish(None) and not h._finish(None)
        assert list(h.tokens()) == [7, 8]
        np.testing.assert_array_equal(h.result(), [1, 2, 7, 8])
        tl = h.timeline()
        assert tl["tokens"] == 2 and tl["priority"] == "low"
        c = streams.RequestHandle(np.asarray([1]), 2)
        c.cancel()
        c._finish(streams.RequestCancelled("x"))
        with pytest.raises(streams.RequestCancelled):
            c.result()
        with pytest.raises(ValueError, match="priority"):
            streams.RequestHandle(np.asarray([1]), 2, priority="urgent")
    keys = set(jstreams.RequestHandle(np.asarray([1]), 2).timeline())
    assert keys == set(tstreams.RequestHandle(np.asarray([1]),
                                              2).timeline())
    assert tstreams.PRIORITIES == jstreams.PRIORITIES
    a, b = tstreams.next_request_id(), tstreams.next_request_id()
    assert a != b and len(a) == len("req-000042")
