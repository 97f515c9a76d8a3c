"""A profiler capture asked for on one thread runs on the loop that
launches the device work (``observability/profiler.py``'s ``hosting`` /
``poll``, wired into the serving engine's loop): the engine's thread
starts and stops the session, an idle loop is roused for it, the
engine's stop ends a session it hosts, a second capture meanwhile is
refused, and with no host, or a host that never polls, the session
runs on the calling thread. Whether the loop's CUDA kernels land in
the trace is held on the card by ``chip_smoke.py``'s ``obs_serving``.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch.observability import profiler
from bigdl_tpu_torch.observability.events import FlightRecorder
from bigdl_tpu_torch.serving import ContinuousBatchingEngine


@pytest.fixture()
def rec():
    r = FlightRecorder()
    prev = obs.set_default_recorder(r)
    try:
        yield r
    finally:
        obs.set_default_recorder(prev)


@pytest.fixture(scope="module")
def lm():
    from bigdl_tpu_torch.models.transformer import TransformerLM

    torch.manual_seed(31)
    m = TransformerLM(32, embed_dim=16, num_heads=4, num_kv_heads=2,
                      num_layers=1, max_len=48, use_rope=True, device="cpu")
    m.evaluate()
    return m


def _start_threads(rec):
    return [e.attrs["thread"] for e in rec.tail()
            if e.kind == "profiler/capture_start"]


def _trace_in(path):
    return any(f.endswith(".pt.trace.json") for f in os.listdir(path))


def test_capture_on_another_thread_runs_on_the_serving_loop(lm, rec,
                                                            tmp_path):
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4) as eng:
        stop = threading.Event()

        def load():
            r = np.random.RandomState(5)
            while not stop.is_set():
                eng.submit(r.randint(0, 32, (6,)), 6).result(timeout=60)

        t = threading.Thread(target=load)
        t.start()
        try:
            path = profiler.capture(0.2, out_dir=str(tmp_path / "p"))
        finally:
            stop.set()
            t.join(timeout=60)
        loop_name = eng._thread.name
    assert _trace_in(path)
    assert _start_threads(rec) == [loop_name]
    assert loop_name != threading.current_thread().name
    assert not profiler.capturing()


def test_an_idle_loop_is_roused_for_the_capture(lm, rec, tmp_path):
    # the loop's idle wait is far longer than the capture: only the
    # wake and the capture's own end bound the call
    with ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                  idle_wait_s=30.0) as eng:
        time.sleep(0.1)                         # the loop is waiting
        t0 = time.monotonic()
        path = profiler.capture(0.1, out_dir=str(tmp_path / "p"))
        took = time.monotonic() - t0
        loop_name = eng._thread.name
    assert _trace_in(path)
    assert _start_threads(rec) == [loop_name]
    assert took < 10.0, took
    assert not profiler.capturing()


def test_engine_stop_ends_the_capture_it_hosts(lm, rec, tmp_path):
    out = {}
    eng = ContinuousBatchingEngine(lm, max_slots=2, prefill_chunk=4,
                                   idle_wait_s=30.0).start()

    def ask():
        out["path"] = profiler.capture(30.0, out_dir=str(tmp_path / "p"))

    t = threading.Thread(target=ask)
    t.start()
    deadline = time.monotonic() + 20
    while not profiler.capturing() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert profiler.capturing()
    # a second capture while the first runs on the loop is refused
    with pytest.raises(profiler.ProfilerBusy):
        profiler.capture(0.05, out_dir=str(tmp_path / "q"))
    t0 = time.monotonic()
    eng.stop()
    t.join(timeout=20)
    assert not t.is_alive()
    assert time.monotonic() - t0 < 20
    assert _trace_in(out["path"])
    assert not profiler.capturing()
    kinds = [e.kind for e in rec.tail()]
    assert kinds.count("profiler/capture_done") == 1


def test_without_a_host_the_capture_runs_on_the_calling_thread(rec,
                                                               tmp_path):
    path = profiler.capture(0.05, out_dir=str(tmp_path / "p"))
    assert _trace_in(path)
    assert _start_threads(rec) == [threading.current_thread().name]


def test_a_host_that_never_polls_is_passed_over(rec, tmp_path,
                                                monkeypatch):
    monkeypatch.setattr(profiler, "HANDOFF_S", 0.05)
    entered, leave = threading.Event(), threading.Event()

    def host():
        with profiler.hosting():
            entered.set()
            leave.wait(30)

    t = threading.Thread(target=host)
    t.start()
    try:
        assert entered.wait(10)
        path = profiler.capture(0.05, out_dir=str(tmp_path / "p"))
    finally:
        leave.set()
        t.join(timeout=10)
    assert _trace_in(path)
    assert _start_threads(rec) == [threading.current_thread().name]
    # the withdrawn offer is not left for a later poll to take
    assert profiler.poll() is None
    assert not profiler.capturing()
