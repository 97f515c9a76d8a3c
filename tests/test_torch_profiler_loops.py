"""Every loop that launches device work hosts profiler captures asked for
on another thread (``observability/profiler.py``'s ``hosting`` / ``poll``):
the micro-batcher's drain thread, which serves ``PredictionService`` and
``GenerationService``, the ``LocalOptimizer``'s step loop and the
``DistriOptimizer``'s. The capture starts on the launching thread (its
``profiler/capture_start`` event names it), lasts its seconds, holds the
ops of the batches or steps in its window, and a batch that ends never
cuts it short. A capture asked for while the drain thread waits out a
batch window, or while it runs a batch longer than ``HANDOFF_S``, is
still taken by it. Whether the CUDA kernels land in the trace is held
on the card by ``chip_smoke.py``'s ``profiler_hosting`` phase.
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch.dataset.dataset import DataSet
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.observability import profiler
from bigdl_tpu_torch.observability.events import FlightRecorder
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
from bigdl_tpu_torch.optim.generation_service import GenerationService
from bigdl_tpu_torch.optim.prediction_service import (
    PredictionService, _MicroBatcher)

CAPTURE_S = 0.3


@pytest.fixture()
def rec():
    r = FlightRecorder()
    prev = obs.set_default_recorder(r)
    try:
        yield r
    finally:
        obs.set_default_recorder(prev)


def _start_threads(rec):
    return [e.attrs["thread"] for e in rec.tail()
            if e.kind == "profiler/capture_start"]


def _trace_ops(path):
    names = []
    for f in os.listdir(path):
        if f.endswith(".pt.trace.json"):
            with open(os.path.join(path, f)) as fh:
                names += [e.get("name", "") for e in
                          json.load(fh).get("traceEvents", [])]
    return names


def _timed_capture(tmp_path):
    t0 = time.monotonic()
    path = profiler.capture(CAPTURE_S, out_dir=str(tmp_path / "p"))
    return path, time.monotonic() - t0


def _mlp():
    torch.manual_seed(3)
    m = tnn.Sequential(tnn.Linear(8, 16, device="cpu"), tnn.Tanh(),
                       tnn.Linear(16, 3, device="cpu"))
    return m.evaluate()


def _under_load(submit, tmp_path):
    """A capture taken while another thread keeps submitting."""
    stop, served = threading.Event(), []

    def load():
        r = np.random.RandomState(5)
        while not stop.is_set():
            served.append(submit(r))

    t = threading.Thread(target=load, name="client")
    t.start()
    try:
        while not served:
            time.sleep(0.01)
        n0 = len(served)
        path, took = _timed_capture(tmp_path)
        during = len(served) - n0
    finally:
        stop.set()
        t.join(timeout=60)
    return path, took, during


def test_prediction_service_batcher_hosts_the_capture(rec, tmp_path):
    svc = PredictionService(_mlp(), num_threads=4, max_batch=4,
                            batch_timeout_ms=1.0, sample_ndim=1,
                            service_name="pred-host")
    path, took, during = _under_load(
        lambda r: svc.predict(r.randn(8).astype(np.float32)), tmp_path)
    assert _start_threads(rec) == ["pred-host-drain"]
    assert took >= CAPTURE_S
    assert during > 1                      # the flushes went on meanwhile
    assert any(n.startswith("aten::") for n in _trace_ops(path))
    assert not profiler.capturing()


def test_a_drain_that_ends_does_not_cut_the_capture_short(rec, tmp_path):
    """A capture taken while a request waits out its window: the batch
    lands and the queue empties, the drain thread holds the session for
    its seconds all the same, and a flush later in the window is in the
    trace."""
    svc = PredictionService(_mlp(), num_threads=2, max_batch=2,
                            batch_timeout_ms=60.0, sample_ndim=1,
                            service_name="pred-idle")
    x = np.ones(8, np.float32)
    box = {}

    def first():
        box["first"] = svc.predict(x)

    t = threading.Thread(target=first)
    t.start()
    time.sleep(0.01)                       # inside the first window
    c = threading.Thread(target=lambda: box.update(
        zip(("path", "took"), _timed_capture(tmp_path))))
    c.start()
    t.join(timeout=60)
    time.sleep(CAPTURE_S / 3)              # the queue is empty now
    out = svc.predict(x * 2)               # a flush later in the window
    c.join(timeout=60)
    assert box["first"].shape == out.shape == (3,)
    assert _start_threads(rec) == ["pred-idle-drain"]
    assert box["took"] >= CAPTURE_S
    assert sum(n == "aten::addmm" for n in _trace_ops(box["path"])) >= 4


def _slow_service(name, inside, seconds=0.4):
    """A PredictionService whose forward sleeps ``seconds`` after setting
    ``inside``."""
    model = _mlp()

    class Slow(torch.nn.Module):
        def forward(self, x):
            inside.set()
            time.sleep(seconds)
            return model(x)

    slow = Slow()
    slow.evaluate = lambda: slow
    return PredictionService(slow, num_threads=2, max_batch=2,
                             batch_timeout_ms=1.0, sample_ndim=1,
                             service_name=name)


def test_an_idle_batcher_leaves_the_capture_to_a_launching_loop(
        rec, tmp_path):
    """A batcher with nothing queued (its drain thread still alive) does
    not take a capture asked for while another service runs a batch: the
    launching service's drain takes it when its batch ends."""
    idle = PredictionService(_mlp(), num_threads=2, max_batch=2,
                             batch_timeout_ms=1.0, sample_ndim=1,
                             service_name="pred-quiet")
    x = np.ones(8, np.float32)
    idle.predict(x)
    inside = threading.Event()
    busy = _slow_service("pred-busy", inside)
    box = {}
    t = threading.Thread(target=lambda: box.update(out=busy.predict(x)))
    t.start()
    assert inside.wait(30)
    _, took = _timed_capture(tmp_path)
    t.join(timeout=60)
    assert box["out"].shape == (3,)
    assert _start_threads(rec) == ["pred-busy-drain"]
    assert took >= CAPTURE_S


def test_generation_service_batcher_hosts_the_capture(rec, tmp_path):
    from bigdl_tpu_torch.models.transformer import TransformerLM

    torch.manual_seed(31)
    lm = TransformerLM(32, embed_dim=16, num_heads=4, num_kv_heads=2,
                       num_layers=1, max_len=48, use_rope=True, device="cpu")
    lm.evaluate()
    svc = GenerationService(lm, max_batch=2, batch_timeout_ms=1.0,
                            bucket_tokens=4, service_name="gen-host")
    path, took, during = _under_load(
        lambda r: svc.generate(list(r.randint(0, 32, (5,))), 3), tmp_path)
    assert _start_threads(rec) == ["gen-host-drain"]
    assert took >= CAPTURE_S and during >= 1
    assert any(n.startswith("aten::") for n in _trace_ops(path))


def test_a_capture_asked_for_inside_a_long_batch_window_is_hosted(
        rec, tmp_path, monkeypatch):
    """A batch window longer than ``HANDOFF_S`` (the phase-6 server's
    500 ms against 0.5 s, here 200 ms against 50 ms): the drain thread
    waits it out, takes the capture meanwhile, and the batch at the
    window's end is in the trace."""
    monkeypatch.setattr(profiler, "HANDOFF_S", 0.05)
    svc = PredictionService(_mlp(), num_threads=4, max_batch=8,
                            batch_timeout_ms=200.0, sample_ndim=1,
                            service_name="pred-window")
    x = np.ones(8, np.float32)
    box = {}

    def ask():
        box["out"] = svc.predict(x)

    t = threading.Thread(target=ask)
    t.start()
    time.sleep(0.05)                       # inside the window
    path, took = _timed_capture(tmp_path)
    t.join(timeout=60)
    assert box["out"].shape == (3,)
    assert _start_threads(rec) == ["pred-window-drain"]
    assert took >= CAPTURE_S
    assert any(n.startswith("aten::") for n in _trace_ops(path))


def test_a_batch_longer_than_the_handoff_wait_still_hosts_the_capture(
        rec, tmp_path, monkeypatch):
    """A capture asked for while the drain thread runs a batch that
    outlasts ``HANDOFF_S`` waits for the batch's end and starts on the
    drain thread, not on the caller's."""
    monkeypatch.setattr(profiler, "HANDOFF_S", 0.05)
    inside = threading.Event()
    svc = _slow_service("pred-slow", inside)
    x = np.ones(8, np.float32)
    box = {}
    t = threading.Thread(target=lambda: box.update(out=svc.predict(x)))
    t.start()
    assert inside.wait(30)
    path, took = _timed_capture(tmp_path)
    t.join(timeout=60)
    assert box["out"].shape == (3,)
    assert _start_threads(rec) == ["pred-slow-drain"]
    assert took >= CAPTURE_S


def test_a_drain_thread_that_dies_answers_its_requests_and_is_replaced(
        monkeypatch):
    """A fault outside the batch's own error handling fails the waiting
    requests with an error naming it, and the next request starts a new
    drain thread."""
    real_poll, calls = profiler.poll, []

    def poll_once_broken():
        calls.append(1)
        if len(calls) == 1:
            raise OSError("poll broke")
        return real_poll()

    monkeypatch.setattr(profiler, "poll", poll_once_broken)
    mb = _MicroBatcher(lambda b: b * 2, max_batch=4, timeout_ms=1.0,
                       submit_timeout_s=30.0)
    with pytest.raises(RuntimeError, match="drain thread died.*poll broke"):
        mb.submit(np.ones(2, np.float32))
    np.testing.assert_array_equal(mb.submit(np.ones(2, np.float32)),
                                  [2.0, 2.0])


def test_generation_service_hosts_the_capture_inside_a_long_window(
        rec, tmp_path, monkeypatch):
    """The phase-6 server's settings at a small size: ``max_batch`` 8 and
    a window four times ``HANDOFF_S`` (200 ms against 50 ms), a capture
    asked for while the window runs."""
    monkeypatch.setattr(profiler, "HANDOFF_S", 0.05)
    from bigdl_tpu_torch.models.transformer import TransformerLM

    torch.manual_seed(33)
    lm = TransformerLM(32, embed_dim=16, num_heads=4, num_kv_heads=2,
                       num_layers=1, max_len=48, use_rope=True, device="cpu")
    lm.evaluate()
    svc = GenerationService(lm, max_batch=8, batch_timeout_ms=200.0,
                            bucket_tokens=4, service_name="gen-window")
    rs = np.random.RandomState(34)
    answers = [None] * 3

    def ask(i):
        answers[i] = svc.generate(list(rs.randint(0, 32, (5,))), 3)

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    path, took = _timed_capture(tmp_path)
    for t in threads:
        t.join(timeout=60)
    assert all(a is not None and a.shape == (8,) for a in answers)
    assert _start_threads(rec) == ["gen-window-drain"]
    assert took >= CAPTURE_S
    assert any(n.startswith("aten::") for n in _trace_ops(path))


def _samples(n=64):
    rs = np.random.RandomState(0)
    return [Sample(rs.randn(8).astype(np.float32), float(i % 3 + 1))
            for i in range(n)]


def _train_in_thread(make_opt, name, tmp_path):
    done = threading.Event()
    opt = make_opt()

    def run():
        try:
            opt.optimize()
        finally:
            done.set()

    t = threading.Thread(target=run, name=name)
    t.start()
    try:
        deadline = time.monotonic() + 60
        while opt.optim_method.state.get("neval", 1) < 3:   # stepping
            assert time.monotonic() < deadline and not done.is_set()
            time.sleep(0.01)
        path, took = _timed_capture(tmp_path)
    finally:
        opt.end_when = Trigger.max_iteration(0)   # stop at the next step
        t.join(timeout=120)
    return path, took


def _classifier():
    torch.manual_seed(4)
    return tnn.Sequential(tnn.Linear(8, 16, device="cpu"), tnn.Tanh(),
                          tnn.Linear(16, 3, device="cpu"), tnn.LogSoftMax())


def test_local_optimizer_loop_hosts_the_capture(rec, tmp_path):
    def make():
        opt = Optimizer(model=_classifier(), dataset=_samples(),
                        criterion=tnn.ClassNLLCriterion(), batch_size=8,
                        end_when=Trigger.max_iteration(10 ** 7))
        return opt.set_optim_method(SGD(learning_rate=0.01))

    path, took = _train_in_thread(make, "local-train", tmp_path)
    assert _start_threads(rec) == ["local-train"]
    assert took >= CAPTURE_S
    assert any(n.startswith("aten::") for n in _trace_ops(path))


def test_distri_optimizer_loop_hosts_the_capture(rec, tmp_path):
    from bigdl_tpu_torch.parallel import DistriOptimizer

    def make():
        opt = DistriOptimizer(model=_classifier(),
                              dataset=DataSet.sharded(_samples(), 0, 1),
                              criterion=tnn.ClassNLLCriterion(), batch_size=8,
                              end_when=Trigger.max_iteration(10 ** 7))
        return opt.set_optim_method(SGD(learning_rate=0.01))

    path, took = _train_in_thread(make, "distri-train", tmp_path)
    assert _start_threads(rec) == ["distri-train"]
    assert took >= CAPTURE_S
    assert any(n.startswith("aten::") for n in _trace_ops(path))
