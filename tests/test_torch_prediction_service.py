"""The port's PredictionService (bigdl_tpu_torch/optim/prediction_service.py)
against the JAX package's: the nine cases of
tests/test_prediction_service.py on the port, each output held to the
JAX model on the same weights, and the Activity codec both ways (bytes
written by either package decode in the other).

Tolerance: f32 at rtol 1e-5 (a lone forward) and rtol 1e-4 / atol 1e-5
(a micro-batched forward: another batch shape), as the JAX tests.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bigdl_tpu import nn as jnn
from bigdl_tpu.optim import prediction_service as jps
from bigdl_tpu.utils.table import Table as JTable
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.optim.prediction_service import (
    PredictionService, _MicroBatcher, deserialize_activity,
    serialize_activity)
from bigdl_tpu_torch.utils.table import Table
from bigdl_tpu_torch.utils.weights import load_jax_params


def _models():
    """(JAX model, port model) on the same weights."""
    from bigdl_tpu.utils import random as rnd

    rnd.set_seed(11)
    jm = (jnn.Sequential().add(jnn.Linear(8, 16)).add(jnn.ReLU())
          .add(jnn.Linear(16, 4)).add(jnn.SoftMax()))
    tm = (nn.Sequential().add(nn.Linear(8, 16, device="cpu")).add(nn.ReLU())
          .add(nn.Linear(16, 4, device="cpu")).add(nn.SoftMax()))
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    return jm, tm


def _ref(jm, x):
    return np.asarray(jm(jnp.asarray(x)))


def test_activity_codec_roundtrip():
    x = np.random.RandomState(0).randn(3, 8).astype(np.float32)
    assert np.allclose(deserialize_activity(serialize_activity(x)), x)
    t = Table(x, 2 * x)
    back = deserialize_activity(serialize_activity(t))
    assert np.allclose(back[1], x) and np.allclose(back[2], 2 * x)


def test_codec_reads_across_packages():
    """Bytes either package writes decode in the other, tensors and
    Tables with int and str keys, and error tensors."""
    x = np.random.RandomState(1).randn(2, 5).astype(np.float32)
    ids = np.arange(6, dtype=np.int64)
    np.testing.assert_array_equal(
        jps.deserialize_activity(serialize_activity(x)), x)
    np.testing.assert_array_equal(
        deserialize_activity(jps.serialize_activity(x)), x)
    back = jps.deserialize_activity(serialize_activity(Table(x, ids=ids)))
    np.testing.assert_array_equal(back[1], x)
    np.testing.assert_array_equal(back["ids"], ids)
    back = deserialize_activity(jps.serialize_activity(JTable(x, ids=ids)))
    assert isinstance(back, Table)
    np.testing.assert_array_equal(back[1], x)
    np.testing.assert_array_equal(back["ids"], ids)
    assert serialize_activity(x) == jps.serialize_activity(x)
    err = jps._error_tensor("running forward", ValueError("boom"))
    assert str(deserialize_activity(jps.serialize_activity(err))) == \
        str(err)


def test_predict_matches_model_and_is_host_copy():
    jm, tm = _models()
    svc = PredictionService(tm, num_threads=2)
    x = np.random.RandomState(1).randn(5, 8).astype(np.float32)
    out = svc.predict(x)
    np.testing.assert_allclose(out, _ref(jm, x), rtol=1e-5)
    assert isinstance(out, np.ndarray)


def test_concurrent_clients_no_recompile():
    """Eight clients share one module; every answer equals the JAX
    model's, and every request is counted as one dispatch (nothing to
    recompile in eager PyTorch)."""
    jm, tm = _models()
    svc = PredictionService(tm, num_threads=4)
    x = np.random.RandomState(2).randn(2, 8).astype(np.float32)
    ref = _ref(jm, x)
    svc.predict(x)
    results, errs = [], []

    def client():
        try:
            for _ in range(5):
                results.append(np.asarray(svc.predict(x)))
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=client) for _ in range(8)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert not errs
    assert len(results) == 40
    for r in results:
        np.testing.assert_allclose(r, ref, rtol=1e-5)
    assert svc.stats() == {"served": 41, "dispatches": 41,
                           "mean_batch_occupancy": 1.0}


def test_bytes_protocol_roundtrip():
    jm, tm = _models()
    svc = PredictionService(tm, num_threads=1)
    x = np.random.RandomState(3).randn(4, 8).astype(np.float32)
    out = deserialize_activity(svc.predict(serialize_activity(x)))
    np.testing.assert_allclose(out, _ref(jm, x), rtol=1e-5)
    # the JAX package's encoder in, its decoder out
    out = jps.deserialize_activity(svc.predict(jps.serialize_activity(x)))
    np.testing.assert_allclose(out, _ref(jm, x), rtol=1e-5)


def test_error_returns_scalar_not_raise():
    _, tm = _models()
    svc = PredictionService(tm, num_threads=1)
    bad = np.zeros((3, 5), np.float32)  # wrong feature dim
    out = svc.predict(bad)
    assert out.dtype.kind == "U" and "running forward" in str(out)
    back = deserialize_activity(svc.predict(b"not an npz"))
    assert "DeSerialize Input" in str(back)


def test_micro_batching_coalesces():
    jm, tm = _models()
    svc = PredictionService(tm, num_threads=8, max_batch=8,
                            batch_timeout_ms=30.0)
    x1 = np.random.RandomState(4).randn(8).astype(np.float32)
    ref = _ref(jm, x1[None])[0]
    outs = [None] * 6

    def client(i):
        outs[i] = np.asarray(svc.predict(x1))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    for o in outs:
        np.testing.assert_allclose(o, ref, rtol=1e-4, atol=1e-5)
    st = svc.stats()
    assert st["served"] == 6 and st["dispatches"] < 6


def test_micro_batcher_groups_by_shape():
    """Mixed request shapes never stack together; with ``sample_ndim``
    a batched request runs alone."""
    jm, tm = _models()
    svc = PredictionService(tm, num_threads=8, max_batch=4,
                            batch_timeout_ms=20.0, sample_ndim=1)
    xs = np.random.RandomState(6).randn(2, 8).astype(np.float32)
    x1 = xs[0]
    ref1 = _ref(jm, x1[None])[0]
    refb = _ref(jm, xs)
    outs = {}

    def single(i):
        outs[f"s{i}"] = np.asarray(svc.predict(x1))

    def batched(i):
        outs[f"b{i}"] = np.asarray(svc.predict(xs))

    threads = ([threading.Thread(target=single, args=(i,)) for i in range(3)]
               + [threading.Thread(target=batched, args=(i,))
                  for i in range(2)])
    [t.start() for t in threads]
    [t.join() for t in threads]
    for i in range(3):
        np.testing.assert_allclose(outs[f"s{i}"], ref1, rtol=1e-4, atol=1e-5)
    for i in range(2):
        np.testing.assert_allclose(outs[f"b{i}"], refb, rtol=1e-4, atol=1e-5)


def test_table_request_preserves_keys():
    class KeyedModel(nn.Module):
        def forward(self, t):
            return t["a"] + 2.0 * t["b"]

    m = KeyedModel()
    svc = PredictionService(m, num_threads=1)
    out = svc.predict(Table(a=np.ones((2,), np.float32),
                            b=np.full((2,), 3.0, np.float32)))
    np.testing.assert_allclose(out, [7.0, 7.0])


def test_micro_batcher_submit_timeout_raises_instead_of_hanging():
    release = threading.Event()

    def wedged(batch):
        release.wait(30.0)
        return batch

    mb = _MicroBatcher(wedged, max_batch=4, timeout_ms=1.0,
                       submit_timeout_s=0.05)
    try:
        with pytest.raises(RuntimeError, match="drain thread died or"):
            mb.submit(np.zeros((2,), np.float32))
    finally:
        release.set()


def test_a_malformed_request_leaves_its_batch_mates_served():
    """A request that fails gets the error tensor; the requests around it
    are answered."""
    jm, tm = _models()
    svc = PredictionService(tm, num_threads=8, max_batch=4,
                            batch_timeout_ms=30.0, sample_ndim=1)
    x = np.random.RandomState(8).randn(8).astype(np.float32)
    ref = _ref(jm, x[None])[0]
    outs = {}

    def good(i):
        outs[i] = svc.predict(x)

    def bad():
        outs["bad"] = svc.predict(np.asarray(["not", "numbers"]))

    threads = [threading.Thread(target=good, args=(i,)) for i in range(3)]
    threads.append(threading.Thread(target=bad))
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert outs["bad"].dtype.kind == "U"
    for i in range(3):
        np.testing.assert_allclose(outs[i], ref, rtol=1e-4, atol=1e-5)


def test_registry_accepted_and_unused():
    """``registry=`` and ``service_name=`` feed the service's
    ``bdt_serve_*`` family (they were once accepted and ignored): with a
    fresh registry, the family's counters equal ``stats()``, standalone
    and micro-batched."""
    from bigdl_tpu_torch.observability import MetricRegistry

    _, tm = _models()
    reg = MetricRegistry()
    svc = PredictionService(tm, registry=reg, service_name="s")
    assert svc.stats() == {"served": 0, "dispatches": 0,
                           "mean_batch_occupancy": 0.0}
    x = np.random.RandomState(0).rand(3, 8).astype(np.float32)
    svc.predict(x)
    svc.predict(np.zeros((2,), np.float32))     # a forward that fails
    bat = PredictionService(tm, registry=reg, service_name="b",
                            max_batch=4, batch_timeout_ms=50.0,
                            sample_ndim=1)
    threads = [threading.Thread(target=bat.predict, args=(x[i],))
               for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)

    def fam(name, service):
        return reg.get(name).labels(service)

    for service, s in (("s", svc), ("b", bat)):
        st = s.stats()
        _, occ_sum, occ_n = fam("bdt_serve_batch_occupancy", service).get()
        assert fam("bdt_serve_dispatches_total", service).get() \
            == st["dispatches"] == occ_n
        assert occ_sum == st["served"]
        assert fam("bdt_serve_inflight_requests", service).get() == 0
    assert fam("bdt_serve_requests_total", "s").get() == 2
    assert fam("bdt_serve_errors_total", "s").get() == 1
    assert fam("bdt_serve_requests_total", "b").get() == 3
    assert bat.stats()["served"] == 3
