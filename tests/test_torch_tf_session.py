"""``Session.train`` in the port (``bigdl_tpu_torch/utils/tf_session.py``)
against ``tests/test_tf_session.py`` and the JAX package's Session: an
UNFROZEN TF1 graph (VariableV2 + Assign initializers) trains with the
port's Optimizer, its Variables updating in place."""

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu.dataset.sample import Sample as JSample  # noqa: E402
from bigdl_tpu.optim.optim_method import SGD as JSGD  # noqa: E402
from bigdl_tpu.optim.trigger import Trigger as JTrigger  # noqa: E402
from bigdl_tpu.utils.tf_session import Session as JSession  # noqa: E402
from bigdl_tpu_torch import nn  # noqa: E402
from bigdl_tpu_torch.dataset.sample import Sample  # noqa: E402
from bigdl_tpu_torch.optim.optim_method import SGD  # noqa: E402
from bigdl_tpu_torch.optim.trigger import Trigger  # noqa: E402
from bigdl_tpu_torch.utils.tf_session import Session  # noqa: E402

W_TRUE = np.asarray([[1.0], [-2.0], [0.5]], np.float32)


def _build_tf1_linear_graph(path, w0, b0):
    g = tf.Graph()
    with g.as_default():
        x = tf.compat.v1.placeholder(tf.float32, [None, 3], name="x")
        w = tf.compat.v1.get_variable(
            "w", initializer=tf.constant(w0))
        b = tf.compat.v1.get_variable(
            "b", initializer=tf.constant(b0))
        tf.identity(tf.matmul(x, w) + b, name="pred")
    with open(path, "wb") as f:
        f.write(g.as_graph_def().SerializeToString())


@pytest.fixture(scope="module")
def linear_pb(tmp_path_factory):
    pb = str(tmp_path_factory.mktemp("tf_session") / "train.pb")
    _build_tf1_linear_graph(pb, np.zeros((3, 1), np.float32),
                            np.zeros((1,), np.float32))
    return pb


def _data(n):
    rng = np.random.RandomState(0)
    x = rng.randn(n, 3).astype(np.float32)
    return x, x @ W_TRUE + 0.25


def test_session_trains_imported_variables(linear_pb):
    sess = Session(linear_pb, ["x"], ["pred"], device="cpu")
    # imported variables are trainable parameters with their init values
    assert set(sess._loader.variables) == {"w", "b"}
    w_param = sess._loader.variables["w"].value
    x, y = _data(64)
    samples = [Sample(x[i], y[i]) for i in range(64)]
    sess.train(samples, nn.MSECriterion(),
               optim_method=SGD(learning_rate=0.2),
               end_when=Trigger.max_epoch(40), batch_size=16)
    pred = sess.predict(x).numpy()
    mse = float(np.mean((pred - y) ** 2))
    assert mse < 0.01, mse
    # the learned weight variable approximates the target, in place
    assert sess._loader.variables["w"].value is w_param
    np.testing.assert_allclose(w_param.detach().numpy(), W_TRUE, atol=0.15)


def test_one_sgd_step_equals_jax(linear_pb):
    """One SGD step on the same 16-sample batch moves the port's
    Variables as the JAX package's Session moves its own."""
    x, y = _data(16)
    jsess = JSession(linear_pb, ["x"], ["pred"])
    jsess.train([JSample(x[i], y[i]) for i in range(16)], jnn.MSECriterion(),
                optim_method=JSGD(learning_rate=0.2),
                end_when=JTrigger.max_iteration(1), batch_size=16)
    sess = Session(linear_pb, ["x"], ["pred"], device="cpu")
    sess.train([Sample(x[i], y[i]) for i in range(16)], nn.MSECriterion(),
               optim_method=SGD(learning_rate=0.2),
               end_when=Trigger.max_iteration(1), batch_size=16)
    for name in ("w", "b"):
        want = np.asarray(jsess._loader.variables[name].value)
        got = sess._loader.variables[name].value.detach().numpy()
        assert np.abs(want).max() > 1e-3, name   # the step moved it
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sess.predict(torch.from_numpy(x)).numpy(),
                               np.asarray(jsess.predict(x)),
                               rtol=1e-5, atol=1e-6)
