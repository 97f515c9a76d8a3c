"""The port's DataFrame estimators (bigdl_tpu_torch/dlframes/) against
the JAX package's.

Parity on copied weights (``load_jax_params``): ``DLModel.transform`` of
the same rows equals JAX's within rtol 1e-6 / atol 1e-6 (f32), custom
columns and a 19-row tail batch included (JAX pads the tail for its
jit, the port does not), and LeNet-5's classes equal JAX's on a frame of
one row and on 17 rows at batch 8 (a lone tail row, which LeNet-5's
``Reshape`` would take for one unbatched sample); a ``fit`` at ``batch_size = rows`` (one batch
an epoch, so the sample order cannot matter) ends after 5 epochs with
weights within rtol 1e-5 / atol 1e-6 of JAX's. The JAX package's six
behavioural cases (``tests/test_dlframes.py``) run as their
counterparts, with the same thresholds: regression mse < 0.05,
classifier accuracy > 0.9, the sklearn params contract and ``clone``.
"""

import jax
import numpy as np
import pandas as pd
import pytest

from bigdl_tpu import nn as jnn
from bigdl_tpu.dlframes import DLEstimator as JaxDLEstimator
from bigdl_tpu.optim.trigger import Trigger as JaxTrigger
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dlframes import (DLClassifier, DLClassifierModel,
                                      DLEstimator, DLImageReader, DLModel)
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.utils.random import RandomGenerator
from bigdl_tpu_torch.utils.weights import load_jax_params, params_to_numpy


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _regression_df(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    w = np.asarray([[1.0], [-2.0], [0.5], [3.0]], np.float32)
    y = x @ w + 0.1
    return pd.DataFrame({"features": list(x), "label": list(y)})


def _kw(seed=1):
    return dict(rng=RandomGenerator(seed), device="cpu")


def _pair(jax_model, torch_model):
    load_jax_params(torch_model, _np(jax_model.params_dict()))
    return jax_model, torch_model


def _mlp(mod, **kw):
    return (mod.Sequential().add(mod.Linear(4, 8, **kw)).add(mod.Tanh())
            .add(mod.Linear(8, 3, **kw)))


def test_transform_matches_jax_with_custom_cols_and_tail():
    df = _regression_df(n=19).rename(columns={"features": "f"})
    jm, tm = _pair(_mlp(jnn), _mlp(nn, device="cpu"))
    from bigdl_tpu.dlframes import DLModel as JaxDLModel

    want = JaxDLModel(jm, [4], features_col="f", prediction_col="pred",
                      batch_size=8).transform(df)
    got = DLModel(tm, [4], features_col="f", prediction_col="pred",
                  batch_size=8).transform(df)
    assert list(got.columns) == list(want.columns) == ["f", "label", "pred"]
    np.testing.assert_allclose(np.asarray(got["pred"].tolist()),
                               np.asarray(want["pred"].tolist()),
                               rtol=1e-6, atol=1e-6)
    # the classifier model: JAX's rule (argmax + 1 as int64) over JAX's
    # predictions, tail rows included
    cw = (np.argmax(np.asarray(want["pred"].tolist()), -1) + 1).tolist()
    cg = DLClassifierModel(tm, [4], features_col="f",
                           batch_size=8).transform(df)
    assert cg["prediction"].tolist() == cw
    assert all(type(v) is int for v in cg["prediction"].tolist())


@pytest.mark.parametrize("rows", [1, 17])
def test_lenet_transform_with_a_lone_tail_row_matches_jax(rows):
    from bigdl_tpu.dlframes import DLClassifierModel as JaxClassifierModel
    from bigdl_tpu.dlframes import DLModel as JaxDLModel
    from bigdl_tpu.models import LeNet5 as JaxLeNet5
    from bigdl_tpu_torch.models import LeNet5

    from tests.jax_numpy_init import numpy_weight_draws

    with numpy_weight_draws(6):
        jm = JaxLeNet5(10)
    _, tm = _pair(jm, LeNet5(10, device="cpu"))
    x = np.random.RandomState(7).rand(rows, 28, 28).astype(np.float32)
    df = pd.DataFrame({"features": list(x)})
    want = JaxClassifierModel(jm, [28, 28], batch_size=8).transform(df)
    got = DLClassifierModel(tm, [28, 28], batch_size=8).transform(df)
    assert len(got) == rows
    assert got["prediction"].tolist() == want["prediction"].tolist()
    want = JaxDLModel(jm, [28, 28], batch_size=8).transform(df)
    got = DLModel(tm, [28, 28], batch_size=8).transform(df)
    assert np.asarray(got["prediction"].tolist()).shape == (rows, 10)
    np.testing.assert_allclose(np.asarray(got["prediction"].tolist()),
                               np.asarray(want["prediction"].tolist()),
                               rtol=1e-6, atol=1e-6)


def test_one_batch_fit_matches_jax():
    df = _regression_df(n=24, seed=2)
    jm, tm = _pair(jnn.Sequential().add(jnn.Linear(4, 1)),
                   nn.Sequential().add(nn.Linear(4, 1, device="cpu")))
    JaxDLEstimator(jm, jnn.MSECriterion(), [4], [1]).set_batch_size(24) \
        .set_learning_rate(0.05).set_end_when(JaxTrigger.max_epoch(5)) \
        .fit(df)
    fitted = DLEstimator(tm, nn.MSECriterion(), [4], [1]) \
        .set_batch_size(24).set_learning_rate(0.05) \
        .set_end_when(Trigger.max_epoch(5)).fit(df)
    assert fitted.model is tm
    want = _np(jm.params_dict())
    got = params_to_numpy(tm)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_dlestimator_fit_transform_regression():
    df = _regression_df()
    model = nn.Sequential().add(nn.Linear(4, 1, **_kw(3)))
    est = (DLEstimator(model, nn.MSECriterion(), [4], [1])
           .set_batch_size(16)
           .set_learning_rate(0.05)
           .set_end_when(Trigger.max_epoch(60)))
    fitted = est.fit(df)
    out = fitted.transform(df)
    assert "prediction" in out.columns
    preds = np.asarray(out["prediction"].tolist()).reshape(-1)
    truth = np.asarray(df["label"].tolist()).reshape(-1)
    mse = float(np.mean((preds - truth) ** 2))
    assert mse < 0.05, mse


def test_dlclassifier_fit_transform():
    rng = np.random.RandomState(1)
    x = rng.randn(80, 2).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.int64) + 1  # classes 1/2
    df = pd.DataFrame({"features": list(x),
                       "label": list(y.astype(np.float32))})
    kw = _kw(4)
    model = (nn.Sequential().add(nn.Linear(2, 8, **kw)).add(nn.ReLU())
             .add(nn.Linear(8, 2, **kw)).add(nn.LogSoftMax()))
    clf = (DLClassifier(model, nn.ClassNLLCriterion(), [2])
           .set_batch_size(16).set_learning_rate(0.1)
           .set_end_when(Trigger.max_epoch(40)))
    fitted = clf.fit(df)
    out = fitted.transform(df)
    preds = np.asarray(out["prediction"].tolist())
    acc = float(np.mean(preds == y))
    assert acc > 0.9, acc
    assert set(np.unique(preds)) <= {1, 2}  # 1-based like the reference


def test_sklearn_style_params():
    model = nn.Sequential().add(nn.Linear(4, 1, device="cpu"))
    est = DLEstimator(model, nn.MSECriterion(), [4], [1])
    p = est.get_params()
    assert p["features_col"] == "features" and p["batch_size"] == 32
    assert tuple(p) == JaxDLEstimator._param_names
    est.set_params(batch_size=8, features_col="f2")
    assert est.batch_size == 8 and est.features_col == "f2"
    with pytest.raises(ValueError):
        est.set_params(bogus=1)


def test_transform_respects_custom_cols_and_tail_batch():
    df = _regression_df(n=19).rename(columns={"features": "f", "label": "y"})
    model = nn.Sequential().add(nn.Linear(4, 1, **_kw(5)))
    est = (DLEstimator(model, nn.MSECriterion(), [4], [1])
           .set_features_col("f").set_label_col("y")
           .set_prediction_col("pred").set_batch_size(8)
           .set_end_when(Trigger.max_epoch(1)))
    fitted = est.fit(df)
    out = fitted.transform(df)
    assert "pred" in out.columns and len(out) == 19


def test_dlimage_reader_npy(tmp_path):
    a = np.arange(12.0, dtype=np.float32).reshape(2, 2, 3)
    p = str(tmp_path / "img0.npy")
    np.save(p, a)
    df = DLImageReader.read_images([p])
    assert list(df.columns) == ["origin", "height", "width", "n_channels",
                                "data"]
    assert df.iloc[0]["data"].shape == (3, 2, 2)  # CHW


def test_sklearn_clone_compatible():
    """sklearn.base.clone rebuilds through type(est)(**est.get_params())."""
    from sklearn.base import clone

    model = nn.Sequential().add(nn.Linear(4, 1, device="cpu"))
    est = (DLEstimator(model, nn.MSECriterion(), [4], [1])
           .set_batch_size(8).set_prediction_col("p"))
    c = clone(est)
    assert c is not est
    assert c.batch_size == 8 and c.prediction_col == "p"
    clf = DLClassifier(model, nn.ClassNLLCriterion(), [4], batch_size=4)
    c2 = clone(clf)
    assert c2.batch_size == 4 and list(c2.label_size) == [1]
