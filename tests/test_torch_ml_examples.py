"""The port's MLPipeline and udfpredictor examples (bigdl_tpu_torch/
example/{MLPipeline,udfpredictor}/) as the JAX package's example tests
run theirs (``tests/test_examples.py``: held-out accuracy > 0.7 after
20 epochs, 1-based classes from the udf), plus ``make_udf`` held to the
JAX package's over the same weights: every row's class equal, with and
without micro-batching (``concurrent=True``), and a lone request of a
micro-batch (a stack of one) answered as the batched forward's row for
a model that infers the batch from the element count (LeNet-5)."""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np

from bigdl_tpu import nn as jnn
from bigdl_tpu.example.udfpredictor.predict import make_udf as jax_make_udf
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.example.udfpredictor.predict import make_udf
from bigdl_tpu_torch.utils.weights import load_jax_params


def test_udfpredictor_example():
    from bigdl_tpu_torch.example.udfpredictor.predict import main

    df = main(["--rows", "16", "--device", "cpu"])
    assert set(df["prediction"].unique()) <= {1, 2}


def test_mlpipeline_example():
    from bigdl_tpu_torch.example.MLPipeline.train import main

    acc = main(["--rows", "96", "--epochs", "20", "--device", "cpu"])
    assert acc > 0.7, acc


def test_make_udf_matches_jax_rows():
    def net(mod, **kw):
        return (mod.Sequential().add(mod.Linear(8, 16, **kw))
                .add(mod.ReLU()).add(mod.Linear(16, 3, **kw))
                .add(mod.SoftMax()))

    jm, tm = net(jnn), net(nn, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    rows = list(np.random.RandomState(3).randn(12, 8).astype(np.float32))
    want = [jax_make_udf(jm)(r) for r in rows]
    assert [make_udf(tm)(r) for r in rows] == want
    udf = make_udf(tm, concurrent=True)
    with ThreadPoolExecutor(8) as ex:
        assert list(ex.map(udf, rows)) == want


def test_lone_micro_batched_request_is_a_batch_of_one():
    """JAX pads every micro-batch to ``max_batch``; the port stacks a lone
    request with a copy of itself, so LeNet-5's ``Reshape`` sees a batch
    and the answer is the request's row, not the first logits of an
    unbatched forward."""
    import torch

    from bigdl_tpu_torch.models import LeNet5
    from bigdl_tpu_torch.optim.prediction_service import PredictionService

    m = LeNet5(10, device="cpu")
    x = np.random.RandomState(4).randn(28, 28).astype(np.float32)
    svc = PredictionService(m, max_batch=4, sample_ndim=2)
    got = svc.predict(x)
    with torch.no_grad():    # a stack of one would run unbatched
        want = m(torch.from_numpy(np.stack([x, x])))[0].numpy()
    assert got.shape == (10,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert svc.stats()["dispatches"] == 1
