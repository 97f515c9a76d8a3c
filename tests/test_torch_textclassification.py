"""The port's text-classification trainer
(``bigdl_tpu_torch/example/textclassification/train.py``) held against
the JAX main (``bigdl_tpu/example/textclassification/train.py``).

``vectorize`` gives the JAX samples byte for byte (hashed embeddings and
a GloVe dict, an empty document keeping its label). The model carries
the JAX weights across (``load_jax_params``) and one SGD step of each
package's ``Optimizer`` over the same first batch (both ``LocalDataSet``s
shuffle with the same numpy seed) gives the same parameters within 1e-5
and the same loss within 1e-5 (f32). The main reaches the JAX test's bar
at the JAX test's sizes.
"""

import json

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset.dataset import LocalDataSet as JaxLocalDataSet
from bigdl_tpu.dataset.news20 import synthetic_news20
from bigdl_tpu.example.textclassification import train as jtrain
from bigdl_tpu.optim.optim_method import SGD as JaxSGD
from bigdl_tpu.optim.optimizer import Optimizer as JaxOptimizer
from bigdl_tpu.optim.trigger import Trigger as JaxTrigger
from bigdl_tpu.utils import random as jrandom
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.dataset.dataset import LocalDataSet
from bigdl_tpu_torch.example.textclassification import train
from bigdl_tpu_torch.optim.optim_method import SGD
from bigdl_tpu_torch.optim.optimizer import Optimizer
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.utils.weights import load_jax_params, params_to_numpy

TOL = dict(rtol=1e-5, atol=1e-5)


def _same_samples(ours, theirs):
    assert len(ours) == len(theirs)
    for s, js in zip(ours, theirs):
        assert s.feature().tobytes() == js.feature().tobytes()
        assert s.label().tobytes() == js.label().tobytes()


def test_vectorize_gives_the_jax_samples():
    texts = synthetic_news20(n=24, class_num=3)
    _same_samples(train.vectorize(texts, 32, 20),
                  jtrain.vectorize(texts, 32, 20))
    w2v = {"the": [0.5] * 100, "orbit": list(np.arange(100) / 7.0)}
    _same_samples(train.vectorize(texts, 16, 50, w2v),
                  jtrain.vectorize(texts, 16, 50, w2v))


def test_vectorize_keeps_labels_aligned_with_empty_docs():
    texts = [("hello world", 1), ("   ", 2), ("goodbye moon", 3)]
    samples = train.vectorize(texts, 4, 8, None)
    assert [int(s.label()[0]) for s in samples] == [1, 2, 3]
    assert np.abs(samples[1].feature()).sum() == 0   # empty doc: zeros
    _same_samples(samples, jtrain.vectorize(texts, 4, 8, None))


def test_build_model_has_the_jax_tree():
    jrandom.set_seed(0)
    jm = jtrain.build_model(4, 32, 20)
    tm = train.build_model(4, 32, 20, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    x = np.random.RandomState(0).randn(5, 32, 20).astype(np.float32)
    np.testing.assert_allclose(tm(torch.tensor(x)).detach().numpy(),
                               np.asarray(jm.forward(x)), **TOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.build_model(4)


def test_one_sgd_step_on_jax_weights_matches_the_jax_step():
    texts = synthetic_news20(n=48, class_num=3)
    samples = train.vectorize(texts, 32, 20)
    jrandom.set_seed(0)
    jm = jtrain.build_model(3, 32, 20)
    tm = train.build_model(3, 32, 20, device="cpu")
    before = jax.tree.map(np.asarray, jm.params_dict())
    load_jax_params(tm, before)

    j_opt = JaxOptimizer(model=jm, dataset=JaxLocalDataSet(
        jtrain.vectorize(texts, 32, 20)), criterion=jnn.ClassNLLCriterion(),
        batch_size=16, end_when=JaxTrigger.max_iteration(1))
    j_method = JaxSGD(learning_rate=0.1)
    j_opt.set_optim_method(j_method)
    j_trained = j_opt.optimize()

    t_opt = Optimizer(model=tm, dataset=LocalDataSet(samples),
                      criterion=tnn.ClassNLLCriterion(), batch_size=16,
                      end_when=Trigger.max_iteration(1))
    t_method = SGD(learning_rate=0.1)
    t_opt.set_optim_method(t_method)
    t_trained = t_opt.optimize()

    np.testing.assert_allclose(float(t_method.state["Loss"]),
                               float(j_method.state["Loss"]), **TOL)
    ours = params_to_numpy(t_trained)
    theirs = jax.tree.map(np.asarray, j_trained.params_dict())
    flat_o, _ = jax.tree.flatten(ours)
    flat_t, _ = jax.tree.flatten(theirs)
    assert len(flat_o) == len(flat_t) == 4
    for o, t, b in zip(flat_o, flat_t, jax.tree.leaves(before)):
        np.testing.assert_allclose(o, t, **TOL)
        assert np.abs(o - b).max() > 1e-4          # the step moved it


def test_main_learns_at_the_jax_test_sizes(capsys):
    _, acc = train.main(["--samples", "96", "--class-num", "3",
                         "--max-epoch", "8", "--device", "cpu"])
    assert acc > 0.85, acc
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-2].startswith("validation accuracy:")
    summary = json.loads(out[-1])
    assert summary["iterations"] == 8 * 5          # 76 records, batch 16
    assert summary["validation_accuracy"] == acc
    assert summary["ms_per_step"] > 0 and summary["records_per_sec"] > 0
