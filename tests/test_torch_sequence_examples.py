"""The port's sequence mains (bigdl_tpu_torch/example/languagemodel,
example/treeLSTMSentiment, models/rnn/train.py) against the JAX
package's: the cases of tests/test_examples.py and
tests/test_zoo_mains.py at their sizes, run with ``--device cpu``.

The language model of the main, on JAX weights carried across, gives
the JAX model's forward and parameter gradients (f32 rtol 1e-5 / atol
1e-6), and one Adagrad step of each package's ``Optimizer`` over the
same first batch (both ``LocalDataSet``s shuffle with one numpy seed)
the same loss and parameters (rtol 1e-5 / atol 1e-6). The data helpers
give the JAX samples byte for byte.
"""

import json

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset.dataset import LocalDataSet as JaxLocalDataSet
from bigdl_tpu.example.languagemodel import train as jlm
from bigdl_tpu.example.treeLSTMSentiment import train as jtree
from bigdl_tpu.models.rnn import train as jrnn
from bigdl_tpu.optim.optim_method import Adagrad as JaxAdagrad
from bigdl_tpu.optim.optimizer import Optimizer as JaxOptimizer
from bigdl_tpu.optim.trigger import Trigger as JaxTrigger
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.dataset.dataset import LocalDataSet
from bigdl_tpu_torch.example.languagemodel import train as lm
from bigdl_tpu_torch.example.treeLSTMSentiment import train as tree
from bigdl_tpu_torch.models.rnn import train as rnn
from bigdl_tpu_torch.optim.optim_method import Adagrad
from bigdl_tpu_torch.optim.optimizer import Optimizer
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.utils.weights import load_jax_params, params_to_numpy
from tests.jax_numpy_init import numpy_weight_draws
from tests.test_torch_graph import TOL, like_jax

CPU = ["--device", "cpu"]


def _same_samples(ours, theirs):
    assert len(ours) == len(theirs)
    for s, js in zip(ours, theirs):
        assert [f.tobytes() for f in s.features] == \
            [np.asarray(f).tobytes() for f in js.features]
        assert [x.tobytes() for x in s.labels] == \
            [np.asarray(x).tobytes() for x in js.labels]


# ------------------------------------------------------- language model
def test_language_model_matches_jax():
    with numpy_weight_draws(1):
        jm = jlm.build_model(20, 8, 16)
    tm = lm.build_model(20, 8, 16, device="cpu")
    ids = np.random.RandomState(2).randint(1, 21, (4, 8)).astype(np.int64)
    out = like_jax(jm, tm, ids)[0]
    assert tuple(out.shape) == (4, 8, 20)
    stream, vocab = lm.load_tokens(None, 20)
    j_stream, j_vocab = jlm.load_tokens(None, 20)
    assert vocab == j_vocab and stream.tobytes() == j_stream.tobytes()
    _same_samples(lm.windows(stream, 8), jlm.windows(j_stream, 8))


def test_language_model_adagrad_step_matches_jax():
    stream, vocab = lm.load_tokens(None, 20)
    with numpy_weight_draws(3):
        jm = jlm.build_model(vocab, 8, 16)
    tm = lm.build_model(vocab, 8, 16, device="cpu")
    before = jax.tree.map(np.asarray, jm.params_dict())
    load_jax_params(tm, before)
    runs = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            opt = JaxOptimizer(
                model=jm, dataset=JaxLocalDataSet(jlm.windows(stream, 8)),
                criterion=jnn.TimeDistributedCriterion(
                    jnn.ClassNLLCriterion(), size_average=True),
                batch_size=8, end_when=JaxTrigger.max_iteration(1))
            method = JaxAdagrad(learning_rate=0.1)
        else:
            opt = Optimizer(
                model=tm, dataset=LocalDataSet(lm.windows(stream, 8)),
                criterion=tnn.TimeDistributedCriterion(
                    tnn.ClassNLLCriterion(), size_average=True),
                batch_size=8, end_when=Trigger.max_iteration(1))
            method = Adagrad(learning_rate=0.1)
        opt.set_optim_method(method)
        trained = opt.optimize()
        runs.append((float(method.state["Loss"]), trained))
    (j_loss, j_trained), (t_loss, t_trained) = runs
    np.testing.assert_allclose(t_loss, j_loss, **TOL)
    ours = jax.tree.leaves(params_to_numpy(t_trained))
    theirs = jax.tree.leaves(jax.tree.map(np.asarray,
                                          j_trained.params_dict()))
    assert len(ours) == len(theirs) == 6
    for o, t, b in zip(ours, theirs, jax.tree.leaves(before)):
        np.testing.assert_allclose(o, t, **TOL)
        assert np.abs(o - b).max() > 1e-4          # the step moved it


def test_languagemodel_example(capsys):
    trained = lm.main(["--vocab", "20", "--num-steps", "8", "--batch-size",
                       "8", "--max-epoch", "1", "--hidden", "16", "--embed",
                       "8"] + CPU)
    assert trained is not None
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["iterations"] == 7              # 49 windows, batch 8
    assert np.isfinite(summary["last_loss"])
    assert summary["ms_per_step"] > 0 and summary["records_per_sec"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lm.build_model(20, 8, 16)


# ---------------------------------------------------- tree sentiment
def test_treelstm_sentiment_example(capsys):
    x, trees, labels = tree.synthetic_trees(16, 2, 4)
    jx, jtrees, jlabels = jtree.synthetic_trees(16, 2, 4)
    for a, b in ((x, jx), (trees, jtrees), (labels, jlabels)):
        assert a.tobytes() == b.tobytes()
    loss, acc = tree.main(["--samples", "16", "--leaves", "2",
                           "--embed-dim", "4", "--hidden", "8", "--epochs",
                           "15", "--lr", "0.3"] + CPU)
    assert acc >= 0.7, acc
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["root_accuracy"] == acc and summary["last_loss"] == loss
    assert summary["last_loss"] < summary["first_loss"]


# ---------------------------------------------------------- SimpleRNN main
def test_rnn_train_main_smoke(tmp_path):
    with open(tmp_path / "train.txt", "w") as f:
        f.write("the cat sat on the mat. " * 20)
    samples, dictionary = rnn.build_samples(str(tmp_path), 50, 12)
    j_samples, j_dictionary = jrnn.build_samples(str(tmp_path), 50, 12)
    assert dictionary.vocab_size() == j_dictionary.vocab_size()
    _same_samples(samples, j_samples)
    model = rnn.main(["-f", str(tmp_path), "-b", "4", "--max-iteration",
                      "2", "--vocab-size", "50", "--hidden-size", "16",
                      "--seq-len", "12"] + CPU)
    assert model is not None
    out = model(torch.tensor(samples[0].feature()[None]))
    assert tuple(out.shape) == (1, 12, dictionary.vocab_size())
