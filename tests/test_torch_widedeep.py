"""The port's wide-and-deep example (bigdl_tpu_torch/example/widedeep/
train.py) against the JAX package's (bigdl_tpu/example/widedeep/train.py).

``synthetic_census`` draws the same rows from numpy's ``RandomState`` in
both packages and ``preprocess`` (the feature columns on the host) gives
JAX's arrays exactly. ``build_wide_deep`` on the JAX weights, carried by
``load_jax_params``, gives JAX's forward and input and parameter
gradients (rtol 1e-5 / atol 1e-6), and one Adam step of each package's
``Optimizer`` from the same Samples gives JAX's loss and parameters. The
port's main learns the crossed feature as the JAX test asks (held-out
accuracy above the majority baseline + 0.08), and the held-out rows
serialized as ``tf.Example`` records come back through ``ParseExample``
as the same features.
"""

import json
import logging

import jax
import numpy as np
import torch

from bigdl_tpu.dataset.sample import Sample as JaxSample
from bigdl_tpu.example.widedeep import train as jwd
from bigdl_tpu.optim import optim_method as jom
from bigdl_tpu.optim.optimizer import Optimizer as JaxOptimizer
from bigdl_tpu.optim.trigger import Trigger as JaxTrigger
from bigdl_tpu.utils.table import Table as JaxTable
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.example.widedeep import train as wd
from bigdl_tpu_torch.nn.module import tree_leaves
from bigdl_tpu_torch.utils import protowire as pw
from bigdl_tpu_torch.utils.table import Table
from bigdl_tpu_torch.utils.weights import load_jax_params
from tests.test_torch_graph import like_jax

CPU = dict(device="cpu")
ROWS, LABELS = wd.synthetic_census(192, seed=5)


def _jax_params(jm):
    return jax.tree.map(np.asarray, jm.params_dict())


def test_synthetic_census_and_preprocess_match_jax():
    jrows, jlabels = jwd.synthetic_census(192, seed=5)
    assert ROWS == jrows
    np.testing.assert_array_equal(LABELS, jlabels)
    wide, deep = wd.preprocess(ROWS)
    jwide, jdeep = jwd.preprocess(jrows)
    assert wide.dtype == jwide.dtype == np.float32
    assert deep.dtype == jdeep.dtype == np.int32
    np.testing.assert_array_equal(wide, jwide)
    np.testing.assert_array_equal(deep, jdeep)
    assert wide.shape == (192, 6 + wd.HASH_OCC + wd.HASH_CROSS)
    assert (wide.sum(1) == 3).all()          # one hot in each column


def test_build_wide_deep_matches_jax_forward_and_gradients():
    wide, deep = wd.preprocess(ROWS[:16])
    jm = jwd.build_wide_deep(wide.shape[1])
    tm = wd.build_wide_deep(wide.shape[1], **CPU)
    like_jax(jm, tm, JaxTable(wide, deep))


class _Losses(logging.Handler):
    def __init__(self):
        super().__init__()
        self.losses = []

    def emit(self, record):
        if "Throughput" in record.msg:
            self.losses.append(record.args[-1])


def _one_step(opt_cls, trig, adam, crit, model, samples, logger_name):
    opt = opt_cls(model=model, dataset=samples, criterion=crit,
                  batch_size=len(samples), end_when=trig.max_iteration(1))
    opt.set_optim_method(adam(learning_rate=0.01))
    logger = logging.getLogger(logger_name)
    handler, level = _Losses(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        opt.optimize()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    return handler.losses


def test_one_adam_step_matches_jax():
    wide, deep = wd.preprocess(ROWS[:32])
    y = LABELS[:32, None]
    jm = jwd.build_wide_deep(wide.shape[1])
    tm = wd.build_wide_deep(wide.shape[1], **CPU)
    load_jax_params(tm, _jax_params(jm))
    j_losses = _one_step(JaxOptimizer, JaxTrigger, jom.Adam,
                         jwd.nn.BCECriterion(), jm,
                         [JaxSample([wide[i], deep[i]], y[i])
                          for i in range(32)], "bigdl_tpu.optim")
    losses = _one_step(topt.Optimizer, topt.Trigger, topt.Adam,
                       tnn.BCECriterion(), tm,
                       [Sample([wide[i], deep[i]], y[i]) for i in range(32)],
                       "bigdl_tpu_torch.optim")
    assert len(losses) == len(j_losses) == 1
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    theirs = dict(tree_leaves(_jax_params(jm)))
    for name, ours in tree_leaves(tm.params_dict()):
        np.testing.assert_allclose(ours.detach().numpy(), theirs[name],
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_widedeep_example_feature_columns_learn(capsys):
    """Wide&Deep over BucketizedCol/HashBucket/CrossCol/IndicatorCol: the
    crossed wide feature must lift accuracy well above the majority class
    (the JAX test's sizes and bound)."""
    _, acc, base = wd.main(["--samples", "1024", "--max-epoch", "8",
                            "--device", "cpu"])
    assert acc > base + 0.08, (acc, base)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["iterations"] == 8 * 15        # 921 records at 64
    assert summary["held_out_accuracy"] == acc
    assert summary["majority_baseline"] == base
    assert summary["ms_per_step"] > 0 and summary["records_per_sec"] > 0


def example_records(wide, deep):
    """Each row as a tf.Example with a float feature "wide" and an int64
    feature "deep", encoded with the port's protowire."""
    def feature(kind, payload):
        return pw.enc_bytes(kind, payload)

    def entry(name, feat):
        return pw.enc_bytes(1, pw.enc_string(1, name) + pw.enc_bytes(2, feat))

    return [pw.enc_bytes(1, entry("wide", feature(
        2, pw.enc_packed_floats(1, w))) + entry("deep", feature(
            3, pw.enc_packed_varints(1, d)))) for w, d in zip(wide, deep)]


def test_parsed_records_feed_the_model_as_the_direct_features():
    wide, deep = wd.preprocess(ROWS[:24])
    recs = example_records(wide, deep)
    pe = tnn.ParseExample(2, [np.float32, np.int64],
                          [(wide.shape[1],), (3,)], **CPU)
    pw_wide, pw_deep = pe(Table(np.asarray(recs, object), None, "wide",
                                "deep", np.zeros(wide.shape[1], np.float32),
                                np.zeros(3, np.int64)))
    np.testing.assert_array_equal(pw_wide.numpy(), wide)
    np.testing.assert_array_equal(pw_deep.numpy(), deep)
    tm = wd.build_wide_deep(wide.shape[1], **CPU).evaluate()
    with torch.no_grad():
        direct = tm(Table(torch.from_numpy(wide), torch.from_numpy(deep)))
        parsed = tm(Table(pw_wide, pw_deep))
    np.testing.assert_array_equal(parsed.numpy(), direct.numpy())
