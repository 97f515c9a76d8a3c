"""TF GraphDef export (bigdl_tpu_torch/utils/tf_export.py) against the
JAX package's (the export cases of tests/test_convert.py, run through
the port).

The same model is built in both packages with the JAX weights (numpy
draws) carried to the port; the port's ``save_tf`` writes the JAX
exporter's bytes, and the GraphDef runs in the installed TensorFlow with
the port's output (rtol 1e-5 / atol 1e-6, 1e-4 / 1e-5 for convolutions,
as the JAX tests hold theirs). NCHW spatial layers are refused.
"""

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.utils import tf_export as jexport
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.utils import tf_export as texport
from bigdl_tpu_torch.utils.weights import load_jax_buffers, load_jax_params
from tests.jax_numpy_init import numpy_weight_draws

tf = pytest.importorskip("tensorflow")
CPU = dict(device="cpu")


def _run_tf_graphdef(pb_path, feed, in_name, out_name):
    gd = tf.compat.v1.GraphDef()
    with open(pb_path, "rb") as f:
        gd.ParseFromString(f.read())
    g = tf.Graph()
    with g.as_default():
        tf.import_graph_def(gd, name="")
        with tf.compat.v1.Session(graph=g) as s:
            return s.run(f"{out_name}:0", {f"{in_name}:0": feed})


def _mlp(nn, d):
    return (nn.Sequential().add(nn.Linear(8, 16, **d)).add(nn.ReLU())
            .add(nn.Linear(16, 4, **d)).add(nn.SoftMax()))


def _conv(nn, d):
    return (nn.Sequential()
            .add(nn.SpatialConvolution(3, 8, 3, 3, 1, 1, -1, -1,
                                       format="NHWC", **d))
            .add(nn.SpatialBatchNormalization(8, format="NHWC", **d))
            .add(nn.ReLU())
            .add(nn.SpatialMaxPooling(2, 2, format="NHWC"))
            .add(nn.View(8 * 8 * 8))
            .add(nn.Linear(8 * 8 * 8, 5, **d)))


def _lenet_nhwc(nn, d):
    return (nn.Sequential()
            .add(nn.SpatialConvolution(1, 6, 5, 5, 1, 1, -1, -1,
                                       format="NHWC", **d))
            .add(nn.Tanh())
            .add(nn.SpatialMaxPooling(2, 2, format="NHWC"))
            .add(nn.SpatialConvolution(6, 12, 5, 5, 1, 1, -1, -1,
                                       format="NHWC", **d))
            .add(nn.Tanh())
            .add(nn.SpatialMaxPooling(2, 2, format="NHWC"))
            .add(nn.View(7 * 7 * 12))
            .add(nn.Linear(7 * 7 * 12, 100, **d)).add(nn.Tanh())
            .add(nn.Linear(100, 10, **d)).add(nn.SoftMax()))


def _every(nn, d):
    """Every layer ``_emit`` maps that the cases above leave out."""
    return (nn.Sequential()
            .add(nn.SpatialConvolution(2, 4, 3, 3, 2, 2, format="NHWC",
                                       with_bias=False, **d))
            .add(nn.SpatialAveragePooling(2, 2, 1, 1, format="NHWC"))
            .add(nn.Sigmoid())
            .add(nn.Dropout(0.4))
            .add(nn.Identity())
            .add(nn.Reshape((4 * 2 * 2,)))
            .add(nn.Linear(16, 6, with_bias=False, **d))
            .add(nn.BatchNormalization(6, **d))
            .add(nn.Tanh())
            .add(nn.Linear(6, 3, **d)).add(nn.LogSoftMax()))


CASES = [("mlp", _mlp, (8,), dict(rtol=1e-5, atol=1e-6)),
         ("conv", _conv, (16, 16, 3), dict(rtol=1e-4, atol=1e-5)),
         ("lenet_nhwc", _lenet_nhwc, (28, 28, 1), dict(rtol=1e-4, atol=1e-5)),
         ("every", _every, (7, 7, 2), dict(rtol=1e-4, atol=1e-5))]


@pytest.mark.parametrize("tag,build,shape,tol", CASES,
                         ids=[c[0] for c in CASES])
def test_tf_export_bytes_equal_jax_and_run_in_tf(tag, build, shape, tol,
                                                 tmp_path):
    with numpy_weight_draws(len(tag)):
        jm = build(jnn, {})
    rng = np.random.RandomState(len(tag))
    for _, sub in [("", jm)] + list(jm.named_modules()):
        if "running_var" in sub._buffers:
            n = sub._buffers["running_var"].shape
            sub._set_buffer("running_var", rng.uniform(0.5, 1.5, n)
                            .astype(np.float32))
            sub._set_buffer("running_mean", rng.randn(*n).astype(np.float32))
    jm.evaluate()
    tm = build(tnn, CPU)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    load_jax_buffers(tm, jax.tree.map(np.asarray, jm.buffers_dict()))
    tm.evaluate()
    tp, jp = str(tmp_path / "port.pb"), str(tmp_path / "jax.pb")
    names = texport.save_tf(tm, shape, tp)
    assert names == jexport.save_tf(jm, shape, jp)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    x = np.random.RandomState(1).randn(3, *shape).astype(np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(x)).numpy()
    out_tf = _run_tf_graphdef(tp, x, names["input"], names["output"])
    np.testing.assert_allclose(out_tf, want, **tol)


def test_tf_export_of_a_bf16_model_equals_its_f32_copy(tmp_path):
    tm = _mlp(tnn, CPU)
    t16 = _mlp(tnn, CPU).to(torch.bfloat16)
    t16.load_state_dict(tm.state_dict())
    tm.load_state_dict(t16.state_dict())      # the bf16 values, in f32
    a, b = str(tmp_path / "a.pb"), str(tmp_path / "b.pb")
    texport.save_tf(tm, (8,), a)
    texport.save_tf(t16, (8,), b)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_tf_export_rejects_nchw_spatial_model(tmp_path):
    model = tnn.Sequential().add(tnn.SpatialConvolution(3, 4, 3, 3, **CPU))
    with pytest.raises(ValueError, match="NCHW"):
        texport.save_tf(model, (8, 8, 3), str(tmp_path / "bad.pb"))
    pool = tnn.Sequential().add(tnn.SpatialMaxPooling(2, 2))
    with pytest.raises(ValueError, match="NCHW"):
        texport.save_tf(pool, (8, 8, 3), str(tmp_path / "bad2.pb"))
    padded = tnn.Sequential().add(tnn.SpatialConvolution(
        3, 4, 3, 3, 1, 1, 1, 1, format="NHWC", **CPU))
    with pytest.raises(ValueError, match="explicit conv padding"):
        texport.save_tf(padded, (8, 8, 3), str(tmp_path / "bad3.pb"))
    with pytest.raises(ValueError, match="unsupported layer"):
        texport.save_tf(tnn.Sequential(tnn.Abs()), (3,),
                        str(tmp_path / "bad4.pb"))
