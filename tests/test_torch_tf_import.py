"""TF GraphDef import in the port (``bigdl_tpu_torch/utils/tf_import.py``)
held against TensorFlow and the JAX package.

Each case of ``tests/test_tf_oracle.py`` freezes the same TF function,
loads the GraphDef with the JAX package's ``load_tf`` and with the
port's (on the CPU, weights carried by ``load_jax_params``), and holds
the port's outputs against TF's at that file's rtol 2e-4 / atol 2e-5
and against JAX's at rtol 1e-5 / atol 1e-6. The three ``TestTFImport``
cases of ``tests/test_import.py`` follow, then the committed fixtures
of ``tests/data/torch_tf/`` (written by
``scripts/torch_make_tf_fixtures.py``), the random ops, the frozen-graph
``VariableV2`` error and a ``save_module`` round trip.

``test_imported_graph_is_jittable`` has no torch meaning beyond eager
parity: the CPU case checks that, and ``chip_smoke.py``'s
``tf_import_gate`` captures the imported VGG-16 in a CUDA graph on the
card and holds its replay equal to eager in its place.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")

from tensorflow.python.framework.convert_to_constants import (  # noqa: E402
    convert_variables_to_constants_v2,
)

from bigdl_tpu.utils import protowire as jpw  # noqa: E402
from bigdl_tpu.utils.table import Table as JaxTable  # noqa: E402
from bigdl_tpu.utils.tf_import import load_tf as jax_load_tf  # noqa: E402
from bigdl_tpu_torch.nn.module import Module  # noqa: E402
from bigdl_tpu_torch.utils.table import Table  # noqa: E402
from bigdl_tpu_torch.utils.tf_import import load_tf  # noqa: E402
from bigdl_tpu_torch.utils.weights import load_jax_params  # noqa: E402

TF_TOL = dict(rtol=2e-4, atol=2e-5)
JAX_TOL = dict(rtol=1e-5, atol=1e-6)
FIXTURES = os.path.join(os.path.dirname(__file__), "data", "torch_tf")


def freeze(fn, path, lower=True):
    cf = convert_variables_to_constants_v2(fn.get_concrete_function(),
                                           lower_control_flow=lower)
    with open(path, "wb") as f:
        f.write(cf.graph.as_graph_def().SerializeToString())
    return cf


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def load_both(pb, inputs=("x",), outputs=("Identity",)):
    """(JAX model, port model on the CPU with the JAX weights)."""
    jm = jax_load_tf(pb, list(inputs), list(outputs))
    jm.evaluate()
    pm = load_tf(pb, list(inputs), list(outputs), device="cpu")
    load_jax_params(pm, _np_tree(jm.params_dict()))
    pm.evaluate()
    return jm, pm


def _feed(x):
    if isinstance(x, np.ndarray) and x.dtype != object:
        return torch.from_numpy(x.copy())
    return x


def _outs(out):
    if isinstance(out, (Table, JaxTable, list, tuple)):
        return [np.asarray(o.detach() if torch.is_tensor(o) else o)
                for o in out]
    if torch.is_tensor(out):
        return [out.detach().numpy()]
    return [np.asarray(out)]


def _tf_outs(r):
    return [t.numpy() for t in (r if isinstance(r, (list, tuple)) else [r])]


def check(ref, jm, pm, x, pick=None):
    """The port's outputs against TF's ``ref`` and the JAX model's."""
    with torch.no_grad():
        got = _outs(pm(_feed(x)))
    want_jax = _outs(jm(x))
    if pick is not None:
        got, want_jax = [got[i] for i in pick], [want_jax[i] for i in pick]
    assert len(got) >= len(ref)
    for r, j, g in zip(ref, want_jax, got):
        assert g.shape == np.shape(r), (g.shape, np.shape(r))
        np.testing.assert_allclose(g.astype(np.float64),
                                   np.asarray(r, np.float64), **TF_TOL)
        np.testing.assert_allclose(g.astype(np.float64),
                                   np.asarray(j, np.float64), **JAX_TOL)
    return got


def run_three(tmp_path, tf_fn, x, inputs=("x",), outputs=("Identity",),
              lower=True):
    pb = str(tmp_path / "g.pb")
    cf = freeze(tf_fn, pb, lower)
    ref = _tf_outs(cf(tf.constant(x)))
    jm, pm = load_both(pb, inputs, outputs)
    check(ref, jm, pm, x)
    return pm


# ------------------------------------------- tests/test_tf_oracle.py's cases
def test_cnn_graph_matches_tf(tmp_path):
    rng = np.random.RandomState(0)
    w = tf.constant(rng.randn(3, 3, 3, 8).astype(np.float32) * 0.3)
    b = tf.constant(rng.randn(8).astype(np.float32))
    dw = tf.constant(rng.randn(3, 3, 8, 1).astype(np.float32) * 0.3)
    scale = tf.constant(rng.rand(8).astype(np.float32) + 0.5)
    offset = tf.constant(rng.randn(8).astype(np.float32))
    mean = tf.constant(rng.randn(8).astype(np.float32) * 0.1)
    var = tf.constant(rng.rand(8).astype(np.float32) + 0.5)
    dense = tf.constant(rng.randn(4 * 4 * 8, 10).astype(np.float32) * 0.1)

    @tf.function(input_signature=[tf.TensorSpec([2, 16, 16, 3], tf.float32)])
    def f(x):
        y = tf.nn.conv2d(x, w, strides=[1, 2, 2, 1], padding="SAME")
        y = tf.nn.bias_add(y, b)
        y, _, _ = tf.raw_ops.FusedBatchNormV3(
            x=y, scale=scale, offset=offset, mean=mean, variance=var,
            is_training=False)[:3]
        y = tf.nn.relu(y)
        y = tf.nn.depthwise_conv2d(y, dw, strides=[1, 1, 1, 1], padding="SAME")
        y = tf.nn.max_pool2d(y, 2, 2, "VALID")
        y = tf.reshape(y, [2, -1])
        y = tf.matmul(y, dense)
        return tf.nn.softmax(y)

    x = np.random.RandomState(1).randn(2, 16, 16, 3).astype(np.float32)
    pm = run_three(tmp_path, f, x)
    # the weights are parameters under JAX's names, on the model's device
    names = {n.rsplit(".", 1)[-1] for n, _ in pm.named_parameters()}
    assert names == {"weight", "bias"}


def test_elementwise_medley_matches_tf(tmp_path):
    c = tf.constant(np.random.RandomState(2).rand(4, 6).astype(np.float32) + 0.5)

    @tf.function(input_signature=[tf.TensorSpec([4, 6], tf.float32)])
    def f(x):
        y = tf.abs(x) + 0.5
        a = tf.sqrt(y) * tf.math.rsqrt(y + 1.0)
        b = tf.square(x) - tf.exp(-y)
        z = tf.maximum(a, b) / tf.minimum(y, c)
        z = tf.math.log1p(tf.abs(z))
        w = tf.transpose(z)                     # (6, 4)
        w = tf.reduce_sum(w, axis=0)            # (4,)
        s = tf.reduce_max(z, axis=1)            # (4,)
        return z - (w + s)[:, None]

    x = np.random.RandomState(3).randn(4, 6).astype(np.float32)
    run_three(tmp_path, f, x)


def test_split_pack_slice_matches_tf(tmp_path):
    @tf.function(input_signature=[tf.TensorSpec([2, 8], tf.float32)])
    def f(x):
        lo, hi = tf.split(x, 2, axis=1)         # multi-output consumers
        y = tf.stack([lo, hi], axis=0)          # Pack
        y = y[:, :, 1:3]                        # StridedSlice
        y = tf.concat([y[0], y[1]], axis=1)     # more StridedSlice + ConcatV2
        return y * 2.0 - lo[:, :1] + x[:, ::-3][:, :1]  # a negative stride

    x = np.random.RandomState(4).randn(2, 8).astype(np.float32)
    run_three(tmp_path, f, x)


def test_activation_chain_matches_tf(tmp_path):
    @tf.function(input_signature=[tf.TensorSpec([3, 5], tf.float32)])
    def f(x):
        y = tf.nn.leaky_relu(x, alpha=0.1)
        y = tf.nn.elu(y) + tf.nn.softplus(x) + tf.nn.softsign(x)
        y = tf.sigmoid(y) + tf.nn.log_softmax(x, axis=-1)
        return tf.tanh(y)

    x = np.random.RandomState(5).randn(3, 5).astype(np.float32)
    run_three(tmp_path, f, x)


def test_gather_onehot_argmax_matches_tf(tmp_path):
    table = tf.constant(np.random.RandomState(6).randn(10, 4).astype(np.float32))

    @tf.function(input_signature=[tf.TensorSpec([3, 4], tf.float32)])
    def f(x):
        idx = tf.argmax(x, axis=1)                       # int64
        g = tf.gather(table, idx)                        # GatherV2
        oh = tf.one_hot(idx, 4, on_value=2.0, off_value=-1.0)
        return g + oh + tf.cast(idx[:, None], tf.float32)

    x = np.random.RandomState(7).randn(3, 4).astype(np.float32)
    run_three(tmp_path, f, x)


def test_imported_graph_is_jittable(tmp_path):
    """Eager parity only: the CUDA-graph capture of an imported graph and
    its replay equal to eager are ``chip_smoke.py``'s ``tf_import_gate``
    (torch has no CPU counterpart of ``jax.jit``)."""
    w = tf.constant(np.random.RandomState(8).randn(6, 3).astype(np.float32))

    @tf.function(input_signature=[tf.TensorSpec([2, 6], tf.float32)])
    def f(x):
        return tf.nn.softmax(tf.matmul(x, w))

    x = np.random.RandomState(9).randn(2, 6).astype(np.float32)
    run_three(tmp_path, f, x)


def test_while_loop_functional_matches_tf(tmp_path):
    """Functional While (lower_control_flow=False) -> WhileLoop."""
    @tf.function(input_signature=[tf.TensorSpec([4], tf.float32)])
    def f(x):
        i = tf.constant(0)

        def cond(i, v):
            return i < 5

        def body(i, v):
            return i + 1, v * 1.5 + tf.cast(i, tf.float32)

        i, v = tf.while_loop(cond, body, [i, x])
        return v + 2.0

    run_three(tmp_path, f, np.arange(4, dtype=np.float32), lower=False)


def test_while_loop_tf1_lowered_matches_tf(tmp_path):
    """Default freezing lowers to TF1 Switch/Merge frames; the loader
    rebuilds them into one WhileLoop: one host read an iteration."""
    @tf.function(input_signature=[tf.TensorSpec([3], tf.float32)])
    def f(x):
        def cond(i, v):
            return i < 4

        def body(i, v):
            return i + 1, v * 2.0

        _, v = tf.while_loop(cond, body, [tf.constant(0), x])
        return v

    pm = run_three(tmp_path, f, np.array([1.0, -2.0, 0.5], np.float32))
    from bigdl_tpu_torch.nn.tf_ops import WhileLoop

    loops = [m for m in pm.modules() if isinstance(m, WhileLoop)]
    assert len(loops) == 1 and loops[0].iterations == 4
    assert loops[0].host_syncs == 5


def test_cond_functional_and_tf1(tmp_path):
    @tf.function(input_signature=[tf.TensorSpec([4], tf.float32)])
    def g(x):
        return tf.cond(tf.reduce_sum(x) > 0.0, lambda: x * 2.0,
                       lambda: x - 5.0)

    for lower in (False, True):
        pb = str(tmp_path / f"c{int(lower)}.pb")
        cf = freeze(g, pb, lower)
        jm, pm = load_both(pb)
        for x in (np.array([1, 2, 3, 4], np.float32),
                  np.array([-1, -2, -3, -4], np.float32)):
            check(_tf_outs(cf(tf.constant(x))), jm, pm, x)


def test_parse_example_matches_tf(tmp_path):
    """ParseExampleV2 import: serialized tf.Example batch -> dense tensors
    on the host through the port's protowire."""
    def make_ex(fv, iv):
        ex = tf.train.Example(features=tf.train.Features(feature={
            "feat": tf.train.Feature(
                float_list=tf.train.FloatList(value=fv)),
            "label": tf.train.Feature(
                int64_list=tf.train.Int64List(value=[iv])),
        }))
        return ex.SerializeToString()

    recs = [make_ex([1., 2., 3.], 7), make_ex([4., 5., 6.], 9)]

    @tf.function(input_signature=[tf.TensorSpec([None], tf.string)])
    def p(s):
        d = tf.io.parse_example(s, {
            "feat": tf.io.FixedLenFeature([3], tf.float32),
            "label": tf.io.FixedLenFeature([], tf.int64, default_value=0)})
        return d["feat"], tf.cast(d["label"], tf.int32)

    pb = str(tmp_path / "p.pb")
    freeze(p, pb, lower=False)
    ref = [r.numpy() for r in p(tf.constant(recs))]
    jm, pm = load_both(pb, ["s"], ["Identity", "Identity_1"])
    # JAX's Table reads 1-based; the port's outputs in order
    check(ref, jm, pm, np.asarray(recs, object))


def test_nested_cond_matches_tf(tmp_path):
    """Nested tf.cond under TF1 lowering: the outer Merge selects by the
    OUTER predicate."""
    @tf.function(input_signature=[tf.TensorSpec([2], tf.float32)])
    def g(x):
        return tf.cond(
            x[0] > 0.0,
            lambda: tf.cond(x[1] > 0.0, lambda: x * 2.0, lambda: x * 3.0),
            lambda: x - 10.0)

    for lower in (False, True):
        pb = str(tmp_path / f"n{int(lower)}.pb")
        cf = freeze(g, pb, lower)
        jm, pm = load_both(pb)
        for x in (np.array([1, 1], np.float32), np.array([1, -1], np.float32),
                  np.array([-1, 1], np.float32)):
            check(_tf_outs(cf(tf.constant(x))), jm, pm, x)


def test_cond_const_branches(tmp_path):
    """Zero-arg branches returning constants."""
    @tf.function(input_signature=[tf.TensorSpec([], tf.float32)])
    def g(x):
        return tf.cond(x > 0.0, lambda: tf.constant(1.0),
                       lambda: tf.constant(2.0)) + x

    pb = str(tmp_path / "cc.pb")
    cf = freeze(g, pb, lower=False)
    jm, pm = load_both(pb)
    for x in (np.float32(3.0), np.float32(-3.0)):
        x = np.asarray(x)
        check(_tf_outs(cf(tf.constant(x))), jm, pm, x)


def test_while_body_with_topk(tmp_path):
    """Multi-output op with named output args inside a function body."""
    @tf.function(input_signature=[tf.TensorSpec([6], tf.float32)])
    def f(x):
        def cond(i, v):
            return i < 2

        def body(i, v):
            vals, idxs = tf.math.top_k(v, k=6)
            return i + 1, vals + tf.cast(idxs, tf.float32) * 0.1

        _, v = tf.while_loop(cond, body, [tf.constant(0), x])
        return v

    x = np.array([3.0, 1.0, 4.0, 1.5, 9.0, 2.0], np.float32)
    run_three(tmp_path, f, x, lower=False)


def test_misc_math_shape_ops_match_tf(tmp_path):
    @tf.function(input_signature=[tf.TensorSpec([2, 6], tf.float32)])
    def f(x):
        a = tf.math.expm1(x) + tf.cast(tf.fill([2, 6], 0.5), tf.float32)
        b = a + tf.cast(tf.shape(x)[1], tf.float32) \
            + tf.cast(tf.rank(x), tf.float32)
        c = tf.slice(b, [0, 1], [2, 4])
        d = tf.math.floormod(c, 3.0) + tf.cast(
            tf.math.is_finite(c), tf.float32)
        rng = tf.cast(tf.range(1.0, 5.0, 1.0), tf.float32)
        return d * rng + tf.nn.l2_loss(x)

    x = np.random.RandomState(0).randn(2, 6).astype(np.float32)
    run_three(tmp_path, f, x, lower=False)


def test_softmax_cross_entropy_with_logits_matches_tf(tmp_path):
    labels = np.asarray([[0, 1, 0.0], [1, 0, 0]], np.float32)

    @tf.function(input_signature=[tf.TensorSpec([2, 3], tf.float32)])
    def f(x):
        return tf.nn.softmax_cross_entropy_with_logits(
            labels=tf.constant(labels), logits=x)

    x = np.random.RandomState(1).randn(2, 3).astype(np.float32)
    run_three(tmp_path, f, x, lower=False)


def test_reduction_family_matches_tf(tmp_path):
    @tf.function(input_signature=[tf.TensorSpec([3, 4], tf.float32)])
    def f(x):
        return (tf.reduce_sum(x, axis=1) + tf.reduce_max(x, axis=1)
                + tf.reduce_min(x, axis=1)
                + tf.reduce_prod(x * 0.5, axis=1, keepdims=False))

    run_three(tmp_path, f, np.random.RandomState(3).randn(3, 4).astype(
        np.float32))


def test_bool_reductions_match_tf(tmp_path):
    @tf.function(input_signature=[tf.TensorSpec([3, 4], tf.float32)])
    def f(x):
        pos = x > 0
        return tf.cast(tf.reduce_all(pos, axis=1), tf.float32) + \
            2.0 * tf.cast(tf.reduce_any(pos, axis=1), tf.float32)

    run_three(tmp_path, f, np.random.RandomState(4).randn(3, 4).astype(
        np.float32))


def test_segment_sum_matches_tf(tmp_path):
    ids = np.asarray([0, 0, 1, 2], np.int32)

    @tf.function(input_signature=[tf.TensorSpec([4, 3], tf.float32)])
    def f(x):
        return tf.math.segment_sum(x, tf.constant(ids))

    pm = run_three(tmp_path, f, np.random.RandomState(5).randn(4, 3).astype(
        np.float32))
    # num_segments is folded at import: no host read in the forward
    seg = [m for m in pm.modules() if getattr(m, "op", "") == "segment_sum"]
    assert len(seg) == 1 and seg[0].attrs["num"] == 3


def test_in_top_k_matches_tf(tmp_path):
    tgt = np.asarray([1, 0], np.int32)

    @tf.function(input_signature=[tf.TensorSpec([2, 5], tf.float32)])
    def f(x):
        return tf.cast(tf.math.in_top_k(tf.constant(tgt), x, k=2), tf.float32)

    run_three(tmp_path, f, np.random.RandomState(6).randn(2, 5).astype(
        np.float32))


def test_dilation2d_matches_tf(tmp_path):
    filt = (np.random.RandomState(7).rand(2, 2, 1) * 0.1).astype(np.float32)

    @tf.function(input_signature=[tf.TensorSpec([1, 5, 5, 1], tf.float32)])
    def f(x):
        return tf.nn.dilation2d(x, tf.constant(filt), strides=[1, 1, 1, 1],
                                padding="SAME", data_format="NHWC",
                                dilations=[1, 1, 1, 1])

    run_three(tmp_path, f, np.random.RandomState(8).randn(1, 5, 5, 1).astype(
        np.float32))


def test_bias_add_v1_matches_tf(tmp_path):
    b = np.asarray([0.5, -0.5], np.float32)

    @tf.function(input_signature=[tf.TensorSpec([2, 2], tf.float32)])
    def f(x):
        return tf.nn.bias_add(x, tf.constant(b))

    run_three(tmp_path, f, np.random.RandomState(9).randn(2, 2).astype(
        np.float32))


def test_decode_png_matches_tf(tmp_path):
    rgb = (np.random.RandomState(11).rand(6, 5, 3) * 255).astype(np.uint8)
    png_bytes = tf.io.encode_png(tf.constant(rgb)).numpy()

    @tf.function(input_signature=[tf.TensorSpec([], tf.string)])
    def f(x):
        return tf.cast(tf.io.decode_png(x, channels=3), tf.float32)

    pb = str(tmp_path / "d.pb")
    freeze(f, pb)
    jm, pm = load_both(pb)
    check([f(tf.constant(png_bytes)).numpy()], jm, pm, png_bytes)


def test_decode_png_grayscale_native_channels(tmp_path):
    gray = (np.random.RandomState(12).rand(4, 4, 1) * 255).astype(np.uint8)
    png_bytes = tf.io.encode_png(tf.constant(gray)).numpy()

    @tf.function(input_signature=[tf.TensorSpec([], tf.string)])
    def f(x):
        return tf.cast(tf.io.decode_png(x), tf.float32)

    pb = str(tmp_path / "g.pb")
    freeze(f, pb)
    jm, pm = load_both(pb)
    got = check([f(tf.constant(png_bytes)).numpy()], jm, pm, png_bytes)
    assert got[0].shape == (4, 4, 1)


# ---------------------------------- tests/test_import.py::TestTFImport's cases
def _attr(key: str, value_bytes: bytes) -> bytes:
    return jpw.enc_bytes(5, jpw.enc_string(1, key) + jpw.enc_bytes(2, value_bytes))


def _attr_tensor(key: str, arr: np.ndarray, dt: int = 1) -> bytes:
    shape = b"".join(jpw.enc_bytes(2, jpw.enc_varint(1, s)) for s in arr.shape)
    np_dt = {1: np.float32, 3: np.int32}[dt]
    tp = (jpw.enc_varint(1, dt) + jpw.enc_bytes(2, shape) +
          jpw.enc_bytes(4, arr.astype(np_dt).tobytes()))
    return _attr(key, jpw.enc_bytes(8, tp))


def _attr_ints(key: str, vals) -> bytes:
    lst = b"".join(jpw.enc_varint(3, v) for v in vals)
    return _attr(key, jpw.enc_bytes(1, lst))


def _attr_s(key: str, s: str) -> bytes:
    return _attr(key, jpw.enc_string(2, s))


def _node(name: str, op: str, inputs=(), attrs=b"") -> bytes:
    out = jpw.enc_string(1, name) + jpw.enc_string(2, op)
    for i in inputs:
        out += jpw.enc_string(3, i)
    return jpw.enc_bytes(1, out + attrs)


class TestTFImport:
    def test_mlp_graph(self, tmp_path):
        rng = np.random.RandomState(0)
        w1 = rng.randn(4, 6).astype(np.float32)
        b1 = rng.randn(6).astype(np.float32)
        w2 = rng.randn(6, 3).astype(np.float32)
        gd = b"".join([
            _node("x", "Placeholder"),
            _node("w1", "Const", attrs=_attr_tensor("value", w1)),
            _node("b1", "Const", attrs=_attr_tensor("value", b1)),
            _node("w2", "Const", attrs=_attr_tensor("value", w2)),
            _node("mm1", "MatMul", ["x", "w1"]),
            _node("add1", "BiasAdd", ["mm1", "b1"]),
            _node("relu1", "Relu", ["add1"]),
            _node("mm2", "MatMul", ["relu1", "w2"]),
            _node("prob", "Softmax", ["mm2"]),
        ])
        p = tmp_path / "mlp.pb"
        p.write_bytes(gd)
        x = rng.randn(5, 4).astype(np.float32)
        h = np.maximum(x @ w1 + b1, 0.0)
        logits = h @ w2
        want = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        jm, pm = load_both(str(p), ["x"], ["prob"])
        got = check([want], jm, pm, x)
        np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-6)

    def test_conv_graph_nhwc(self, tmp_path):
        rng = np.random.RandomState(1)
        w = rng.randn(3, 3, 2, 5).astype(np.float32) * 0.3  # HWIO
        b = rng.randn(5).astype(np.float32)
        gd = b"".join([
            _node("img", "Placeholder"),
            _node("w", "Const", attrs=_attr_tensor("value", w)),
            _node("b", "Const", attrs=_attr_tensor("value", b)),
            _node("conv", "Conv2D", ["img", "w"],
                  attrs=_attr_ints("strides", [1, 1, 1, 1]) + _attr_s("padding", "SAME")),
            _node("bias", "BiasAdd", ["conv", "b"]),
            _node("relu", "Relu", ["bias"]),
            _node("pool", "MaxPool", ["relu"],
                  attrs=_attr_ints("ksize", [1, 2, 2, 1]) +
                  _attr_ints("strides", [1, 2, 2, 1]) + _attr_s("padding", "VALID")),
            _node("mean", "Mean", ["pool", "axes"]),
            _node("axes", "Const", attrs=_attr_tensor("value",
                                                      np.asarray([1., 2.], np.float32))),
        ])
        p = tmp_path / "conv.pb"
        p.write_bytes(gd)
        x = rng.randn(2, 8, 8, 2).astype(np.float32)
        # oracle: the same NHWC math in TF
        y = tf.nn.conv2d(x, w, 1, "SAME") + b
        y = tf.nn.max_pool2d(tf.nn.relu(y), 2, 2, "VALID")
        ref = tf.reduce_mean(y, axis=(1, 2)).numpy()
        jm, pm = load_both(str(p), ["img"], ["mean"])
        got = check([ref], jm, pm, x)
        assert got[0].shape == (2, 5)

    def test_unsupported_op_raises(self, tmp_path):
        gd = _node("x", "Placeholder") + _node("y", "FancyOp", ["x"])
        p = tmp_path / "bad.pb"
        p.write_bytes(gd)
        with pytest.raises(ValueError, match="unsupported tf op") as port:
            load_tf(str(p), ["x"], ["y"], device="cpu")
        with pytest.raises(ValueError, match="unsupported tf op") as ref:
            jax_load_tf(str(p), ["x"], ["y"])
        assert str(port.value) == str(ref.value)


# ------------------------------------------------------- the port's own cases
def test_committed_fixtures_match_their_stored_tf_outputs():
    """Every GraphDef of ``tests/data/torch_tf/`` (each with TF's outputs)
    loads in the port and gives TF's outputs; the card runs the same check
    in ``tf_import_gate``."""
    specs = sorted(glob.glob(os.path.join(FIXTURES, "*.json")))
    assert {os.path.basename(s)[:-5] for s in specs} >= {
        "tf1_while", "functional_while_topk", "nested_cond", "tf1_linear"}
    for spec_path in specs:
        with open(spec_path) as f:
            spec = json.load(f)
        pb = os.path.join(FIXTURES, spec["graph"])
        assert os.path.getsize(pb) < 100_000
        data = np.load(os.path.join(FIXTURES, spec["io"]))
        m = load_tf(pb, spec["inputs"], spec["outputs"], device="cpu")
        m.evaluate()
        for case in range(spec["cases"]):
            x = torch.from_numpy(data[f"x{case}"])
            with torch.no_grad():
                got = _outs(m(x))
            for j in range(len(spec["outputs"])):
                np.testing.assert_allclose(got[j], data[f"y{case}_{j}"],
                                           **TF_TOL, err_msg=spec_path)


def _random_graph(tmp_path, op, shape_or_rows):
    if op == "RandomUniform":
        gd = b"".join([
            _node("x", "Placeholder"),
            _node("shape", "Const", attrs=_attr_tensor(
                "value", np.asarray(shape_or_rows, np.int32), dt=3)),
            _node("r", "RandomUniform", ["shape", "^x"]),
            _node("y", "Add", ["r", "x"])])
    else:
        gd = _node("x", "Placeholder") + _node("y", "RandomShuffle", ["x"])
    p = tmp_path / f"{op}.pb"
    p.write_bytes(gd)
    return str(p)


def test_random_uniform_draws_from_the_loaders_generator(tmp_path):
    pb = _random_graph(tmp_path, "RandomUniform", (64, 32))

    def draw(seed):
        m = load_tf(pb, ["x"], ["y"], device="cpu",
                    generator=torch.Generator().manual_seed(seed))
        return m(torch.zeros(64, 32))

    a, b, c = draw(3), draw(3), draw(4)
    jm = jax_load_tf(pb, ["x"], ["y"])
    assert tuple(a.shape) == np.shape(jm(np.zeros((64, 32), np.float32)))
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    assert abs(float(a.mean()) - 0.5) < 0.02
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_random_shuffle_permutes_rows_by_the_loaders_generator(tmp_path):
    pb = _random_graph(tmp_path, "RandomShuffle", None)
    x = torch.arange(40.0).reshape(20, 2)

    def draw(seed):
        m = load_tf(pb, ["x"], ["y"], device="cpu",
                    generator=torch.Generator().manual_seed(seed))
        return m(x)

    a, b, c = draw(5), draw(5), draw(6)
    assert a.shape == x.shape
    assert torch.equal(a.sort(0).values, x)        # a permutation of rows
    assert torch.equal(a[:, 1] - a[:, 0], torch.ones(20))
    assert abs(float(a.mean()) - float(x.mean())) < 1e-6
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_floor_and_truncate_mod_keep_tfs_signs(tmp_path):
    """FloorMod takes the divisor's sign, TruncateMod the dividend's
    (``torch.remainder`` and ``torch.fmod``), on negative inputs; and
    ApproximateEqual takes its tolerance."""
    @tf.function(input_signature=[tf.TensorSpec([2, 5], tf.float32)])
    def f(x):
        near = tf.raw_ops.ApproximateEqual(x=x, y=x * 1.0001 + 0.002,
                                           tolerance=0.0025)
        return (tf.math.floormod(x, 3.0) + 10.0 * tf.truncatemod(x, 3.0)
                + 100.0 * tf.cast(near, tf.float32))

    x = np.asarray([[-7.5, -3.0, -1.25, 2.5, 7.0],
                    [5.5, -0.5, -4.0, 1.0, -8.75]], np.float32)
    run_three(tmp_path, f, x, lower=False)


def test_reduction_over_no_axes_reduces_nothing(tmp_path):
    """A Sum / Max / Mean over an empty axis list is the input itself,
    as in JAX and TF (torch's empty ``dim`` reduces every axis)."""
    empty = jpw.enc_bytes(5, jpw.enc_string(1, "value") + jpw.enc_bytes(
        2, jpw.enc_bytes(8, jpw.enc_varint(1, 3) + jpw.enc_bytes(
            2, jpw.enc_bytes(2, jpw.enc_varint(1, 0))))))
    gd = b"".join([_node("x", "Placeholder"),
                   _node("axes", "Const", attrs=empty),
                   _node("s", "Sum", ["x", "axes"]),
                   _node("m", "Max", ["s", "axes"]),
                   _node("y", "Mean", ["m", "axes"])])
    p = tmp_path / "noaxes.pb"
    p.write_bytes(gd)
    x = np.random.RandomState(15).randn(3, 4).astype(np.float32)
    jm, pm = load_both(str(p), ["x"], ["y"])
    got = check([x], jm, pm, x)
    np.testing.assert_array_equal(got[0], x)


def test_unfrozen_variable_in_a_frozen_load_raises_as_jax(tmp_path):
    gd = (_node("x", "Placeholder") + _node("v", "VariableV2")
          + _node("y", "Mul", ["x", "v"]))
    p = tmp_path / "unfrozen.pb"
    p.write_bytes(gd)
    with pytest.raises(ValueError, match="graph is not frozen") as port:
        load_tf(str(p), ["x"], ["y"], device="cpu")
    with pytest.raises(ValueError, match="graph is not frozen") as ref:
        jax_load_tf(str(p), ["x"], ["y"])
    assert str(port.value) == str(ref.value)


def test_imported_graph_round_trips_through_save_module(tmp_path):
    """An imported graph with weights, folded constants and a TF1 cond
    saves in the structured archive and loads back equal."""
    rng = np.random.RandomState(13)
    w = tf.constant(rng.randn(3, 3, 2, 4).astype(np.float32))
    d = tf.constant(rng.randn(4 * 4 * 4, 3).astype(np.float32))

    @tf.function(input_signature=[tf.TensorSpec([2, 8, 8, 2], tf.float32)])
    def f(x):
        y = tf.nn.relu(tf.nn.conv2d(x, w, 1, "SAME"))
        y = tf.nn.avg_pool2d(y, 3, 2, "SAME")
        y = tf.matmul(tf.reshape(y, [2, -1]), d)
        return tf.cond(tf.reduce_sum(y) > 0.0, lambda: y * 2.0,
                       lambda: tf.nn.softmax(y))

    x = rng.randn(2, 8, 8, 2).astype(np.float32)
    pm = run_three(tmp_path, f, x)
    path = str(tmp_path / "imported.bigdl")
    pm.save_module(path)
    back = Module.load_module(path, device="cpu")
    back.evaluate()
    with torch.no_grad():
        for xx in (x, -x):
            assert torch.equal(back(torch.from_numpy(xx)),
                               pm(torch.from_numpy(xx)))
