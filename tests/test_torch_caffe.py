"""Caffe import and export (bigdl_tpu_torch/utils/caffe.py,
caffe_export.py) against the JAX package's (tests/test_caffe_import.py
and the Caffe cases of tests/test_convert.py, run through the port).

The fixtures are built in the test (a prototxt and a caffemodel encoded
with the port's protowire). The port's imported graph gives the JAX
package's output on the same file and input (rtol 1e-5 / atol 1e-6);
the port's exporter writes the JAX exporter's prototxt text and
caffemodel bytes for the same weights; a pair either package wrote
loads in the other; and the port's ``np.frombuffer`` read of a blob
equals the JAX package's Python-float read, on -0.0, denormals and
infinities.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.utils import caffe as jcaffe
from bigdl_tpu.utils import caffe_export as jexport
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.utils import caffe as tcaffe
from bigdl_tpu_torch.utils import caffe_export as texport
from bigdl_tpu_torch.utils import protowire as pw
from bigdl_tpu_torch.utils.weights import load_jax_buffers, load_jax_params
from tests.jax_numpy_init import numpy_weight_draws

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = dict(device="cpu")

PROTOTXT = """
name: "mini_googlenet"
input: "data"
input_dim: 1
input_dim: 3
input_dim: 16
input_dim: 16
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 3 stride: 1 pad: 1 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "norm1" type: "LRN" bottom: "pool1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "inc_1x1" type: "Convolution" bottom: "norm1" top: "inc_1x1"
  convolution_param { num_output: 4 kernel_size: 1 } }
layer { name: "inc_3x3" type: "Convolution" bottom: "norm1" top: "inc_3x3"
  convolution_param { num_output: 6 kernel_size: 3 pad: 1 } }
layer { name: "inc_out" type: "Concat" bottom: "inc_1x1" bottom: "inc_3x3"
  top: "inc_out" }
layer { name: "drop" type: "Dropout" bottom: "inc_out" top: "inc_out"
  dropout_param { dropout_ratio: 0.4 } }
layer { name: "fc" type: "InnerProduct" bottom: "inc_out" top: "fc"
  inner_product_param { num_output: 5 } }
layer { name: "prob" type: "Softmax" bottom: "fc" top: "prob" }
"""


def _blob(arr: np.ndarray) -> bytes:
    shape = pw.enc_bytes(7, pw.enc_packed_varints(1, arr.shape))
    return shape + pw.enc_packed_floats(5, arr.reshape(-1))


def _layer(name: str, blobs) -> bytes:
    out = pw.enc_string(1, name)
    for b in blobs:
        out += pw.enc_bytes(7, _blob(b))
    return out


def _make_caffemodel(weights: dict) -> bytes:
    out = b""
    for name, blobs in weights.items():
        out += pw.enc_bytes(100, _layer(name, blobs))
    return out


@pytest.fixture
def fixture_paths(tmp_path):
    rng = np.random.RandomState(0)
    weights = {
        "conv1": [rng.randn(8, 3, 3, 3).astype(np.float32) * 0.1,
                  rng.randn(8).astype(np.float32) * 0.1],
        "inc_1x1": [rng.randn(4, 8, 1, 1).astype(np.float32) * 0.1,
                    rng.randn(4).astype(np.float32) * 0.1],
        "inc_3x3": [rng.randn(6, 8, 3, 3).astype(np.float32) * 0.1,
                    rng.randn(6).astype(np.float32) * 0.1],
        "fc": [rng.randn(5, 10 * 8 * 8).astype(np.float32) * 0.01,
               rng.randn(5).astype(np.float32) * 0.1],
    }
    ppath = tmp_path / "net.prototxt"
    ppath.write_text(PROTOTXT)
    mpath = tmp_path / "net.caffemodel"
    mpath.write_bytes(_make_caffemodel(weights))
    return str(ppath), str(mpath), weights


def _np(out):
    return out.detach().numpy() if torch.is_tensor(out) else np.asarray(out)


def test_parse_prototxt_structure():
    net = tcaffe.parse_prototxt(PROTOTXT)
    assert net == jcaffe.parse_prototxt(PROTOTXT)
    assert net["name"][0] == "mini_googlenet"
    layers = net["layer"]
    assert len(layers) == 10
    assert layers[0]["type"][0] == "Convolution"
    assert layers[0]["convolution_param"][0]["num_output"][0] == 8
    assert net["input_dim"] == [1, 3, 16, 16]


def test_load_and_predict(fixture_paths):
    ppath, mpath, weights = fixture_paths
    model = tcaffe.load_caffe(ppath, mpath, **CPU)
    model.evaluate()
    x = np.random.RandomState(1).randn(2, 3, 16, 16).astype(np.float32)
    with torch.no_grad():
        out = _np(model(torch.from_numpy(x)))
    assert out.shape == (2, 5)
    np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5)
    jm = jcaffe.load_caffe(ppath, mpath)
    jm.evaluate()
    np.testing.assert_allclose(out, np.asarray(jm(jnp.asarray(x))), **TOL)

    # oracle: the hand-built equivalent, in the port
    def conv(name, *args):
        c = tnn.SpatialConvolution(*args, **CPU)
        with torch.no_grad():
            c.weight.copy_(torch.from_numpy(weights[name][0]))
            c.bias.copy_(torch.from_numpy(weights[name][1]))
        return c

    ref = tnn.Sequential()
    ref.add(conv("conv1", 3, 8, 3, 3, 1, 1, 1, 1)).add(tnn.ReLU())
    ref.add(tnn.SpatialMaxPooling(2, 2, 2, 2).ceil())
    ref.add(tnn.SpatialCrossMapLRN(5, 0.0001, 0.75))
    ref.add(tnn.Concat(2).add(conv("inc_1x1", 8, 4, 1, 1)).add(
        conv("inc_3x3", 8, 6, 3, 3, 1, 1, 1, 1)))
    fc = tnn.Linear(10 * 8 * 8, 5, **CPU)
    with torch.no_grad():
        fc.weight.copy_(torch.from_numpy(weights["fc"][0]))
        fc.bias.copy_(torch.from_numpy(weights["fc"][1]))
    ref.add(tnn.View(10 * 8 * 8)).add(fc).add(tnn.SoftMax())
    ref.evaluate()
    with torch.no_grad():
        np.testing.assert_allclose(out, _np(ref(torch.from_numpy(x))), **TOL)


def test_in_place_layers_resolve(fixture_paths):
    """relu1/drop write top == bottom; the chain must stay linear."""
    ppath, mpath, _ = fixture_paths
    model, inputs = tcaffe.CaffeLoader(ppath, mpath, **CPU).load()
    _, jinputs = jcaffe.CaffeLoader(ppath, mpath).load()
    assert len(inputs) == len(jinputs) == 1
    names = [m.get_name() for _, m in model.named_modules()]
    assert "conv1" in " ".join(names)
    jtopo = jcaffe.CaffeLoader(ppath, mpath).load()[0]._topo

    def named(topo):
        return [(type(n.module).__name__, n.module._name,
                 [topo.index(p) for p in n.prev]) for n in topo]
    assert named(model._topo) == named(jtopo)


def test_missing_weights_ok(fixture_paths):
    """prototxt-only load (random init) still builds and runs; the fc's
    Linear is built at the first call, on the input's device and dtype."""
    ppath, _, _ = fixture_paths
    model = tcaffe.load_caffe(ppath, **CPU)
    model.evaluate()
    with torch.no_grad():
        out = model(torch.ones(1, 3, 16, 16))
    assert out.shape == (1, 5)
    ip = tcaffe._InnerProduct(None, 3, True, **CPU)
    with torch.no_grad():
        y = ip(torch.ones(2, 4, 2, dtype=torch.float64))
    assert ip.linear.weight.dtype == torch.float64 and y.shape == (2, 3)
    assert isinstance(ip.linear, tnn.Linear) and "linear" in ip._modules


def test_loads_never_fall_back_to_the_cpu(fixture_paths):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    ppath, mpath, _ = fixture_paths
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcaffe.load_caffe(ppath, mpath)


def test_frombuffer_parse_equals_the_python_float_parse():
    special = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45,
                        1.17549435e-38, 5.9e-39, -3.4028235e38, 0.1, -2.5,
                        1.0 / 3.0], np.float32)
    vals = np.concatenate([special, np.random.RandomState(5).randn(
        4 * 3 * 5).astype(np.float32)])[:60].reshape(4, 3, 5)
    for blob in (_blob(vals),
                 # the same data as one f32 entry at a time (not packed)
                 pw.enc_bytes(7, pw.enc_packed_varints(1, vals.shape))
                 + b"".join(pw.enc_float(5, float(v))
                            for v in vals.reshape(-1)),
                 # legacy num/channels/height/width
                 pw.enc_varint(1, 1) + pw.enc_varint(2, 4)
                 + pw.enc_varint(3, 3) + pw.enc_varint(4, 5)
                 + pw.enc_packed_floats(5, vals.reshape(-1))):
        got = tcaffe._blob_to_array(blob)
        want = jcaffe._blob_to_array(blob)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape == (4, 3, 5)
        assert got.tobytes() == want.tobytes() == vals.tobytes()


# ------------------------------------------------------------------ export
def _pair(build, seed):
    """The same model in both packages, the JAX weights (numpy draws)
    and running statistics carried to the port."""
    with numpy_weight_draws(seed):
        jm = build(jnn, {})
    rng = np.random.RandomState(seed + 1)
    for _, sub in [("", jm)] + list(jm.named_modules()):
        for k, v in list(sub._buffers.items()):
            if k == "running_var":
                sub._set_buffer(k, jnp.asarray(
                    rng.uniform(0.5, 1.5, v.shape).astype(np.float32)))
            elif k == "running_mean":
                sub._set_buffer(k, jnp.asarray(
                    rng.randn(*v.shape).astype(np.float32) * 0.1))
    jm.evaluate()
    tm = build(tnn, CPU)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    load_jax_buffers(tm, jax.tree.map(np.asarray, jm.buffers_dict()))
    tm.evaluate()
    return jm, tm


def _convnet(nn, d):
    return (nn.Sequential()
            .add(nn.SpatialConvolution(3, 6, 3, 3, 1, 1, 1, 1, **d))
            .add(nn.ReLU())
            .add(nn.SpatialMaxPooling(2, 2))
            .add(nn.View(6 * 4 * 4))
            .add(nn.Linear(6 * 4 * 4, 4, **d))
            .add(nn.SoftMax()))


def _same_floor(nn, d):
    return (nn.Sequential()
            .add(nn.SpatialConvolution(1, 4, 3, 3, 1, 1, -1, -1, **d))  # SAME
            .add(nn.ReLU())
            .add(nn.SpatialMaxPooling(2, 2))  # floor: 9 -> 4 (ceil: 5)
            .add(nn.View(4 * 4 * 4))
            .add(nn.Linear(4 * 4 * 4, 3, **d)))


def _bn_net(nn, d):
    return (nn.Sequential()
            .add(nn.SpatialConvolution(3, 5, 3, 3, 2, 2, 1, 1, n_group=1, **d))
            .add(nn.SpatialBatchNormalization(5, **d))
            .add(nn.Tanh())
            .add(nn.SpatialAveragePooling(2, 2, 2, 2, ceil_mode=True))
            .add(nn.Dropout(0.3))
            .add(nn.Reshape((5 * 2 * 2,)))
            .add(nn.Identity())
            .add(nn.Linear(5 * 2 * 2, 6, **d))
            .add(nn.Sigmoid())
            .add(nn.Linear(6, 3, with_bias=False, **d)))


EXPORTS = [("convnet", _convnet, (3, 8, 8)),
           ("same_floor", _same_floor, (1, 9, 9)),
           ("bn_net", _bn_net, (3, 7, 7))]


@pytest.mark.parametrize("tag,build,shape", EXPORTS, ids=[e[0] for e in EXPORTS])
def test_export_import_roundtrip_and_bytes_equal_jax(tag, build, shape,
                                                     tmp_path):
    jm, tm = _pair(build, seed=len(tag))
    tp, tc = str(tmp_path / "t.prototxt"), str(tmp_path / "t.caffemodel")
    jp, jc = str(tmp_path / "j.prototxt"), str(tmp_path / "j.caffemodel")
    texport.save_caffe(tm, tp, tc, input_shape=shape)
    jexport.save_caffe(jm, jp, jc, input_shape=shape)
    assert open(tp).read() == open(jp).read()
    assert open(tc, "rb").read() == open(jc, "rb").read()
    x = np.random.RandomState(3).randn(2, *shape).astype(np.float32)
    with torch.no_grad():
        want = _np(tm(torch.from_numpy(x)))
    np.testing.assert_allclose(want, np.asarray(jm(jnp.asarray(x))),
                               rtol=1e-4, atol=1e-6)
    back = tcaffe.load_caffe(tp, tc, **CPU)      # the port's own pair
    back.evaluate()
    with torch.no_grad():
        np.testing.assert_allclose(_np(back(torch.from_numpy(x))), want,
                                   rtol=1e-4, atol=1e-6)
    cross = tcaffe.load_caffe(jp, jc, **CPU)     # the JAX package's pair
    cross.evaluate()
    jback = jcaffe.load_caffe(tp, tc)            # and the reverse
    jback.evaluate()
    with torch.no_grad():
        got = _np(cross(torch.from_numpy(x)))
    np.testing.assert_allclose(got, np.asarray(jback(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_scale_after_a_2d_blob_keeps_its_shape(tmp_path):
    """A BatchNormalization after a Linear exports as a caffe Scale over a
    2-D blob. The port's ``_ScaleModule`` scales axis 1 of any rank; the
    JAX package's broadcasts as if the input were 4-D, and its import of
    the same pair fails at the next InnerProduct."""
    def build(nn, d):
        return (nn.Sequential().add(nn.Linear(5, 6, **d))
                .add(nn.BatchNormalization(6, **d)).add(nn.ReLU())
                .add(nn.Linear(6, 3, **d)))

    jm, tm = _pair(build, seed=4)
    tp, tc = str(tmp_path / "t.prototxt"), str(tmp_path / "t.caffemodel")
    texport.save_caffe(tm, tp, tc, input_shape=(5,))
    jp, jc = str(tmp_path / "j.prototxt"), str(tmp_path / "j.caffemodel")
    jexport.save_caffe(jm, jp, jc, input_shape=(5,))
    assert open(tc, "rb").read() == open(jc, "rb").read()
    x = np.random.RandomState(2).randn(4, 5).astype(np.float32)
    back = tcaffe.load_caffe(tp, tc, **CPU)
    back.evaluate()
    with torch.no_grad():
        got, want = _np(back(torch.from_numpy(x))), _np(tm(torch.from_numpy(x)))
    assert got.shape == (4, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(want, np.asarray(jm(jnp.asarray(x))), **TOL)
    jback = jcaffe.load_caffe(jp, jc)
    jback.evaluate()
    with pytest.raises(TypeError):
        jback(jnp.asarray(x))


def test_export_from_a_bf16_model_writes_f32_blobs(tmp_path):
    _, tm = _pair(_convnet, seed=9)
    p32, c32 = str(tmp_path / "a.prototxt"), str(tmp_path / "a.caffemodel")
    texport.save_caffe(tm, p32, c32, input_shape=(3, 8, 8))
    tm16 = _convnet(tnn, CPU).to(torch.bfloat16)
    tm16.load_state_dict(tm.state_dict())
    p16, c16 = str(tmp_path / "b.prototxt"), str(tmp_path / "b.caffemodel")
    texport.save_caffe(tm16, p16, c16, input_shape=(3, 8, 8))
    assert open(p16).read() == open(p32).read()
    blobs = {r["name"]: r["blobs"] for r in
             tcaffe.parse_caffemodel(open(c16, "rb").read())}
    w = tm16[0].weight.detach().float().numpy()
    assert blobs["conv1"][0].dtype == np.float32
    assert np.array_equal(blobs["conv1"][0], w)


def test_caffe_export_rejects_multidim_reshape(tmp_path):
    model = tnn.Sequential().add(tnn.Reshape((2, 3)))
    with pytest.raises(ValueError, match="collapsing"):
        texport.save_caffe(model, str(tmp_path / "a.prototxt"),
                           str(tmp_path / "a.caffemodel"))
    with pytest.raises(ValueError, match="unsupported layer LogSoftMax"):
        texport.save_caffe(tnn.Sequential(tnn.LogSoftMax()),
                           str(tmp_path / "b.prototxt"),
                           str(tmp_path / "b.caffemodel"))
