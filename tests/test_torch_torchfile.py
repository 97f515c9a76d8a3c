"""Lua Torch ``.t7`` read and write (bigdl_tpu_torch/utils/torchfile.py)
against the JAX package's (the .t7 cases of tests/test_import.py, run
through the port).

The port's writer gives the JAX writer's bytes for the same objects
(numpy arrays or torch tensors); both readers give the same objects;
``load_torch`` builds the port's modules with the JAX package's weights
and outputs (rtol 1e-5 / atol 1e-6). As in the JAX package, the writer
refuses a module.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.utils import torchfile as jtf
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.utils import torchfile as ttf

TOL = dict(rtol=1e-5, atol=1e-6)


def _np(out):
    return out.detach().numpy() if torch.is_tensor(out) else np.asarray(out)


def _same(a, b):
    """The same object read by both readers: arrays equal in dtype and
    bits, TorchObjects by class and fields, tables entry by entry."""
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    elif isinstance(a, (ttf.TorchObject, jtf.TorchObject)):
        assert a.torch_class == b.torch_class
        _same(a.fields, b.fields)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    else:
        assert type(a) is type(b) and a == b


def _both(obj, tmp_path, name):
    """Write ``obj`` (the port's TorchObjects) with both writers; the two
    files must be the same bytes. Returns the path."""
    def as_jax(o):
        if isinstance(o, ttf.TorchObject):
            return jtf.TorchObject(o.torch_class, as_jax(o.fields))
        if isinstance(o, dict):
            return {k: as_jax(v) for k, v in o.items()}
        return o.detach().numpy() if torch.is_tensor(o) else o

    tp, jp = str(tmp_path / f"{name}.port.t7"), str(tmp_path / f"{name}.jax.t7")
    ttf.save(tp, obj)
    jtf.save(jp, as_jax(obj))
    assert open(tp, "rb").read() == open(jp, "rb").read()
    return tp


def test_raw_roundtrip(tmp_path):
    obj = {"a": 1.5, "b": "hello",
           "t": np.arange(12, dtype=np.float32).reshape(3, 4),
           "d": torch.arange(6, dtype=torch.float64).reshape(2, 3),
           "l": np.arange(5, dtype=np.int64), "i": np.arange(4, dtype=np.int32),
           "nested": {"x": True, "y": None, 3: -2.0}}
    p = _both(obj, tmp_path, "raw")
    back = ttf.load(p)
    _same(back, jtf.load(p))
    assert back["a"] == 1.5 and back["b"] == "hello"
    np.testing.assert_array_equal(back["t"], obj["t"])
    assert back["d"].dtype == np.float64 and back["l"].dtype == np.int64
    assert back["i"].dtype == np.float32          # written as a FloatTensor
    assert back["nested"]["x"] is True and back["nested"][3] == -2.0


def test_load_torch_mlp(tmp_path):
    rng = np.random.RandomState(0)
    w1, b1 = rng.randn(6, 4).astype(np.float32), rng.randn(6).astype(np.float32)
    w2, b2 = rng.randn(2, 6).astype(np.float32), rng.randn(2).astype(np.float32)
    seq = ttf.TorchObject("nn.Sequential", {"modules": {
        1: ttf.TorchObject("nn.Linear", {"weight": w1, "bias": b1}),
        2: ttf.TorchObject("nn.Tanh", {}),
        3: ttf.TorchObject("nn.Linear", {"weight": torch.from_numpy(w2),
                                         "bias": b2}),
        4: ttf.TorchObject("nn.LogSoftMax", {}),
    }})
    p = _both(seq, tmp_path, "mlp")
    m = ttf.load_torch(p, device="cpu")
    x = rng.randn(3, 4).astype(np.float32)
    with torch.no_grad():
        got = _np(m(torch.from_numpy(x)))
    h = np.tanh(x @ w1.T + b1)
    logits = h @ w2.T + b2
    want = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, np.asarray(
        jtf.load_torch(p)(jnp.asarray(x))), **TOL)


def test_load_torch_convnet(tmp_path):
    rng = np.random.RandomState(1)
    w = rng.randn(4, 3, 3, 3).astype(np.float32) * 0.2
    b = rng.randn(4).astype(np.float32)
    seq = ttf.TorchObject("nn.Sequential", {"modules": {
        1: ttf.TorchObject("nn.SpatialConvolution", {
            "weight": w, "bias": b, "nInputPlane": 3, "nOutputPlane": 4,
            "kW": 3, "kH": 3, "dW": 1, "dH": 1, "padW": 1, "padH": 1}),
        2: ttf.TorchObject("nn.ReLU", {}),
        3: ttf.TorchObject("nn.SpatialMaxPooling", {
            "kW": 2, "kH": 2, "dW": 2, "dH": 2, "padW": 0, "padH": 0}),
    }})
    p = _both(seq, tmp_path, "conv")
    m = ttf.load_torch(p, device="cpu")
    with torch.no_grad():
        out = m(torch.ones(2, 3, 8, 8))
    assert out.shape == (2, 4, 4, 4)
    x = rng.randn(2, 3, 8, 8).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(_np(m(torch.from_numpy(x))), np.asarray(
            jtf.load_torch(p)(jnp.asarray(x))), **TOL)


def test_load_torch_every_class_equals_jax(tmp_path):
    """Every class ``load_torch`` maps, weights from the file: the port's
    output equals the JAX package's on the same file."""
    rng = np.random.RandomState(2)

    def f32(*s):
        return rng.randn(*s).astype(np.float32)

    bn = {"weight": f32(4), "bias": f32(4), "running_mean": f32(4) * 0.1,
          "running_var": rng.uniform(0.5, 1.5, 4).astype(np.float32),
          "eps": 1e-3, "momentum": 0.1}
    obj = ttf.TorchObject("nn.Sequential", {"modules": {
        1: ttf.TorchObject("nn.SpatialConvolutionMM", {
            "weight": f32(4, 27), "bias": f32(4), "nInputPlane": 3,
            "nOutputPlane": 4, "kW": 3, "kH": 3, "padW": 1, "padH": 1}),
        2: ttf.TorchObject("nn.SpatialBatchNormalization", bn),
        3: ttf.TorchObject("nn.Sigmoid", {}),
        4: ttf.TorchObject("nn.SpatialMaxPooling", {
            "kW": 3, "kH": 3, "dW": 2, "dH": 2, "ceil_mode": True}),
        5: ttf.TorchObject("nn.SpatialAveragePooling", {
            "kW": 2, "kH": 2, "dW": 2, "dH": 2}),
        6: ttf.TorchObject("nn.Concat", {"dimension": 2, "modules": {
            1: ttf.TorchObject("nn.Identity", {}),
            2: ttf.TorchObject("nn.ReLU", {})}}),
        7: ttf.TorchObject("nn.Dropout", {"p": 0.3}),
        8: ttf.TorchObject("nn.View", {"size": np.array([32.0])}),
        9: ttf.TorchObject("nn.ConcatTable", {"modules": {
            1: ttf.TorchObject("nn.Linear", {"weight": f32(5, 32),
                                             "bias": f32(5)}),
            2: ttf.TorchObject("nn.Linear", {"weight": f32(5, 32)})}}),
        10: ttf.TorchObject("nn.CAddTable", {}),
        11: ttf.TorchObject("nn.Reshape", {"size": np.array([5.0, 1.0])}),
        12: ttf.TorchObject("nn.Tanh", {}),
        13: ttf.TorchObject("nn.View", {"size": np.array([5.0])}),
        14: ttf.TorchObject("nn.SoftMax", {}),
    }})
    p = _both(obj, tmp_path, "every")
    m = ttf.load_torch(p, device="cpu")
    jm = jtf.load_torch(p)
    m.evaluate()
    jm.evaluate()
    x = f32(2, 3, 9, 9)
    with torch.no_grad():
        got = _np(m(torch.from_numpy(x)))
    assert got.shape == (2, 5)
    np.testing.assert_allclose(got, np.asarray(jm(jnp.asarray(x))), **TOL)
    with pytest.raises(ValueError, match="unsupported torch module class"):
        ttf._to_module(ttf.TorchObject("nn.Fancy", {}), torch.device("cpu"))


def test_writer_refuses_a_module_and_loads_need_a_device(tmp_path):
    p = str(tmp_path / "m.t7")
    with pytest.raises(TypeError, match="cannot write"):
        ttf.save(p, tnn.Linear(2, 2, device="cpu"))
    with pytest.raises(TypeError, match="cannot write"):
        jtf.save(p, object())
    if not torch.cuda.is_available():
        ttf.save(p, ttf.TorchObject("nn.Tanh", {}))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttf.load_torch(p)
