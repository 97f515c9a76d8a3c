"""Keras json + hdf5 import in the port (``bigdl_tpu_torch/keras/converter.py``)
held against the installed tf.keras and the JAX package.

Each case of ``tests/test_keras_weights_oracle.py`` saves the same real
tf.keras model to legacy hdf5 and loads it with the JAX package's
``load_keras`` and the port's (on the CPU): the port's predictions equal
keras' own at that file's rtol 1e-4 / atol 1e-5 and JAX's at rtol 1e-5 /
atol 1e-6. The Keras-1.2.2 per-gate layouts are held equal to the fused
ones, as there. The keras cases of ``tests/test_convert.py`` follow
under their names, then the port's own: a json-only model with weights
set from numpy works with no ``h5py``, and reading an .h5 then raises an
``ImportError`` that names it.
"""

import json
import sys

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")
keras = tf.keras

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu.keras.converter import load_keras as jax_load_keras  # noqa: E402
from bigdl_tpu.nn.module import jit_inference_fn  # noqa: E402
from bigdl_tpu_torch.keras.converter import (  # noqa: E402
    DefinitionLoader, WeightLoader, load_keras)
from bigdl_tpu_torch.utils.table import Table  # noqa: E402

KERAS_TOL = dict(rtol=1e-4, atol=1e-5)
JAX_TOL = dict(rtol=1e-5, atol=1e-6)


def _save(tmp_path, model, name):
    h5 = str(tmp_path / f"{name}.h5")
    model.save(h5)
    return model.to_json(), h5


def _forward(model, x):
    model.evaluate()  # inference mode (dropout off, BN running stats)
    if isinstance(x, Table):
        xs = Table(*[torch.from_numpy(np.asarray(v)) for v in x])
    else:
        xs = torch.from_numpy(np.asarray(x))
    with torch.no_grad():
        return model(xs).numpy()


def _jax_forward(model, x):
    model.evaluate()
    fn = jit_inference_fn(model)
    return np.asarray(fn(model.params_dict(), model.buffers_dict(),
                         jnp.asarray(x)))


def both(want, x, **kw):
    """The port's model from ``kw`` against keras' ``want`` and JAX's."""
    m = load_keras(device="cpu", **kw)
    got = _forward(m, x)
    np.testing.assert_allclose(got, want, **KERAS_TOL)
    np.testing.assert_allclose(got, _jax_forward(jax_load_keras(**kw), x),
                               **JAX_TOL)
    return m


# ------------------------------------------------------------- fused layout
def test_lstm_text_model_matches_keras(tmp_path):
    np.random.seed(1)
    km = keras.Sequential([
        keras.layers.Embedding(50, 8),
        keras.layers.LSTM(6),
        keras.layers.Dense(3, activation="softmax"),
    ])
    km.build((None, 12))
    js, h5 = _save(tmp_path, km, "lstm")
    x = np.random.randint(0, 50, (4, 12))
    both(km.predict(x, verbose=0), x, json_str=js, hdf5_path=h5,
         input_shape=(12,))


def test_lstm_return_sequences_matches_keras(tmp_path):
    np.random.seed(2)
    km = keras.Sequential([
        keras.layers.Embedding(30, 5),
        keras.layers.LSTM(4, return_sequences=True),
    ])
    km.build((None, 7))
    js, h5 = _save(tmp_path, km, "lstm_seq")
    x = np.random.randint(0, 30, (3, 7))
    both(km.predict(x, verbose=0), x, json_str=js, hdf5_path=h5,
         input_shape=(7,))


def test_gru_model_matches_keras(tmp_path):
    np.random.seed(3)
    km = keras.Sequential([
        keras.layers.Embedding(40, 6),
        keras.layers.GRU(5, reset_after=False),
        keras.layers.Dense(2),
    ])
    km.build((None, 9))
    js, h5 = _save(tmp_path, km, "gru")
    x = np.random.randint(0, 40, (4, 9))
    both(km.predict(x, verbose=0), x, json_str=js, hdf5_path=h5,
         input_shape=(9,))


def test_gru_reset_after_is_rejected(tmp_path):
    km = keras.Sequential([
        keras.layers.Embedding(10, 4),
        keras.layers.GRU(3, reset_after=True),
    ])
    km.build((None, 5))
    js, h5 = _save(tmp_path, km, "gru_ra")
    with pytest.raises(ValueError, match="reset_after"):
        load_keras(json_str=js, hdf5_path=h5, input_shape=(5,), device="cpu")
    with pytest.raises(ValueError, match="reset_after"):
        jax_load_keras(json_str=js, hdf5_path=h5, input_shape=(5,))


def test_simplernn_model_matches_keras(tmp_path):
    np.random.seed(4)
    km = keras.Sequential([
        keras.layers.Embedding(20, 4),
        keras.layers.SimpleRNN(6),
        keras.layers.Dense(2, activation="tanh"),
    ])
    km.build((None, 8))
    js, h5 = _save(tmp_path, km, "rnn")
    x = np.random.randint(0, 20, (3, 8))
    both(km.predict(x, verbose=0), x, json_str=js, hdf5_path=h5,
         input_shape=(8,))


def test_conv1d_model_matches_keras(tmp_path):
    np.random.seed(5)
    km = keras.Sequential([
        keras.layers.Embedding(25, 6),
        keras.layers.Conv1D(7, 3, activation="relu"),
        keras.layers.GlobalMaxPooling1D(),
        keras.layers.Dense(3),
    ])
    km.build((None, 10))
    js, h5 = _save(tmp_path, km, "conv1d")
    x = np.random.randint(0, 25, (4, 10))
    both(km.predict(x, verbose=0), x, json_str=js, hdf5_path=h5,
         input_shape=(10,))


def _to_th_json(js: str) -> str:
    """A channels_last keras json rewritten to the th (channels-first)
    layout the importer pins: data_format dropped, input shapes moved
    from (..., C) to (C, ...)."""
    spec = json.loads(js)
    layers = spec["config"]["layers"] if isinstance(spec["config"], dict) \
        else spec["config"]
    for l in layers:
        c = l["config"]
        c.pop("data_format", None)
        for key in ("batch_shape", "batch_input_shape"):
            if c.get(key) and len(c[key]) == 4:
                b, h, w, ch = c[key]
                c[key] = [b, ch, h, w]
    return json.dumps(spec)


def test_conv2d_separable_model_matches_keras(tmp_path):
    np.random.seed(6)
    km = keras.Sequential([
        keras.layers.Input((8, 8, 2)),
        keras.layers.Conv2D(4, 3, activation="relu"),
        keras.layers.SeparableConv2D(6, 3, depth_multiplier=2),
        keras.layers.GlobalAveragePooling2D(),
        keras.layers.Dense(3),
    ])
    js, h5 = _save(tmp_path, km, "conv2d")
    x = np.random.randn(2, 8, 8, 2).astype(np.float32)
    both(km.predict(x, verbose=0), x.transpose(0, 3, 1, 2),  # NHWC -> NCHW
         json_str=_to_th_json(js), hdf5_path=h5)


# ----------------------------------------------- keras-1.2.2 per-gate layout
def _write_k1_h5(path, groups):
    """Write {layer_name: [arrays]} in the Keras-1 hdf5 layout."""
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = [n.encode() for n in groups]
        for ln, arrs in groups.items():
            g = f.create_group(ln)
            names = [f"{ln}_W_{i}".encode() for i in range(len(arrs))]
            g.attrs["weight_names"] = names
            for n, a in zip(names, arrs):
                g.create_dataset(n.decode(), data=a)


K1_LSTM_JSON = json.dumps({"class_name": "Sequential", "config": [
    {"class_name": "LSTM", "config": {
        "output_dim": 4, "return_sequences": False,
        "batch_input_shape": [None, 6, 3]}},
]})

K1_GRU_JSON = json.dumps({"class_name": "Sequential", "config": [
    {"class_name": "GRU", "config": {
        "output_dim": 4, "return_sequences": False,
        "batch_input_shape": [None, 6, 3]}},
]})


def _pergate_pair(tmp_path, json_str, k1, fused, x):
    p1, p2 = str(tmp_path / "k1.h5"), str(tmp_path / "k2.h5")
    name = json.loads(json_str)["config"][0]["class_name"].lower() + "_1"
    _write_k1_h5(p1, {name: k1})
    _write_k1_h5(p2, {name: fused})
    m1 = load_keras(json_str=json_str, hdf5_path=p1, device="cpu")
    m2 = load_keras(json_str=json_str, hdf5_path=p2, device="cpu")
    got = _forward(m1, x)
    np.testing.assert_allclose(got, _forward(m2, x), rtol=1e-6)
    np.testing.assert_allclose(got, _jax_forward(jax_load_keras(
        json_str=json_str, hdf5_path=p1), x), **JAX_TOL)


def test_keras1_lstm_pergate_layout_equals_fused(tmp_path):
    rng = np.random.RandomState(7)
    h = 4
    per = {g: (rng.randn(3, h).astype(np.float32),
               rng.randn(h, h).astype(np.float32),
               rng.randn(h).astype(np.float32))
           for g in "icfo"}
    # keras-1 group order i, c, f, o; fused (tf.keras) order i, f, c, o
    k1 = [a for g in "icfo" for a in per[g]]
    fused = [np.concatenate([per[g][0] for g in "ifco"], 1),
             np.concatenate([per[g][1] for g in "ifco"], 1),
             np.concatenate([per[g][2] for g in "ifco"])]
    _pergate_pair(tmp_path, K1_LSTM_JSON, k1, fused,
                  rng.randn(2, 6, 3).astype(np.float32))


def test_keras1_gru_pergate_layout_equals_fused(tmp_path):
    rng = np.random.RandomState(8)
    h = 4
    per = {g: (rng.randn(3, h).astype(np.float32),
               rng.randn(h, h).astype(np.float32),
               rng.randn(h).astype(np.float32))
           for g in "zrh"}
    k1 = [a for g in "zrh" for a in per[g]]  # keras-1 groups z, r, h
    fused = [np.concatenate([per[g][0] for g in "zrh"], 1),
             np.concatenate([per[g][1] for g in "zrh"], 1),
             np.concatenate([per[g][2] for g in "zrh"])]
    _pergate_pair(tmp_path, K1_GRU_JSON, k1, fused,
                  rng.randn(2, 6, 3).astype(np.float32))


# ------------------------------------------------------- functional API
def test_functional_model_with_merges_matches_keras(tmp_path):
    np.random.seed(9)
    inp = keras.Input((6,))
    a = keras.layers.Dense(8, activation="relu", name="da")(inp)
    b = keras.layers.Dense(8, name="db")(inp)
    added = keras.layers.Add()([a, b])
    cat = keras.layers.Concatenate()([added, a])
    out = keras.layers.Dense(3, name="head")(cat)
    km = keras.Model(inp, out)
    js, h5 = _save(tmp_path, km, "func")
    x = np.random.randn(4, 6).astype(np.float32)
    both(km.predict(x, verbose=0), x, json_str=js, hdf5_path=h5)


def test_functional_lstm_matches_keras(tmp_path):
    np.random.seed(10)
    inp = keras.Input((7,))
    e = keras.layers.Embedding(30, 5, name="emb")(inp)
    h = keras.layers.LSTM(4, name="rnn")(e)
    out = keras.layers.Dense(2, name="out")(h)
    km = keras.Model(inp, out)
    js, h5 = _save(tmp_path, km, "func_lstm")
    x = np.random.randint(0, 30, (3, 7))
    both(km.predict(x, verbose=0), x, json_str=js, hdf5_path=h5)


def test_functional_shared_layer_matches_keras(tmp_path):
    np.random.seed(12)
    inp_a = keras.Input((4,), name="ia")
    inp_b = keras.Input((4,), name="ib")
    d = keras.layers.Dense(6, activation="relu", name="shared")
    out = keras.layers.Dense(2, name="head")(
        keras.layers.Concatenate()([d(inp_a), d(inp_b)]))
    km = keras.Model([inp_a, inp_b], out)
    js, h5 = _save(tmp_path, km, "shared")
    xa = np.random.randn(3, 4).astype(np.float32)
    xb = np.random.randn(3, 4).astype(np.float32)
    want = km.predict([xa, xb], verbose=0)
    m = load_keras(json_str=js, hdf5_path=h5, device="cpu")
    got = _forward(m, Table(xa, xb))
    np.testing.assert_allclose(got, want, **KERAS_TOL)
    from bigdl_tpu import T

    jm = jax_load_keras(json_str=js, hdf5_path=h5)
    jm.evaluate()
    np.testing.assert_allclose(
        got, np.asarray(jm.forward(T(jnp.asarray(xa), jnp.asarray(xb)))),
        **JAX_TOL)
    # one weight-owning Dense for both branches: its W, b and the head's
    assert len(list(m.parameters())) == 4


def test_functional_chained_self_share_matches_keras(tmp_path):
    np.random.seed(13)
    inp = keras.Input((5,))
    f = keras.layers.Dense(5, activation="tanh", name="f")
    out = keras.layers.Dense(2, name="head")(f(f(inp)))
    km = keras.Model(inp, out)
    js, h5 = _save(tmp_path, km, "selfshare")
    x = np.random.randn(4, 5).astype(np.float32)
    m = both(km.predict(x, verbose=0), x, json_str=js, hdf5_path=h5)
    assert len(list(m.parameters())) == 4    # f's W, b and head's W, b


def test_functional_variable_dim_input_uses_override(tmp_path):
    inp = keras.Input((None, 5))  # variable time dim
    h = keras.layers.LSTM(3, name="r")(inp)
    km = keras.Model(inp, h)
    js, h5 = _save(tmp_path, km, "vardim")
    with pytest.raises(ValueError, match="input_shape"):
        load_keras(json_str=js, hdf5_path=h5, device="cpu")
    x = np.random.RandomState(11).randn(2, 6, 5).astype(np.float32)
    both(km.predict(x, verbose=0), x, json_str=js, hdf5_path=h5,
         input_shape=(6, 5))


def test_load_keras_from_h5_alone_uses_embedded_config(tmp_path):
    np.random.seed(12)
    km = keras.Sequential([
        keras.layers.Embedding(20, 4),
        keras.layers.GRU(3, reset_after=False),
        keras.layers.Dense(2),
    ])
    km.build((None, 6))
    h5 = str(tmp_path / "solo.h5")
    km.save(h5)
    x = np.random.randint(0, 20, (3, 6))
    both(km.predict(x, verbose=0), x, hdf5_path=h5, input_shape=(6,))


# ---------------------------------------- tests/test_convert.py's keras cases
def _write_keras_fixture(tmp_path, rng):
    """A Keras-1.2.2-layout json + hdf5 written by hand."""
    import h5py

    spec = {"class_name": "Sequential", "config": [
        {"class_name": "Dense", "config": {
            "output_dim": 16, "activation": "relu", "bias": True,
            "batch_input_shape": [None, 8]}},
        {"class_name": "Dropout", "config": {"p": 0.5}},
        {"class_name": "Dense", "config": {
            "output_dim": 4, "activation": "softmax", "bias": True}},
    ]}
    jpath = str(tmp_path / "model.json")
    with open(jpath, "w") as f:
        json.dump(spec, f)
    w1 = rng.randn(8, 16).astype(np.float32) * 0.3
    b1 = rng.randn(16).astype(np.float32) * 0.1
    w2 = rng.randn(16, 4).astype(np.float32) * 0.3
    b2 = rng.randn(4).astype(np.float32) * 0.1
    hpath = str(tmp_path / "weights.h5")
    with h5py.File(hpath, "w") as f:
        f.attrs["layer_names"] = [b"dense_1", b"dropout_1", b"dense_2"]
        g1 = f.create_group("dense_1")
        g1.attrs["weight_names"] = [b"dense_1_W", b"dense_1_b"]
        g1.create_dataset("dense_1_W", data=w1)
        g1.create_dataset("dense_1_b", data=b1)
        f.create_group("dropout_1").attrs["weight_names"] = []
        g2 = f.create_group("dense_2")
        g2.attrs["weight_names"] = [b"dense_2_W", b"dense_2_b"]
        g2.create_dataset("dense_2_W", data=w2)
        g2.create_dataset("dense_2_b", data=b2)
    return jpath, hpath, (w1, b1, w2, b2)


def _mlp_ref(x, w1, b1, w2, b2):
    h = np.maximum(x @ w1 + b1, 0.0)
    logits = h @ w2 + b2
    return np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)


def test_keras_import_matches_manual_math(tmp_path):
    rng = np.random.RandomState(0)
    jpath, hpath, ws = _write_keras_fixture(tmp_path, rng)
    x = rng.randn(5, 8).astype(np.float32)
    got = _forward(both(_mlp_ref(x, *ws), x, json_path=jpath,
                        hdf5_path=hpath), x)
    np.testing.assert_allclose(got, _mlp_ref(x, *ws), rtol=1e-4, atol=1e-6)


def _json_pair(spec):
    from bigdl_tpu.keras.converter import DefinitionLoader as JDL

    return (JDL.from_json_str(json.dumps(spec)),
            DefinitionLoader.from_json_str(json.dumps(spec), device="cpu"))


def _shapes_agree(spec, x_shape):
    jm, pm = _json_pair(spec)
    want = _jax_forward(jm, np.zeros(x_shape, np.float32)).shape
    pm.evaluate()
    with torch.no_grad():
        got = tuple(pm(torch.zeros(x_shape)).shape)
    assert got == want
    assert pm.get_output_shape() == tuple(jm.get_output_shape())
    return got


def test_keras_import_conv_topology(tmp_path):
    spec = {"class_name": "Sequential", "config": [
        {"class_name": "Convolution2D", "config": {
            "nb_filter": 4, "nb_row": 3, "nb_col": 3,
            "border_mode": "same", "activation": "relu",
            "batch_input_shape": [None, 3, 8, 8], "dim_ordering": "th"}},
        {"class_name": "MaxPooling2D", "config": {"pool_size": [2, 2]}},
        {"class_name": "Flatten", "config": {}},
        {"class_name": "Dense", "config": {"output_dim": 2}},
    ]}
    assert _shapes_agree(spec, (2, 3, 8, 8)) == (2, 2)


def test_keras_import_extended_layer_set(tmp_path):
    spec = {"class_name": "Sequential", "config": [
        {"class_name": "Convolution1D", "config": {
            "nb_filter": 6, "filter_length": 3, "activation": "relu",
            "batch_input_shape": [None, 12, 4]}},
        {"class_name": "MaxPooling1D", "config": {"pool_length": 2}},
        {"class_name": "LSTM", "config": {"output_dim": 8,
                                          "return_sequences": True}},
        {"class_name": "GRU", "config": {"output_dim": 5}},
        {"class_name": "Dense", "config": {"output_dim": 3}},
    ]}
    assert _shapes_agree(spec, (2, 12, 4)) == (2, 3)
    spec2 = {"class_name": "Sequential", "config": [
        {"class_name": "ZeroPadding2D", "config": {
            "padding": [1, 1], "batch_input_shape": [None, 2, 4, 4]}},
        {"class_name": "UpSampling2D", "config": {"size": [2, 2]}},
        {"class_name": "GlobalAveragePooling2D", "config": {}},
        {"class_name": "Dense", "config": {"output_dim": 2}},
    ]}
    assert _shapes_agree(spec2, (1, 2, 4, 4)) == (1, 2)
    spec3 = {"class_name": "Sequential", "config": [
        {"class_name": "GlobalMaxPooling1D", "config": {
            "batch_input_shape": [None, 7, 5]}},
    ]}
    assert _shapes_agree(spec3, (2, 7, 5)) == (2, 5)


def test_convert_model_cli_keras_to_bigdl(tmp_path):
    from bigdl_tpu_torch.utils.convert_model import main
    from bigdl_tpu_torch.utils.file import load_module

    rng = np.random.RandomState(5)
    jpath, hpath, ws = _write_keras_fixture(tmp_path, rng)
    dst = str(tmp_path / "from_keras.bigdl")
    main(["--from", "keras", "--to", "bigdl", "--input", hpath,
          "--keras-json", jpath, "--output", dst, "--device", "cpu"])
    model = load_module(dst, device="cpu")
    x = rng.randn(3, 8).astype(np.float32)
    np.testing.assert_allclose(_forward(model, x), _mlp_ref(x, *ws),
                               rtol=1e-4, atol=1e-6)


def test_keras_weight_loader_fails_fast_on_unmapped_layers(tmp_path):
    """A weighted layer without an hdf5 mapping is refused BEFORE any
    weight is set (no half-loaded model), as in JAX."""
    import h5py

    from bigdl_tpu_torch import keras as bk

    model = bk.Sequential()
    model.add(bk.Deconvolution2D(2, 3, 3, input_shape=(3, 8, 8),
                                 device="cpu"))
    model.add(bk.Flatten(device="cpu"))
    model.add(bk.Dense(3, device="cpu"))
    hpath = str(tmp_path / "w.h5")
    with h5py.File(hpath, "w") as f:
        f.attrs["layer_names"] = [b"deconv_1", b"dense_1"]
        g1 = f.create_group("deconv_1")
        g1.attrs["weight_names"] = [b"W"]
        g1.create_dataset("W", data=np.zeros((3, 8), np.float32))
        g2 = f.create_group("dense_1")
        g2.attrs["weight_names"] = [b"W", b"b"]
        g2.create_dataset("W", data=np.zeros((2, 3), np.float32))
        g2.create_dataset("b", data=np.zeros((3,), np.float32))
    dense = model._layers[-1]
    before = dense.layer.weight.detach().clone()
    with pytest.raises(ValueError, match="topology-only"):
        WeightLoader.load_weights(model, hpath)
    assert torch.equal(dense.layer.weight.detach(), before)   # untouched


def test_keras_import_rejects_asymmetric_zero_padding():
    spec = {"class_name": "Sequential", "config": [
        {"class_name": "ZeroPadding2D", "config": {
            "padding": [[0, 1], [0, 1]],
            "batch_input_shape": [None, 2, 4, 4]}},
    ]}
    with pytest.raises(ValueError, match="asymmetric"):
        DefinitionLoader.from_json_str(json.dumps(spec), device="cpu")


# -------------------------------------------------------- the port's own
def test_json_only_model_needs_no_h5py(tmp_path, monkeypatch):
    """Without h5py a json topology loads and takes numpy weights, and
    reading an .h5 raises an ImportError naming h5py."""
    rng = np.random.RandomState(1)
    jpath, hpath, (w1, b1, w2, b2) = _write_keras_fixture(tmp_path, rng)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        load_keras(json_path=jpath, hdf5_path=hpath, device="cpu")
    with pytest.raises(ImportError, match="h5py"):
        load_keras(hdf5_path=hpath, device="cpu")
    m = load_keras(json_path=jpath, device="cpu")
    dense = [l for l in m._layers if l.layer.params_dict()]
    for layer, (w, b) in zip(dense, ((w1, b1), (w2, b2))):
        lin = [mod for mod in layer.modules()
               if type(mod).__name__ == "Linear"][0]
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w.T))
            lin.bias.copy_(torch.from_numpy(b))
    x = rng.randn(4, 8).astype(np.float32)
    np.testing.assert_allclose(_forward(m, x), _mlp_ref(x, w1, b1, w2, b2),
                               rtol=1e-5, atol=1e-6)
