"""The port's Keras API (``bigdl_tpu_torch/keras``) held against the JAX
package's ``bigdl_tpu.keras``.

Each case of ``tests/test_keras.py`` builds the same model with both
packages (the JAX one's weights drawn by numpy,
``tests/jax_numpy_init.py``), holds the port's inferred shapes equal to
JAX's and, after ``load_jax_params``, its forward to JAX's jitted
eval-mode forward at rtol 1e-5 / atol 1e-6; ``compile`` / ``fit`` /
``evaluate`` reach JAX's thresholds. The keras cases of
``tests/test_parity_tails.py`` (from ``test_keras_3d_stack_shapes`` on)
follow under their names, then the port's own: the shape inference
leaves the model's generators and training flags as they were, a sweep
over every name ``bigdl_tpu.keras`` exports, and a ``save_module``
round trip.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu import keras as jk
from bigdl_tpu.nn.module import jit_inference_fn
from bigdl_tpu.utils.table import Table as JTable
from bigdl_tpu_torch import keras as pk
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import Table
from bigdl_tpu_torch.utils.weights import load_jax_buffers, load_jax_params
from tests.jax_numpy_init import numpy_weight_draws, seed_of

CPU = {"device": "cpu"}
TOL = dict(rtol=1e-5, atol=1e-6)


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def pair(layers, name):
    """(JAX Sequential, port Sequential) of ``layers(K, kw)``, the port's
    weights and buffers carried from JAX's; both in eval mode."""
    with numpy_weight_draws(seed_of(name)):
        jm = jk.Sequential()
        for layer in layers(jk, {}):
            jm.add(layer)
    pm = pk.Sequential()
    for layer in layers(pk, CPU):
        pm.add(layer)
    load_jax_params(pm, _np_tree(jm.params_dict()))
    load_jax_buffers(pm, _np_tree(jm.buffers_dict()))
    jm.evaluate()
    pm.evaluate()
    return jm, pm


def same_forward(jm, pm, x):
    fn = jit_inference_fn(jm)
    want = np.asarray(fn(jm.params_dict(), jm.buffers_dict(), jnp.asarray(x)))
    with torch.no_grad():
        got = pm(torch.from_numpy(np.asarray(x))).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    return got


class TestShapes:
    def test_dense_chain(self):
        jm, pm = pair(lambda K, d: [
            K.Dense(16, activation="relu", input_shape=(8,), **d),
            K.Dense(4, activation="softmax", **d)], "dense_chain")
        assert pm.get_output_shape() == jm.get_output_shape() == (4,)
        out = same_forward(jm, pm, np.random.RandomState(0).randn(5, 8)
                           .astype(np.float32))
        np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5)

    def test_mnist_cnn_stack(self):
        jm, pm = pair(lambda K, d: [
            K.Convolution2D(8, 3, 3, activation="relu",
                            input_shape=(1, 28, 28), **d),
            K.MaxPooling2D((2, 2), **d),
            K.Convolution2D(16, 3, 3, border_mode="same", **d),
            K.BatchNormalization(**d),
            K.Activation("relu", **d),
            K.GlobalAveragePooling2D(**d),
            K.Dense(10, activation="log_softmax", **d)], "mnist_cnn")
        assert pm.get_output_shape() == jm.get_output_shape() == (10,)
        same_forward(jm, pm, np.random.RandomState(1).randn(2, 1, 28, 28)
                     .astype(np.float32))

    def test_embedding_lstm(self):
        jm, pm = pair(lambda K, d: [
            K.Embedding(100, 16, input_shape=(12,), **d),
            K.LSTM(24, return_sequences=True, **d),
            K.TimeDistributed(K.Dense(8, **d), **d)], "embedding_lstm")
        assert pm.get_output_shape() == jm.get_output_shape() == (12, 8)
        ids = np.random.RandomState(0).randint(0, 100, (3, 12))
        assert same_forward(jm, pm, ids).shape == (3, 12, 8)

    def test_lstm_last_output(self):
        jm, pm = pair(lambda K, d: [K.LSTM(6, input_shape=(5, 4), **d)],
                      "lstm_last")
        assert pm.get_output_shape() == jm.get_output_shape() == (6,)
        same_forward(jm, pm, np.random.RandomState(2).randn(2, 5, 4)
                     .astype(np.float32))

    def test_bidirectional_concat(self):
        jm, pm = pair(lambda K, d: [
            K.Bidirectional(K.GRU(5, return_sequences=True, **d),
                            input_shape=(7, 3), **d)], "bidirectional")
        assert pm.get_output_shape() == jm.get_output_shape() == (7, 10)
        same_forward(jm, pm, np.random.RandomState(3).randn(2, 7, 3)
                     .astype(np.float32))

    def test_flatten_reshape_permute(self):
        jm, pm = pair(lambda K, d: [
            K.Reshape((4, 6), input_shape=(24,), **d),
            K.Permute((2, 1), **d), K.Flatten(**d)], "flatten_permute")
        assert pm.get_output_shape() == jm.get_output_shape() == (24,)
        x = np.arange(48, dtype=np.float32).reshape(2, 24)
        got = same_forward(jm, pm, x)
        want = x.reshape(2, 4, 6).transpose(0, 2, 1).reshape(2, 24)
        np.testing.assert_allclose(got, want)

    @pytest.mark.parametrize("layer,shape", [
        (lambda K, d: K.Convolution1D(6, 3, input_shape=(10, 4), **d), (8, 6)),
        (lambda K, d: K.AtrousConvolution2D(4, 3, 3, atrous_rate=(2, 2),
                                            input_shape=(2, 12, 12), **d),
         (4, 8, 8)),
        (lambda K, d: K.Deconvolution2D(3, 2, 2, subsample=(2, 2),
                                        input_shape=(4, 5, 5), **d),
         (3, 10, 10)),
        (lambda K, d: K.SeparableConvolution2D(6, 3, 3, input_shape=(3, 9, 9),
                                               **d), (6, 7, 7)),
        (lambda K, d: K.ZeroPadding2D((2, 1), input_shape=(3, 5, 5), **d),
         (3, 9, 7)),
        (lambda K, d: K.Cropping2D(((1, 1), (2, 2)), input_shape=(3, 8, 8),
                                   **d), (3, 6, 4)),
        (lambda K, d: K.UpSampling2D((2, 2), input_shape=(3, 4, 4), **d),
         (3, 8, 8)),
        (lambda K, d: K.GlobalMaxPooling1D(input_shape=(6, 5), **d), (5,)),
        (lambda K, d: K.MaxoutDense(7, 3, input_shape=(10,), **d), (7,)),
        (lambda K, d: K.Highway(input_shape=(9,), **d), (9,)),
        (lambda K, d: K.LeakyReLU(0.1, input_shape=(4,), **d), (4,)),
        (lambda K, d: K.ThresholdedReLU(0.5, input_shape=(4,), **d), (4,)),
    ])
    def test_single_layer_shapes(self, layer, shape, request):
        jm, pm = pair(lambda K, d: [layer(K, d)], request.node.name)
        assert pm.get_output_shape() == jm.get_output_shape() == shape
        x = np.random.RandomState(4).randn(2, *pm._layers[0].input_shape)
        same_forward(jm, pm, x.astype(np.float32))

    def test_merge_sum(self):
        def branches(K, d):
            out = []
            for _ in range(2):
                b = K.Dense(6, input_shape=(4,), **d)
                b.build((4,))
                out.append(b)
            m = K.Merge(out, mode="sum", input_shape=(4,), **d)
            m.build((4,))
            return m

        with numpy_weight_draws(seed_of("merge_sum")):
            jm = branches(jk, {})
        pm = branches(pk, CPU)
        load_jax_params(pm, _np_tree(jm.params_dict()))
        x = np.random.RandomState(5).randn(2, 4).astype(np.float32)
        want = np.asarray(jm(JTable(jnp.asarray(x), jnp.asarray(x * 2))))
        with torch.no_grad():
            got = pm(Table(torch.from_numpy(x), torch.from_numpy(x * 2)))
        assert tuple(got.shape) == want.shape == (2, 6)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


class TestTraining:
    def test_compile_fit_evaluate_predict(self):
        from bigdl_tpu_torch.optim import Adam

        rng = np.random.RandomState(0)
        x = rng.rand(128, 8).astype(np.float32)
        y = ((x.sum(-1) > 4.0).astype(np.float32)) + 1.0  # 1-based classes

        torch.manual_seed(0)
        m = pk.Sequential()
        m.add(pk.Dense(16, activation="tanh", input_shape=(8,), **CPU))
        m.add(pk.Dense(2, activation="log_softmax", **CPU))
        # string optimizer/loss resolution is exercised; the lr override
        # keeps the tiny fixture converging in few steps
        m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
        assert isinstance(m.optim_method, Adam)
        m.optim_method = Adam(learning_rate=0.05)
        m.fit(x, y.reshape(-1, 1), batch_size=32, nb_epoch=30)
        res = m.evaluate(x, y.reshape(-1, 1), batch_size=32)
        (name, acc), = res
        assert name == "Top1Accuracy" and acc > 0.9

        preds = m.predict_classes(x[:16], zero_based_label=False)
        assert set(np.unique(preds)).issubset({1, 2})


# ------------------------------- tests/test_parity_tails.py's keras cases
def test_keras_3d_stack_shapes():
    jm, pm = pair(lambda K, d: [
        K.Convolution3D(4, 3, 3, 3, border_mode="same",
                        input_shape=(2, 8, 8, 8), **d),
        K.MaxPooling3D(**d), K.AveragePooling3D(**d),
        K.GlobalAveragePooling3D(**d)], "k3d_stack")
    assert pm.get_output_shape() == jm.get_output_shape() == (4,)
    out = same_forward(jm, pm, np.random.RandomState(6).randn(2, 2, 8, 8, 8)
                       .astype(np.float32))
    assert out.shape == (2, 4)


def test_keras_3d_shape_layers():
    jm, pm = pair(lambda K, d: [
        K.ZeroPadding3D(padding=(1, 1, 1), input_shape=(2, 3, 3, 3), **d),
        K.Cropping3D(cropping=((1, 1), (0, 0), (0, 0)), **d),
        K.UpSampling3D(size=(2, 1, 1), **d),
        K.SpatialDropout3D(0.5, **d)], "k3d_shape")
    assert pm.get_output_shape() == jm.get_output_shape() == (2, 6, 5, 5)
    same_forward(jm, pm, np.random.RandomState(7).randn(2, 2, 3, 3, 3)
                 .astype(np.float32))


def test_keras_atrous_conv1d():
    jm, pm = pair(lambda K, d: [
        K.AtrousConvolution1D(6, 3, atrous_rate=2, input_shape=(10, 4), **d)],
        "atrous1d")
    # effective kernel = (3-1)*2+1 = 5 -> T' = 10-5+1 = 6
    assert pm.get_output_shape() == jm.get_output_shape() == (6, 6)
    out = same_forward(jm, pm, np.random.RandomState(8).randn(2, 10, 4)
                       .astype(np.float32))
    assert out.shape == (2, 6, 6)


def test_keras_locally_connected1d():
    jm, pm = pair(lambda K, d: [
        K.LocallyConnected1D(5, 3, input_shape=(8, 4), **d)], "lc1d")
    assert pm.get_output_shape() == jm.get_output_shape() == (6, 5)
    same_forward(jm, pm, np.random.RandomState(9).randn(2, 8, 4)
                 .astype(np.float32))


def test_keras_conv_lstm2d():
    jm, pm = pair(lambda K, d: [
        K.ConvLSTM2D(4, 3, input_shape=(5, 2, 6, 6), **d)], "convlstm")
    out = same_forward(jm, pm, np.random.RandomState(10).randn(2, 5, 2, 6, 6)
                       .astype(np.float32))
    assert out.shape == (2, 4, 6, 6)

    ms = pk.Sequential()
    ms.add(pk.ConvLSTM2D(4, 3, return_sequences=True,
                         input_shape=(5, 2, 6, 6), **CPU))
    with torch.no_grad():
        assert ms(torch.ones(1, 5, 2, 6, 6)).shape == (1, 5, 4, 6, 6)


def test_keras_conv_lstm2d_rejects_unsupported_config():
    for K, kw in ((pk, CPU), (jk, {})):
        with pytest.raises(ValueError, match="subsample"):
            K.ConvLSTM2D(4, 3, subsample=(2, 2), **kw)
        with pytest.raises(ValueError, match="activations are fixed"):
            K.ConvLSTM2D(4, 3, activation="relu", **kw)


def test_keras_softmax_layer_and_input_node():
    jm, pm = pair(lambda K, d: [K.SoftMax(input_shape=(5,), **d)], "softmax")
    out = same_forward(jm, pm, np.random.RandomState(11).randn(2, 5)
                       .astype(np.float32))
    np.testing.assert_allclose(out.sum(axis=1), [1.0, 1.0], rtol=1e-6)

    def functional(K, d):
        node = K.Input(shape=(4,), name="inp")
        dense = K.Dense(3, input_shape=(4,), **d)
        dense.build((4,))
        return K.Model(node, dense.layer.inputs(node))

    with numpy_weight_draws(seed_of("functional_input")):
        jfm = functional(jk, {})
    pfm = functional(pk, CPU)
    load_jax_params(pfm, _np_tree(jfm.params_dict()))
    x = np.random.RandomState(12).randn(2, 4).astype(np.float32)
    with torch.no_grad():
        got = pfm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got, np.asarray(jfm(jnp.asarray(x))), **TOL)


# -------------------------------------------------------- the port's own
def test_shape_inference_leaves_generators_and_modes_as_they_were():
    """``build`` runs the layer once (eval mode, no grad): the dropout's
    generator and the default streams do not move, BatchNorm's running
    statistics stay, and every module keeps the training flag it had."""
    from bigdl_tpu_torch import nn as tnn

    g = torch.Generator().manual_seed(7)
    m = pk.Sequential()
    m.add(pk.Dense(6, input_shape=(4,), **CPU))
    m.training_mode()
    cpu_before, g_before = torch.get_rng_state(), g.get_state()
    drop = pk.Dropout(0.5, **CPU)
    drop.build_module = lambda shape: tnn.Dropout(0.5, generator=g)
    m.add(drop)
    m.add(pk.GaussianNoise(0.3, **CPU))
    m.add(pk.BatchNormalization(**CPU))
    m.add(pk.Dense(2, **CPU))
    bn = m._layers[-2].layer
    # a train-mode forward would have moved the running statistics
    assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))
    assert torch.equal(torch.get_rng_state(), cpu_before)
    assert torch.equal(g.get_state(), g_before)
    assert len(list(m.modules())) > 6
    assert all(mod.training for mod in m.modules())


#: every public name of ``bigdl_tpu.keras`` and a way to build it in both
#: packages: (layers(K, kw), x) for a Sequential, or None for the classes
#: checked elsewhere in this file (named by the test).
SWEEP = {
    "Dense": (lambda K, d: [K.Dense(3, input_shape=(5,), **d)], (2, 5)),
    "Activation": (lambda K, d: [K.Activation("tanh", input_shape=(5,), **d)],
                   (2, 5)),
    "Dropout": (lambda K, d: [K.Dropout(0.3, input_shape=(5,), **d)], (2, 5)),
    "Flatten": (lambda K, d: [K.Flatten(input_shape=(2, 3), **d)], (2, 2, 3)),
    "Reshape": (lambda K, d: [K.Reshape((3, 2), input_shape=(6,), **d)],
                (2, 6)),
    "Permute": (lambda K, d: [K.Permute((2, 1), input_shape=(2, 3), **d)],
                (2, 2, 3)),
    "RepeatVector": (lambda K, d: [K.RepeatVector(3, input_shape=(4,), **d)],
                     (2, 4)),
    "Masking": (lambda K, d: [K.Masking(0.0, input_shape=(3, 4), **d)],
                (2, 3, 4)),
    "Highway": None, "MaxoutDense": None, "Convolution1D": None,
    "Convolution2D": (lambda K, d: [K.Convolution2D(
        3, 3, 3, subsample=(2, 2), input_shape=(2, 7, 7), **d)], (2, 2, 7, 7)),
    "SeparableConvolution2D": None, "Deconvolution2D": None,
    "AtrousConvolution2D": None,
    "LocallyConnected2D": (lambda K, d: [K.LocallyConnected2D(
        2, 3, 3, input_shape=(2, 5, 5), **d)], (2, 2, 5, 5)),
    "MaxPooling1D": (lambda K, d: [K.MaxPooling1D(2, input_shape=(6, 3),
                                                  **d)], (2, 6, 3)),
    "MaxPooling2D": (lambda K, d: [K.MaxPooling2D(
        (2, 2), border_mode="same", input_shape=(2, 5, 5), **d)],
        (2, 2, 5, 5)),
    "AveragePooling1D": (lambda K, d: [K.AveragePooling1D(
        2, input_shape=(6, 3), **d)], (2, 6, 3)),
    "AveragePooling2D": (lambda K, d: [K.AveragePooling2D(
        (2, 2), input_shape=(2, 6, 6), **d)], (2, 2, 6, 6)),
    "GlobalAveragePooling1D": (lambda K, d: [K.GlobalAveragePooling1D(
        input_shape=(6, 3), **d)], (2, 6, 3)),
    "GlobalAveragePooling2D": None, "GlobalMaxPooling1D": None,
    "GlobalMaxPooling2D": (lambda K, d: [K.GlobalMaxPooling2D(
        input_shape=(2, 4, 4), **d)], (2, 2, 4, 4)),
    "BatchNormalization": (lambda K, d: [K.BatchNormalization(
        input_shape=(5,), **d)], (3, 5)),
    "Embedding": None,
    "GaussianNoise": (lambda K, d: [K.GaussianNoise(0.2, input_shape=(5,),
                                                    **d)], (2, 5)),
    "GaussianDropout": (lambda K, d: [K.GaussianDropout(
        0.2, input_shape=(5,), **d)], (2, 5)),
    "SpatialDropout1D": (lambda K, d: [K.SpatialDropout1D(
        0.2, input_shape=(4, 5), **d)], (2, 4, 5)),
    "SpatialDropout2D": (lambda K, d: [K.SpatialDropout2D(
        0.2, input_shape=(2, 4, 4), **d)], (2, 2, 4, 4)),
    "LSTM": None,
    "GRU": (lambda K, d: [K.GRU(3, go_backwards=True, input_shape=(4, 2),
                                **d)], (2, 4, 2)),
    "SimpleRNN": (lambda K, d: [K.SimpleRNN(3, activation="relu",
                                            input_shape=(4, 2), **d)],
                  (2, 4, 2)),
    "Bidirectional": (lambda K, d: [K.Bidirectional(
        K.LSTM(3, **d), merge_mode="sum", input_shape=(4, 2), **d)],
        (2, 4, 2)),
    "TimeDistributed": None, "Merge": None,
    "ZeroPadding1D": (lambda K, d: [K.ZeroPadding1D(2, input_shape=(3, 4),
                                                    **d)], (2, 3, 4)),
    "ZeroPadding2D": None,
    "Cropping1D": (lambda K, d: [K.Cropping1D((1, 2), input_shape=(6, 3),
                                              **d)], (2, 6, 3)),
    "Cropping2D": None,
    "UpSampling1D": (lambda K, d: [K.UpSampling1D(2, input_shape=(3, 4),
                                                  **d)], (2, 3, 4)),
    "UpSampling2D": None, "LeakyReLU": None,
    "ELU": (lambda K, d: [K.ELU(0.5, input_shape=(5,), **d)], (2, 5)),
    "PReLU": (lambda K, d: [K.PReLU(input_shape=(2, 3, 3), **d)], (2, 2, 3, 3)),
    "SReLU": (lambda K, d: [K.SReLU(input_shape=(5,), **d)], (2, 5)),
    "ThresholdedReLU": None, "Convolution3D": None, "MaxPooling3D": None,
    "AveragePooling3D": None,
    "GlobalMaxPooling3D": (lambda K, d: [K.GlobalMaxPooling3D(
        input_shape=(2, 3, 3, 3), **d)], (2, 2, 3, 3, 3)),
    "GlobalAveragePooling3D": None, "Cropping3D": None, "ZeroPadding3D": None,
    "UpSampling3D": None, "SpatialDropout3D": None,
    "AtrousConvolution1D": None, "LocallyConnected1D": None,
    "ConvLSTM2D": None, "SoftMax": None,
    "InputLayer": (lambda K, d: [K.InputLayer(input_shape=(5,), **d),
                                 K.Dense(2, **d)], (2, 5)),
    "KerasLayer": None, "Sequential": None, "Model": None, "Input": None,
}


def test_sweep_covers_every_name_jax_keras_exports():
    jax_names = {n for n in dir(jk) if not n.startswith("_")
                 and n[0].isupper()}
    assert jax_names == set(SWEEP), (jax_names ^ set(SWEEP))
    missing = sorted(n for n in jax_names if not hasattr(pk, n))
    assert not missing, missing


@pytest.mark.parametrize("name", sorted(n for n, v in SWEEP.items() if v))
def test_sweep_layer_matches_jax(name):
    layers, shape = SWEEP[name]
    jm, pm = pair(layers, "sweep_" + name)
    assert pm.get_output_shape() == jm.get_output_shape()
    same_forward(jm, pm, np.random.RandomState(13).randn(*shape)
                 .astype(np.float32))


def test_keras_models_round_trip_through_save_module(tmp_path):
    jm, pm = pair(lambda K, d: [
        K.Convolution2D(4, 3, 3, activation="relu", input_shape=(1, 8, 8),
                        **d),
        K.MaxPooling2D((2, 2), **d), K.Flatten(**d),
        K.Dense(5, activation="softmax", **d)], "roundtrip_seq")
    x = torch.from_numpy(np.random.RandomState(14).randn(2, 1, 8, 8)
                         .astype(np.float32))
    path = str(tmp_path / "seq.bigdl")
    pm.save_module(path)
    back = Module.load_module(path, device="cpu")
    back.evaluate()
    with torch.no_grad():
        assert torch.equal(back(x), pm(x))
    assert back.get_output_shape() == (5,)
    assert isinstance(back, pk.Sequential) and len(back._layers) == 4

    node = pk.Input(shape=(6,))
    d1 = pk.Dense(4, activation="tanh", input_shape=(6,), **CPU)
    d1.build((6,))
    fm = pk.Model(node, d1.inputs(node))
    fm.evaluate()
    path = str(tmp_path / "func.bigdl")
    fm.save_module(path)
    back = Module.load_module(path, device="cpu")
    xf = torch.randn(3, 6)
    with torch.no_grad():
        assert torch.equal(back(xf), fm(xf))
