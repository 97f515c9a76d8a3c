"""The JAX layer sweep (tests/test_layer_sweep.py), run through the port.

For every ``FIXTURES`` tag of the JAX sweep whose layer class the port
exports, the same layer is built in both packages from the same
arguments (``PORT``), the JAX weights are carried across, and the same
numpy input goes through both in evaluation mode, as the JAX sweep runs
it: the forward, and the input and parameter gradients for one random
output cotangent (``jax.vjp`` against autograd), at rtol 1e-5 / atol
1e-6 in f32. A tag flagged "random" (stochastic in evaluation mode too)
compares the shapes and the gradients that do not depend on the draw.

``test_every_jax_layer_is_ported_or_waiting`` is the completeness check
(≙ the JAX sweep's ``:371-392``): every Module class the JAX ``nn``
exports is either exported by the port and covered by a swept fixture
(or an abstract base, or tested in its own file: ``ELSEWHERE``), or
listed in ``WAITING`` with the ROADMAP.md item that ports it. A stale
``WAITING`` entry (a class the port now exports, or one JAX no longer
exports) fails the test.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn.module import Module as JaxModule
from bigdl_tpu.nn.module import pure_apply
from bigdl_tpu.utils.table import Table as JaxTable
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.nn.module import activity_tensors, tree_leaves
from bigdl_tpu_torch.utils.table import Table
from bigdl_tpu_torch.utils.weights import load_jax_buffers, load_jax_params
from tests.jax_numpy_init import numpy_weight_draws, seed_of
from tests.test_layer_sweep import FIXTURES

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = dict(device="cpu")

# tag -> the port's layer, built from the JAX fixture's arguments
PORT = {
    "abs": lambda: tnn.Abs(),
    "addconstant": lambda: tnn.AddConstant(1.5),
    "binarythreshold": lambda: tnn.BinaryThreshold(0.1),
    "clamp": lambda: tnn.Clamp(-0.5, 0.5),
    "elu": lambda: tnn.ELU(0.9),
    "exp": lambda: tnn.Exp(),
    "hardshrink": lambda: tnn.HardShrink(0.3),
    "hardsigmoid": lambda: tnn.HardSigmoid(),
    "hardtanh": lambda: tnn.HardTanh(),
    "identity": lambda: tnn.Identity(),
    "leakyrelu": lambda: tnn.LeakyReLU(0.1),
    "log": lambda: tnn.Log(),
    "log1p": lambda: tnn.Log1p(),
    "logsigmoid": lambda: tnn.LogSigmoid(),
    "logsoftmax": lambda: tnn.LogSoftMax(),
    "mulconstant": lambda: tnn.MulConstant(2.0),
    "negative": lambda: tnn.Negative(),
    "power": lambda: tnn.Power(2.0, 1.5, 0.1),
    "relu": lambda: tnn.ReLU(),
    "relu6": lambda: tnn.ReLU6(),
    "sigmoid": lambda: tnn.Sigmoid(),
    "softmax": lambda: tnn.SoftMax(),
    "softmin": lambda: tnn.SoftMin(),
    "softplus": lambda: tnn.SoftPlus(),
    "softshrink": lambda: tnn.SoftShrink(),
    "softsign": lambda: tnn.SoftSign(),
    "sqrt": lambda: tnn.Sqrt(),
    "square": lambda: tnn.Square(),
    "tanh": lambda: tnn.Tanh(),
    "tanhshrink": lambda: tnn.TanhShrink(),
    "threshold": lambda: tnn.Threshold(0.2, -1.0),
    "dropout": lambda: tnn.Dropout(0.5),
    "gaussiandropout": lambda: tnn.GaussianDropout(0.3),
    "gaussiannoise": lambda: tnn.GaussianNoise(0.3),
    "rrelu": lambda: tnn.RReLU(),
    "spatialdropout1d": lambda: tnn.SpatialDropout1D(0.5),
    "spatialdropout2d": lambda: tnn.SpatialDropout2D(0.5),
    "spatialdropout3d": lambda: tnn.SpatialDropout3D(0.5),
    "linear": lambda: tnn.Linear(4, 3, **CPU),
    "maxout": lambda: tnn.Maxout(4, 6, 3, **CPU),
    "prelu": lambda: tnn.PReLU(**CPU),
    "srelu": lambda: tnn.SReLU((4,), **CPU),
    "batchnorm": lambda: tnn.BatchNormalization(5, **CPU),
    "layernorm": lambda: tnn.LayerNorm(6, **CPU),
    "normalize": lambda: tnn.Normalize(2.0),
    "normalizescale": lambda: tnn.NormalizeScale(2.0, size=(1, 4, 1, 1),
                                                 **CPU),
    "l1penalty": lambda: tnn.L1Penalty(0.01),
    "negentropy": lambda: tnn.NegativeEntropyPenalty(0.01),
    "gradientreversal": lambda: tnn.GradientReversal(0.5),
    "reshape": lambda: tnn.Reshape((8,)),
    "view": lambda: tnn.View(-1),
    "echo": lambda: tnn.Echo(),
    "caddtable": lambda: tnn.CAddTable(),
    "gaussiansampler": lambda: tnn.GaussianSampler(),
    "sequential": lambda: tnn.Sequential(tnn.Linear(5, 7, **CPU), tnn.ReLU(),
                                         tnn.Linear(7, 2, **CPU)),
    "concat": lambda: tnn.Concat(2, tnn.Linear(4, 3, **CPU),
                                 tnn.Linear(4, 5, **CPU)),
    "concattable": lambda: tnn.Sequential(
        tnn.ConcatTable(tnn.Linear(4, 4, **CPU), tnn.Identity()),
        tnn.CAddTable()),
    "conv2d": lambda: tnn.SpatialConvolution(2, 4, 3, 3, 1, 1, 1, 1, **CPU),
    "conv2d_share": lambda: tnn.SpatialShareConvolution(2, 3, 3, 3, **CPU),
    "conv2d_dilated": lambda: tnn.SpatialDilatedConvolution(
        2, 3, 3, 3, dilation_w=2, dilation_h=2, **CPU),
    "conv2d_full": lambda: tnn.SpatialFullConvolution(2, 3, 3, 3, **CPU),
    "conv2d_sep": lambda: tnn.SpatialSeparableConvolution(2, 4, 2, 3, 3,
                                                          **CPU),
    "conv1d_temporal": lambda: tnn.TemporalConvolution(5, 6, 3, **CPU),
    "conv3d": lambda: tnn.VolumetricConvolution(2, 3, 2, 3, 3, **CPU),
    "conv3d_full": lambda: tnn.VolumetricFullConvolution(2, 3, 2, 3, 3,
                                                         **CPU),
    "local1d": lambda: tnn.LocallyConnected1D(8, 5, 6, 3, **CPU),
    "local2d": lambda: tnn.LocallyConnected2D(2, 6, 6, 3, 3, 3, **CPU),
    "maxpool": lambda: tnn.SpatialMaxPooling(2, 2, 2, 2),
    "avgpool": lambda: tnn.SpatialAveragePooling(3, 3, 2, 2),
    "maxpool_idx_unpool": lambda: tnn.Sequential(
        tnn.SpatialMaxPoolingWithIndices(2, 2), tnn.SpatialUnpooling(2, 2)),
    "temporal_maxpool": lambda: tnn.TemporalMaxPooling(2),
    "volumetric_maxpool": lambda: tnn.VolumetricMaxPooling(2, 2, 2),
    "volumetric_avgpool": lambda: tnn.VolumetricAveragePooling(2, 2, 2),
    "sbn": lambda: tnn.SpatialBatchNormalization(3, **CPU),
    "vbn": lambda: tnn.VolumetricBatchNormalization(2, **CPU),
    "lrn_crossmap": lambda: tnn.SpatialCrossMapLRN(5, 1e-4, 0.75),
    "lrn_within": lambda: tnn.SpatialWithinChannelLRN(3),
    "contrastive_norm": lambda: tnn.SpatialContrastiveNormalization(2, **CPU),
    "divisive_norm": lambda: tnn.SpatialDivisiveNormalization(2, **CPU),
    "subtractive_norm": lambda: tnn.SpatialSubtractiveNormalization(2, **CPU),
    "mha": lambda: tnn.MultiHeadAttention(8, 2, **CPU),
    "transformer_block": lambda: tnn.TransformerBlock(8, 2, **CPU),
    # the table and shape layers
    "masking": lambda: tnn.Masking(0.0),
    "contiguous": lambda: tnn.Contiguous(),
    "inferreshape": lambda: tnn.InferReshape((-1, 2)),
    "squeeze": lambda: tnn.Squeeze(2),
    "unsqueeze": lambda: tnn.Unsqueeze(2),
    "transpose": lambda: tnn.Transpose(((2, 3),)),
    "tile": lambda: tnn.Tile(2, 3),
    "replicate": lambda: tnn.Replicate(3, 2),
    "select": lambda: tnn.Select(2, 1),
    "narrow": lambda: tnn.Narrow(2, 1, 2),
    "reverse": lambda: tnn.Reverse(2),
    "padding": lambda: tnn.Padding(2, 2, 2),
    "index": lambda: tnn.Index(1),
    "maskedselect": lambda: tnn.MaskedSelect(),
    "max": lambda: tnn.Max(2),
    "min": lambda: tnn.Min(2),
    "mean": lambda: tnn.Mean(2),
    "sum": lambda: tnn.Sum(2),
    "cavetable": lambda: tnn.CAveTable(),
    "cmaxtable": lambda: tnn.CMaxTable(),
    "cmintable": lambda: tnn.CMinTable(),
    "csubtable": lambda: tnn.CSubTable(),
    "cdivtable": lambda: tnn.CDivTable(),
    "cmultable": lambda: tnn.CMulTable(),
    "dotproduct": lambda: tnn.DotProduct(),
    "cosinedistance": lambda: tnn.CosineDistance(),
    "pairwisedistance": lambda: tnn.PairwiseDistance(),
    "crossproduct": lambda: tnn.CrossProduct(),
    "mm": lambda: tnn.MM(),
    "mv": lambda: tnn.MV(),
    "jointable": lambda: tnn.JoinTable(2),
    "splittable": lambda: tnn.SplitTable(2),
    "bifurcatesplit": lambda: tnn.BifurcateSplitTable(2),
    "narrowtable": lambda: tnn.NarrowTable(1, 2),
    "selecttable": lambda: tnn.SelectTable(2),
    "flattentable": lambda: tnn.FlattenTable(),
    "packtable": lambda: tnn.Pack(2),
    "mixturetable": lambda: tnn.MixtureTable(),
    "zeropad2d": lambda: tnn.SpatialZeroPadding(1),
    "crop2d": lambda: tnn.Cropping2D((1, 1), (1, 1)),
    "crop3d": lambda: tnn.Cropping3D(),
    "upsample1d": lambda: tnn.UpSampling1D(2),
    "upsample2d": lambda: tnn.UpSampling2D((2, 2)),
    "upsample3d": lambda: tnn.UpSampling3D(),
    "resize_bilinear": lambda: tnn.ResizeBilinear(6, 6),
    # linear.py's other layers
    "add": lambda: tnn.Add(4, **CPU),
    "cadd": lambda: tnn.CAdd((1, 4), **CPU),
    "cmul": lambda: tnn.CMul((1, 4), **CPU),
    "mul": lambda: tnn.Mul(**CPU),
    "bilinear": lambda: tnn.Bilinear(3, 4, 5, **CPU),
    "cosine": lambda: tnn.Cosine(4, 3, **CPU),
    "euclidean": lambda: tnn.Euclidean(4, 3, **CPU),
    "scale": lambda: tnn.Scale((1, 4), **CPU),
    # the container leftovers
    "paralleltable": lambda: tnn.ParallelTable(tnn.Linear(4, 3, **CPU),
                                               tnn.Linear(5, 3, **CPU)),
    "maptable": lambda: tnn.MapTable(tnn.Linear(4, 3, **CPU)),
    "bottle": lambda: tnn.Bottle(tnn.Linear(4, 3, **CPU)),
    "timedistributed": lambda: tnn.TimeDistributed(tnn.Linear(5, 3, **CPU)),
    # the embedding and the recurrent stack
    "lookup": lambda: tnn.LookupTable(10, 6, **CPU),
    "recurrent_rnn": lambda: tnn.Recurrent(tnn.RnnCell(5, 7, tnn.Tanh(),
                                                       **CPU)),
    "recurrent_lstm": lambda: tnn.Recurrent(tnn.LSTM(4, 6, **CPU)),
    "recurrent_lstmpeephole": lambda: tnn.Recurrent(
        tnn.LSTMPeephole(4, 6, **CPU)),
    "recurrent_gru": lambda: tnn.Recurrent(tnn.GRU(4, 6, **CPU)),
    "recurrent_convlstm": lambda: tnn.Recurrent(
        tnn.ConvLSTMPeephole(2, 3, **CPU)),
    "recurrent_convlstm3d": lambda: tnn.Recurrent(
        tnn.ConvLSTMPeephole3D(2, 3, **CPU)),
    "recurrent_multi": lambda: tnn.Recurrent(tnn.MultiRNNCell(
        [tnn.LSTM(4, 5, **CPU), tnn.LSTM(5, 6, **CPU)])),
    "birecurrent": lambda: tnn.BiRecurrent(cell=tnn.RnnCell(4, 4, tnn.Tanh(),
                                                            **CPU)),
    "recurrent_decoder": lambda: tnn.RecurrentDecoder(
        3, cell=tnn.RnnCell(4, 4, tnn.Tanh(), **CPU)),
}

# JAX layers the port exports that the sweep does not reach, and why
ELSEWHERE = {
    "Module": "abstract base",
    "Container": "abstract base",
    "DynamicContainer": "alias of Container (an abstract base)",
    "SpatialConvolutionMap": "connection-table input, "
                             "tests/test_torch_conv_pool_variants.py",
    "Cell": "abstract recurrent base",
    "RNN": "alias of RnnCell",
    "TreeLSTM": "abstract tree base",
    "BinaryTreeLSTM": "tree input, tests/test_torch_tree_lstm.py",
    "Graph": "node-wired, tests/test_torch_graph.py",
    "StaticGraph": "node-wired, tests/test_torch_graph.py",
    "DynamicGraph": "node-wired, tests/test_torch_graph.py",
    "SparseLinear": "sparse input, tests/test_torch_sparse.py",
    "SparseJoinTable": "sparse input, tests/test_torch_sparse.py",
    "LookupTableSparse": "sparse input, tests/test_torch_sparse.py",
    "DenseToSparse": "sparse output, tests/test_torch_sparse.py",
    "PriorBox": "detection head, tests/test_torch_detection.py",
    "Proposal": "detection head, tests/test_torch_detection.py",
    "RoiPooling": "detection head, tests/test_torch_detection.py",
    "DetectionOutputSSD": "detection head, tests/test_torch_detection.py",
    "DetectionOutputFrcnn": "detection head, tests/test_torch_detection.py",
    **dict.fromkeys(["If", "WhileLoop", "Variable", "Assign", "ParseExample"],
                    "TF infra op, tests/test_torch_tf_ops.py"),
}

# every JAX nn Module class the port does not export yet, by the item
# that ports it (none since the TF infra ops)
WAITING = {}


def _jax_exports():
    return {name for name in dir(jnn) if not name.startswith("_")
            and inspect.isclass(getattr(jnn, name))
            and issubclass(getattr(jnn, name), JaxModule)}


def _port_exports():
    return {name for name in tnn.__all__
            if inspect.isclass(getattr(tnn, name))
            and issubclass(getattr(tnn, name), torch.nn.Module)}


def _classes(m):
    """The class names of ``m`` and of every module under it (both
    packages' ``named_modules`` yield (name, module) pairs)."""
    return {type(m).__name__} | {type(s).__name__
                                 for _, s in m.named_modules()}


def _to_port(x):
    """A JAX input (array or Table) as the port's (tensor or Table)."""
    if isinstance(x, JaxTable):
        return Table(*[_to_port(v) for v in x.values()])
    return torch.tensor(np.asarray(x))


def _port_inputs(x):
    """The port's input with every float tensor a leaf that needs its
    gradient, and those leaves in order."""
    leaves = []

    def conv(v):
        if isinstance(v, Table):
            return Table(*[conv(u) for u in v.values()])
        if v.is_floating_point():
            v = v.clone().requires_grad_(True)
            leaves.append(v)
        return v

    return conv(_to_port(x)), leaves


_JAX_BUILT = {}


def _jax_fixture(tag):
    """The JAX fixture's module, built once per module run (its initial
    weights drawn by numpy, ``tests/jax_numpy_init.py``): the layer case
    and the coverage check share it."""
    if tag not in _JAX_BUILT:
        with numpy_weight_draws(seed_of(tag)):
            _JAX_BUILT[tag] = FIXTURES[tag][0]()
    return _JAX_BUILT[tag]


def _float_leaves(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)
            if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)]


@pytest.mark.parametrize("tag", sorted(PORT), ids=sorted(PORT))
def test_layer_matches_jax(tag):
    entry = FIXTURES[tag]
    flags = entry[2] if len(entry) > 2 else ""
    jm = _jax_fixture(tag)
    tm = PORT[tag]()
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    load_jax_buffers(tm, jax.tree.map(np.asarray, jm.buffers_dict()))
    jm.evaluate()
    tm.evaluate()
    x = entry[1]()

    fn = pure_apply(jm)
    buffers = jm.buffers_dict()
    j_out, vjp = jax.vjp(lambda p, xx: fn(p, buffers, xx,
                                          training=False)[0],
                         jm.params_dict(), x)
    # one cotangent per output tensor (a Table output has several)
    j_outs, j_tree = jax.tree.flatten(j_out)
    rs = np.random.RandomState(7)
    gs = [rs.randn(*o.shape).astype(np.float32) for o in j_outs]
    j_gp, j_gx = vjp(jax.tree.unflatten(
        j_tree, [jnp.asarray(g, o.dtype) for g, o in zip(gs, j_outs)]))

    xt, x_leaves = _port_inputs(x)
    params = [p for _, p in tree_leaves(tm.params_dict())]
    t_outs = activity_tensors(tm(xt))
    assert [tuple(o.shape) for o in t_outs] == \
        [tuple(o.shape) for o in j_outs], tag
    if any(o.requires_grad for o in t_outs):
        grads = torch.autograd.grad(
            t_outs, x_leaves + params,
            [torch.from_numpy(g).to(o.dtype) for g, o in zip(gs, t_outs)],
            allow_unused=True)
    else:
        grads = [None] * (len(x_leaves) + len(params))
    grads = [np.zeros(tuple(t.shape), np.float32) if d is None
             else d.numpy() for t, d in zip(x_leaves + params, grads)]
    t_gx, t_gp = grads[:len(x_leaves)], grads[len(x_leaves):]

    j_gx, j_gp = _float_leaves(j_gx), _float_leaves(j_gp)
    assert len(t_gx) == len(j_gx) and len(t_gp) == len(j_gp), tag
    if "random" in flags:
        # the sample depends on the draw; d out / d mean does not
        np.testing.assert_allclose(t_gx[0], j_gx[0], **TOL)
        return
    for ours, theirs in zip(t_outs, j_outs):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                                   **TOL, err_msg=f"{tag}: forward")
    for i, (ours, theirs) in enumerate(zip(t_gx, j_gx)):
        np.testing.assert_allclose(ours, theirs, **TOL,
                                   err_msg=f"{tag}: input grad {i}")
    names = [n for n, _ in tree_leaves(tm.params_dict())]
    for name, ours, theirs in zip(names, t_gp, j_gp):
        np.testing.assert_allclose(ours, theirs, **TOL,
                                   err_msg=f"{tag}: grad of {name}")


def test_port_fixtures_cover_every_exported_tag():
    """``PORT`` holds exactly the JAX fixtures whose layers the port
    exports: a fixture of the sweep whose classes all exist in the port
    must be swept here."""
    ported = _port_exports()
    want = {tag for tag in FIXTURES
            if _classes(_jax_fixture(tag)) <= ported}
    assert set(PORT) == want, (sorted(want - set(PORT)),
                               sorted(set(PORT) - want))


def test_every_jax_layer_is_ported_or_waiting():
    jax_classes = _jax_exports()
    ported = _port_exports()
    swept = set()
    for tag in PORT:
        swept |= _classes(PORT[tag]())
    for name in sorted(jax_classes):
        if name in ported:
            assert name in swept or name in ELSEWHERE, \
                f"{name} is ported but no sweep fixture reaches it"
            assert name not in WAITING, f"stale WAITING entry {name}"
        else:
            assert name in WAITING, (
                f"JAX layer {name} is neither ported nor listed in "
                f"WAITING with its ROADMAP item")
    stale = sorted(set(WAITING) - jax_classes)
    assert not stale, f"WAITING entries JAX no longer exports: {stale}"
    for name, item in WAITING.items():
        assert item.startswith("ROADMAP.md Queue 1 item "), (name, item)


# ------------------------------------------------- beyond the sweep's args
def _jax_forward_vjp(jm, x, g, training):
    fn = pure_apply(jm)
    out, vjp = jax.vjp(lambda p, xx: fn(p, jm.buffers_dict(), xx,
                                        training=training)[0],
                       jm.params_dict(), jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(g))[1])


@pytest.mark.parametrize("size", [4, 5])
@pytest.mark.parametrize("kind", ["crossmap", "within"])
def test_lrn_window_matches_jax_for_even_and_odd_sizes(kind, size):
    """The JAX LRNs pad (size-1)//2 before and the rest after; an even
    size puts the window one channel (or pixel) off F.local_response_norm's
    centring, which this case would catch."""
    if kind == "crossmap":
        jm, tm = (jnn.SpatialCrossMapLRN(size, 0.5, 0.75, 2.0),
                  tnn.SpatialCrossMapLRN(size, 0.5, 0.75, 2.0))
    else:
        jm, tm = (jnn.SpatialWithinChannelLRN(size, 0.5, 0.75),
                  tnn.SpatialWithinChannelLRN(size, 0.5, 0.75))
    rs = np.random.RandomState(size)
    x = rs.randn(2, 7, 6, 5).astype(np.float32)
    g = rs.randn(2, 7, 6, 5).astype(np.float32)
    j_out, j_gx = _jax_forward_vjp(jm, x, g, training=False)
    xt = torch.tensor(x, requires_grad=True)
    out = tm(xt)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), j_out, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), j_gx, **TOL)
    # unbatched (C, H, W) input is the batched result's first image
    np.testing.assert_allclose(tm(torch.tensor(x[0])).numpy(), j_out[0],
                               **TOL)


def test_training_mode_noise_layers_at_zero_rate_match_jax():
    """Training mode at p = 0 / stddev 0, where the draws cancel; and the
    unscaled Dropout keeps each element as it was or zeroes it."""
    x = np.random.RandomState(1).randn(4, 6).astype(np.float32)
    pairs = [(jnn.Dropout(0.0, scale=False), tnn.Dropout(0.0, scale=False)),
             (jnn.GaussianNoise(0.0), tnn.GaussianNoise(0.0)),
             (jnn.GaussianDropout(0.0), tnn.GaussianDropout(0.0)),
             (jnn.SpatialDropout2D(0.0), tnn.SpatialDropout2D(0.0))]
    for jm, tm in pairs:
        jm.training_mode()
        tm.training_mode()
        np.testing.assert_allclose(tm(torch.tensor(x)).numpy(),
                                   np.asarray(jm(jnp.asarray(x))), **TOL)
    d = tnn.Dropout(0.5, inplace=True, scale=False,
                    generator=torch.Generator().manual_seed(0))
    out = d(torch.tensor(x)).numpy()
    kept = out != 0
    assert 0 < kept.sum() < x.size
    np.testing.assert_array_equal(out[kept], x[kept])


def test_bind_generator_reaches_every_random_layer():
    layers = [tnn.Dropout(0.5), tnn.SpatialDropout1D(0.5),
              tnn.SpatialDropout2D(0.5), tnn.SpatialDropout3D(0.5),
              tnn.GaussianDropout(0.3), tnn.GaussianNoise(0.3),
              tnn.GaussianSampler(), tnn.RReLU()]
    model = tnn.Sequential(*layers)
    gen = torch.Generator()
    tnn.bind_generator(model, gen)
    assert all(m.generator is gen for m in layers)
    # the same generator state draws the same RReLU slopes
    x = -torch.ones(3, 5)
    outs = []
    for _ in range(2):
        gen.manual_seed(11)
        outs.append(layers[-1](x))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    slopes = -outs[0]
    assert ((slopes >= 1 / 8) & (slopes <= 1 / 3)).all()
    assert slopes.unique().numel() > 1


def test_sync_bn_axis_waits_for_the_distributed_slice(tmp_path):
    """Sync-BN (``global_stats_axis``), ported with the distributed slice:
    a SpatialBatchNormalization over a 2-rank gloo world normalizes each
    rank's images by the statistics of both ranks' batch, and its output,
    input gradient and running statistics equal the JAX layer's under
    ``shard_map`` over 2 devices."""
    from jax.sharding import Mesh, PartitionSpec as P

    import torch_jobs_parallel as jobs
    from torch_world import World

    rs = np.random.RandomState(8)
    x = (rs.randn(4, 3, 5, 5) * 2 + 1).astype(np.float32)
    w_out = rs.randn(4, 3, 5, 5).astype(np.float32)
    weight = rs.rand(3).astype(np.float32) + 0.5
    bias = rs.randn(3).astype(np.float32)
    jbn = jnn.SpatialBatchNormalization(3, global_stats_axis="data")
    apply_fn = pure_apply(jbn)
    params = {"~params": {"weight": jnp.asarray(weight),
                          "bias": jnp.asarray(bias)}}
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))

    def loss(xx):
        def body(xx, ww):
            out, nb = apply_fn(params, jbn.buffers_dict(), xx, rng=None,
                               training=True)
            return jnp.sum(out * ww)[None], out, nb
        s, out, nb = jax.shard_map(
            body, mesh=mesh, in_specs=(P("data"), P("data")),
            out_specs=(P("data"), P("data"), P()), check_vma=False)(
                xx, jnp.asarray(w_out))
        return jnp.sum(s), (out, nb)

    # the ranks boot while the JAX side computes
    world = World(2, tmp_path)
    try:
        (_, (out, nb)), dx = jax.value_and_grad(loss, has_aux=True)(
            jnp.asarray(x))
        got = world.run(jobs.sync_bn_forward_and_grad, x, w_out, weight,
                        bias)
    finally:
        world.close()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([g["out"] for g in got]),
                               np.asarray(out), **tol)
    np.testing.assert_allclose(np.concatenate([g["dx"] for g in got]),
                               np.asarray(dx), **tol)
    for g in got:
        np.testing.assert_allclose(
            g["running_var"], np.asarray(nb["~buffers"]["running_var"]),
            **tol)


def test_penalty_layers_record_the_jax_loss():
    x = np.abs(np.random.RandomState(2).randn(3, 4)).astype(np.float32) + .1
    for jm, tm in ((jnn.L1Penalty(0.01, size_average=True),
                    tnn.L1Penalty(0.01, size_average=True)),
                   (jnn.NegativeEntropyPenalty(0.02),
                    tnn.NegativeEntropyPenalty(0.02))):
        jm.forward(jnp.asarray(x))
        tm(torch.tensor(x))
        np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-6)
    # provide_output=False propagates the penalty term alone
    jm = jnn.L1Penalty(0.5, provide_output=False)
    tm = tnn.L1Penalty(0.5, provide_output=False)
    g = np.ones_like(x)
    _, j_gx = _jax_forward_vjp(jm, x, g, training=True)
    xt = torch.tensor(x, requires_grad=True)
    tm(xt).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), j_gx, **TOL)


def test_init_methods_match_jax():
    from bigdl_tpu.nn import init as jinit
    from bigdl_tpu_torch.nn import init as tinit
    from bigdl_tpu_torch.utils.random import RandomGenerator

    rng = RandomGenerator(0)
    shape = (3, 2, 4, 5)
    for jm, tm in ((jinit.Zeros(), tinit.Zeros()),
                   (jinit.Ones(), tinit.Ones()),
                   (jinit.ConstInitMethod(0.3), tinit.ConstInitMethod(0.3)),
                   (jinit.BilinearFiller(), tinit.BilinearFiller())):
        np.testing.assert_array_equal(tm(shape, rng).numpy(),
                                      np.asarray(jm(shape)))
        assert isinstance(tm, tinit.InitializationMethod)
    # RandomUniform: Torch's default range U(-1/sqrt(fan_in), ..) and an
    # explicit one (draws differ from JAX's: threefry is not Philox)
    w = tinit.RandomUniform()((400, 25), rng, fan_in=25)
    assert w.abs().max() <= 0.2 and w.abs().max() > 0.19
    w = tinit.RandomUniform(-3.0, -2.0)((1000,), rng)
    assert w.min() >= -3.0 and w.max() <= -2.0 and abs(w.mean() + 2.5) < .05
