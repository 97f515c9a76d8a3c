"""The structured serializer (bigdl_tpu_torch/utils/serializer) against
the JAX package's (tests/test_serializer.py, run through the port).

Each case of the JAX sweep is built in both packages from the same
arguments and checked three ways: (a) the archive the JAX package writes
loads in the port, on the CPU, and gives the JAX model's output on the
same numpy input (within 1e-6 of the largest |value|, f32); (b) the
port's own round trip gives the port's output exactly (``torch.equal``);
(c) the port's ``module.json`` equals the JAX package's for the same
model, once the JAX record's positional arguments are bound to JAX's
parameter names, the class paths are mapped to the port's and each
tensor key is replaced by its shape and dtype. The port writes some
plain attributes JAX does not have (``PORT_ONLY_EXTRAS``); nothing else
may differ.

Then the JAX file's other cases (LeNet's graph, ResNet-20, name and
freeze, pickle against structured, the recurrent model), the flagship's
shape at small widths in f32 and bf16, and the hazards: bf16 as the
``|V2`` payload both ways, JAX's positional order, shared modules,
regularizer and init objects, a train step after a load, ``device`` and
generators kept out of the records, and arguments that cannot be
encoded.
"""

import inspect
import io
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import models as jmodels
from bigdl_tpu import nn as jnn
from bigdl_tpu.nn.module import jit_inference_fn
from bigdl_tpu.utils import serializer as jser
from bigdl_tpu.utils.table import Table as JaxTable
from bigdl_tpu_torch import models as tmodels
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.nn.module import Module, tree_leaves
from bigdl_tpu_torch.utils import serializer as tser
from bigdl_tpu_torch.utils.serializer.serializer import (JAX_POSITIONAL,
                                                         takes_device)
from bigdl_tpu_torch.utils.table import Table
from tests.jax_numpy_init import numpy_weight_draws, seed_of

REL = 1e-6

# plain attributes the port's layers hold and JAX's do not, by class
PORT_ONLY_EXTRAS = {
    "Dropout": {"generator"},
    "RnnCell": {"generator"},
    "LSTM": {"generator"},
    "GRU": {"generator"},
    "SpatialDilatedConvolution": {"dilation"},
}


def mk(cls, *args, **kwargs):
    """``cls(*args, **kwargs)``, on the CPU where a port class takes
    ``device=``."""
    if cls.__module__.startswith("bigdl_tpu_torch.") and takes_device(cls):
        kwargs["device"] = "cpu"
    return cls(*args, **kwargs)


# (tag, factory over either package's nn, input shape): tests/test_serializer.py
SWEEP = [
    ("linear", lambda nn: mk(nn.Linear, 6, 4), (3, 6)),
    ("linear_nobias", lambda nn: mk(nn.Linear, 6, 4, with_bias=False),
     (3, 6)),
    ("bilinear", lambda nn: mk(nn.Bilinear, 3, 4, 5), [(2, 3), (2, 4)]),
    ("conv", lambda nn: mk(nn.SpatialConvolution, 2, 4, 3, 3, 1, 1, 1, 1),
     (2, 2, 8, 8)),
    ("conv_group", lambda nn: mk(nn.SpatialConvolution, 4, 4, 3, 3,
                                 n_group=2), (2, 4, 8, 8)),
    ("dilated", lambda nn: mk(nn.SpatialDilatedConvolution, 2, 3, 3, 3,
                              dilation_w=2, dilation_h=2), (1, 2, 10, 10)),
    ("maxpool", lambda nn: mk(nn.SpatialMaxPooling, 2, 2, 2, 2).ceil(),
     (2, 3, 7, 7)),
    ("avgpool", lambda nn: mk(nn.SpatialAveragePooling, 3, 3, 2, 2),
     (2, 3, 9, 9)),
    ("bn", lambda nn: mk(nn.BatchNormalization, 5), (4, 5)),
    ("sbn", lambda nn: mk(nn.SpatialBatchNormalization, 3), (2, 3, 4, 4)),
    ("lrn", lambda nn: mk(nn.SpatialCrossMapLRN, 5, 0.0001, 0.75),
     (2, 6, 5, 5)),
    ("relu", lambda nn: mk(nn.ReLU), (3, 4)),
    ("prelu", lambda nn: mk(nn.PReLU, 4), (2, 4)),
    ("tanh", lambda nn: mk(nn.Tanh), (3, 4)),
    ("logsoftmax", lambda nn: mk(nn.LogSoftMax), (3, 4)),
    ("dropout_eval", lambda nn: mk(nn.Dropout, 0.5), (3, 4)),
    ("lookup", lambda nn: mk(nn.LookupTable, 10, 6), None),
    ("reshape", lambda nn: mk(nn.Reshape, (8,)), (3, 2, 4)),
    ("view", lambda nn: mk(nn.View, -1), (3, 2, 4)),
    ("seq", lambda nn: mk(nn.Sequential, mk(nn.Linear, 5, 7), mk(nn.ReLU),
                          mk(nn.Linear, 7, 2)), (3, 5)),
    ("concat", lambda nn: mk(nn.Concat, 2).add(mk(nn.Linear, 4, 3)).add(
        mk(nn.Linear, 4, 5)), (2, 4)),
    ("caddtable", lambda nn: mk(
        nn.Sequential, mk(nn.ConcatTable).add(mk(nn.Linear, 4, 4)).add(
            mk(nn.Identity)), mk(nn.CAddTable)), (2, 4)),
    ("recurrent", lambda nn: mk(nn.Recurrent).add(
        mk(nn.RnnCell, 5, 7, mk(nn.Tanh))), (2, 6, 5)),
    ("lstm", lambda nn: mk(nn.Recurrent).add(mk(nn.LSTM, 4, 6)), (2, 5, 4)),
    ("gru", lambda nn: mk(nn.Recurrent).add(mk(nn.GRU, 4, 6)), (2, 5, 4)),
    ("birecurrent", lambda nn: mk(
        nn.BiRecurrent, cell=mk(nn.RnnCell, 4, 4, mk(nn.Tanh))), (2, 5, 4)),
    ("timedist", lambda nn: mk(nn.TimeDistributed, mk(nn.Linear, 5, 3)),
     (2, 4, 5)),
    ("embedding_seq", lambda nn: mk(
        nn.Sequential, mk(nn.LookupTable, 20, 8),
        mk(nn.TimeDistributed, mk(nn.Linear, 8, 4))), None),
    ("norm", lambda nn: mk(nn.Normalize, 2.0), (3, 6)),
    ("maxout", lambda nn: mk(nn.Maxout, 4, 6, 3), (2, 4)),
]
IDS = [s[0] for s in SWEEP]


def _input(shape):
    rng = np.random.RandomState(0)
    if shape is None:
        return rng.randint(1, 10, size=(3, 6)).astype(np.int32)
    if isinstance(shape, list):
        return [rng.randn(*s).astype(np.float32) for s in shape]
    return rng.randn(*shape).astype(np.float32)


def _jax_in(x):
    if isinstance(x, list):
        return JaxTable(*[jnp.asarray(v) for v in x])
    return jnp.asarray(x)


def _port_in(x):
    if isinstance(x, list):
        return Table(*[torch.from_numpy(v) for v in x])
    return torch.from_numpy(x).long() if x.dtype == np.int32 \
        else torch.from_numpy(x)


def _arrays(out):
    if isinstance(out, (list, tuple)) or type(out).__name__ == "Table":
        return [a for o in out for a in _arrays(o)]
    if torch.is_tensor(out):
        return [out.detach().float().numpy()]
    return [np.asarray(out)]


def _host(v):
    return v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)


def _close(got, want, rel=REL):
    for g, w in zip(_arrays(got), _arrays(want), strict=True):
        assert g.shape == w.shape
        np.testing.assert_allclose(
            g, w, rtol=rel, atol=rel * max(float(np.abs(w).max()), 1e-30))


def _equal(a, b):
    for x, y in zip(_arrays(a), _arrays(b), strict=True):
        assert np.array_equal(x, y, equal_nan=True)


def _spec(path):
    with zipfile.ZipFile(path) as z:
        spec = json.loads(z.read("module.json"))
        with np.load(io.BytesIO(z.read("tensors.npz"))) as npz:
            tensors = {k: npz[k] for k in npz.files}
    return spec, tensors


def _jax_forward(m, x):
    """The JAX model's evaluation-mode output, jitted whole (one
    compile, where eager JAX compiles op by op)."""
    return jit_inference_fn(m)(m.params_dict(), m.buffers_dict(),
                               _jax_in(x))


@pytest.fixture(scope="module")
def jax_cases(tmp_path_factory):
    """tag -> (JAX archive path, JAX output, input), built once."""
    root = tmp_path_factory.mktemp("jax_archives")
    cache = {}

    def get(tag):
        if tag not in cache:
            factory, shape = {t: (f, s) for t, f, s in SWEEP}[tag]
            with numpy_weight_draws(seed_of(tag)):
                m = factory(jnn)
            m.evaluate()
            x = _input(shape)
            want = _jax_forward(m, x)
            path = str(root / f"{tag}.bigdl")
            jser.save_module(m, path)
            cache[tag] = (path, want, x)
        return cache[tag]
    return get


@pytest.mark.parametrize("tag", IDS)
def test_jax_archive_loads_in_the_port(tag, jax_cases):
    path, want, x = jax_cases(tag)
    port = tser.load_module(path, device="cpu")
    port.evaluate()
    with torch.no_grad():
        got = port(_port_in(x))
    _close(got, want)


@pytest.mark.parametrize("tag,factory,shape", SWEEP, ids=IDS)
def test_port_round_trip_is_exact(tag, factory, shape, tmp_path):
    m = factory(tnn)
    m.evaluate()
    x = _port_in(_input(shape))
    with torch.no_grad():
        want = m(x)
    path = str(tmp_path / f"{tag}.bigdl")
    m.save_module(path)
    back = Module.load_module(path, device="cpu")
    back.evaluate()
    assert type(back) is type(m)
    with torch.no_grad():
        _equal(back(x), want)
    for (n, a), (_, b) in zip(back.named_parameters(), m.named_parameters(),
                              strict=True):
        assert isinstance(a, torch.nn.Parameter) and a.requires_grad, n
        assert torch.equal(a, b) and a.dtype == b.dtype, n
    for (n, a), (_, b) in zip(back.named_buffers(), m.named_buffers(),
                              strict=True):
        assert torch.equal(a, b) and a.dtype == b.dtype, n


def _jax_class(path):
    import importlib

    mod, _, name = path.rpartition(".")
    return getattr(importlib.import_module(mod), name)


def _bind_jax(path, args, kwargs):
    """A JAX record's ``init`` with its positional arguments bound to
    JAX's parameter names (a ``*args`` parameter's values stay)."""
    params = list(inspect.signature(_jax_class(path).__init__)
                  .parameters.values())[1:]
    names = [p.name for p in params if p.kind == p.POSITIONAL_OR_KEYWORD]
    if not args or len(args) > len(names):
        return args, kwargs
    return [], {**dict(zip(names, args)), **kwargs}


def _normal(enc, tensors, jax_side):
    """An encoded value with tensor keys as (shape, dtype), class paths
    in the port's package and, on the JAX side, objects' arguments
    bound to names."""
    if isinstance(enc, list):
        return [_normal(e, tensors, jax_side) for e in enc]
    if not isinstance(enc, dict):
        return enc
    if enc.get("t") == "tensor":
        arr = tensors[enc["key"]]
        return {"t": "tensor", "shape": list(arr.shape), "dtype": arr.dtype.str}
    out = {k: _normal(v, tensors, jax_side) for k, v in enc.items()}
    if enc.get("t") == "obj":
        out["class"] = enc["class"].replace("bigdl_tpu.", "bigdl_tpu_torch.", 1)
        if jax_side:
            a, kw = _bind_jax(enc["class"], out["args"], out["kwargs"])
            out["args"], out["kwargs"] = a, kw
    return out


def _records(path, jax_side):
    spec, tensors = _spec(path)
    recs = {}
    for mid, rec in spec["records"].items():
        r = {k: _normal(v, tensors, jax_side) for k, v in rec.items()}
        for key in ("params", "buffers"):
            r[key] = {k: [list(tensors[v].shape), tensors[v].dtype.str]
                      for k, v in rec[key].items()}
        r["class"] = rec["class"].replace("bigdl_tpu.", "bigdl_tpu_torch.", 1)
        if jax_side and "init" in r:
            r["init"]["args"], r["init"]["kwargs"] = _bind_jax(
                rec["class"], r["init"]["args"], r["init"]["kwargs"])
        recs[mid] = r
    return spec["root"], recs


@pytest.mark.parametrize("tag,factory,shape", SWEEP, ids=IDS)
def test_port_records_equal_jax_records(tag, factory, shape, jax_cases,
                                        tmp_path):
    jpath = jax_cases(tag)[0]
    tpath = str(tmp_path / f"{tag}.bigdl")
    tser.save_module(factory(tnn), tpath)
    jroot, jrecs = _records(jpath, jax_side=True)
    troot, trecs = _records(tpath, jax_side=False)
    assert jroot == troot and set(jrecs) == set(trecs)
    for mid, jr in jrecs.items():
        tr = dict(trecs[mid])
        cls = tr["class"].rpartition(".")[2]
        textra, jextra = tr.pop("extra", {}), jr.get("extra", {})
        assert set(textra) - set(jextra) == PORT_ONLY_EXTRAS.get(cls, set()), \
            (mid, cls)
        assert {k: textra[k] for k in jextra} == jextra, (mid, cls)
        assert tr == {k: v for k, v in jr.items() if k != "extra"}, (mid, cls)


def test_roundtrip_graph_lenet(tmp_path):
    with numpy_weight_draws(seed_of("lenet_graph")):
        jm = jmodels.LeNet5.graph(10)
    jm.evaluate()
    x = np.random.RandomState(1).randn(2, 28, 28).astype(np.float32)
    want = _jax_forward(jm, x)
    jpath = str(tmp_path / "lenet_graph.j")
    jser.save_module(jm, jpath)
    port = tser.load_module(jpath, device="cpu")
    port.evaluate()
    assert isinstance(port, tnn.Graph)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), want, rel=1e-5)
    tm = tmodels.LeNet5.graph(10, device="cpu")
    tm.evaluate()
    tpath = str(tmp_path / "lenet_graph.t")
    tm.save_module(tpath)
    back = Module.load_module(tpath, device="cpu")
    back.evaluate()
    assert [type(n.module) for n in back._topo] == \
        [type(n.module) for n in tm._topo]
    assert [[tm._topo.index(p) for p in n.prev] for n in tm._topo] == \
        [[back._topo.index(p) for p in n.prev] for n in back._topo]
    with torch.no_grad():
        _equal(back(torch.from_numpy(x)), tm(torch.from_numpy(x)))


def test_roundtrip_resnet_cifar(tmp_path):
    with numpy_weight_draws(seed_of("resnet20")):
        jm = jmodels.ResNet(10, {"depth": 20,
                                 "dataSet": jmodels.DatasetType.CIFAR10})
    jm.evaluate()
    x = np.random.RandomState(2).randn(2, 3, 32, 32).astype(np.float32)
    want = _jax_forward(jm, x)
    jpath = str(tmp_path / "resnet20.j")
    jser.save_module(jm, jpath)
    port = tser.load_module(jpath, device="cpu")
    port.evaluate()
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), want, rel=1e-4)
    tm = tmodels.ResNet(10, {"depth": 20, "dataSet": "CIFAR10"},
                        device="cpu")
    tm.evaluate()
    tpath = str(tmp_path / "resnet20.t")
    tm.save_module(tpath)
    back = Module.load_module(tpath, device="cpu")
    back.evaluate()
    with torch.no_grad():
        _equal(back(torch.from_numpy(x)), tm(torch.from_numpy(x)))
    for (n, a), (_, b) in zip(back.named_buffers(), tm.named_buffers(),
                              strict=True):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("side", ["jax", "port"])
def test_roundtrip_preserves_name_and_freeze(side, tmp_path):
    nn, save = (jnn, jser.save_module) if side == "jax" \
        else (tnn, tser.save_module)
    m = mk(nn.Sequential, mk(nn.Linear, 3, 3).set_name("proj"), mk(nn.ReLU))
    m[0].freeze()
    p = str(tmp_path / "m.bigdl")
    save(m, p)
    loaded = tser.load_module(p, device="cpu")
    assert loaded[0].get_name() == "proj"
    assert loaded[0]._frozen and not loaded[1]._frozen
    assert loaded.trainable_dict() == {"m0": {"~params": {
        "weight": False, "bias": False}}}


def test_pickle_save_load_agree_with_structured(tmp_path):
    m = tmodels.LeNet5(10, device="cpu")
    m.evaluate()
    x = torch.from_numpy(
        np.random.RandomState(3).randn(2, 28, 28).astype(np.float32))
    with torch.no_grad():
        want = m(x)
    p1, p2 = str(tmp_path / "a.pkl"), str(tmp_path / "a.bigdl")
    m.save(p1)
    m.save_module(p2)
    for loaded in (Module.load(p1, device="cpu"),
                   Module.load_module(p2, device="cpu")):
        loaded.evaluate()
        with torch.no_grad():
            assert torch.equal(loaded(x), want)


def test_pickle_roundtrip_recurrent_model(tmp_path):
    from bigdl_tpu_torch.utils import file as bf

    m = tnn.Sequential(tnn.Recurrent().add(tnn.LSTM(3, 4, device="cpu")),
                       tnn.Select(2, -1), tnn.Linear(4, 2, device="cpu"))
    x = torch.from_numpy(
        np.random.RandomState(0).randn(2, 5, 3).astype(np.float32))
    with torch.no_grad():
        want = m.forward(x)
    for i, (save, load) in enumerate([
            (bf.save_module, lambda p: bf.load_module(p, device="cpu")),
            (tser.save_module, lambda p: tser.load_module(p, device="cpu"))]):
        p = str(tmp_path / f"rnn{i}.bigdl")
        save(m, p)
        loaded = load(p)
        with torch.no_grad():
            assert torch.equal(loaded.forward(x), want)
        loaded.reset()  # init thunks survive the round trip


# ------------------------------------------------------ the flagship shape
CFG = dict(vocab_size=64, embed_dim=32, num_heads=4, num_layers=2,
           max_len=64, num_kv_heads=2, use_flash=True, use_rope=True)


def _cast_jax(m, dtype):
    for sub in [m] + [s for _, s in m.named_modules()]:
        for k, v in list(sub._parameters.items()):
            sub._set_param(k, v.astype(dtype))


def test_flagship_f32_jax_archive_and_round_trip(tmp_path):
    from bigdl_tpu.models import transformer as jtr

    with numpy_weight_draws(11):
        jm = jtr.TransformerLM(**CFG)
    jm.evaluate()
    ids = np.random.RandomState(0).randint(0, 64, (2, 24)).astype(np.int32)
    want = np.asarray(_jax_forward(jm, ids))
    jpath = str(tmp_path / "lm.j")
    jser.save_module(jm, jpath)
    port = Module.load_module(jpath, device="cpu")
    port.evaluate()
    blocks = port.blocks()
    assert [b.attn.use_flash for b in blocks] == [True, True]
    assert port.use_rope and blocks[0].attn.num_kv_heads == 2
    assert blocks[0].attn.causal
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    tpath = str(tmp_path / "lm.t")
    port.save_module(tpath)
    back = Module.load_module(tpath, device="cpu")
    back.evaluate()
    with torch.no_grad():
        assert torch.equal(back(torch.from_numpy(ids)),
                           torch.from_numpy(got))


def test_flagship_bf16_jax_archive_bits_and_round_trip(tmp_path):
    """A bf16 archive of the JAX package (its ml_dtypes arrays are saved
    as ``|V2``, which JAX's own loader cannot read back) loads in the
    port with every weight equal to JAX's bits; the port writes the same
    payload and reads its own archive back exactly."""
    from bigdl_tpu.models import transformer as jtr

    with numpy_weight_draws(12):
        jm = jtr.TransformerLM(**CFG)
    _cast_jax(jm, jnp.bfloat16)
    jpath = str(tmp_path / "lm16.j")
    jser.save_module(jm, jpath)
    with pytest.raises(TypeError, match="V2"):
        jser.load_module(jpath)          # the JAX package's own fault
    _, jt = _spec(jpath)
    assert {a.dtype.str for a in jt.values()} == {"|V2"}
    port = Module.load_module(jpath, device="cpu")
    jleaves = jax.tree.leaves(jm.params_dict())
    tleaves = [v for _, v in tree_leaves(port.params_dict())]
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        assert t.dtype == torch.bfloat16
        assert np.array_equal(np.asarray(j).view(np.uint16),
                              t.view(torch.int16).numpy().view(np.uint16))
    ref = tmodels.TransformerLM(**CFG, device="cpu", dtype=torch.bfloat16)
    with torch.no_grad():
        for r, j in zip([v for _, v in tree_leaves(ref.params_dict())],
                        jleaves, strict=True):
            r.copy_(torch.from_numpy(np.asarray(j).view(np.int16).copy())
                    .view(torch.bfloat16))
    port.evaluate()
    ref.evaluate()
    ids = torch.from_numpy(
        np.random.RandomState(1).randint(0, 64, (2, 16)).astype(np.int64))
    with torch.no_grad():
        want = ref(ids)
        assert torch.equal(port(ids), want)
    tpath = str(tmp_path / "lm16.t")
    port.save_module(tpath)
    _, tt = _spec(tpath)
    assert sorted(a.tobytes() for a in tt.values()) == \
        sorted(a.tobytes() for a in jt.values())
    back = Module.load_module(tpath, device="cpu")
    back.evaluate()
    with torch.no_grad():
        assert torch.equal(back(ids), want)


def test_bf16_payload_equals_ml_dtypes_and_reads_back_bit_for_bit():
    from bigdl_tpu_torch.utils.serializer.serializer import (from_numpy,
                                                             to_numpy,
                                                             write_npz)

    bits = np.array([0x0000, 0x8000, 0x3F80, 0xBF80, 0x7F80, 0xFF80, 0x7FC1,
                     0x0001, 0x8001, 0x7F7F, 0x4049], np.uint16)
    t = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    arr = to_numpy(t.reshape(11, 1))
    assert arr.dtype.str == "|V2" and arr.shape == (11, 1)
    ml = np.asarray(jnp.asarray(bits.view(jnp.bfloat16)))
    assert arr.tobytes() == ml.tobytes()
    buf_port, buf_jax = io.BytesIO(), io.BytesIO()
    write_npz(buf_port, {"t0": arr.reshape(-1)})
    np.savez(buf_jax, t0=ml)
    members = []
    for buf in (buf_port, buf_jax):
        with zipfile.ZipFile(buf) as z:
            members.append(z.read("t0.npy"))
    assert members[0] == members[1]
    back = from_numpy(np.load(io.BytesIO(buf_jax.getvalue()))["t0"])
    assert back.dtype == torch.bfloat16
    assert np.array_equal(back.view(torch.int16).numpy().view(np.uint16),
                          bits)


def test_other_void_widths_are_refused():
    from bigdl_tpu_torch.utils.serializer.serializer import from_numpy

    with pytest.raises(TypeError, match="void"):
        from_numpy(np.zeros(3, "V1"))


# ------------------------------------------------------ positional order
def test_positional_names_agree_with_jax_or_stand_in_the_table():
    """Every Module class both packages export from nn and models: the
    port's positional parameters are JAX's, up to a trailing
    ``generator``, or the class is in ``JAX_POSITIONAL`` with JAX's."""
    from bigdl_tpu.nn.module import Module as JaxModule

    def positional(cls):
        ps = list(inspect.signature(cls.__init__).parameters.values())[1:]
        return [p.name for p in ps if p.kind == p.POSITIONAL_OR_KEYWORD]

    seen, tabled = 0, set()
    for jpkg, tpkg in ((jnn, tnn), (jmodels, tmodels)):
        for name in dir(jpkg):
            jc, tc = getattr(jpkg, name), getattr(tpkg, name, None)
            if not (inspect.isclass(jc) and issubclass(jc, JaxModule)
                    and inspect.isclass(tc) and issubclass(tc, Module)):
                continue
            seen += 1
            j, t = positional(jc), positional(tc)
            path = f"{tc.__module__}.{tc.__qualname__}"
            if path in JAX_POSITIONAL:
                assert tuple(j) == JAX_POSITIONAL[path], name
                tabled.add(name)
            else:
                assert t == j or t == j + ["generator"], (name, j, t)
    assert seen >= 170
    assert tabled == {"MultiHeadAttention", "TransformerBlock",
                      "TransformerLM"}


def test_jax_positional_arguments_bind_to_jax_names(tmp_path):
    """JAX's ``MultiHeadAttention(16, 4, 0.0, True, False)`` is
    ``dropout=0.0, with_bias=True, causal=False``; bound in the port's
    order it would be ``causal=0.0, use_flash=True, num_kv_heads=False``."""
    from bigdl_tpu.models import transformer as jtr

    with numpy_weight_draws(4):
        jm = jnn.Sequential(
            jnn.MultiHeadAttention(16, 4, 0.0, True, False, None, False, 2),
            jtr.TransformerLM(32, 16, 4, 1, 16, 4, 0.0, True, None, False,
                              False, False, 0, None, 2, True))
    path = str(tmp_path / "order.bigdl")
    jser.save_module(jm, path)
    port = tser.load_module(path, device="cpu")
    attn, lm = port[0], port[1]
    assert (attn.causal, attn.use_flash, attn.num_kv_heads) == (False, False, 2)
    assert attn.qkv.with_bias and attn.out_proj.with_bias
    blk = lm.blocks()[0]
    assert lm.use_rope is True and lm.tie_embeddings is False
    assert (blk.attn.num_kv_heads, blk.attn.use_flash, blk.attn.causal) == \
        (2, False, True)
    x = np.random.RandomState(4).randn(2, 5, 16).astype(np.float32)
    want = _jax_forward(jm[0], x)
    port.evaluate()
    with torch.no_grad():
        _close(attn(torch.from_numpy(x)), want, rel=1e-5)


# --------------------------------------------------- shared, objects, train
@pytest.mark.parametrize("side", ["jax", "port"])
def test_shared_module_loads_once(side, tmp_path):
    nn, save = (jnn, jser.save_module) if side == "jax" \
        else (tnn, tser.save_module)
    lin = mk(nn.Linear, 4, 4)
    m = mk(nn.Sequential, lin, mk(nn.Tanh), lin)
    p = str(tmp_path / "shared.bigdl")
    save(m, p)
    spec, _ = _spec(p)
    assert len(spec["records"]) == 3
    back = tser.load_module(p, device="cpu")
    assert back[0] is back[2]
    assert len(list(back.parameters())) == 2
    from bigdl_tpu_torch.optim import SGD

    method = SGD(learning_rate=0.1)
    before = back[0].weight.detach().clone()
    x = torch.ones(2, 4)
    back.zero_grad_parameters()
    back.backward(x, torch.ones(2, 4))
    grad = back[0].weight.grad.clone()
    params = list(back.parameters())
    slots = method.init_slots(params)
    new, _ = method.step(params, [p.grad for p in params], slots, 0.1)
    with torch.no_grad():
        for p, n in zip(params, new):
            p.copy_(n)
    torch.testing.assert_close(back[0].weight, before - 0.1 * grad)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_regularizer_and_init_objects_round_trip(side, tmp_path):
    if side == "jax":
        from bigdl_tpu.nn import init as binit
        from bigdl_tpu.optim.regularizer import L1L2Regularizer, L2Regularizer
        nn, save = jnn, jser.save_module
    else:
        from bigdl_tpu_torch.nn import init as binit
        from bigdl_tpu_torch.optim.regularizer import (L1L2Regularizer,
                                                       L2Regularizer)
        nn, save = tnn, tser.save_module
    m = mk(nn.Linear, 4, 3, w_regularizer=L1L2Regularizer(0.01, 0.02),
           b_regularizer=L2Regularizer(0.5),
           init_method=binit.RandomUniform(-0.1, 0.1))
    p = str(tmp_path / "reg.bigdl")
    save(m, p)
    back = tser.load_module(p, device="cpu")
    from bigdl_tpu_torch.nn.init import RandomUniform
    from bigdl_tpu_torch.optim.regularizer import (L1L2Regularizer as TL1L2,
                                                   L2Regularizer as TL2)
    w, b = back._regularizers["weight"], back._regularizers["bias"]
    assert type(w) is TL1L2 and (w.l1, w.l2) == (0.01, 0.02)
    assert type(b) is TL2 and b.l2 == 0.5
    assert type(back._init_method) is RandomUniform
    want = sum(float(np.abs(np.asarray(v)).sum()) * 0.01
               + 0.5 * 0.02 * float((np.asarray(v) ** 2).sum())
               for v in [_host(m.weight)])
    want += 0.5 * 0.5 * float((_host(m.bias) ** 2).sum())
    assert float(back.regularization_loss().detach()) == pytest.approx(
        want, rel=1e-5)
    back.reset()
    assert float(back.weight.detach().abs().max()) <= 0.1


def test_a_train_step_after_a_load_moves_the_weights(tmp_path):
    from bigdl_tpu_torch.dataset.sample import Sample
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

    jm = jnn.Sequential(jnn.Linear(4, 8), jnn.Tanh(), jnn.Linear(8, 2),
                        jnn.LogSoftMax())
    jm[0].freeze()
    p = str(tmp_path / "train.bigdl")
    jser.save_module(jm, p)
    model = tser.load_module(p, device="cpu")
    assert all(isinstance(q, torch.nn.Parameter) and q.requires_grad
               for q in model.parameters())
    before = [q.detach().clone() for q in model.parameters()]
    rng = np.random.RandomState(0)
    samples = [Sample(rng.randn(4).astype(np.float32),
                      np.array([1.0 + (i % 2)], np.float32))
               for i in range(16)]
    opt = LocalOptimizer(model, samples, tnn.ClassNLLCriterion(),
                         batch_size=8, end_when=Trigger.max_iteration(2))
    opt.set_optim_method(SGD(learning_rate=0.1))
    trained = opt.optimize()
    after = list(trained.parameters())
    assert torch.equal(after[0], before[0]) and torch.equal(after[1],
                                                            before[1])
    assert not torch.equal(after[2], before[2])
    assert not torch.equal(after[3], before[3])


# ---------------------------------------------------- what is not written
def test_device_and_generators_are_not_written(tmp_path):
    from bigdl_tpu_torch.utils.random import RandomGenerator

    m = tnn.Sequential(
        tnn.Linear(4, 4, rng=RandomGenerator(3), device="cpu"),
        tnn.Dropout(0.3, generator=torch.Generator().manual_seed(1)),
        tnn.Linear(4, 2, device="cpu", dtype=torch.float64))
    p = str(tmp_path / "dev.bigdl")
    m.save_module(p)
    spec, _ = _spec(p)
    text = json.dumps(spec)
    assert "device" not in text and "rng" not in text
    kw = [r["init"]["kwargs"] for r in spec["records"].values()]
    assert {"input_size": 4, "output_size": 4} in kw
    assert {"init_p": {"t": "f", "v": "0.3"}} in kw
    assert {"input_size": 4, "output_size": 2,
            "dtype": {"t": "dtype", "v": "float64"}} in kw
    back = tser.load_module(p, device="cpu")
    assert back[1].generator is None
    assert back[2].weight.dtype == torch.float64


def test_unencodable_argument_raises(tmp_path):
    def zeros(shape, rng=None, fan_in=None, fan_out=None):
        return torch.zeros(shape)

    m = tnn.Sequential(tnn.Linear(2, 2, init_method=zeros, device="cpu"))
    with pytest.raises(TypeError, match="cannot serialize"):
        tser.save_module(m, str(tmp_path / "bad.bigdl"))
    with pytest.raises(FileExistsError):
        p = str(tmp_path / "twice.bigdl")
        tser.save_module(tnn.ReLU(), p)
        tser.save_module(tnn.ReLU(), p)


def test_classes_outside_the_port_are_not_resolved(tmp_path):
    p = str(tmp_path / "evil.bigdl")
    tser.save_module(tnn.ReLU(), p)
    spec, tensors = _spec(p)
    spec["records"]["m0"]["class"] = "os.system"
    with pytest.raises(ValueError, match="outside bigdl_tpu_torch"):
        tser.module_from_spec(spec, tensors, device="cpu")


def test_a_jax_extra_named_like_a_port_property_is_skipped(tmp_path):
    """A plain attribute of a JAX layer that the port derives as a
    read-only property (a cell's ``draws_random``) leaves the load
    alone: the property keeps deriving its value."""
    p = str(tmp_path / "lstm.bigdl")
    jser.save_module(jnn.Recurrent().add(jnn.LSTM(3, 4, p=0.25)), p)
    spec, tensors = _spec(p)
    cell = next(r for r in spec["records"].values()
                if r["class"].endswith(".LSTM"))
    cell["extra"]["draws_random"] = False
    back = tser.module_from_spec(spec, tensors, device="cpu")
    assert isinstance(back.cell, tnn.LSTM) and back.cell.p == 0.25
    assert back.cell.draws_random is True
    with torch.no_grad():
        assert back(torch.ones(2, 5, 3)).shape == (2, 5, 4)
