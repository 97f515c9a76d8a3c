"""Keras 1.2.2 model import: json topology + hdf5 weights -> keras layers
(port of ``bigdl_tpu/keras/converter.py``).

Reference: pyspark/bigdl/keras/converter.py:32-420 (DefinitionLoader /
WeightLoader + per-layer LayerConverter methods) — the reference pins
Keras 1.2.2 and walks ``model.get_config()``; here the SAME json document
is parsed directly (class_name/config tree) with the Keras-1.x hdf5
weight layout (root attr ``layer_names``, per-layer group attr
``weight_names``).

Topology (json) import covers: Dense, Activation, Dropout, Flatten,
Reshape, Convolution1D/2D, SeparableConvolution2D (th dim-ordering),
MaxPooling1D/2D, AveragePooling1D/2D, Global{Max,Average}Pooling1D/2D,
ZeroPadding2D (symmetric), UpSampling2D, BatchNormalization, Embedding,
LSTM, GRU, SimpleRNN; Keras 2/3 ``InputLayer`` json and functional
models (shared layers included).

hdf5 WEIGHT loading covers Dense, Convolution1D/2D,
SeparableConvolution2D, BatchNormalization, Embedding, LSTM, GRU,
SimpleRNN — in BOTH weight layouts: the Keras-1.2.2 per-gate arrays the
reference pins (LSTM groups ordered i,c,f,o; GRU groups z,r,h — ≙
WeightsConverter.convert_lstm/convert_gru, ref:
pyspark/bigdl/keras/converter.py:218-241) and the fused kernels modern
tf.keras/Keras-2+ writes (LSTM kernel gate order i,f,c,o; GRU z,r,h with
``reset_after=False`` semantics); a conv kernel in the Keras-1 th OIHW
layout or the HWIO layout tf.keras writes. load_keras with weights fails
fast (before mutating anything) if the model contains other weighted
layers. Weights are copied into the parameters in place, on the model's
device. ``h5py`` is imported only where a .h5 file is read: without it
``load_keras(hdf5_path=...)`` raises an ``ImportError`` naming h5py, and a
json-only model with weights set from numpy needs none.
"""

from __future__ import annotations

import functools
import json
from typing import Dict, List, Optional

import numpy as np
import torch

from bigdl_tpu_torch import keras as bk
from bigdl_tpu_torch import keras as _keras
from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn.module import Module


def _tuplify(v):
    return tuple(int(x) for x in v) if v is not None else None


def _shape_from(batch_shape):
    """Batch shape -> per-sample shape, or None when absent or carrying
    variable (None) dims — variable-length models need an explicit
    ``input_shape`` at load time."""
    if not batch_shape:
        return None
    dims = batch_shape[1:]
    if any(d is None for d in dims):
        return None
    return _tuplify(dims)


def _conv2d_args(c: dict):
    """nb_filter/nb_row/nb_col/subsample from either Keras-1 keys or the
    filters/kernel_size/strides modern configs use (scalars accepted)."""
    nb = c.get("nb_filter", c.get("filters"))
    ks = c.get("kernel_size")
    if isinstance(ks, int):
        ks = (ks, ks)
    row = c.get("nb_row", (ks or [None])[0])
    col = c.get("nb_col", (ks or [None, None])[1])
    sub = c.get("subsample", c.get("strides", (1, 1)))
    if isinstance(sub, int):
        sub = (sub, sub)
    return nb, row, col, _tuplify(sub)


def _require_th(cls: str, c: dict):
    if c.get("dim_ordering", "th") != "th" or \
            c.get("data_format") == "channels_last":
        raise ValueError(
            f"{cls}: only th (channels-first) dim_ordering is supported; "
            "re-export the model channels-first (the reference is th-only "
            "too, ref: pyspark/bigdl/keras/converter.py)")


_MERGE_CLASSES = {"Add", "Subtract", "Multiply", "Average", "Maximum",
                  "Minimum", "Concatenate"}


def _parse_inbound_nodes(lspec: dict) -> List[List[tuple]]:
    """Per CALL NODE ``(source layer name, source call-node index)``
    pairs, across formats: Keras-1/2 ``[[["src", 0, 0, {}], ...], ...]``
    and Keras-3's kwargs dicts carrying ``keras_history`` triples.
    SHARED layers are supported: a layer called k times yields k entries
    here, and the functional importer wires each call node as its own
    graph Node over the one weight-owning module."""
    inbound = lspec.get("inbound_nodes") or []
    out: List[List[tuple]] = []
    for node_spec in inbound:
        srcs: List[tuple] = []

        def add(src, node_index):
            srcs.append((src, int(node_index or 0)))

        if isinstance(node_spec, dict):  # keras 3
            def walk(obj):
                if isinstance(obj, dict):
                    if obj.get("class_name") == "__keras_tensor__":
                        hist = obj["config"]["keras_history"]
                        add(hist[0], hist[1])
                        return
                    for v in obj.values():
                        walk(v)
                elif isinstance(obj, (list, tuple)):
                    for v in obj:
                        walk(v)

            walk(node_spec)
        else:
            for entry in node_spec:
                add(entry[0], entry[1] if len(entry) > 1 else 0)
        out.append(srcs)
    return out


def _convert_merge(cls: str, c: dict, in_shapes):
    """Keras merge layer -> nn table op + output shape (sans batch)."""
    from bigdl_tpu_torch import nn as bnn

    if cls == "Concatenate":
        rank = len(in_shapes[0])
        axis = c.get("axis", -1)
        # keras axes count batch as 0 and negatives from the end (incl.
        # batch): rank+1 total dims
        axis = rank + 1 + axis if axis < 0 else axis
        if not 1 <= axis <= rank:
            raise ValueError(f"Concatenate axis {c.get('axis')} out of "
                             f"range for rank-{rank} inputs")
        out = list(in_shapes[0])
        out[axis - 1] = sum(s[axis - 1] for s in in_shapes)
        return bnn.JoinTable(axis + 1), tuple(out)  # nn dims count batch=1
    table = {"Add": bnn.CAddTable, "Subtract": bnn.CSubTable,
             "Multiply": bnn.CMulTable, "Average": bnn.CAveTable,
             "Maximum": bnn.CMaxTable, "Minimum": bnn.CMinTable}
    if any(s != in_shapes[0] for s in in_shapes):
        raise ValueError(f"{cls} inputs must share a shape, got {in_shapes}")
    return table[cls](), tuple(in_shapes[0])


class _OnDevice:
    """The keras layer classes with ``device=`` bound: ``bk.Dense(...)``
    inside ``_convert_layer`` builds on the loader's device."""

    def __init__(self, device):
        self.device = device

    def __getattr__(self, name):
        return functools.partial(getattr(_keras, name), device=self.device)


class DefinitionLoader:
    """json -> un-weighted keras model (≙ converter.py DefinitionLoader)."""

    @staticmethod
    def from_json_str(text: str, input_shape=None, device=DEFAULT_DEVICE):
        device = resolve_device(device)
        spec = json.loads(text)
        return DefinitionLoader._convert_model(spec, input_shape, device)

    @staticmethod
    def from_json_path(path: str, device=DEFAULT_DEVICE):
        with open(path) as f:
            return DefinitionLoader.from_json_str(f.read(), device=device)

    # ------------------------------------------------------------- builders
    @staticmethod
    def _convert_model(spec: dict, input_shape=None, device=DEFAULT_DEVICE):
        cls = spec.get("class_name")
        if cls in ("Model", "Functional"):
            return DefinitionLoader._convert_functional(spec, input_shape,
                                                        device)
        if cls != "Sequential":
            raise ValueError(
                f"unsupported keras model class {cls!r} (Sequential and "
                "functional Model/Functional)")
        cfg = spec["config"]
        layer_specs = cfg["layers"] if isinstance(cfg, dict) else cfg
        if (input_shape is not None and layer_specs
                and not layer_specs[0]["config"].get("batch_input_shape")):
            layer_specs[0]["config"]["batch_input_shape"] = \
                [None] + list(input_shape)
        model = bk.Sequential()
        pending_shape = None  # from a preceding InputLayer (Keras-2+/3 json)
        for lspec in layer_specs:
            if lspec["class_name"] == "InputLayer":
                pending_shape = (
                    _shape_from(lspec["config"].get("batch_input_shape"))
                    or _shape_from(lspec["config"].get("batch_shape")))
                continue
            if pending_shape is not None and \
                    not lspec["config"].get("batch_input_shape"):
                lspec["config"]["batch_input_shape"] = \
                    [None] + list(pending_shape)
            pending_shape = None
            layer = DefinitionLoader._convert_layer(lspec, device)
            if layer is not None:
                model.add(layer)  # Sequential builds + shape-infers here
        return model

    @staticmethod
    def _convert_functional(spec: dict, input_shape=None,
                            device=DEFAULT_DEVICE):
        """Functional-API import: layers + inbound_nodes -> the nn Graph
        engine via node wiring, shapes propagated with each KerasLayer's
        ``build`` (≙ the reference DefinitionLoader walking a loaded
        functional model's node graph). ``input_shape`` is the fallback
        for an InputLayer whose json shape carries variable dims."""
        from bigdl_tpu_torch import nn as bnn

        cfg = spec["config"]
        pending = list(cfg["layers"])
        nodes: Dict[tuple, object] = {}    # (layer name, call-node idx)
        shapes: Dict[tuple, tuple] = {}
        klayers: Dict[str, object] = {}
        next_call: Dict[str, int] = {}     # per-layer wiring progress

        def endpoint_keys(entries):
            # single endpoint may arrive FLAT: ['name', 0, 0] (keras 3)
            if (isinstance(entries, (list, tuple)) and entries
                    and isinstance(entries[0], str)):
                entries = [entries]
            keys = []
            for e in entries:
                if isinstance(e, (list, tuple)):
                    keys.append((e[0], int(e[1]) if len(e) > 1 else 0))
                else:
                    keys.append((e, 0))
            return keys

        while pending:
            progressed = False
            for lspec in list(pending):
                name = lspec.get("name") or lspec["config"].get("name")
                if lspec["class_name"] == "InputLayer":
                    shp = (_shape_from(lspec["config"].get("batch_input_shape"))
                           or _shape_from(lspec["config"].get("batch_shape"))
                           or (tuple(input_shape) if input_shape else None))
                    if shp is None:
                        raise ValueError(
                            f"InputLayer {name!r} needs a concrete shape "
                            "(variable dims in the json: pass input_shape=)")
                    nodes[(name, 0)], shapes[(name, 0)] = bnn.Input(), shp
                    pending.remove(lspec)
                    progressed = True
                    continue
                call_nodes = _parse_inbound_nodes(lspec)
                if not call_nodes:
                    continue
                cls = lspec["class_name"]
                # wire call nodes INCREMENTALLY: chained self-sharing
                # (y = f(x); z = f(y)) makes node 1's source this layer's
                # own node 0, so all-at-once readiness would deadlock
                j = next_call.get(name, 0)
                while (j < len(call_nodes)
                       and all(k in nodes for k in call_nodes[j])):
                    in_nodes = [nodes[k] for k in call_nodes[j]]
                    in_shapes = [shapes[k] for k in call_nodes[j]]
                    if cls in _MERGE_CLASSES:
                        mod, out = _convert_merge(cls, lspec["config"],
                                                  in_shapes)
                        node = mod.inputs(*in_nodes)
                    else:
                        kl = klayers.get(name)
                        if kl is None:
                            kl = DefinitionLoader._convert_layer(lspec,
                                                                 device)
                            out = kl.build(in_shapes[0])
                            klayers[name] = kl
                        else:
                            # SHARED layer, call node j > 0: reuse the one
                            # weight-owning module (Graph registers shared
                            # modules once); re-infer the out shape only
                            from bigdl_tpu_torch.keras.engine import \
                                _infer_output_shape
                            out = _infer_output_shape(kl.layer, in_shapes[0],
                                                      kl._infer_dtype,
                                                      kl.device)
                        node = kl.inputs(in_nodes[0])
                    nodes[(name, j)], shapes[(name, j)] = node, out
                    j += 1
                    progressed = True
                next_call[name] = j
                if j == len(call_nodes):
                    pending.remove(lspec)
            if not progressed:
                raise ValueError(
                    "unresolvable functional graph (cycle or missing "
                    f"sources): {[ls.get('name') for ls in pending]}")

        ins = [nodes[k] for k in endpoint_keys(cfg["input_layers"])]
        outs = [nodes[k] for k in endpoint_keys(cfg["output_layers"])]
        model = bk.Model(ins if len(ins) > 1 else ins[0],
                         outs if len(outs) > 1 else outs[0])
        #: name -> KerasLayer, for name-matched hdf5 weight loading
        model._klayers_by_name = klayers
        return model

    @staticmethod
    def _convert_layer(lspec: dict, device=DEFAULT_DEVICE):
        cls = lspec["class_name"]
        c = lspec["config"]
        in_shape = (_shape_from(c.get("batch_input_shape"))
                    or _shape_from(c.get("batch_shape")))
        bk = _OnDevice(device)
        if cls == "Dense":
            units = c.get("output_dim", c.get("units"))
            return bk.Dense(units, activation=c.get("activation") or None,
                            bias=c.get("bias", c.get("use_bias", True)),
                            input_shape=in_shape)
        if cls == "Activation":
            return bk.Activation(c["activation"], input_shape=in_shape)
        if cls == "Dropout":
            return bk.Dropout(c.get("p", c.get("rate", 0.5)),
                              input_shape=in_shape)
        if cls == "Flatten":
            return bk.Flatten(input_shape=in_shape)
        if cls == "Reshape":
            return bk.Reshape(_tuplify(c["target_shape"]),
                              input_shape=in_shape)
        if cls in ("Convolution2D", "Conv2D"):
            _require_th(cls, c)
            nb, row, col, sub = _conv2d_args(c)
            return bk.Convolution2D(
                nb, row, col, subsample=sub,
                border_mode=c.get("border_mode", c.get("padding", "valid")),
                activation=c.get("activation") or None,
                input_shape=in_shape)
        if cls == "MaxPooling2D":
            return bk.MaxPooling2D(
                pool_size=_tuplify(c.get("pool_size", (2, 2))),
                strides=_tuplify(c.get("strides")) or None,
                border_mode=c.get("border_mode", "valid"),
                input_shape=in_shape)
        if cls == "AveragePooling2D":
            return bk.AveragePooling2D(
                pool_size=_tuplify(c.get("pool_size", (2, 2))),
                strides=_tuplify(c.get("strides")) or None,
                border_mode=c.get("border_mode", "valid"),
                input_shape=in_shape)
        if cls == "BatchNormalization":
            return bk.BatchNormalization(epsilon=c.get("epsilon", 1e-3),
                                         momentum=c.get("momentum", 0.99),
                                         input_shape=in_shape)
        if cls == "Embedding":
            return bk.Embedding(c["input_dim"], c["output_dim"],
                                input_shape=in_shape
                                or ((c["input_length"],)
                                    if c.get("input_length") else None))
        def _scalar(v):
            return v[0] if isinstance(v, (list, tuple)) else v

        def _pool1d_args():
            return (_scalar(c.get("pool_length", c.get("pool_size", 2))),
                    _scalar(c.get("stride", c.get("strides"))))

        if cls in ("Convolution1D", "Conv1D"):
            nb = c.get("nb_filter", c.get("filters"))
            flen = c.get("filter_length",
                         (c.get("kernel_size") or [None])[0])
            sub = _scalar(c.get("subsample_length", c.get("strides", 1)))
            return bk.Convolution1D(nb, flen, subsample_length=sub,
                                    activation=c.get("activation") or None,
                                    input_shape=in_shape)
        if cls == "MaxPooling1D":
            pl, st = _pool1d_args()
            return bk.MaxPooling1D(pool_length=pl, stride=st,
                                   input_shape=in_shape)
        if cls == "AveragePooling1D":
            pl, st = _pool1d_args()
            return bk.AveragePooling1D(pool_length=pl, stride=st,
                                       input_shape=in_shape)
        if cls == "GlobalMaxPooling1D":
            return bk.GlobalMaxPooling1D(input_shape=in_shape)
        if cls == "GlobalAveragePooling1D":
            return bk.GlobalAveragePooling1D(input_shape=in_shape)
        if cls == "GlobalMaxPooling2D":
            return bk.GlobalMaxPooling2D(input_shape=in_shape)
        if cls == "GlobalAveragePooling2D":
            return bk.GlobalAveragePooling2D(input_shape=in_shape)
        if cls == "ZeroPadding2D":
            pad = c.get("padding", (1, 1))
            if isinstance(pad, (list, tuple)) and pad and \
                    isinstance(pad[0], (list, tuple)):
                (t, b), (l, r) = pad
                if t != b or l != r:
                    raise ValueError(
                        "asymmetric ZeroPadding2D "
                        f"{pad} is unsupported (symmetric only)")
                pad = (t, l)
            return bk.ZeroPadding2D(padding=_tuplify(pad),
                                    input_shape=in_shape)
        if cls == "UpSampling2D":
            return bk.UpSampling2D(size=_tuplify(c.get("size", (2, 2))),
                                   input_shape=in_shape)
        if cls in ("SeparableConvolution2D", "SeparableConv2D"):
            _require_th(cls, c)
            nb, row, col, sub = _conv2d_args(c)
            return bk.SeparableConvolution2D(
                nb, row, col,
                depth_multiplier=c.get("depth_multiplier", 1),
                subsample=sub,
                activation=c.get("activation") or None,
                bias=c.get("bias", c.get("use_bias", True)),
                input_shape=in_shape)
        if cls in ("LSTM", "GRU", "SimpleRNN"):
            if cls == "GRU" and c.get("reset_after", False):
                raise ValueError(
                    "GRU(reset_after=True) is unsupported: the Keras-1.2.2 "
                    "recurrence the reference pins applies the reset gate "
                    "before the hidden matmul (reset_after=False)")
            units = c.get("output_dim", c.get("units"))
            kw = dict(
                activation=c.get("activation") or None,
                inner_activation=(c.get("inner_activation")
                                  or c.get("recurrent_activation") or None),
                return_sequences=c.get("return_sequences", False),
                go_backwards=c.get("go_backwards", False),
                input_shape=in_shape)
            if cls == "SimpleRNN":
                kw.pop("inner_activation")
            return getattr(bk, cls)(units, **kw)
        raise ValueError(f"unsupported keras layer {cls!r}")


def _read_weight_groups(root, layer_names):
    """hdf5 -> ordered {layer_name: [arrays]} for layers CARRYING weights."""
    named = {}
    for ln in layer_names:
        wn = [n.decode() if isinstance(n, bytes) else n
              for n in root[ln].attrs.get("weight_names", [])]
        if wn:
            named[ln] = [np.asarray(root[ln][n]) for n in wn]
    return named


def _check_mapped(klayers):
    """Fail fast BEFORE mutating: a missing mapping mid-loop would leave
    the model half-loaded."""
    unmapped = [type(kl).__name__ for kl in klayers
                if not _has_weight_mapping(kl)]
    if unmapped:
        raise ValueError(
            "no hdf5 weight mapping for layer(s) "
            f"{sorted(set(unmapped))}; these import topology-only "
            "(json) for now")


def _h5py():
    """``h5py``, imported where a .h5 file is read (as in JAX)."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "reading Keras .h5 files needs h5py, which is not installed; "
            "load the json topology alone (load_keras(json_str=...) or "
            "DefinitionLoader) and set the weights from numpy") from e
    return h5py


def _set_param(module: Module, name: str, value) -> None:
    """Copy ``value`` into the parameter ``name`` in place (its device and
    dtype kept); a shape that differs raises."""
    p = getattr(module, name)
    arr = np.asarray(value)
    if tuple(arr.shape) != tuple(p.shape):
        raise ValueError(f"{type(module).__name__}.{name}: weight of shape "
                         f"{arr.shape}, parameter of shape {tuple(p.shape)}")
    with torch.no_grad():
        p.copy_(torch.from_numpy(np.ascontiguousarray(arr)).to(p.dtype))


def _set_buffer(module: Module, name: str, value) -> None:
    b = getattr(module, name)
    setattr(module, name, torch.from_numpy(np.array(value)).to(
        device=b.device, dtype=b.dtype))


class WeightLoader:
    """hdf5 -> weights into a built model (≙ converter.py WeightLoader)."""

    @staticmethod
    def load_weights(model, h5_path: str):
        h5py = _h5py()

        with h5py.File(h5_path, "r") as f:
            root = f["model_weights"] if "model_weights" in f else f
            layer_names = [n.decode() if isinstance(n, bytes) else n
                           for n in root.attrs.get("layer_names", [])]
            named = _read_weight_groups(root, layer_names)
            klmap = getattr(model, "_klayers_by_name", None)
            if klmap is not None:
                # functional import: match hdf5 groups to layers BY NAME
                weighted = {n: kl for n, kl in klmap.items()
                            if kl.layer.params_dict()}
                if set(named) != set(weighted):
                    raise ValueError(
                        "weight/layer name mismatch: hdf5 has "
                        f"{sorted(named)} vs model {sorted(weighted)}")
                _check_mapped(weighted.values())
                for n, kl in weighted.items():
                    _set_layer_weights(kl, named[n])
                return
            weighted = [l for l in model._layers
                        if getattr(l, "layer", None) is not None
                        and l.layer.params_dict()]
            w_groups = list(named.values())
            if len(w_groups) != len(weighted):
                raise ValueError(
                    f"weight/layer mismatch: {len(w_groups)} weighted hdf5 "
                    f"layers vs {len(weighted)} weighted model layers")
            _check_mapped(weighted)
            for layer, weights in zip(weighted, w_groups):
                _set_layer_weights(layer, weights)


def _has_weight_mapping(klayer) -> bool:
    from bigdl_tpu_torch.keras import layers as kl

    return isinstance(klayer, (kl.Dense, kl.Convolution2D, kl.Convolution1D,
                               kl.SeparableConvolution2D,
                               kl.BatchNormalization, kl.Embedding,
                               kl.LSTM, kl.GRU, kl.SimpleRNN))


def _conv2d_kernel(w: np.ndarray, expected) -> np.ndarray:
    """Accept a 2-D conv kernel in either Keras-1 th OIHW layout or the
    HWIO layout modern tf.keras hdf5 files carry; return OIHW."""
    w = np.asarray(w)
    expected = tuple(expected)
    if w.shape == expected:  # OIHW
        return w
    o, i, kh, kw = expected
    if w.shape == (kh, kw, i, o):  # HWIO
        return w.transpose(3, 2, 0, 1)
    raise ValueError(f"conv kernel shape {w.shape} matches neither OIHW "
                     f"{expected} nor HWIO {(kh, kw, i, o)}")


def _set_layer_weights(klayer, weights: List[np.ndarray]):
    from bigdl_tpu_torch.keras import layers as kl

    inner = klayer.layer
    if isinstance(klayer, kl.Dense):
        lin = _find(inner, "Linear")
        _set_param(lin, "weight", (weights[0].T))  # (in,out)->(out,in)
        if len(weights) > 1:
            _set_param(lin, "bias", (weights[1]))
    elif isinstance(klayer, kl.Convolution2D):
        conv = _find(inner, "SpatialConvolution")
        _set_param(conv, "weight", (
            _conv2d_kernel(weights[0], conv.weight.shape)))
        if len(weights) > 1:
            _set_param(conv, "bias", (weights[1]))
    elif isinstance(klayer, kl.Convolution1D):
        conv = _find(inner, "TemporalConvolution")
        w = np.asarray(weights[0])
        out, cin, kw = conv.weight.shape
        if w.shape == (kw, 1, cin, out):  # keras-1 stores conv1d as 4-D
            w = w[:, 0]
        if w.shape == (kw, cin, out):  # (kw,in,out) -> (out,in,kw)
            w = w.transpose(2, 1, 0)
        if w.shape != (out, cin, kw):
            raise ValueError(f"conv1d kernel shape mismatch: {weights[0].shape}")
        _set_param(conv, "weight", (w))
        if len(weights) > 1:
            _set_param(conv, "bias", (weights[1]))
    elif isinstance(klayer, kl.SeparableConvolution2D):
        sep = _find(inner, "SpatialSeparableConvolution")
        dw, pw = sep.depthwise, sep.pointwise
        d = np.asarray(weights[0])
        exp = tuple(dw.weight.shape)  # (in*dm, 1, kh, kw) grouped OIHW
        if d.shape != exp:
            indm, _, kh, kw = exp
            dm = klayer.depth_multiplier
            cin = indm // dm
            if d.shape == (kh, kw, cin, dm):  # tf.keras (kh,kw,in,dm)
                d = d.transpose(2, 3, 0, 1).reshape(exp)
            elif d.shape == (dm, cin, kh, kw):  # keras-1 th (dm,in,kh,kw)
                d = d.transpose(1, 0, 2, 3).reshape(exp)
            else:
                raise ValueError(
                    f"depthwise kernel shape {d.shape} matches none of "
                    f"grouped-OIHW {exp}, (kh,kw,in,dm), (dm,in,kh,kw)")
        _set_param(dw, "weight", (d))
        _set_param(pw, "weight", (
            _conv2d_kernel(weights[1], pw.weight.shape)))
        if len(weights) > 2:
            _set_param(pw, "bias", (weights[2]))
    elif isinstance(klayer, kl.LSTM):
        cell = _find(inner, "LSTM")
        if len(weights) == 12:
            # Keras-1.2.2 per-gate arrays grouped [W,U,b] x [i,c,f,o]
            # (≙ ref converter.py:222-226); our fused order is i,f,g(=c),o.
            gi, gc, gf, go = 0, 3, 6, 9
            i2g = np.concatenate([weights[g] for g in (gi, gf, gc, go)], 1)
            h2g = np.concatenate([weights[g + 1] for g in (gi, gf, gc, go)], 1)
            bias = np.concatenate([weights[g + 2] for g in (gi, gf, gc, go)])
        elif len(weights) == 3:
            # fused kernels (modern tf.keras): gate order i,f,c,o == ours
            i2g, h2g, bias = weights
        else:
            raise ValueError(f"LSTM expects 3 or 12 arrays, got {len(weights)}")
        _set_param(cell, "i2g", (i2g))
        _set_param(cell, "h2g", (h2g))
        _set_param(cell, "bias", (bias))
    elif isinstance(klayer, kl.GRU):
        cell = _find(inner, "GRU")
        h = cell.hidden_size
        if len(weights) == 9:
            # Keras-1.2.2 groups [W,U,b] x [z,r,h] (≙ ref converter.py:236-241)
            W_z, U_z, b_z = weights[0:3]
            W_r, U_r, b_r = weights[3:6]
            W_h, U_h, b_h = weights[6:9]
        elif len(weights) == 3:
            # fused kernels, gate order z,r,h (reset_after=False layout)
            K, U, b = (np.asarray(w) for w in weights)
            if b.ndim == 2:
                raise ValueError(
                    "GRU hdf5 carries a (2, 3h) bias: the model was saved "
                    "with reset_after=True, which is unsupported")
            W_z, W_r, W_h = K[:, :h], K[:, h:2 * h], K[:, 2 * h:]
            U_z, U_r, U_h = U[:, :h], U[:, h:2 * h], U[:, 2 * h:]
            b_z, b_r, b_h = b[:h], b[h:2 * h], b[2 * h:]
        else:
            raise ValueError(f"GRU expects 3 or 9 arrays, got {len(weights)}")
        # our fused gate order is r,z; candidate is separate
        _set_param(cell, "i2g", (np.concatenate([W_r, W_z], 1)))
        _set_param(cell, "h2g", (np.concatenate([U_r, U_z], 1)))
        _set_param(cell, "gate_bias", (np.concatenate([b_r, b_z])))
        _set_param(cell, "i2c", (W_h))
        _set_param(cell, "h2c", (U_h))
        _set_param(cell, "cand_bias", (b_h))
    elif isinstance(klayer, kl.SimpleRNN):
        cell = _find(inner, "RnnCell")
        _set_param(cell, "i2h", (weights[0]))
        _set_param(cell, "h2h", (weights[1]))
        if len(weights) > 2:
            _set_param(cell, "bias", (weights[2]))
    elif isinstance(klayer, kl.BatchNormalization):
        bn = _find(inner, "BatchNormalization", startswith=True)
        gamma, beta, mean, var = weights[:4]
        _set_param(bn, "weight", (gamma))
        _set_param(bn, "bias", (beta))
        _set_buffer(bn, "running_mean", (mean))
        _set_buffer(bn, "running_var", (var))
    elif isinstance(klayer, kl.Embedding):
        emb = _find(inner, "LookupTable", startswith=True)
        _set_param(emb, "weight", (weights[0]))
    else:
        raise ValueError(
            f"no weight mapping for {type(klayer).__name__}")


def _find(module: Module, cls_name: str, startswith: bool = False):
    for _, m in module.named_modules():
        n = type(m).__name__
        if n == cls_name or (startswith and n.startswith(cls_name)):
            return m
    raise ValueError(f"no {cls_name} inside {type(module).__name__}")


def load_keras(json_path: Optional[str] = None,
               hdf5_path: Optional[str] = None,
               json_str: Optional[str] = None,
               input_shape=None, device=DEFAULT_DEVICE):
    """≙ the reference's Model.load_keras(json_path, hdf5_path). Builds the
    model (shape inference needs either batch_input_shape in the json or an
    explicit ``input_shape``), then loads weights if given.

    With only ``hdf5_path``, the topology is read from the file's own
    ``model_config`` attribute (keras ``model.save(...h5)`` embeds it).
    The model is built on ``device`` (default the card)."""
    device = resolve_device(device)
    if json_str is None and json_path is not None:
        with open(json_path) as f:
            json_str = f.read()
    if json_str is None:
        if hdf5_path is None:
            raise ValueError("need json_path/json_str or an hdf5 with an "
                             "embedded model_config")
        with _h5py().File(hdf5_path, "r") as f:
            mc = f.attrs.get("model_config")
        if mc is None:
            raise ValueError(
                f"{hdf5_path} carries no model_config attribute (weights-"
                "only file?); pass the topology json explicitly")
        json_str = mc.decode() if isinstance(mc, bytes) else mc
    model = DefinitionLoader.from_json_str(json_str, input_shape, device)
    if hdf5_path:
        WeightLoader.load_weights(model, hdf5_path)
    return model
