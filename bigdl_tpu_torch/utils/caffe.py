"""Caffe model import: prototxt + caffemodel → the port's Graph (port of
``bigdl_tpu/utils/caffe.py``).

Reference: utils/caffe/CaffeLoader.scala:57-299 (+ Converter/
V1LayerConverter) — parse NetParameter (text or binary), convert each
layer to a module node wiring bottoms/tops, then copy blob weights.
Interpretation here is by field number against the public caffe.proto;
binary decoding rides the port's ``utils/protowire``. Supports the layer
set the reference converts for the BASELINE config-4 path (Inception-v1
predict): Convolution, Pooling, InnerProduct, ReLU, LRN, Concat,
Dropout, Softmax, Eltwise, BatchNorm(+Scale), Sigmoid, TanH, Flatten,
Input/Data.

A blob's ``data`` (packed little-endian f32, or f32 entries one by one)
is read with ``np.frombuffer``: the JAX package's reader makes a Python
float of every weight (``pw.packed_floats``), ~28 s for VGG-16's 138 M;
the values are the same. Caffe pools default to CEIL, and a BatchNorm's
third blob is the scale factor its statistics are divided by. The model
is built on ``device=``; an ``_InnerProduct`` without blobs builds its
``Linear`` at its first call, on the input's device and dtype.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.utils import protowire as pw


# --------------------------------------------------------------- prototxt
def parse_prototxt(text: str) -> Dict[str, list]:
    """Parse protobuf text format into nested {key: [values]} dicts."""
    text = re.sub(r"#[^\n]*", "", text)  # strip comments
    tokens = re.findall(r'"(?:\\.|[^"\\])*"|[{}:]|[^\s{}:]+', text)
    pos = 0

    def parse_block():
        nonlocal pos
        out: Dict[str, list] = {}
        while pos < len(tokens):
            t = tokens[pos]
            if t == "}":
                pos += 1
                return out
            key = t
            pos += 1
            if pos < len(tokens) and tokens[pos] == ":":
                pos += 1
                val = tokens[pos]
                pos += 1
                if val.startswith('"'):
                    val = val[1:-1]
                else:
                    val = _coerce(val)
                out.setdefault(key, []).append(val)
            elif pos < len(tokens) and tokens[pos] == "{":
                pos += 1
                out.setdefault(key, []).append(parse_block())
            else:
                raise ValueError(f"prototxt parse error near {key!r}")
        return out

    return parse_block()


def _coerce(v: str):
    if v in ("true", "True"):
        return True
    if v in ("false", "False"):
        return False
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v  # enum name


def _g1(d: dict, key: str, default=None):
    vals = d.get(key)
    return vals[0] if vals else default


# ------------------------------------------------------- binary caffemodel
# LayerParameter field numbers (public caffe.proto)
_LP = {"name": 1, "type": 2, "bottom": 3, "top": 4, "blobs": 7,
       "concat": 104, "convolution": 106, "dropout": 108, "eltwise": 110,
       "inner_product": 117, "lrn": 118, "pooling": 121, "relu": 123,
       "batch_norm": 139, "scale": 142, "input": 143}

# V1LayerParameter (old `layers` field): name=4 type=5(enum) bottom=2 top=3 blobs=6
_V1_TYPES = {1: "Accuracy", 3: "Concat", 4: "Convolution", 5: "Data",
             6: "Dropout", 8: "Flatten", 14: "InnerProduct", 15: "LRN",
             17: "Pooling", 18: "ReLU", 19: "Sigmoid", 20: "Softmax",
             21: "SoftmaxWithLoss", 22: "Split", 23: "TanH", 25: "Eltwise"}
_V1_PARAM_FIELDS = {"concat": 9, "convolution": 10, "dropout": 12,
                    "inner_product": 17, "lrn": 18, "pooling": 19,
                    "relu": 30}


def _blob_to_array(blob_bytes: bytes) -> np.ndarray:
    msg = pw.decode(blob_bytes)
    if 7 in msg:  # shape: BlobShape{dim=1 packed int64}
        shape = pw.repeated_varints(pw.decode(msg[7][0]).get(1, []))
    else:  # legacy num/channels/height/width
        shape = [_g1_int(msg, f, 1) for f in (1, 2, 3, 4)]
        while len(shape) > 1 and shape[0] == 1:
            shape = shape[1:]
    chunks = msg.get(5, [])  # data: packed floats, or one f32 an entry
    raw = chunks[0] if len(chunks) == 1 else b"".join(chunks)
    arr = np.frombuffer(raw, "<f4").astype(np.float32)
    return arr.reshape([int(s) for s in shape]) if shape else arr


def _g1_int(msg: dict, field: int, default: int = 0) -> int:
    vals = msg.get(field)
    return int(vals[0]) if vals else default


def _binary_layer_record(layer_bytes: bytes, v1: bool) -> dict:
    msg = pw.decode(layer_bytes)
    if v1:
        rec = {
            "name": pw.as_string(msg.get(4, [b""])[0]),
            "type": _V1_TYPES.get(_g1_int(msg, 5), f"V1_{_g1_int(msg, 5)}"),
            "bottom": [pw.as_string(v) for v in msg.get(2, [])],
            "top": [pw.as_string(v) for v in msg.get(3, [])],
            "blobs": [_blob_to_array(b) for b in msg.get(6, [])],
        }
    else:
        rec = {
            "name": pw.as_string(msg.get(1, [b""])[0]),
            "type": pw.as_string(msg.get(2, [b""])[0]),
            "bottom": [pw.as_string(v) for v in msg.get(3, [])],
            "top": [pw.as_string(v) for v in msg.get(4, [])],
            "blobs": [_blob_to_array(b) for b in msg.get(7, [])],
        }
    return rec


def parse_caffemodel(data: bytes) -> List[dict]:
    """NetParameter binary → list of layer records with blobs."""
    net = pw.decode(data)
    records = []
    for lb in net.get(100, []):  # layer (new)
        records.append(_binary_layer_record(lb, v1=False))
    for lb in net.get(2, []):  # layers (V1)
        records.append(_binary_layer_record(lb, v1=True))
    return records


# ---------------------------------------------------------------- building
class _CaffeNet:
    def __init__(self, proto: Dict[str, list]):
        self.proto = proto

    def layer_defs(self) -> List[dict]:
        return [l for l in self.proto.get("layer", []) + self.proto.get("layers", [])]

    def input_names(self) -> List[str]:
        return list(self.proto.get("input", []))


_TEST_SKIP_TYPES = {"Data", "ImageData", "HDF5Data", "Accuracy",
                    "SoftmaxWithLoss", "Silence", "Split"}


def _conv_module(p: dict, dev) -> nn.Module:
    num_out = _g1(p, "num_output")
    ks = _g1(p, "kernel_size")
    kh = _g1(p, "kernel_h", ks)
    kw = _g1(p, "kernel_w", ks)
    stride = _g1(p, "stride", 1)
    sh = _g1(p, "stride_h", stride)
    sw = _g1(p, "stride_w", stride)
    pad = _g1(p, "pad", 0)
    ph = _g1(p, "pad_h", pad)
    pab = _g1(p, "pad_w", pad)
    group = _g1(p, "group", 1)
    bias = _g1(p, "bias_term", True)
    dilation = _g1(p, "dilation", 1)
    n_in = p["__n_in__"]
    if dilation and dilation > 1:
        return nn.SpatialDilatedConvolution(n_in, num_out, kw, kh, sw, sh,
                                            pab, ph, dilation, dilation,
                                            device=dev)
    return nn.SpatialConvolution(n_in, num_out, kw, kh, sw, sh, pab, ph,
                                 n_group=group, with_bias=bool(bias),
                                 device=dev)


def _pool_module(p: dict) -> nn.Module:
    mode = _g1(p, "pool", "MAX")
    if _g1(p, "global_pooling", False):
        return nn.SpatialAveragePooling(1, 1, global_pooling=True) \
            if mode in ("AVE", 1) else _GlobalMaxPool()
    ks = _g1(p, "kernel_size")
    kh = _g1(p, "kernel_h", ks)
    kw = _g1(p, "kernel_w", ks)
    stride = _g1(p, "stride", 1)
    sh = _g1(p, "stride_h", stride)
    sw = _g1(p, "stride_w", stride)
    pad = _g1(p, "pad", 0)
    ph = _g1(p, "pad_h", pad)
    pb = _g1(p, "pad_w", pad)
    # caffe defaults to CEIL; round_mode: FLOOR (enum 1) opts out
    ceil = _g1(p, "round_mode", "CEIL") not in ("FLOOR", 1)
    if mode in ("MAX", 0):
        mp = nn.SpatialMaxPooling(kw, kh, sw, sh, pb, ph)
        return mp.ceil() if ceil else mp
    return nn.SpatialAveragePooling(kw, kh, sw, sh, pb, ph, ceil_mode=ceil)


class _GlobalMaxPool(nn.Module):
    def forward(self, x):
        return torch.amax(x, dim=(2, 3), keepdim=True)


class _Flatten(nn.Module):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class _InnerProduct(nn.Module):
    """Flatten trailing dims then Linear (caffe IP semantics, axis=1).
    With no caffemodel blobs the fan-in is unknown until the first call
    (prototxt-only load): the Linear is then built at that call, on the
    input's device and dtype."""

    def __init__(self, n_in: Optional[int], n_out: int, bias: bool, *,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        self.n_out, self.with_bias = n_out, bias
        if n_in is not None:
            self.linear = nn.Linear(n_in, n_out, with_bias=bias,
                                    device=device, dtype=dtype)
        else:
            self.linear = None

    def forward(self, x):
        flat = x.reshape(x.shape[0], -1)
        if self.linear is None:
            self.linear = nn.Linear(int(flat.shape[1]), self.n_out,
                                    with_bias=self.with_bias,
                                    device=x.device, dtype=x.dtype)
        return self.linear(flat)


class CaffeLoader:
    """≙ CaffeLoader.loadCaffe (utils/caffe/CaffeLoader.scala:85-127)."""

    def __init__(self, def_path: str, model_path: Optional[str] = None,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        with open(def_path) as f:
            self.net = _CaffeNet(parse_prototxt(f.read()))
        self.weights: Dict[str, List[np.ndarray]] = {}
        if model_path is not None:
            with open(model_path, "rb") as f:
                for rec in parse_caffemodel(f.read()):
                    if rec["blobs"]:
                        self.weights[rec["name"]] = rec["blobs"]

    # ---------------------------------------------------------------- build
    def load(self, input_channels: int = 3):
        """Build the Graph and copy weights. Returns (model, input_names).
        ``input_dim`` lines in the prototxt (N, C, H, W) override the
        ``input_channels`` default."""
        dims = self.net.proto.get("input_dim", [])
        if len(dims) >= 2:
            input_channels = int(dims[1])
        defs = [d for d in self.net.layer_defs()
                if not self._is_train_only(d)]
        blob_node: Dict[str, nn.Node] = {}
        blob_channels: Dict[str, int] = {}
        inputs = []

        for name in self.net.input_names():
            node = nn.Input()
            blob_node[name] = node
            blob_channels[name] = input_channels
            inputs.append(node)

        named_modules: Dict[str, nn.Module] = {}
        outputs_order: List[nn.Node] = []
        consumed = set()

        for d in defs:
            ltype = str(_g1(d, "type", ""))
            name = str(_g1(d, "name", ""))
            if ltype in ("Input",):
                node = nn.Input()
                for top in d.get("top", []):
                    blob_node[top] = node
                    blob_channels[top] = input_channels
                inputs.append(node)
                continue
            if ltype in _TEST_SKIP_TYPES:
                # pass-through: map tops to bottom's node where possible
                bots = d.get("bottom", [])
                for top in d.get("top", []):
                    if bots and bots[0] in blob_node:
                        blob_node[top] = blob_node[bots[0]]
                        blob_channels[top] = blob_channels.get(bots[0], input_channels)
                continue

            bots = [b for b in d.get("bottom", [])]
            module, out_channels = self._convert(ltype, d, bots, blob_channels)
            if module is None:
                raise ValueError(f"unsupported caffe layer type {ltype!r} ({name})")
            module.set_name(name)
            named_modules[name] = module
            prev = [blob_node[b] for b in bots]
            consumed.update(id(p) for p in prev)
            node = module.inputs(*prev)
            for top in d.get("top", []):
                blob_node[top] = node
                blob_channels[top] = out_channels
            outputs_order.append(node)

        # outputs = nodes never consumed as a bottom at build time
        outs = [n for n in outputs_order if id(n) not in consumed] \
            or outputs_order[-1:]

        model = nn.Graph(inputs, outs)
        self._copy_weights(named_modules)
        return model, inputs

    def _is_train_only(self, d: dict) -> bool:
        for inc in d.get("include", []):
            if isinstance(inc, dict) and _g1(inc, "phase") in ("TRAIN", 0):
                return True
        return False

    def _convert(self, ltype: str, d: dict, bots, blob_channels):
        n_in = blob_channels.get(bots[0], 3) if bots else 3
        if ltype == "Convolution":
            p = _g1(d, "convolution_param", {})
            p = dict(p)
            p["__n_in__"] = n_in
            m = _conv_module(p, self.device)
            return m, _g1(p, "num_output")
        if ltype == "Pooling":
            return _pool_module(_g1(d, "pooling_param", {})), n_in
        if ltype == "InnerProduct":
            p = _g1(d, "inner_product_param", {})
            num_out = _g1(p, "num_output")
            blobs = self.weights.get(str(_g1(d, "name", "")))
            if blobs:
                in_features = int(np.prod(blobs[0].shape[1:])) \
                    if blobs[0].ndim > 1 else blobs[0].shape[0] // num_out
            else:
                in_features = None  # prototxt-only: lazy build on first call
            return _InnerProduct(in_features, num_out,
                                 bool(_g1(p, "bias_term", True)),
                                 device=self.device), num_out
        if ltype == "ReLU":
            return nn.ReLU(), n_in
        if ltype == "Sigmoid":
            return nn.Sigmoid(), n_in
        if ltype == "TanH":
            return nn.Tanh(), n_in
        if ltype == "LRN":
            p = _g1(d, "lrn_param", {})
            return nn.SpatialCrossMapLRN(
                _g1(p, "local_size", 5), _g1(p, "alpha", 1.0),
                _g1(p, "beta", 0.75), _g1(p, "k", 1.0)), n_in
        if ltype == "Concat":
            p = _g1(d, "concat_param", {})
            axis = _g1(p, "axis", _g1(p, "concat_dim", 1))
            total = sum(blob_channels.get(b, 0) for b in bots) if axis == 1 else n_in
            return nn.JoinTable(axis + 1), total
        if ltype == "Dropout":
            p = _g1(d, "dropout_param", {})
            return nn.Dropout(_g1(p, "dropout_ratio", 0.5)), n_in
        if ltype == "Softmax":
            return nn.SoftMax(), n_in
        if ltype == "Eltwise":
            p = _g1(d, "eltwise_param", {})
            op = _g1(p, "operation", "SUM")
            if op in ("SUM", 1):
                return nn.CAddTable(), n_in
            if op in ("PROD", 0):
                return nn.CMulTable(), n_in
            return nn.CMaxTable(), n_in
        if ltype == "BatchNorm":
            p = _g1(d, "batch_norm_param", {})
            return nn.SpatialBatchNormalization(
                n_in, _g1(p, "eps", 1e-5), affine=False,
                device=self.device), n_in
        if ltype == "Scale":
            p = _g1(d, "scale_param", {})
            return _ScaleModule(n_in, bool(_g1(p, "bias_term", False)),
                                device=self.device), n_in
        if ltype == "Flatten":
            return _Flatten(), n_in
        return None, n_in

    # --------------------------------------------------------------- weights
    def _copy_weights(self, named_modules: Dict[str, nn.Module]) -> None:
        """≙ CaffeLoader.copyParameters (CaffeLoader.scala:255-299)."""
        for name, blobs in self.weights.items():
            m = named_modules.get(name)
            if m is None:
                continue
            target = m.linear if isinstance(m, _InnerProduct) else m
            if isinstance(target, (nn.SpatialConvolution, nn.Linear)):
                _assign(target.weight, blobs[0])
                if len(blobs) > 1 and "bias" in target._parameters:
                    _assign(target.bias, blobs[1])
            elif isinstance(target, nn.SpatialBatchNormalization):
                # caffe BatchNorm blobs: mean, var, scale_factor
                sf = float(blobs[2].reshape(-1)[0]) if len(blobs) > 2 else 1.0
                sf = 1.0 / sf if sf != 0 else 1.0
                _assign(target.running_mean, blobs[0].reshape(-1) * sf)
                _assign(target.running_var, blobs[1].reshape(-1) * sf)
            elif isinstance(target, _ScaleModule):
                _assign(target.weight, blobs[0])
                if len(blobs) > 1 and "bias" in target._parameters:
                    _assign(target.bias, blobs[1])


def _assign(dst: torch.Tensor, arr: np.ndarray) -> None:
    """``dst``'s values, in place, from the host array ``arr``."""
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.ascontiguousarray(arr))
                  .reshape(dst.shape))


class _ScaleModule(nn.Module):
    """Per-channel affine (caffe Scale layer, usually after BatchNorm) on
    axis 1 of an input of any rank: the JAX package's broadcasts as if
    the input were 4-D, so a Scale after a 2-D blob (a BatchNorm after an
    InnerProduct) comes out of the wrong shape there."""

    def __init__(self, n: int, bias: bool, *, device=DEFAULT_DEVICE,
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.new_param("weight", torch.ones(n), dev, dtype)
        if bias:
            self.new_param("bias", torch.zeros(n), dev, dtype)
        self.has_bias = bias

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        out = x * self.weight.reshape(shape)
        if self.has_bias:
            out = out + self.bias.reshape(shape)
        return out


def load_caffe(def_path: str, model_path: Optional[str] = None,
               input_channels: int = 3, device=DEFAULT_DEVICE):
    """≙ Module.loadCaffeModel (nn/Module.scala:80). Returns the Graph, on
    ``device``."""
    model, _ = CaffeLoader(def_path, model_path, device).load(input_channels)
    return model
