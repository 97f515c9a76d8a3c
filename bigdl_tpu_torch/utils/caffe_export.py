"""Export a module tree to Caffe prototxt + caffemodel (port of
``bigdl_tpu/utils/caffe_export.py``).

Reference: utils/caffe/CaffePersister.scala (+ per-layer Converter
methods): walks the module graph, emits V2 LayerParameters with blobs.
Here the NetParameter binary is encoded with utils/protowire using the
same field numbers utils/caffe.py's importer reads (layer=100,
name=1/type=2/bottom=3/top=4/blobs=7; BlobProto shape=7/data=5), so
export -> import round-trips exactly.

Supported: Linear (InnerProduct), SpatialConvolution (Convolution),
SpatialMaxPooling/SpatialAveragePooling (Pooling), ReLU, Tanh, Sigmoid,
SoftMax (Softmax), Dropout, View/Reshape (Flatten when collapsing),
SpatialBatchNormalization (Scale with folded stats, inference-only).

The weights are copied to the host as f32 numpy arrays and folded with
the JAX package's numpy arithmetic, so the same weights give the same
prototxt text and caffemodel bytes, from the card or from the CPU.
"""

from __future__ import annotations

from typing import List

import numpy as np

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils import protowire as pw


def host_f32(t) -> np.ndarray:
    """``t`` as an f32 numpy array on the host."""
    if torch.is_tensor(t):
        return t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, np.float32)


def _blob(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr, np.float32)
    shape = pw.enc_bytes(7, b"".join(pw.enc_varint(1, int(d))
                                     for d in arr.shape))
    # packed little-endian f32 IS the wire format — single tobytes
    data = pw.enc_bytes(5, np.ascontiguousarray(arr, "<f4").tobytes())
    return shape + data


def _layer_bin(name: str, type_: str, bottoms: List[str], tops: List[str],
               blobs: List[np.ndarray]) -> bytes:
    body = pw.enc_string(1, name) + pw.enc_string(2, type_)
    for b in bottoms:
        body += pw.enc_string(3, b)
    for t in tops:
        body += pw.enc_string(4, t)
    for blob in blobs:
        body += pw.enc_bytes(7, _blob(blob))
    return pw.enc_bytes(100, body)


def _flatten_modules(module: Module) -> List[Module]:
    from bigdl_tpu_torch.nn.container import flatten_sequential

    return flatten_sequential(module)


def save_caffe(module: Module, prototxt_path: str, model_path: str,
               input_shape=None) -> None:
    """≙ Module.saveCaffe / CaffePersister.persist. ``input_shape`` is the
    sample shape sans batch for the prototxt input declaration."""
    proto_lines = ['name: "bigdl_tpu_export"', 'input: "data"']
    if input_shape is not None:
        for d in (1,) + tuple(input_shape):
            proto_lines.append(f"input_dim: {int(d)}")
    bins: List[bytes] = []
    bottom = "data"
    idx = 0

    def emit(type_: str, params: List[str], blobs: List[np.ndarray],
             name_hint: str):
        nonlocal bottom, idx
        idx += 1
        name = f"{name_hint}{idx}"
        top = name
        lines = ["layer {", f'  name: "{name}"', f'  type: "{type_}"',
                 f'  bottom: "{bottom}"', f'  top: "{top}"']
        lines += [f"  {p}" for p in params]
        lines.append("}")
        proto_lines.extend(lines)
        bins.append(_layer_bin(name, type_, [bottom], [top], blobs))
        bottom = top

    for m in _flatten_modules(module):
        cls = type(m).__name__
        if isinstance(m, nn.Linear):
            w = host_f32(m.weight)  # (out, in) = caffe IP blob layout
            blobs = [w]
            if getattr(m, "with_bias", True) and hasattr(m, "bias"):
                blobs.append(host_f32(m.bias))
            emit("InnerProduct",
                 ["inner_product_param {",
                  f"    num_output: {w.shape[0]}",
                  "  }"], blobs, "ip")
        elif isinstance(m, nn.SpatialConvolution):
            w = host_f32(m.weight)  # OIHW = caffe conv blob layout
            blobs = [w]
            if m.with_bias:
                blobs.append(host_f32(m.bias))
            pad_h, pad_w = m.pad_h, m.pad_w
            if pad_h == -1 or pad_w == -1:  # SAME sentinel
                if (m.stride_h, m.stride_w) != (1, 1) or \
                        m.kernel_h % 2 == 0 or m.kernel_w % 2 == 0:
                    raise ValueError(
                        "SAME conv padding only exports to caffe for "
                        "stride-1 odd kernels (symmetric pad)")
                pad_h = (m.kernel_h - 1) // 2
                pad_w = (m.kernel_w - 1) // 2
            emit("Convolution",
                 ["convolution_param {",
                  f"    num_output: {w.shape[0]}",
                  f"    kernel_h: {m.kernel_h}",
                  f"    kernel_w: {m.kernel_w}",
                  f"    stride_h: {m.stride_h}",
                  f"    stride_w: {m.stride_w}",
                  f"    pad_h: {pad_h}",
                  f"    pad_w: {pad_w}",
                  f"    group: {m.n_group}",
                  "  }"], blobs, "conv")
        elif isinstance(m, (nn.SpatialMaxPooling, nn.SpatialAveragePooling)):
            mode = "MAX" if isinstance(m, nn.SpatialMaxPooling) else "AVE"
            round_mode = "CEIL" if m.ceil_mode else "FLOOR"
            emit("Pooling",
                 ["pooling_param {", f"    pool: {mode}",
                  f"    kernel_h: {m.kh}", f"    kernel_w: {m.kw}",
                  f"    stride_h: {m.dh}", f"    stride_w: {m.dw}",
                  f"    pad_h: {m.pad_h}", f"    pad_w: {m.pad_w}",
                  f"    round_mode: {round_mode}",
                  "  }"], [], "pool")
        elif isinstance(m, nn.ReLU):
            emit("ReLU", [], [], "relu")
        elif isinstance(m, nn.Tanh):
            emit("TanH", [], [], "tanh")
        elif isinstance(m, nn.Sigmoid):
            emit("Sigmoid", [], [], "sigmoid")
        elif isinstance(m, nn.SoftMax):
            emit("Softmax", [], [], "prob")
        elif isinstance(m, nn.Dropout):
            continue  # inference export
        elif isinstance(m, (nn.View, nn.Reshape)):
            dims = getattr(m, "sizes", getattr(m, "size", None))
            if dims is not None and len(tuple(dims)) != 1:
                raise ValueError(
                    "only collapsing View/Reshape (rank-1 target) exports "
                    "as caffe Flatten")
            emit("Flatten", [], [], "flat")
        elif isinstance(m, (nn.SpatialBatchNormalization,
                            nn.BatchNormalization)):
            mean = host_f32(m.running_mean)
            var = host_f32(m.running_var)
            gamma = host_f32(m.weight) if m.affine else np.ones_like(mean)
            beta = host_f32(m.bias) if m.affine else np.zeros_like(mean)
            scale = gamma / np.sqrt(var + m.eps)
            emit("Scale", ["scale_param { bias_term: true }"],
                 [scale.astype(np.float32),
                  (beta - mean * scale).astype(np.float32)], "scale")
        elif isinstance(m, nn.Identity):
            continue
        else:
            raise ValueError(f"caffe export: unsupported layer {cls}")

    with open(prototxt_path, "w") as f:
        f.write("\n".join(proto_lines) + "\n")
    net = pw.enc_string(1, "bigdl_tpu_export") + b"".join(bins)
    with open(model_path, "wb") as f:
        f.write(net)
