"""Weight bridge between the JAX package's parameter tree and the port.

The JAX package's ``params_dict()`` is a nested dict
``{child: {...}, "~params": {name: array}}``; the port's modules register
the same children and parameters under the same names (see
``nn/module.py``), so the bridge converts the leaves to tensors and
loads them with the module's checked, key-for-key loader.
No layout needs a transpose: Linear weights are (out, in) and conv
weights (out, in / groups, kH, kW) on both sides (a channels-last conv
weight of the NHWC format keeps its shape; the copy fills its strides).
:func:`load_jax_params` takes the tree with its leaves converted to
numpy arrays; :func:`params_to_numpy` gives the way back. Buffers (the
``"~buffers"`` tree of ``buffers_dict()``: BatchNorm's running
statistics) cross the same way with :func:`load_jax_buffers` and
:func:`buffers_to_numpy`, under the same key, shape and dtype rules.
:func:`resnet_ref_params_from_jax` carries the raw ResNet-50 step's
parameter list (``models/jax_resnet_ref.py`` to
``models/torch_resnet_ref.py``), whose convolution weights do need a
transpose (HWIO to OIHW).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.nn.module import PARAMS_KEY


def _walk(tree: Dict, path=()):
    for key in sorted(tree):
        sub = tree[key]
        if key == PARAMS_KEY:
            for name in sorted(sub):
                yield path + (PARAMS_KEY, name), sub[name]
        else:
            yield from _walk(sub, path + (key,))


def jax_param_names(model) -> List[Tuple[str, str]]:
    """``(JAX tree path, port parameter name)`` for every parameter,
    e.g. ``("block0/attn/qkv/~params/weight", "block0.attn.qkv.weight")``."""
    return [("/".join(path),
             ".".join(p for p in path if p != PARAMS_KEY))
            for path, _ in _walk(model.params_dict())]


def _as_array(value) -> np.ndarray:
    arr = np.asarray(value)
    if arr.dtype.kind not in "fiub":   # e.g. ml_dtypes' bfloat16
        arr = arr.astype(np.float32)
    return arr


def _tensors(tree: Dict) -> Dict:
    """The tree with each numpy leaf as a CPU tensor (a copy)."""
    return {key: (_tensors(sub) if isinstance(sub, dict)
                  else torch.tensor(_as_array(sub)))
            for key, sub in tree.items()}


def load_jax_params(model, params: Dict) -> None:
    """Copy the JAX ``params_dict()`` tree ``params`` (numpy leaves) into
    ``model``, casting to each parameter's dtype and device. Raises on a
    missing or extra key or a shape mismatch."""
    model.load_params_dict(_tensors(params))


def load_jax_buffers(model, buffers: Dict) -> None:
    """Copy the JAX ``buffers_dict()`` tree ``buffers`` (numpy leaves)
    into ``model``'s buffers, as :func:`load_jax_params` does for the
    parameters (each buffer keeps its own dtype: f32 statistics stay
    f32)."""
    model.load_buffers_dict(_tensors(buffers))


def _to_numpy(tree: Dict) -> Dict:
    """Copies (never views of the tensors, which the loaders overwrite in
    place), floating leaves as f32."""
    def conv(node):
        return {key: (conv(sub) if isinstance(sub, dict) else
                      sub.detach().cpu().float().numpy().copy()
                      if sub.is_floating_point()
                      else sub.detach().cpu().numpy().copy())
                for key, sub in node.items()}

    return conv(tree)


def params_to_numpy(model_or_tree) -> Dict:
    """The JAX ``params_dict()`` tree of a port model (or of a tree shaped
    like its ``params_dict()``, such as the train step's ``params``) with
    numpy leaves; bf16 leaves become f32, which numpy can hold."""
    return _to_numpy(model_or_tree.params_dict()
                     if isinstance(model_or_tree, torch.nn.Module)
                     else model_or_tree)


def buffers_to_numpy(model_or_tree) -> Dict:
    """The JAX ``buffers_dict()`` tree of a port model (or of a tree
    shaped like it, such as the train step's ``buffers``) with numpy
    leaves."""
    return _to_numpy(model_or_tree.buffers_dict()
                     if isinstance(model_or_tree, torch.nn.Module)
                     else model_or_tree)


def resnet_ref_params_from_jax(arrays, device="cuda") -> List[torch.Tensor]:
    """The parameter list of ``bigdl_tpu/models/jax_resnet_ref.py``'s
    ``init_params`` (numpy leaves, in its order) as the parameters of
    ``bigdl_tpu_torch/models/torch_resnet_ref.py``, whose layout program
    has the same indices: each HWIO convolution weight becomes OIHW,
    channels-last, the rest is copied as it is, in f32 on ``device``."""
    from bigdl_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    out = []
    for a in arrays:
        t = torch.tensor(_as_array(a), dtype=torch.float32)
        if t.dim() == 4:
            t = t.permute(3, 2, 0, 1).to(dev).contiguous(
                memory_format=torch.channels_last)
        out.append(t.to(dev))
    return out
