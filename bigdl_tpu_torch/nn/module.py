"""Thin module base over ``torch.nn.Module``.

Port of the parts of ``bigdl_tpu/nn/module.py`` the inference and
training slices need: parameter and buffer naming (``new_param`` /
``new_buffer``), modes (``training_mode`` / ``evaluate`` /
``is_training``), module names, freezing (``freeze`` / ``unfreeze`` /
``trainable_dict``), the trees ``params_dict`` / ``buffers_dict`` and
their checked loaders ``load_params_dict`` / ``load_buffers_dict``
(:func:`load_tree`, which the weight bridge uses too), and
per-parameter regularizers (``regularization_loss``). Parameters and
buffers are registered under the same names as in the JAX package, so
:meth:`Module.params_dict` returns the JAX ``params_dict()`` tree key
for key: ``{child: {...}, "~params": {name: tensor}}``, and
:meth:`Module.buffers_dict` the ``"~buffers"`` tree.

:func:`tree_leaves` flattens such a tree in the JAX package's leaf order
(``jax.tree.leaves`` sorts dict keys) with each leaf's dotted parameter
name (``block0.attn.qkv.weight``).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import torch

PARAMS_KEY = "~params"
BUFFERS_KEY = "~buffers"


def tree_leaves(tree: Dict, prefix: str = "") -> List[Tuple[str, object]]:
    """``(dotted name, leaf)`` for every leaf of a ``params_dict``-shaped
    tree (``"~params"`` / ``"~buffers"`` levels dropped from the name),
    dict keys sorted at every level as ``jax.tree.leaves`` orders them."""
    out = []
    for key in sorted(tree):
        sub = tree[key]
        if key in (PARAMS_KEY, BUFFERS_KEY):
            out.extend((prefix + name, sub[name]) for name in sorted(sub))
        else:
            out.extend(tree_leaves(sub, f"{prefix}{key}."))
    return out


def tree_unflatten(like: Dict, leaves) -> Dict:
    """The tree ``like`` with its leaves replaced, in
    :func:`tree_leaves` order, by ``leaves``."""
    it = iter(leaves)

    def build(node):
        return {key: ({n: next(it) for n in sorted(node[key])}
                      if key in (PARAMS_KEY, BUFFERS_KEY)
                      else build(node[key]))
                for key in sorted(node)}

    return build(like)


def _same_keys(ours: Dict, theirs: Dict, where: str) -> None:
    missing = sorted(set(ours) - set(theirs))
    extra = sorted(set(theirs) - set(ours))
    if missing or extra:
        raise KeyError(f"tree mismatch at {where}: missing {missing}, "
                       f"unexpected {extra}")


def load_tree(ours: Dict, theirs: Dict, leaf_key: str,
              path: Tuple[str, ...] = ()) -> None:
    """Copy the tensors of ``theirs`` into those of ``ours``, a tree of
    the same layout whose leaves sit under ``leaf_key`` (``"~params"`` or
    ``"~buffers"``), in place, each cast to its target's dtype and
    device. Raises on a missing or extra key or a shape mismatch."""
    where = "/".join(path) or "<root>"
    _same_keys(ours, theirs, where)
    for key in ours:
        if key != leaf_key:
            load_tree(ours[key], theirs[key], leaf_key, path + (key,))
            continue
        _same_keys(ours[key], theirs[key], f"{where}/{key}")
        for name, dst in ours[key].items():
            src = theirs[key][name]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(
                    f"shape mismatch at {where}/{name}: given "
                    f"{tuple(src.shape)} vs model {tuple(dst.shape)}")
            with torch.no_grad():
                dst.copy_(src)


class Module(torch.nn.Module):
    """Base of the port's layers."""

    _instance_counters: Dict[str, int] = {}

    def __init__(self):
        super().__init__()
        cls = type(self).__name__
        n = Module._instance_counters.get(cls, 0)
        Module._instance_counters[cls] = n + 1
        self._default_name = f"{cls}{n}"
        self._name: Optional[str] = None
        self._frozen = False
        self._regularizers: Dict[str, object] = {}

    def new_param(self, name: str, value: torch.Tensor, device, dtype,
                  regularizer=None) -> None:
        """Register ``value`` (an f32 CPU tensor from an init method) as
        parameter ``name``, cast to ``dtype`` on ``device``, with an
        optional ``regularizer`` (a penalty ``reg(w) -> scalar``, see
        ``optim/regularizer.py``)."""
        self.register_parameter(
            name, torch.nn.Parameter(value.to(device=device, dtype=dtype)))
        if regularizer is not None:
            self._regularizers[name] = regularizer

    def new_buffer(self, name: str, value: torch.Tensor, device,
                   dtype=torch.float32) -> None:
        """Register ``value`` as buffer ``name`` (non-trainable state,
        such as BatchNorm's running statistics), cast to ``dtype`` on
        ``device``. A layer updates a buffer by assigning a new tensor to
        it, never in place, so a train step that binds its own buffers
        reads the new values back without changing its inputs."""
        self.register_buffer(name, value.to(device=device, dtype=dtype))

    # --------------------------------------------------------- identity
    def set_name(self, name: str) -> "Module":
        self._name = name
        return self

    def get_name(self) -> str:
        """The name given by :meth:`set_name`, else the class name and a
        per-class counter (``Linear3``), as in the JAX package."""
        return self._name if self._name is not None else self._default_name

    def _port_modules(self) -> Iterator["Module"]:
        return (m for m in self.modules() if isinstance(m, Module))

    # ------------------------------------------------------------ modes
    def training_mode(self) -> "Module":
        """Training mode (the JAX package's ``training``)."""
        return self.train(True)

    def evaluate(self) -> "Module":
        """Inference mode (the JAX package's ``evaluate``)."""
        return self.eval()

    def is_training(self) -> bool:
        return self.training

    # ----------------------------------------------------------- freeze
    def freeze(self, *names: str) -> "Module":
        """Stop updates of this module's parameters (or, with ``names``,
        of the sub-modules with those names): the train step leaves them
        as they were."""
        for m in self._port_modules():
            if not names or m.get_name() in names:
                for sub in m._port_modules():
                    sub._frozen = True
        return self

    def unfreeze(self, *names: str) -> "Module":
        for m in self._port_modules():
            if not names or m.get_name() in names:
                for sub in m._port_modules():
                    sub._frozen = False
        return self

    # ------------------------------------------------------------ trees
    def _tree(self, key: str, leaf) -> Dict:
        d = {}
        own = leaf(self)
        if own:
            d[key] = own
        for name, child in self.named_children():
            sub = child._tree(key, leaf) if isinstance(child, Module) else {}
            if sub:
                d[name] = sub
        return d

    def params_dict(self) -> Dict:
        """Nested ``{child: ..., "~params": {name: tensor}}`` tree, the
        layout of the JAX package's ``params_dict()``."""
        return self._tree(PARAMS_KEY,
                          lambda m: dict(m.named_parameters(recurse=False)))

    def buffers_dict(self) -> Dict:
        """Nested ``{child: ..., "~buffers": {name: tensor}}`` tree."""
        return self._tree(BUFFERS_KEY,
                          lambda m: dict(m.named_buffers(recurse=False)))

    def load_params_dict(self, d: Dict) -> None:
        """Copy a :meth:`params_dict`-shaped tree of tensors into this
        module's parameters, in place, each cast to its parameter's dtype
        and device (the train loop's write-back of its new parameters).
        Raises on a missing or extra key or a shape mismatch."""
        load_tree(self.params_dict(), d, PARAMS_KEY)

    def load_buffers_dict(self, d: Dict) -> None:
        """Copy a :meth:`buffers_dict`-shaped tree into the buffers, as
        :meth:`load_params_dict` does for the parameters."""
        load_tree(self.buffers_dict(), d, BUFFERS_KEY)

    def trainable_dict(self) -> Dict:
        """Tree of bools mirroring :meth:`params_dict`: False where
        frozen."""
        return self._tree(PARAMS_KEY, lambda m: {
            n: not m._frozen for n, _ in m.named_parameters(recurse=False)})

    def regularization_loss(self, params: Optional[Dict] = None):
        """Sum of the per-parameter regularizer penalties over ``params``
        (a :meth:`params_dict`-shaped tree; default: this module's own
        parameters), 0.0 when no parameter has a regularizer."""
        params = params if params is not None else self.params_dict()
        total = 0.0
        own = params.get(PARAMS_KEY, {})
        for name, reg in self._regularizers.items():
            if name in own:
                total = total + reg(own[name])
        for name, child in self.named_children():
            if isinstance(child, Module) and name in params:
                total = total + child.regularization_loss(params[name])
        return total
