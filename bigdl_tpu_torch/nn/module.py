"""Thin module base over ``torch.nn.Module``.

Port of the parts of ``bigdl_tpu/nn/module.py`` the inference and
training slices need: parameter naming, modes (``training_mode`` /
``evaluate`` / ``is_training``), module names, freezing
(``freeze`` / ``unfreeze`` / ``trainable_dict``), ``buffers_dict`` and
per-parameter regularizers (``regularization_loss``). Parameters are
registered under the same names as in the JAX package, so
:meth:`Module.params_dict` returns the JAX ``params_dict()`` tree key
for key: ``{child: {...}, "~params": {name: tensor}}``.

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
