"""Thin module base over ``torch.nn.Module``.

Port of the parts of ``bigdl_tpu/nn/module.py`` the inference and
training slices need: parameter and buffer naming (``new_param`` /
``new_buffer``), modes (``training_mode`` / ``evaluate`` /
``is_training``), module names, freezing (``freeze`` / ``unfreeze`` /
``trainable_dict``), the trees ``params_dict`` / ``buffers_dict`` and
their checked loaders ``load_params_dict`` / ``load_buffers_dict``
(:func:`load_tree`, which the weight bridge uses too), and
per-parameter regularizers (``regularization_loss``), and the eager
API of ``bigdl_tpu/nn/module.py:230-517`` (see :class:`Module`).
Parameters and buffers are registered under the same names as in the JAX package, so
:meth:`Module.params_dict` returns the JAX ``params_dict()`` tree key
for key: ``{child: {...}, "~params": {name: tensor}}``, and
:meth:`Module.buffers_dict` the ``"~buffers"`` tree.

:func:`tree_leaves` flattens such a tree in the JAX package's leaf order
(``jax.tree.leaves`` sorts dict keys) with each leaf's dotted parameter
name (``block0.attn.qkv.weight``).
"""

from __future__ import annotations

import copy
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from bigdl_tpu_torch.utils.table import Table

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


# ------------------------------------------------------------ RNG replay
def _generator_states(module: torch.nn.Module) -> List[Tuple[object, object]]:
    """(generator key, state) of every stream a forward of ``module`` may
    draw from: the explicit generators of its layers (a Dropout's
    ``generator``), the CPU default generator and, once CUDA is up, the
    default generator of each card its tensors live on (or of the
    current card). The key is the generator itself, or ``("cuda", i)``
    / ``"cpu"`` for the defaults."""
    seen, cards = {}, set()
    for m in module.modules():
        g = getattr(m, "generator", None)
        if isinstance(g, torch.Generator):
            seen[id(g)] = g
        cards.update(t.device.index for t in
                     (*m._parameters.values(), *m._buffers.values())
                     if t is not None and t.is_cuda)
    out = [(g, g.get_state()) for g in seen.values()]
    out.append(("cpu", torch.get_rng_state()))
    if torch.cuda.is_initialized():
        cards.add(torch.cuda.current_device())
        out.extend((("cuda", i), torch.cuda.get_rng_state(i))
                   for i in sorted(cards))
    return out


def _get_state(key):
    if key == "cpu":
        return torch.get_rng_state()
    if isinstance(key, tuple):
        return torch.cuda.get_rng_state(key[1])
    return key.get_state()


def _set_state(key, state) -> None:
    if key == "cpu":
        torch.set_rng_state(state)
    elif isinstance(key, tuple):
        torch.cuda.set_rng_state(state, key[1])
    else:
        key.set_state(state)


@contextmanager
def _replaying(states):
    """Every stream in ``states`` set back to its recorded state for the
    body, then to where it was before: a replayed forward draws what the
    recorded one drew and the streams go on as if it had not run."""
    now = [(key, _get_state(key)) for key, _ in states]
    for key, state in states:
        _set_state(key, state)
    try:
        yield
    finally:
        for key, state in now:
            _set_state(key, state)


def activity_tensors(activity) -> List:
    """The tensors of an activity (a tensor, a Table, a list or tuple)."""
    if isinstance(activity, Table):
        return [x for v in activity.values() for x in activity_tensors(v)]
    if isinstance(activity, (list, tuple)):
        return [x for v in activity for x in activity_tensors(v)]
    return [activity] if torch.is_tensor(activity) else []


def with_tensors(activity, leaves: Iterator):
    """``activity`` with its tensors replaced, in
    :func:`activity_tensors` order, by ``leaves``."""
    if isinstance(activity, Table):
        out = Table()
        for k, v in activity.items():
            out[k] = with_tensors(v, leaves)
        return out
    if isinstance(activity, (list, tuple)):
        return type(activity)(with_tensors(v, leaves) for v in activity)
    return next(leaves) if torch.is_tensor(activity) else activity


class Module(torch.nn.Module):
    """Base of the port's layers.

    The eager API of the JAX package: ``backward(input, grad_output)``
    recomputes the forward under autograd and accumulates each
    parameter's gradient in ``param.grad`` until
    ``zero_grad_parameters``; ``update_grad_input``, ``grads_dict`` /
    ``load_grads_dict``, ``get_parameters`` (a flat copy, as in JAX),
    ``update_parameters``, ``copy_parameters_from``, ``clone_module``,
    ``save`` / ``load`` and ``predict`` / ``predict_class`` /
    ``evaluate_on``. The JAX package's ``parameters()`` pair of lists is
    :meth:`parameters_and_grads`: ``parameters()`` stays the iterator
    PyTorch and the port's train step use.

    A layer that draws random numbers sets ``draws_random``. In training
    mode a call of a module holding one records the state of every
    generator the forward may draw from, and ``backward`` replays the
    forward from those states, so a Dropout's mask in the backward is the
    forward's (the JAX package's ``_forward_key``).

    Also ported: ``inputs`` (graph wiring, ``nn/graph.py``),
    ``set_training``, ``is_container``, ``reset`` (layers
    with weights draw them again), ``quantize`` and the host timings
    ``get_times`` / ``get_times_group_by_module_type`` / ``reset_times``
    (each call and ``backward`` adds its host seconds)."""

    _instance_counters: Dict[str, int] = {}
    draws_random = False

    def __init__(self):
        super().__init__()
        cls = type(self).__name__
        n = Module._instance_counters.get(cls, 0)
        Module._instance_counters[cls] = n + 1
        self._default_name = f"{cls}{n}"
        self._name: Optional[str] = None
        self._frozen = False
        self._regularizers: Dict[str, object] = {}
        self._forward_rng = None
        self.grad_input = None
        self._forward_time = 0.0
        self._backward_time = 0.0

    def __call__(self, *args, **kwargs):
        if self.training and any(m.draws_random for m in self.modules()
                                 if isinstance(m, Module)):
            self._forward_rng = _generator_states(self)
        t0 = time.perf_counter()
        try:
            return super().__call__(*args, **kwargs)
        finally:
            self._forward_time += time.perf_counter() - t0

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

    def inputs(self, *nodes):
        """This module wired into a graph after ``nodes``: a new
        :class:`~bigdl_tpu_torch.nn.graph.Node` (see ``nn/graph.py``)."""
        from bigdl_tpu_torch.nn.graph import Node

        return Node(self).inputs(*nodes)

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

    def set_training(self, flag: bool) -> "Module":
        return self.train(flag)

    def is_container(self) -> bool:
        """Whether this module holds sub-modules."""
        return bool(self._modules)

    def reset(self) -> None:
        """Initialize the parameters again: each sub-module's ``reset``;
        the layers with weights (``Linear``, ``SpatialConvolution``)
        draw theirs again."""
        for child in self.children():
            if isinstance(child, Module):
                child.reset()

    # ----------------------------------------------------------- timing
    def get_times(self):
        """``[(module, forward_s, backward_s)]`` for this module and each
        one under it: the host seconds spent in its calls and in its
        ``backward`` since the last :meth:`reset_times`. A call on the
        card returns once its work is queued, so on the card these are
        the host's times, not the device's."""
        return [(m, m._forward_time, m._backward_time)
                for m in self._port_modules()]

    def get_times_group_by_module_type(self):
        """``{class name: (forward_s, backward_s)}`` summed over
        :meth:`get_times`."""
        agg: Dict[str, List[float]] = {}
        for m, f, b in self.get_times():
            t = agg.setdefault(type(m).__name__, [0.0, 0.0])
            t[0] += f
            t[1] += b
        return {k: tuple(v) for k, v in agg.items()}

    def reset_times(self) -> None:
        for m in self._port_modules():
            m._forward_time = 0.0
            m._backward_time = 0.0

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


    # ------------------------------------------------------ eager API
    def _vjp(self, input, grad_output, with_params: bool):
        """(grad of input, grads of every parameter or None): the forward
        recomputed under autograd (the caller's forward may have run
        under ``no_grad``) from the generator states of the last call,
        with every buffer the recompute writes (BatchNorm's running
        statistics) set back afterwards."""
        xs = [x.detach().requires_grad_(x.is_floating_point())
              for x in activity_tensors(input)]
        x = with_tensors(input, iter(xs))
        params = list(self.parameters()) if with_params else []
        wrt = [t for t in xs + params if t.requires_grad]
        saved = [(m._buffers, k, b) for m in self.modules()
                 for k, b in m._buffers.items()]
        try:
            with _replaying(self._forward_rng or []), torch.enable_grad():
                out = self.forward(x)
        finally:
            for table, k, b in saved:
                table[k] = b
        outs, gos = activity_tensors(out), activity_tensors(grad_output)
        pairs = [(o, g) for o, g in zip(outs, gos) if o.requires_grad]
        grads = torch.autograd.grad([o for o, _ in pairs],
                                    wrt, [g for _, g in pairs],
                                    allow_unused=True) if pairs and wrt \
            else [None] * len(wrt)
        by_id = {id(t): g for t, g in zip(wrt, grads)}

        def grad_of(t):
            g = by_id.get(id(t))
            return torch.zeros_like(t) if g is None and t.is_floating_point() \
                else g

        dinput = with_tensors(input, iter([grad_of(t) for t in xs]))
        return dinput, [grad_of(p) for p in params]

    def backward(self, input, grad_output):
        """gradInput of the last forward, and every parameter's gradient
        added to ``param.grad`` (the JAX package's ``_gradients``)."""
        t0 = time.perf_counter()
        dinput, dparams = self._vjp(input, grad_output, with_params=True)
        with torch.no_grad():
            for p, g in zip(self.parameters(), dparams):
                p.grad = g.detach().clone() if p.grad is None \
                    else p.grad + g
        self.grad_input = dinput
        self._backward_time += time.perf_counter() - t0
        return dinput

    def update_grad_input(self, input, grad_output):
        """gradInput only: no parameter gradient is accumulated."""
        self.grad_input, _ = self._vjp(input, grad_output, with_params=False)
        return self.grad_input

    def _grad(self, p: torch.Tensor) -> torch.Tensor:
        return p.grad if p.grad is not None else torch.zeros_like(p)

    def parameters_and_grads(self) -> Tuple[List[torch.Tensor],
                                            List[torch.Tensor]]:
        """(weights, gradients) in tree order: the JAX package's
        ``parameters()``."""
        ws = list(self.parameters())
        return ws, [self._grad(p) for p in ws]

    def get_parameters(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flat 1-D (weights, gradients): a copy, as in the JAX package
        (the reference's views into one storage are not kept)."""
        ws, gs = self.parameters_and_grads()
        if not ws:
            return torch.zeros(0), torch.zeros(0)
        return (torch.cat([w.detach().reshape(-1) for w in ws]),
                torch.cat([g.detach().reshape(-1) for g in gs]))

    def grads_dict(self) -> Dict:
        """The gradients as a :meth:`params_dict`-shaped tree (zeros
        where nothing was accumulated)."""
        return self._tree(PARAMS_KEY, lambda m: {
            n: m._grad(p) for n, p in m.named_parameters(recurse=False)})

    def load_grads_dict(self, d: Dict) -> None:
        """Set the gradients from a :meth:`grads_dict`-shaped tree."""
        params = dict(tree_leaves(self.params_dict()))
        for name, g in tree_leaves(d):
            p = params[name]
            p.grad = torch.as_tensor(g).to(device=p.device, dtype=p.dtype)

    def zero_grad_parameters(self) -> None:
        for p in self.parameters():
            p.grad = torch.zeros_like(p)

    def update_parameters(self, learning_rate: float) -> None:
        """Eager SGD step: ``p - learning_rate * grad`` for every
        parameter, in place."""
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(p - learning_rate * self._grad(p))

    def copy_parameters_from(self, other: "Module") -> "Module":
        self.load_params_dict(other.params_dict())
        self.load_buffers_dict(other.buffers_dict())
        return self

    def clone_module(self) -> "Module":
        return copy.deepcopy(self)

    def quantize(self) -> "Module":
        """The int8 clone for inference (``Quantizer.quantize``)."""
        from bigdl_tpu_torch.nn.quantized import Quantizer

        return Quantizer.quantize(self)

    def save(self, path: str, overwrite: bool = False) -> "Module":
        """Pickle this module with its tensors on the host
        (``utils/file.py``)."""
        from bigdl_tpu_torch.utils import file as bt_file

        bt_file.save_module(self, path, overwrite=overwrite)
        return self

    @staticmethod
    def load(path: str, device="cuda") -> "Module":
        """A module saved by :meth:`save`, on ``device`` (default: the
        card; ``device="cpu"`` on a machine without one)."""
        from bigdl_tpu_torch.utils import file as bt_file

        return bt_file.load_module(path, device=device)

    def save_module(self, path: str, overwrite: bool = False):
        raise NotImplementedError(
            "the structured serializer (saveModule) is not ported yet: "
            "see ROADMAP.md, Queue 1 item 12; Module.save pickles")

    @staticmethod
    def load_module(path: str):
        raise NotImplementedError(
            "the structured serializer (loadModule) is not ported yet: "
            "see ROADMAP.md, Queue 1 item 12; Module.load reads pickles")

    # ------------------------------------------------------ inference
    def predict(self, dataset, batch_size: int = 32):
        from bigdl_tpu_torch.optim.predictor import LocalPredictor

        return LocalPredictor(self, batch_size=batch_size).predict(dataset)

    def predict_class(self, dataset, batch_size: int = 32):
        from bigdl_tpu_torch.optim.predictor import LocalPredictor

        return LocalPredictor(self, batch_size=batch_size).predict_class(
            dataset)

    def evaluate_on(self, dataset, methods, batch_size: int = 32):
        from bigdl_tpu_torch.optim.evaluator import Evaluator

        return Evaluator(self).test(dataset, methods, batch_size=batch_size)
