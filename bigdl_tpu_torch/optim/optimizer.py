"""The train step and the local training loop (port of ``TrainStep`` /
``make_train_step``, ``Optimizer`` and ``LocalOptimizer`` in
``bigdl_tpu/optim/optimizer.py``).

``step(params, buffers, slots, x, y, lrs, rng) -> (loss, new_params,
new_buffers, new_slots)`` keeps the JAX package's functional signature:
``params`` and ``buffers`` are trees shaped like the model's
``params_dict()`` / ``buffers_dict()``, ``slots`` one entry per optimizer
group, ``lrs`` one scheduled rate per group (``current_lrs()``), ``rng``
a ``torch.Generator`` on the model's device that every dropout layer
draws from during the step (``None``: PyTorch's default generator).
``new_buffers`` is the model's whole buffer tree as the training-mode
forward left it (BatchNorm's running statistics after this batch; a
buffer missing from ``buffers`` starts from the model's own value), each
buffer in its own dtype: f32 statistics stay f32 under bf16 compute.
The step changes none of its inputs; the model's own parameters and
buffers are left as they were.

With ``compute_dtype`` (bf16) the f32 master parameters are cast once
per step, the forward and backward run in that dtype, and the grads come
back in f32 through the cast. The step binds the (cast) tensors into the
model in place of its parameters for the forward AND the backward: the
twin of the JAX package's ``pure_apply``, held across the backward
because a checkpointed block (``remat``) recomputes its forward there
(``torch.func.functional_call`` unbinds when the forward returns, so the
recompute would read the model's own parameters). A model is therefore
stepped by one thread at a time.

Also ported: constant and global-L2 gradient clipping (``grad_clip``),
frozen parameters left unchanged, per-submodule optimizer groups
(``sub_methods``, by module name), ``grad_accum`` micro-batches with the
mean or sum combine, the buffers threaded from one micro-batch to the
next (micro-batch i's forward starts from micro-batch i-1's statistics,
as the JAX package's scan carries them) and the regularizer counted
once, and
``step_with_stats``, which also returns the pre-clip global grad norm.
New parameters are stored at each leaf's dtype.

:class:`Optimizer` is the builder; on an in-memory dataset it gives a
:class:`LocalOptimizer`, the JAX package's loop around the step: an
infinite shuffled stream of minibatches staged on the model's device by
a background thread (``dataset/prefetch.py``), the epoch counted by
records (``recordsProcessedThisEpoch``) with producer-side reshuffles,
the state table (``epoch``, ``neval``, ``Loss``, ``LearningRate``,
``score``) that triggers and schedules read, one log line per iteration
with its throughput, validation on its trigger, gradient clipping and
accumulation, and the write-back of the parameters and buffers into the
model; train and validation summaries (Loss, LearningRate and Throughput
each iteration, parameter histograms on the summary's "Parameters"
trigger, each validation method's value); checkpoints on a trigger
(``set_checkpoint``): ``model.{tag}`` and ``optimMethod.{tag}``, tag the
iteration just finished, as in the JAX loop, written in the loop or,
with ``async_write``, on a writer thread, under temporary names renamed
into place when both are written, so a failed write never leaves a torn
newest pair. The snapshot a write takes is a host copy of the model and
of the optim method, made before the next step can change a tensor in
place (pinned copies queued on the stream and an event the writer waits
on); the method carries the loop's optimizer slots (``_train_slots``),
which the JAX local loop drops, so ``load_latest_checkpoint`` and a new
``optimize()`` resume the run exactly. A ``ShardedDataSet`` trains
through the ``DistriOptimizer`` (``parallel/distri_optimizer.py``).
Observability as in the JAX loop: ``train/step``, ``train/validation``
and ``train/checkpoint`` spans, the ``bdt_train_*`` instruments (step
time, records, throughput, loss, learning rate, the pre-clip grad norm,
epoch, checkpoint time, and the distinct step signatures as the
``jit_compiles`` gauge), and the params and optimizer slots as memory
pools. With the default registry disabled the loop takes the plain step
(no grad norm). The loss and the grad norm come back in the step's one
host read. ``set_checkpoint(slots_backend="orbax")`` is accepted and
changes nothing here (the sharded slot format is the
``DistriOptimizer``'s).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

import torch

from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, ShardedDataSet,
                                             as_dataset, dataset_base,
                                             minibatches)
from bigdl_tpu_torch.dataset.prefetch import prefetch
from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.nn.dropout import bind_generator
from bigdl_tpu_torch.nn.sparse import SparseTensor
from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch.nn.module import (PARAMS_KEY, Module, tree_leaves,
                                       tree_unflatten)
from bigdl_tpu_torch.optim.evaluator import (Evaluator, batch_to_device,
                                             model_device)
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.observability import memory as obs_memory
from bigdl_tpu_torch.observability import profiler
from bigdl_tpu_torch.optim.validation import ValidationMethod
from bigdl_tpu_torch.utils import file as bt_file

logger = logging.getLogger("bigdl_tpu_torch.optim")

#: minibatches the host thread stages on the device ahead of the step
PREFETCH_DEPTH = 2


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def _clip_by_global_norm(grads, max_norm: float):
    scale = torch.clamp(max_norm / (_global_norm(grads) + 1e-12), max=1.0)
    return [(g * scale).to(g.dtype) for g in grads]


def _method_groups(model: Module, default_method: OptimMethod, sub_methods):
    """(methods, group id of each parameter leaf in :func:`tree_leaves`
    order): group 0 is ``default_method``, then one group per named
    sub-module of ``sub_methods`` ({module name: method}); a parameter
    belongs to its nearest named ancestor's group."""
    methods = [default_method]
    name_to_gid = {}
    for name, m in (sub_methods or {}).items():
        name_to_gid[name] = len(methods)
        methods.append(m)
    known = {m.get_name() for m in model.modules() if isinstance(m, Module)}
    unmatched = set(name_to_gid) - known
    if unmatched:
        raise ValueError(f"sub_methods names not found in model: "
                         f"{sorted(unmatched)}")

    def walk(module, gid):
        g = name_to_gid.get(module.get_name(), gid)
        d = {}
        own = [n for n, _ in module.named_parameters(recurse=False)]
        if own:
            d[PARAMS_KEY] = {n: g for n in own}
        for child_name, child in module.named_children():
            sub = walk(child, g)
            if sub:
                d[child_name] = sub
        return d

    return methods, [g for _, g in tree_leaves(walk(model, 0))]


def _slot(model: torch.nn.Module, name: str):
    """(the ``_parameters`` or ``_buffers`` table that holds dotted
    ``name``, its key there)."""
    owner, _, leaf = name.rpartition(".")
    mod = model.get_submodule(owner)
    return (mod._parameters if leaf in mod._parameters
            else mod._buffers), leaf


@contextmanager
def _bound(model: torch.nn.Module, tensors: Dict[str, torch.Tensor]):
    """``model`` with the parameters and buffers named in ``tensors``
    (dotted name -> tensor) replaced by those tensors until exit."""
    saved = []
    try:
        for name, value in tensors.items():
            table, leaf = _slot(model, name)
            saved.append((table, leaf, table[leaf]))
            table[leaf] = value
        yield
    finally:
        for table, leaf, old in reversed(saved):
            table[leaf] = old


@contextmanager
def _training(model: torch.nn.Module):
    """``model`` in training mode until exit, then each module back in
    its own mode."""
    modes = [(m, m.training) for m in model.modules()]
    model.train()
    try:
        yield
    finally:
        for m, mode in modes:
            m.training = mode


class TrainStep:
    """The functional train step and its grouped optimizer state (see the
    module docstring)."""

    def __init__(self, model: Module, criterion, optim_method: OptimMethod,
                 grad_clip: Optional[dict] = None, sub_methods=None,
                 compute_dtype=None, grad_accum: int = 1):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.model = model
        self.criterion = criterion
        self.grad_clip = grad_clip or {}
        self.compute_dtype = compute_dtype
        self.grad_accum = grad_accum
        self._names = [n for n, _ in tree_leaves(model.params_dict())]
        self._trainable = [t for _, t in tree_leaves(model.trainable_dict())]
        self.methods, gids = _method_groups(model, optim_method, sub_methods)
        self._idxs_per_group = [[i for i, g in enumerate(gids) if g == k]
                                for k in range(len(self.methods))]

    # ------------------------------------------------------------ grads
    def _cast(self, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.compute_dtype is None:
            return list(leaves)
        return [p.to(self.compute_dtype) if p.is_floating_point() else p
                for p in leaves]

    def _grad(self, loss, leaves):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for g, p in zip(grads, leaves)]

    def _reg(self, params, cparams):
        return self.model.regularization_loss(tree_unflatten(params,
                                                             cparams))

    def _value_and_grad(self, params, leaves, buffers, x, y, with_reg):
        """(loss, grads, new buffers) of one batch: the leaves cast to the
        compute dtype and bound into the model, with the buffers, for the
        forward and backward; the buffers the forward wrote are read back
        before the model gets its own tensors again."""
        cparams = self._cast(leaves)
        like = self.model.buffers_dict()
        tensors = dict(tree_leaves(like))
        tensors.update(tree_leaves(buffers))
        tensors.update(zip(self._names, cparams))
        with _bound(self.model, tensors):
            loss = self.criterion.forward(self.model(x), y)
            new_buffers = tree_unflatten(like, [
                table[leaf] for table, leaf in
                (_slot(self.model, n) for n, _ in tree_leaves(like))])
            if with_reg:
                loss = loss + self._reg(params, cparams)
            return loss.detach(), self._grad(loss, leaves), new_buffers

    def _loss_and_grads(self, params, buffers, x, y, rng):
        """(loss, grads in the f32 master layout, new buffers), over
        ``grad_accum`` sequential micro-batches when it is above 1."""
        leaves = [p.detach().requires_grad_(True)
                  for _, p in tree_leaves(params)]
        bind_generator(self.model, rng)
        with torch.enable_grad(), _training(self.model):
            n = self.grad_accum
            if n == 1:
                return self._value_and_grad(params, leaves, buffers, x, y,
                                            with_reg=True)
            batch = x.shape[0]
            if batch % n:
                raise ValueError(f"batch size {batch} not divisible by "
                                 f"grad_accum {n}")
            xs = x.reshape(n, batch // n, *x.shape[1:])
            ys = y.reshape(n, batch // n, *y.shape[1:])
            l_sum = torch.zeros((), device=leaves[0].device)
            g_sum = None
            for i in range(n):
                loss, g, buffers = self._value_and_grad(
                    params, leaves, buffers, xs[i], ys[i], with_reg=False)
                g_sum = g if g_sum is None else [a + b for a, b in
                                                 zip(g_sum, g)]
                l_sum = l_sum + loss
            # mean criteria average the micro results, sum criteria keep
            # the sum; the regularizer enters once either way
            if getattr(self.criterion, "size_average", True):
                g_sum = [g / n for g in g_sum]
                l_sum = l_sum / n
            reg = self._reg(params, self._cast(leaves))
            if torch.is_tensor(reg):
                g_sum = [a + b for a, b in zip(g_sum, self._grad(reg,
                                                                 leaves))]
                l_sum = l_sum + reg.detach()
            return l_sum, g_sum, buffers

    # ------------------------------------------------------------- step
    def _core(self, params, buffers, slots, x, y, lrs, rng,
              with_norm: bool):
        loss, grads, new_buffers = self._loss_and_grads(params, buffers, x,
                                                        y, rng)
        with torch.no_grad():
            gnorm = _global_norm(grads) if with_norm else None
            if "constant" in self.grad_clip:
                lo, hi = self.grad_clip["constant"]
                grads = [g.clamp(lo, hi) for g in grads]
            if "l2norm" in self.grad_clip:
                grads = _clip_by_global_norm(grads, self.grad_clip["l2norm"])
            leaves = [p.detach() for _, p in tree_leaves(params)]
            new_leaves = list(leaves)
            new_slots = []
            for k, meth in enumerate(self.methods):
                idxs = self._idxs_per_group[k]
                if not idxs:
                    new_slots.append(slots[k])
                    continue
                p_sub, ns = meth.step([leaves[i] for i in idxs],
                                      [grads[i] for i in idxs], slots[k],
                                      lrs[k])
                for i, pv in zip(idxs, p_sub):
                    new_leaves[i] = pv.to(leaves[i].dtype)
                new_slots.append(ns)
            new_leaves = [new if t else old for new, old, t in
                          zip(new_leaves, leaves, self._trainable)]
        return (loss, gnorm, tree_unflatten(params, new_leaves), new_buffers,
                tuple(new_slots))

    def step(self, params, buffers, slots, x, y, lrs, rng):
        """(loss, new_params, new_buffers, new_slots)."""
        loss, _, new_params, new_buffers, new_slots = self._core(
            params, buffers, slots, x, y, lrs, rng, with_norm=False)
        return loss, new_params, new_buffers, new_slots

    def step_with_stats(self, params, buffers, slots, x, y, lrs, rng):
        """(loss, pre-clip global grad L2 norm, new_params, new_buffers,
        new_slots)."""
        return self._core(params, buffers, slots, x, y, lrs, rng,
                          with_norm=True)

    # ------------------------------------------------------------ state
    def init_slots(self, params):
        leaves = [p.detach() for _, p in tree_leaves(params)]
        return tuple(m.init_slots([leaves[i] for i in idxs])
                     for m, idxs in zip(self.methods, self._idxs_per_group))

    def current_lrs(self) -> torch.Tensor:
        """One scheduled rate per optimizer group, an f32 CPU tensor."""
        return torch.tensor([m.get_current_rate() for m in self.methods],
                            dtype=torch.float32)

    def update_states(self, **kv) -> None:
        """Write ``kv`` into every group's state table (the loop's
        ``neval`` / ``epoch`` / ``Loss``, which the schedules read)."""
        for m in self.methods:
            m.state.update(kv)


def _named_param_leaves(params, prefix: str = ""):
    """(dotted path, leaf) over a params tree in its own key order, the
    ``~params`` level kept: the JAX loop's histogram tags
    (``m0.~params.weight``)."""
    for key, sub in params.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(sub, dict):
            yield from _named_param_leaves(sub, path)
        else:
            yield path, sub


def _on_device(tree, device):
    """A slot tree (dicts, lists and tuples of tensors) on ``device``."""
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_device(v, device) for v in tree)
    return tree


def load_latest_checkpoint(path: str, device="cuda"):
    """(model, optim method, tag) of the newest complete pair in the
    checkpoint directory ``path`` (a ``model.{tag}`` with its
    ``optimMethod.{tag}``), the model on ``device``; (None, None, None)
    when there is none."""
    device = resolve_device(device)
    try:
        if not bt_file.isdir(path):
            return None, None, None
        names = bt_file.listdir(path)
    except (FileNotFoundError, NotADirectoryError, OSError):
        return None, None, None
    name_set = set(names)
    tags = [int(f[len("model."):]) for f in names
            if f.startswith("model.") and f[len("model."):].isdigit()
            and f"optimMethod.{f[len('model.'):]}" in name_set]
    if not tags:
        return None, None, None
    tag = max(tags)
    model = bt_file.load_module(os.path.join(path, f"model.{tag}"),
                                device=device)
    method = OptimMethod.load(os.path.join(path, f"optimMethod.{tag}"))
    return model, method, tag


def step_signature(*trees) -> tuple:
    """The shapes and dtypes of a train step's inputs (tensors, possibly
    in Tables, dicts, lists or tuples): what a JAX compile of the step is
    keyed on, so the distinct signatures are the loops'
    ``bdt_train_jit_compiles``, flat once every batch shape was seen."""
    out = []

    def walk(t):
        if torch.is_tensor(t):
            out.append((tuple(t.shape), str(t.dtype)))
        elif isinstance(t, SparseTensor):
            out.append(("sparse", t.shape))
            walk((t.indices, t.values))
        elif hasattr(t, "items"):
            for k, v in t.items():
                out.append(repr(k))
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)

    for t in trees:
        walk(t)
    return tuple(out)


def make_train_step(model: Module, criterion, optim_method: OptimMethod,
                    grad_clip: Optional[dict] = None, sub_methods=None,
                    compute_dtype=None, grad_accum: int = 1) -> TrainStep:
    return TrainStep(model, criterion, optim_method, grad_clip, sub_methods,
                     compute_dtype=compute_dtype, grad_accum=grad_accum)


class Optimizer:
    """Builder: ``Optimizer(model, dataset, criterion, batch_size,
    end_when)`` (``end_when`` default: one epoch) returns a
    :class:`LocalOptimizer` for an in-memory dataset or a list of
    records and a ``DistriOptimizer`` (``parallel/distri_optimizer.py``)
    for a ``ShardedDataSet``, configured by the ``set_*`` methods and run
    by ``optimize()``, which trains on the device of the model's
    parameters."""

    def __new__(cls, model: Module = None, dataset=None, criterion=None,
                batch_size: Optional[int] = None,
                end_when: Optional[Trigger] = None, training_set=None, **kw):
        if cls is Optimizer:
            dataset = dataset if dataset is not None else training_set
            if isinstance(dataset_base(dataset), ShardedDataSet):
                from bigdl_tpu_torch.parallel.distri_optimizer import \
                    DistriOptimizer

                return object.__new__(DistriOptimizer)
            return object.__new__(LocalOptimizer)
        return object.__new__(cls)

    def __init__(self, model: Module = None, dataset=None, criterion=None,
                 batch_size: Optional[int] = None,
                 end_when: Optional[Trigger] = None, training_set=None):
        self.model = model
        dataset = dataset if dataset is not None else training_set
        self.dataset: AbstractDataSet = as_dataset(dataset)
        self.criterion = criterion
        self.batch_size = batch_size
        self.end_when = end_when or Trigger.max_epoch(1)
        self.optim_method: OptimMethod = SGD()
        self.sub_optim_methods: Dict[str, OptimMethod] = {}
        self.validation_trigger: Optional[Trigger] = None
        self.validation_dataset = None
        self.validation_methods: Optional[Sequence[ValidationMethod]] = None
        self.validation_batch_size: Optional[int] = None
        self.grad_clip: dict = {}
        self.grad_accum = 1
        self.compute_dtype = None
        self.metrics = Metrics()
        self.checkpoint_path: Optional[str] = None
        self.checkpoint_trigger: Optional[Trigger] = None
        self.checkpoint_async = False
        self.train_summary = None
        self.validation_summary = None
        self._ckpt_thread = None
        self._ckpt_error = None

    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        self.optim_method = method
        return self

    def set_optim_methods(self, methods: Dict[str, OptimMethod]
                          ) -> "Optimizer":
        """Per-submodule optim methods, keyed by module name."""
        self.sub_optim_methods = dict(methods)
        return self

    def set_end_when(self, trigger: Trigger) -> "Optimizer":
        self.end_when = trigger
        return self

    def set_validation(self, trigger: Trigger, dataset, methods,
                       batch_size: Optional[int] = None) -> "Optimizer":
        self.validation_trigger = trigger
        self.validation_dataset = as_dataset(dataset)
        self.validation_methods = list(methods)
        self.validation_batch_size = batch_size or self.batch_size
        return self

    def set_checkpoint(self, path: str, trigger: Trigger,
                       is_overwrite: bool = True, async_write: bool = False,
                       slots_backend: str = "pickle") -> "Optimizer":
        """Write ``model.{tag}`` and ``optimMethod.{tag}`` under ``path``
        whenever ``trigger`` fires. ``async_write`` snapshots in the loop
        and writes on a thread (one write in flight: the next checkpoint,
        and ``optimize()`` before it returns, join it and raise its
        error). ``slots_backend="orbax"`` (the JAX option's name) is the
        ``DistriOptimizer``'s: there each rank writes its shard of the
        slots as ``optimSlots.{tag}.orbax`` in the sharded format of
        ``utils/sharded_ckpt.py``. This local loop accepts it and, as the
        JAX local loop does, writes its slots as usual (inside
        ``optimMethod.{tag}``)."""
        if slots_backend not in ("pickle", "orbax"):
            raise ValueError(f"unknown slots_backend {slots_backend!r}")
        self.checkpoint_path = path
        self.checkpoint_trigger = trigger
        self.checkpoint_overwrite = is_overwrite
        self.checkpoint_async = async_write
        self.checkpoint_slots_backend = slots_backend
        return self

    def set_compute_dtype(self, dtype) -> "Optimizer":
        """Train in ``dtype`` (bf16) over the parameters' own (f32)
        masters: the train step's ``compute_dtype``, which the JAX
        package sets in its perf harness (``models/perf.py``) and its
        loop does not offer."""
        self.compute_dtype = dtype
        return self

    def set_train_summary(self, summary) -> "Optimizer":
        self.train_summary = summary
        return self

    def set_validation_summary(self, summary) -> "Optimizer":
        self.validation_summary = summary
        return self

    def set_gradient_accumulation(self, n_micro_batches: int
                                  ) -> "Optimizer":
        """Accumulate gradients over ``n_micro_batches`` sequential
        micro-batches per step (the batch size must divide evenly)."""
        self.grad_accum = int(n_micro_batches)
        return self

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float
                                         ) -> "Optimizer":
        self.grad_clip["l2norm"] = float(clip_norm)
        return self

    def set_constant_gradient_clipping(self, min_v: float, max_v: float
                                       ) -> "Optimizer":
        self.grad_clip["constant"] = (float(min_v), float(max_v))
        return self

    def disable_gradient_clipping(self) -> "Optimizer":
        self.grad_clip = {}
        return self

    def optimize(self) -> Module:
        raise NotImplementedError


class LocalOptimizer(Optimizer):
    """The single-process training loop (see the module docstring)."""

    def _batch_stream(self):
        """Infinite minibatch stream that reshuffles the dataset at each
        epoch boundary, counted in records on this side of the prefetch
        queue, so the next epoch's order is settled before its batches
        are staged."""
        if self.dataset.size() == 0:
            raise ValueError("dataset is empty")
        local = getattr(self.dataset, "local_size", self.dataset.size)()
        seen = 0
        for b in minibatches(self.dataset, self.batch_size, train=True):
            yield b
            seen += b.size()
            if seen >= local:
                seen = 0
                self.dataset.shuffle()

    def _prepare_batch(self, batch):
        """(x, y, n) on the model's device (runs on the prefetch thread)."""
        x = batch_to_device(batch.get_input(), self._device)
        y = batch_to_device(batch.get_target(), self._device)
        return x, y, batch.size()

    def optimize(self) -> Module:
        model = self.model
        state = self.optim_method.state
        state.setdefault("epoch", 1)
        state.setdefault("neval", 1)
        state.setdefault("recordsProcessedThisEpoch", 0)
        ga = self.grad_accum
        if ga > 1 and self.batch_size % ga:
            raise ValueError(
                f"batch_size {self.batch_size} not divisible by gradient "
                f"accumulation factor {ga}")
        self._device = model_device(model)
        ts = make_train_step(model, self.criterion, self.optim_method,
                             self.grad_clip, self.sub_optim_methods,
                             compute_dtype=self.compute_dtype, grad_accum=ga)
        params, buffers = model.params_dict(), model.buffers_dict()
        restored = self.optim_method.__dict__.pop("_train_slots", None)
        slots = (_on_device(restored, self._device)
                 if restored is not None and len(restored) == len(ts.methods)
                 else ts.init_slots(params))
        data_iter = prefetch(self._batch_stream(), buffer_size=PREFETCH_DEPTH,
                             transfer=self._prepare_batch)
        try:
            # /debug/memory attribution of the run's two big persistent
            # tensor sets; unregistered on every exit
            # the step loop launches the device work: it hosts profiler
            # captures asked for on other threads (polled between steps)
            with obs_memory.static_pools({
                    "train/params": obs_memory.tree_bytes(params),
                    "train/optimizer_slots": obs_memory.tree_bytes(slots)}), \
                    profiler.hosting():
                params, buffers = self._optimize_loop(state, params, buffers,
                                                      ts, slots, data_iter)
        finally:
            data_iter.close()
            # never abandon a write in flight, even on an error
            self.join_pending_checkpoint()
        model.load_params_dict(params)
        model.load_buffers_dict(buffers)
        return model

    def _optimize_loop(self, state, params, buffers, ts, slots, data_iter):
        num_samples = self.dataset.size()
        wall_start = time.time()
        # a disabled registry takes the plain step (no grad norm)
        obs_on = obs.enabled()
        ins = obs.train_instruments() if obs_on else None
        sigs = set()
        while not self.end_when(state):
            profiler.poll()
            x, y, n = next(data_iter)
            lrs = ts.current_lrs()
            lr = float(lrs[0])
            t0 = time.perf_counter()
            with obs.trace.span("train/step"):
                if obs_on:
                    loss, gnorm, params, buffers, slots = ts.step_with_stats(
                        params, buffers, slots, x, y, lrs, None)
                    # one host read for both
                    loss, gnorm = torch.stack(
                        [loss.detach().float(), gnorm.float()]).tolist()
                else:
                    loss, params, buffers, slots = ts.step(
                        params, buffers, slots, x, y, lrs, None)
                    loss = float(loss)
            dt = time.perf_counter() - t0
            state["recordsProcessedThisEpoch"] += n
            state["Loss"] = loss
            state["LearningRate"] = lr
            self.metrics.add("computing time", dt * 1e9)
            if obs_on:
                sigs.add(step_signature(x, y))
                ins.step_seconds.observe(dt)
                ins.records_total.inc(n)
                ins.throughput.set(n / max(dt, 1e-9))
                ins.loss.set(loss)
                ins.learning_rate.set(lr)
                ins.grad_norm.set(gnorm)
                ins.epoch.set(state["epoch"])
                ins.jit_compiles.set(len(sigs))
            logger.info(
                "[Epoch %d %d/%d][Iteration %d][Wall Clock %.3fs] "
                "Trained %d records in %.4f seconds. Throughput is %.1f "
                "records/second. Loss is %.4f.",
                state["epoch"], state["recordsProcessedThisEpoch"],
                num_samples, state["neval"], time.time() - wall_start, n, dt,
                n / max(dt, 1e-9), loss)
            if self.train_summary is not None:
                self._write_train_summary(state, params, loss, lr,
                                          n / max(dt, 1e-9))
            state["neval"] += 1
            if state["recordsProcessedThisEpoch"] >= num_samples:
                state["epoch"] += 1
                state["recordsProcessedThisEpoch"] = 0
            ts.update_states(neval=state["neval"], epoch=state["epoch"],
                             Loss=loss)
            if self._should_fire_aux(state):
                self.model.load_params_dict(params)
                self.model.load_buffers_dict(buffers)
                with obs.trace.span("train/validation"):
                    if self._val_now:
                        self._run_validation(state)
                # only a real checkpoint samples the latency histogram
                ck_hist = (ins.checkpoint_seconds if obs_on and self._ckpt_now
                           else None)
                with obs.trace.span("train/checkpoint", histogram=ck_hist):
                    if self._ckpt_now:
                        self._run_checkpoint(state, slots)
        return params, buffers

    def _write_train_summary(self, state, params, loss, lr, throughput):
        summ, step = self.train_summary, state["neval"]
        summ.add_scalar("Loss", loss, step)
        summ.add_scalar("LearningRate", lr, step)
        summ.add_scalar("Throughput", throughput, step)
        trig = getattr(summ, "get_summary_trigger",
                       lambda _name: None)("Parameters")
        if trig is not None and trig(state):
            for name, leaf in _named_param_leaves(params):
                summ.add_histogram(name, leaf.detach().float().cpu().numpy(),
                                   step)

    def _should_fire_aux(self, state) -> bool:
        """Ask each trigger once: validation, then checkpoint."""
        self._val_now = (self.validation_trigger is not None
                         and bool(self.validation_trigger(state)))
        self._ckpt_now = (self.checkpoint_trigger is not None
                          and bool(self.checkpoint_trigger(state)))
        return self._val_now or self._ckpt_now

    def _snapshot(self, slots):
        """(model copy, method copy, wait): host copies of the model and of
        the optim method carrying ``slots``, taken now (see
        ``utils/file.py::snapshot``)."""
        method = self.optim_method
        model_snap, wait_model = bt_file.snapshot(self.model)
        method._train_slots = slots
        try:
            method_snap, wait_method = bt_file.snapshot(method)
        finally:
            del method._train_slots

        def wait():
            wait_model()
            wait_method()

        return model_snap, method_snap, wait

    def _run_checkpoint(self, state, slots):
        if self.checkpoint_path is None:
            return
        path = self.checkpoint_path
        bt_file.makedirs(path)
        tag = f"{state['neval'] - 1}"
        model_f = os.path.join(path, f"model.{tag}")
        method_f = os.path.join(path, f"optimMethod.{tag}")
        if not self.checkpoint_async:
            model_snap, method_snap, wait = self._snapshot(slots)
            wait()
            bt_file.save_module(None, model_f, overwrite=True,
                                snapshot=model_snap)
            bt_file.save(None, method_f, overwrite=True,
                         snapshot=method_snap)
            return
        self.join_pending_checkpoint()  # one in flight; raise its error
        model_snap, method_snap, wait = self._snapshot(slots)

        # locally each file lands under a hidden name and is renamed in
        # whole; a bucket has no atomic rename, so there the final names
        # are put directly, the method (which the latest-scan pairs with
        # its model) last
        remote = bt_file.is_remote(path)

        def write():
            mtmp = model_f if remote else \
                os.path.join(path, f".model.{tag}.tmp")
            otmp = method_f if remote else \
                os.path.join(path, f".optimMethod.{tag}.tmp")
            try:
                wait()
                bt_file.save_module(None, mtmp, overwrite=True,
                                    snapshot=model_snap)
                bt_file.save(None, otmp, overwrite=True,
                             snapshot=method_snap)
                if not remote:
                    os.replace(mtmp, model_f)
                    os.replace(otmp, method_f)
            except BaseException as e:  # raised again at the next join
                self._ckpt_error = e

        self._ckpt_thread = threading.Thread(target=write, daemon=True,
                                             name=f"ckpt-{tag}")
        self._ckpt_thread.start()

    def join_pending_checkpoint(self) -> None:
        """Wait for the write in flight, if any, and raise the error it
        hit."""
        t = self._ckpt_thread
        if t is not None:
            t.join()
            self._ckpt_thread = None
        err = self._ckpt_error
        if err is not None:
            self._ckpt_error = None
            raise RuntimeError("async checkpoint write failed") from err

    def _run_validation(self, state):
        if self.validation_dataset is None:
            return
        results = Evaluator(self.model).test(
            self.validation_dataset, self.validation_methods,
            batch_size=self.validation_batch_size or self.batch_size)
        for method, res in results:
            value, _ = res.result()
            logger.info("%s is %s", method.name(), res)
            if method.name() in ("Top1Accuracy", "Top5Accuracy"):
                state["score"] = value
            if self.validation_summary is not None:
                self.validation_summary.add_scalar(method.name(), value,
                                                   state["neval"] - 1)
