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
model. Not ported yet: checkpoints, train and validation summaries and
the observability instruments (``ROADMAP.md``); the distributed loop
(a ``ShardedDataSet``) belongs to the distributed slice.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

import torch

from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, ShardedDataSet,
                                             as_dataset, dataset_base,
                                             minibatches)
from bigdl_tpu_torch.dataset.prefetch import prefetch
from bigdl_tpu_torch.nn.dropout import bind_generator
from bigdl_tpu_torch.nn.module import (PARAMS_KEY, Module, tree_leaves,
                                       tree_unflatten)
from bigdl_tpu_torch.optim.evaluator import (Evaluator, batch_to_device,
                                             model_device)
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import ValidationMethod

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


def make_train_step(model: Module, criterion, optim_method: OptimMethod,
                    grad_clip: Optional[dict] = None, sub_methods=None,
                    compute_dtype=None, grad_accum: int = 1) -> TrainStep:
    return TrainStep(model, criterion, optim_method, grad_clip, sub_methods,
                     compute_dtype=compute_dtype, grad_accum=grad_accum)


class Optimizer:
    """Builder: ``Optimizer(model, dataset, criterion, batch_size,
    end_when)`` (``end_when`` default: one epoch) returns a
    :class:`LocalOptimizer` for an in-memory dataset or a list of
    records, configured by the ``set_*`` methods and run by
    ``optimize()``, which trains on the device of the model's
    parameters."""

    def __new__(cls, model: Module = None, dataset=None, criterion=None,
                batch_size: Optional[int] = None,
                end_when: Optional[Trigger] = None, training_set=None):
        if cls is Optimizer:
            dataset = dataset if dataset is not None else training_set
            if isinstance(dataset_base(dataset), ShardedDataSet):
                raise NotImplementedError(
                    "training on a ShardedDataSet is the distributed "
                    "slice (DistriOptimizer), not ported yet: see "
                    "ROADMAP.md, Queue 1 item 5")
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
        self.metrics = Metrics()

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
                             grad_accum=ga)
        params, buffers = model.params_dict(), model.buffers_dict()
        slots = ts.init_slots(params)
        data_iter = prefetch(self._batch_stream(), buffer_size=PREFETCH_DEPTH,
                             transfer=self._prepare_batch)
        try:
            params, buffers = self._optimize_loop(state, params, buffers, ts,
                                                  slots, data_iter)
        finally:
            data_iter.close()
        model.load_params_dict(params)
        model.load_buffers_dict(buffers)
        return model

    def _optimize_loop(self, state, params, buffers, ts, slots, data_iter):
        num_samples = self.dataset.size()
        wall_start = time.time()
        while not self.end_when(state):
            x, y, n = next(data_iter)
            lrs = ts.current_lrs()
            lr = float(lrs[0])
            t0 = time.perf_counter()
            loss, params, buffers, slots = ts.step(params, buffers, slots, x,
                                                   y, lrs, None)
            loss = float(loss)
            dt = time.perf_counter() - t0
            state["recordsProcessedThisEpoch"] += n
            state["Loss"] = loss
            state["LearningRate"] = lr
            self.metrics.add("computing time", dt * 1e9)
            logger.info(
                "[Epoch %d %d/%d][Iteration %d][Wall Clock %.3fs] "
                "Trained %d records in %.4f seconds. Throughput is %.1f "
                "records/second. Loss is %.4f.",
                state["epoch"], state["recordsProcessedThisEpoch"],
                num_samples, state["neval"], time.time() - wall_start, n, dt,
                n / max(dt, 1e-9), loss)
            state["neval"] += 1
            if state["recordsProcessedThisEpoch"] >= num_samples:
                state["epoch"] += 1
                state["recordsProcessedThisEpoch"] = 0
            ts.update_states(neval=state["neval"], epoch=state["epoch"],
                             Loss=loss)
            if (self.validation_trigger is not None
                    and self.validation_trigger(state)):
                self.model.load_params_dict(params)
                self.model.load_buffers_dict(buffers)
                self._run_validation(state)
        return params, buffers

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
