"""The distributed training loop (port of
``bigdl_tpu/parallel/distri_optimizer.py``).

One rank per device, each running this loop over its share of the global
batch, in lockstep through the collectives of the ``data`` axis of a
mesh (``Engine.default_mesh()`` unless ``mesh=`` names one). Two
parameter-sync modes, as in JAX:

- ``"sharded"`` (default; the reference's algorithm, ZeRO-1): each rank's
  forward and backward, the flat gradient padded to the axis and
  reduce-scattered (bf16 on the wire with the default
  ``compress_dtype``), constant and global-L2 clipping of the owned
  slice (the L2 norm all-reduced), ``method.step`` on the owned slice of
  the f32 flat vector and its slots only (the slots are sharded: a
  rank's optimizer state is 1/n of the whole), then the all-gather of
  the weights (bf16 on the wire too), unflattened, frozen parameters
  kept;
- ``"allreduce"``: replicated parameters and slots, the gradients (and
  the loss) averaged over the axis, then the local train step's clipping
  and update (per-submodule methods only here, as in JAX).

BatchNorm buffers are per rank by default (the reference's thread
replicas); ``sync_batch_norm=True`` averages them every step, and the
``"allreduce"`` mode, whose replicas stay identical, always does. (The
JAX ``"allreduce"`` step normalizes by the global batch's statistics,
which GSPMD computes across the sharded batch; a rank here normalizes by
its own batch unless the BN names a ``global_stats_axis``.) The model
receives rank 0's buffers when the loop writes back, as the JAX loop's
host view takes replica 0's.

The data: the per-rank batch is the global batch over the axis size,
which must divide it (``ValueError``). A ``ShardedDataSet`` must be cut
one shard per rank; a sample stream that is not sharded is strided by
rank (rank r keeps records i with i % n == r), disjoint only when every
rank built the same records in the same order with the same seed (the
JAX warning says so too); a pre-batched stream that is not sharded
raises. The epoch is counted in global records.

``log_interval`` (default: the ``bigdl.log.interval`` property) reads
the loss on the host only every N iterations (``host_reads`` counts the
reads). Each rank's dropout draws from its own generator, seeded by a
draw from PyTorch's default generator folded with the rank (the
counterpart of ``fold_in(rng, axis_index)`` on the JAX loop's key). ``optimize()`` retries from the newest checkpoint on a
failure, at most ``bigdl.failure.retryTimes`` times within
``bigdl.failure.retryTimeInterval`` seconds of the previous failure;
``_fault_hook(state)``, called after every step, injects one.
Checkpoints: rank 0 writes ``model.{tag}`` and ``optimMethod.{tag}``
and the optimizer slots, gathered from every rank, as
``optimSlots.{tag}``; a restore gives each rank its slice again.
With ``set_checkpoint(slots_backend="orbax")`` the slots are written
instead shard by shard, each rank its own slice, as
``optimSlots.{tag}.orbax`` in the format of ``utils/sharded_ckpt.py``
(the counterpart of the JAX package's orbax checkpoint), and a retry
restores them straight into each rank's slice, with no gather.
Summaries are written by rank 0. Not ported: gradient accumulation
(raises, as in JAX). Observability as in the JAX loop: ``train/step``,
``train/validation`` and ``train/checkpoint`` spans, the ``bdt_train_*``
instruments at each log point (the loop's one host read), the per-rank
``bdt_parallel_sync_window_seconds`` / ``bdt_parallel_step_seconds``,
and the params and optimizer slots as memory pools.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import torch

from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch.dataset.dataset import dataset_base
from bigdl_tpu_torch.dataset.minibatch import MiniBatch
from bigdl_tpu_torch.dataset.prefetch import prefetch
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
from bigdl_tpu_torch.nn.module import tree_leaves, tree_unflatten
from bigdl_tpu_torch.observability import memory as obs_memory
from bigdl_tpu_torch.observability import profiler
from bigdl_tpu_torch.optim.evaluator import model_device
from bigdl_tpu_torch.optim.optimizer import (PREFETCH_DEPTH, LocalOptimizer,
                                             TrainStep, load_latest_checkpoint,
                                             make_train_step, _on_device,
                                             step_signature)
from bigdl_tpu_torch.parallel import collectives as C
from bigdl_tpu_torch.parallel.all_reduce import (AllReduceParameter,
                                                 flatten_params,
                                                 pad_to_multiple, slice_of,
                                                 unflatten_leaves)
from bigdl_tpu_torch.parallel.engine import Engine
from bigdl_tpu_torch.parallel.tp import P, NamedSharding
from bigdl_tpu_torch.utils import config as bt_config
from bigdl_tpu_torch.utils import file as bt_file
from bigdl_tpu_torch.utils import sharded_ckpt

logger = logging.getLogger("bigdl_tpu_torch.optim")


def _map_tree(f, tree):
    """``f`` over the tensor leaves of a tree of dicts, lists and
    tuples."""
    if torch.is_tensor(tree):
        return f(tree)
    if isinstance(tree, dict):
        return {k: _map_tree(f, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(f, v) for v in tree)
    return tree


def _mean_buffers(buffers, group):
    """Floating buffers averaged over ``group`` (the others kept)."""
    return tree_unflatten(buffers, [
        C.all_reduce(b, group, "mean").to(b.dtype)
        if b.is_floating_point() else b
        for _, b in tree_leaves(buffers)])


class _AllReduceStep(TrainStep):
    """The local train step with the loss and the gradients averaged over
    a group before clipping and the update, and the buffers too."""

    def __init__(self, *args, group=None, **kw):
        super().__init__(*args, **kw)
        self.group = group

    def _loss_and_grads(self, params, buffers, x, y, rng):
        loss, grads, new_buffers = super()._loss_and_grads(
            params, buffers, x, y, rng)
        flat, spec = flatten_params(grads)
        grads = unflatten_leaves(C.all_reduce(flat, self.group, "mean"),
                                 spec)
        return (C.all_reduce(loss, self.group, "mean"), grads,
                _mean_buffers(new_buffers, self.group))


class DistriOptimizer(LocalOptimizer):
    """Data-parallel training over the ranks of a mesh's ``data`` axis
    (see the module docstring)."""

    def set_gradient_accumulation(self, n_micro_batches: int):
        raise NotImplementedError(
            "gradient accumulation is local-optimizer only for now: the "
            "distributed step's batch axis is sharded over the ranks, and "
            "an in-step micro-batch reshape would re-layout the shards; "
            "lower the per-rank batch or add ranks instead")

    def __init__(self, *args, mesh=None, parameter_sync: str = "sharded",
                 compress_dtype=torch.bfloat16,
                 sync_batch_norm: bool = False,
                 log_interval: Optional[int] = None, **kw):
        super().__init__(*args, **kw)
        self.mesh = mesh if mesh is not None else Engine.default_mesh()
        if "data" not in self.mesh.axis_names:
            raise ValueError(
                "mesh must have a 'data' axis for data parallelism")
        if parameter_sync not in ("sharded", "allreduce"):
            raise ValueError(f"parameter_sync must be 'sharded' or "
                             f"'allreduce', got {parameter_sync!r}")
        self.parameter_sync = parameter_sync
        self.compress_dtype = compress_dtype
        self.sync_batch_norm = sync_batch_norm
        if log_interval is None:
            log_interval = bt_config.get_int("bigdl.log.interval", 1)
        self.log_interval = max(1, int(log_interval))
        self.host_reads = 0
        self._fault_hook = None
        self._restored_slots = None

    # ------------------------------------------------------------ layout
    @property
    def group(self):
        return self.mesh.group("data")

    @property
    def n_data(self) -> int:
        return self.mesh.size("data")

    @property
    def data_rank(self) -> int:
        return self.mesh.index("data")

    # -------------------------------------------------------- data feeding
    def _minibatches(self, dataset, batch_size, train=True):
        n, rank = self.n_data, self.data_rank
        base = dataset_base(dataset)
        pre_sharded = hasattr(base, "shard_id")
        if pre_sharded and getattr(base, "num_shards", n) != n:
            raise ValueError(
                f"dataset is sharded {base.num_shards}-way but the data "
                f"axis has {n} ranks; shards would overlap or go unread: "
                "rebuild it with one shard per rank")
        it = iter(dataset.data(train=train))
        first = next(it, None)
        if first is None:
            return iter(())

        def chain():
            yield first
            yield from it

        if isinstance(first, MiniBatch):
            if n > 1 and not pre_sharded:
                raise ValueError(
                    "distributed training with a pre-batched non-sharded "
                    "dataset would feed identical batches to every rank; "
                    "build a ShardedDataSet instead")
            return chain()
        stream = chain()
        if n > 1 and not pre_sharded:
            if not getattr(self, "_warned_autoshard", False):
                self._warned_autoshard = True
                logger.warning(
                    "distributed run with a non-sharded dataset: striding "
                    "the sample stream by rank (stride %d, offset %d). "
                    "This is only disjoint if EVERY rank built the dataset "
                    "from the same records in the same order with the same "
                    "seed; use a ShardedDataSet for verified-disjoint input",
                    n, rank)

            def strided(src=stream):
                for i, s in enumerate(src):
                    if i % n == rank:
                        yield s

            stream = strided()
        return SampleToMiniBatch(batch_size, parallelism=n)(stream)

    def _batch_stream(self):
        """The infinite stream of this rank's minibatches, reshuffled at
        each epoch boundary, counted in global records (a shard counts
        its own)."""
        if self.dataset.size() == 0:
            raise ValueError("dataset is empty")
        base = dataset_base(self.dataset)
        sharded = hasattr(base, "shard_id")
        scale = 1 if sharded else self.n_data
        local = getattr(self.dataset, "local_size", self.dataset.size)()
        seen = 0
        for b in self._minibatches(self.dataset, self.batch_size):
            yield b
            seen += b.size() * scale
            if seen >= local:
                seen = 0
                self.dataset.shuffle()

    # ---------------------------------------------------------- the steps
    def _sharded_step(self, ts, arp, spec, params, buffers, flat, slots, x,
                      y, lr, gen):
        """(loss, params, buffers, flat slice, slots) of one ZeRO-1 step:
        the JAX ``shard_step``."""
        group, n = self.group, self.n_data
        loss, grads, new_buffers = ts._loss_and_grads(params, buffers, x, y,
                                                      gen)
        with torch.no_grad():
            flat_grad, _ = pad_to_multiple(flatten_params(grads)[0], n)
            owned = arp.aggregate(flat_grad)
            clip = self.grad_clip
            if "constant" in clip:
                lo, hi = clip["constant"]
                owned = owned.clamp(lo, hi)
            if "l2norm" in clip:
                sq = C.all_reduce((owned ** 2).sum(), group)
                owned = owned * torch.clamp(
                    clip["l2norm"] / (sq.sqrt() + 1e-12), max=1.0)
            new_slice, new_slots = self.optim_method.step(flat, owned, slots,
                                                          lr)
            full = arp.all_gather_weights(new_slice)
            new_leaves = unflatten_leaves(full[:sum(spec[3])], spec)
            old = [p for _, p in tree_leaves(params)]
            new_leaves = [new.to(o.device) if t else o for new, o, t in
                          zip(new_leaves, old, ts._trainable)]
            if self.sync_batch_norm:
                new_buffers = _mean_buffers(new_buffers, group)
            loss = C.all_reduce(loss, group, "mean")
        return (loss, tree_unflatten(params, new_leaves), new_buffers,
                new_slice, new_slots)

    # ------------------------------------------------------- checkpoints
    def _gather_slots(self, slots):
        """The whole slot tree: each rank's slices all-gathered in the
        sharded mode (counters, 0-d, are the same everywhere)."""
        if self.parameter_sync != "sharded":
            return slots
        return _map_tree(lambda s: C.all_gather(s.reshape(-1), self.group)
                         if s.dim() else s, slots)

    def _slot_shardings(self, slots):
        """The layout of the live slots: the sharded mode's 1-D slices over
        the data axis (counters replicated), None for replicated slots."""
        if self.parameter_sync != "sharded":
            return None
        data = NamedSharding(self.mesh, P("data"))
        return _map_tree(lambda s: data if s.dim() else None, slots)

    def _orbax_path(self, tag) -> str:
        return os.path.join(os.path.abspath(self.checkpoint_path),
                            f"optimSlots.{tag}.orbax")

    def _run_checkpoint(self, state, slots):
        if self.checkpoint_path is None:
            return
        if getattr(self, "checkpoint_slots_backend", "pickle") == "orbax":
            # every rank writes its own slice: no gather; the model and
            # the method go through rank 0 as before
            if C.group_rank(None) == 0:
                super()._run_checkpoint(state, None)
            tag = f"{state['neval'] - 1}"
            sharded_ckpt.save_train_state(
                self._orbax_path(tag), state["neval"] - 1, {}, {}, slots,
                shardings=(None, None, self._slot_shardings(slots)))
            return
        full = self._gather_slots(slots)
        if C.group_rank(None) == 0:
            super()._run_checkpoint(state, None)
            tag = f"{state['neval'] - 1}"
            bt_file.makedirs(self.checkpoint_path)
            bt_file.save(full, os.path.join(self.checkpoint_path,
                                            f"optimSlots.{tag}"),
                         overwrite=True)
        C.barrier(None)

    def _load_slots_snapshot(self, tag):
        opath = self._orbax_path(tag)
        if sharded_ckpt.exists(opath):
            # restored later straight into the live slices
            return ("__orbax__", opath)
        path = os.path.join(self.checkpoint_path, f"optimSlots.{tag}")
        return bt_file.load(path) if bt_file.exists(path) else None

    def _restore_orbax_slots(self, opath, like):
        """The sharded slots restored into the layout of ``like`` (the
        fresh ``init_slots`` tree of this rank)."""
        return sharded_ckpt.restore_train_state(
            opath, like=({}, {}, like),
            shardings=(None, None, self._slot_shardings(like)))[3]

    # -------------------------------------------------------------- loop
    def optimize(self):
        """Retry from the latest checkpoint around the training loop."""
        max_retry = bt_config.get_int("bigdl.failure.retryTimes", 5)
        retry_window = bt_config.get_float(
            "bigdl.failure.retryTimeInterval", 120.0)
        retry_count, last_failure = 0, None
        while True:
            try:
                return self._optimize_impl()
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                now = time.time()
                retry_count = (retry_count + 1 if last_failure is not None
                               and now - last_failure < retry_window else 1)
                last_failure = now
                if self.checkpoint_path is None or retry_count > max_retry:
                    raise
                try:
                    self.join_pending_checkpoint()
                except Exception:
                    logger.warning("pending async checkpoint write failed; "
                                   "restoring from the previous snapshot")
                C.barrier(None)
                model, method, tag = load_latest_checkpoint(
                    self.checkpoint_path, device=self._device)
                if model is None:
                    raise
                logger.warning(
                    "Training failed (%s: %s); retry %d/%d from checkpoint "
                    "%s (iteration %s)", type(e).__name__, e, retry_count,
                    max_retry, self.checkpoint_path, tag)
                self.model = model
                self.optim_method = method
                self._restored_slots = self._load_slots_snapshot(tag)

    def _optimize_impl(self):
        model, method = self.model, self.optim_method
        state = method.state
        state.setdefault("epoch", 1)
        state.setdefault("neval", 1)
        state.setdefault("recordsProcessedThisEpoch", 0)
        n, group = self.n_data, self.group
        if self.batch_size is not None and self.batch_size % n:
            raise ValueError(
                f"global batch {self.batch_size} must divide evenly over "
                f"the {n} ranks of the data axis (the batch divisibility "
                "invariant)")
        self._device = model_device(model)
        base = int(torch.randint(0, 2 ** 40, ()))
        gen = torch.Generator(device=self._device).manual_seed(
            base * 1_000_003 + self.data_rank)
        method.__dict__.pop("_train_slots", None)
        restored, self._restored_slots = self._restored_slots, None
        params = model.params_dict()
        buffers = model.buffers_dict()
        sharded = self.parameter_sync == "sharded"
        if sharded:
            if self.sub_optim_methods:
                raise NotImplementedError(
                    "per-submodule optim methods require "
                    "parameter_sync='allreduce' (the sharded flat vector "
                    "spans all groups)")
            ts = make_train_step(model, self.criterion, method,
                                 compute_dtype=self.compute_dtype)
            full, spec = flatten_params(params)
            full, _ = pad_to_multiple(full, n)
            flat = slice_of(full, group)
            slots = method.init_slots(flat)
            if isinstance(restored, tuple) and restored[:1] == ("__orbax__",):
                slots = self._restore_orbax_slots(restored[1], slots)
            elif restored is not None:
                slots = _map_tree(
                    lambda s: slice_of(s.to(self._device), group)
                    if s.dim() else s.to(self._device), restored)
            arp = AllReduceParameter(group, self.compress_dtype)
        else:
            ts = _AllReduceStep(model, self.criterion, method,
                                self.grad_clip, self.sub_optim_methods,
                                compute_dtype=self.compute_dtype,
                                group=group)
            if isinstance(restored, tuple) and restored[:1] == ("__orbax__",):
                slots = self._restore_orbax_slots(restored[1],
                                                  ts.init_slots(params))
            else:
                slots = (_on_device(restored, self._device)
                         if restored is not None else ts.init_slots(params))
            flat = arp = spec = None
        data_iter = prefetch(self._batch_stream(), buffer_size=PREFETCH_DEPTH,
                             transfer=self._prepare_batch)
        try:
            # /debug/memory attribution: this rank's params and its
            # optimizer slots (its slice under the sharded sync)
            with obs_memory.static_pools({
                    "train/params": obs_memory.tree_bytes(params),
                    "train/optimizer_slots": obs_memory.tree_bytes(slots)}), \
                    profiler.hosting():
                # the step loop hosts profiler captures asked for on other
                # threads (polled between steps), as the local loop does
                params, buffers = self._loop(state, ts, arp, spec, params,
                                             buffers, flat, slots, gen,
                                             data_iter)
        finally:
            data_iter.close()
            self.join_pending_checkpoint()
        return model

    def _write_back(self, params, buffers):
        """The model takes the new parameters and rank 0's buffers."""
        self.model.load_params_dict(params)
        if self.parameter_sync == "sharded" and not self.sync_batch_norm:
            buffers = tree_unflatten(buffers, [
                C.broadcast(b, 0, self.group)
                for _, b in tree_leaves(buffers)])
        self.model.load_buffers_dict(buffers)

    def _loop(self, state, ts, arp, spec, params, buffers, flat, slots, gen,
              data_iter):
        num_samples = self.dataset.size()
        n = self.n_data
        rank0 = C.group_rank(None) == 0
        wall_start = window_start = time.time()
        window_records = 0
        window_iters = 0
        obs_on = obs.enabled()
        ins = obs.train_instruments() if obs_on else None
        pins = obs.parallel_instruments() if obs_on else None
        host = str(C.group_rank(None))
        sigs = set()
        while not self.end_when(state):
            profiler.poll()
            x, y, n_local = next(data_iter)
            lrs = ts.current_lrs()
            lr = float(lrs[0])
            with obs.trace.span("train/step"):
                if arp is not None:
                    loss, params, buffers, flat, slots = self._sharded_step(
                        ts, arp, spec, params, buffers, flat, slots, x, y,
                        lrs[0], gen)
                else:
                    loss, params, buffers, slots = ts.step(
                        params, buffers, slots, x, y, lrs, gen)
            if obs_on:
                sigs.add(step_signature(x, y))
            self._live_slots = slots
            if self._fault_hook is not None:
                self._fault_hook(state)
            records = n_local * n
            state["recordsProcessedThisEpoch"] += records
            state["LearningRate"] = lr
            window_records += records
            window_iters += 1
            state["neval"] += 1
            aux_now = self._should_fire_aux(state)
            if (state["neval"] - 1) % self.log_interval == 0 or aux_now:
                loss_v = float(loss)     # the loop's only host read
                self.host_reads += 1
                dt = time.time() - window_start
                state["Loss"] = loss_v
                self.metrics.add("computing time", dt * 1e9)
                if obs_on:
                    ins.records_total.inc(window_records)
                    ins.throughput.set(window_records / max(dt, 1e-9))
                    ins.loss.set(loss_v)
                    ins.learning_rate.set(lr)
                    ins.epoch.set(state["epoch"])
                    ins.jit_compiles.set(len(sigs))
                    # the whole window and its per-iteration average (the
                    # step-time proxy while launches overlap host work)
                    pins.sync_window_seconds.labels(host).observe(dt)
                    pins.step_seconds.labels(host).observe(
                        dt / max(window_iters, 1))
                logger.info(
                    "[Epoch %d %d/%d][Iteration %d][Wall Clock %.3fs] "
                    "Trained %d records in %.4f seconds. Throughput is %.1f "
                    "records/second. Loss is %.4f.", state["epoch"],
                    state["recordsProcessedThisEpoch"], num_samples,
                    state["neval"] - 1, time.time() - wall_start,
                    window_records, dt, window_records / max(dt, 1e-9),
                    loss_v)
                if self.train_summary is not None and rank0:
                    it = state["neval"] - 1
                    summ = self.train_summary
                    summ.add_scalar("Loss", loss_v, it)
                    summ.add_scalar("LearningRate", lr, it)
                    summ.add_scalar("Throughput",
                                    window_records / max(dt, 1e-9), it)
                window_records = 0
                window_iters = 0
                window_start = time.time()
            if state["recordsProcessedThisEpoch"] >= num_samples:
                state["epoch"] += 1
                state["recordsProcessedThisEpoch"] = 0
            kv = dict(neval=state["neval"], epoch=state["epoch"])
            if "Loss" in state:
                kv["Loss"] = state["Loss"]
            ts.update_states(**kv)
            if aux_now:
                self._write_back(params, buffers)
                with obs.trace.span("train/validation"):
                    if self._val_now:
                        self._run_validation(state)
                ck_hist = (ins.checkpoint_seconds if obs_on and self._ckpt_now
                           else None)
                with obs.trace.span("train/checkpoint", histogram=ck_hist):
                    if self._ckpt_now:
                        self._run_checkpoint(state, slots)
        if obs_on and window_records:
            # the partial window after the last log point
            ins.records_total.inc(window_records)
        self._write_back(params, buffers)
        return params, buffers
