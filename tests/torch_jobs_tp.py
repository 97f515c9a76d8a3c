"""Rank-side jobs of ``tests/test_torch_tp.py`` and
``tests/test_torch_tp_serving.py`` (run in ``torch_world.World``; no JAX
here). Every rank of the world runs each job; a job on an ``n``-way
model mesh builds the mesh on every rank (``Engine.create_mesh`` is
collective over the world) and the ranks outside it return None."""

from __future__ import annotations

import threading
import time

import numpy as np

from torch_world import rank

_MESHES: dict = {}


def mesh(n: int):
    """The ``("model", n)`` mesh over ranks ``[0, n)``, made once a rank
    (every rank of the world takes part in making it)."""
    from bigdl_tpu_torch.parallel import Engine

    if n not in _MESHES:
        _MESHES[n] = Engine.create_mesh([("model", n)],
                                        devices=list(range(n)))
    return _MESHES[n]


def lm(cfg: dict, params):
    """The port's TransformerLM of ``cfg`` on the CPU, with the JAX
    model's weights."""
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.utils.weights import load_jax_params

    cfg = dict(cfg)
    vocab = cfg.pop("vocab_size")
    m = TransformerLM(vocab, device="cpu", **cfg)
    load_jax_params(m, params)
    m.evaluate()
    return m


def _shard(cfg, params, n, int8=False):
    from bigdl_tpu_torch.nn.quantized import Quantizer
    from bigdl_tpu_torch.parallel.tp import shard_model

    m = lm(cfg, params)
    if int8:
        m = Quantizer.quantize(m)
        m.evaluate()
    return shard_model(m, mesh(n))


# ------------------------------------------------------------- the model
def shard_params_rows(params, n):
    """This rank's slices of a few leaves by ``shard_params``."""
    from bigdl_tpu_torch.parallel.tp import shard_params, transformer_tp_rules

    msh = mesh(n)
    if rank() >= n:
        return None
    local = shard_params(params, msh, transformer_tp_rules("model"))
    b0 = local["block0"]
    return {"qkv": b0["attn"]["qkv"]["~params"]["weight"].numpy(),
            "fc2": b0["fc2"]["~params"]["weight"].numpy(),
            "tok_embed": local["~params"]["tok_embed"].numpy(),
            "ln": b0["ln1"]["~params"]["weight"].numpy()}


def sharded_forward(cfg, params, ids, n, use_flash=False):
    """The sharded scoring forward's logits, and the flash calls a rank
    made (one per layer and forward)."""
    import torch

    from bigdl_tpu_torch.ops import flash_attention as fa

    msh = mesh(n)
    if rank() >= n:
        return None
    local = _shard(cfg, params, n)
    for blk in local.blocks():
        blk.attn.use_flash = use_flash
    calls = []
    real = fa.flash_attention

    def counted(q, k, v, **kw):
        calls.append(tuple(q.shape) + (k.shape[1],))
        return real(q, k, v, **kw)

    fa.flash_attention = counted
    try:
        with torch.no_grad():
            out = local(torch.as_tensor(ids)).numpy()
    finally:
        fa.flash_attention = real
    heads = [blk.attn.num_heads for blk in local.blocks()]
    return {"logits": out, "flash_calls": calls, "local_heads": heads,
            "mesh": repr(msh)}


def sharded_forward_2d(cfg, params, ids):
    """The forward of the 2-D ``data x model`` shard on a (2, 2) mesh of
    the world's 4 ranks, and the blocks this rank keeps."""
    import torch

    from bigdl_tpu_torch.parallel.tp import shard_model, transformer_tp_rules

    local = shard_model(lm(cfg, params), _mesh_2d(),
                        transformer_tp_rules("model", "data"))
    from bigdl_tpu_torch.parallel.tp import _weight

    with torch.no_grad():
        out = local(torch.as_tensor(ids)).numpy()
        gathered = tuple(_weight(local.block0.attn.qkv).shape)
    return {"logits": out, "qkv_block": tuple(local.block0.attn.qkv.weight.shape),
            "qkv_gathered": gathered,
            "pos_block": tuple(local.pos_embed.shape)}


def contiguous_qkv_forward(cfg, params, ids, n):
    """The logits when each rank holds a CONTIGUOUS block of the fused
    qkv rows (the plain dim-0 split) instead of its own heads."""
    import torch

    mesh(n)
    if rank() >= n:
        return None
    full = lm(cfg, params)
    local = _shard(cfg, params, n)
    r = rank()
    with torch.no_grad():
        for blk, fblk in zip(local.blocks(), full.blocks()):
            w, b = fblk.attn.qkv.weight, fblk.attn.qkv.bias
            per = w.shape[0] // n
            blk.attn.qkv.weight.copy_(w[r * per:(r + 1) * per])
            blk.attn.qkv.bias.copy_(b[r * per:(r + 1) * per])
        return local(torch.as_tensor(ids)).numpy()


def bias_before_sum_forward(cfg, params, ids, n):
    """The logits when each row-parallel layer adds its bias on every rank
    BEFORE the all-reduce (the bias then counts n times)."""
    import torch
    import torch.nn.functional as F

    from bigdl_tpu_torch.parallel import collectives as C

    mesh(n)
    if rank() >= n:
        return None
    local = _shard(cfg, params, n)

    def early(self, x):
        return C.all_reduce(F.linear(x, self.weight, self.bias),
                            self.tp_group)

    for blk in local.blocks():
        for mod in (blk.attn.out_proj, blk.fc2):
            mod.forward = early.__get__(mod)
    with torch.no_grad():
        return local(torch.as_tensor(ids)).numpy()


def int8_forward(cfg, params, ids, n, local_scale=False):
    """The sharded int8 clone's logits beside the unsharded clone's on
    this rank; ``local_scale`` quantizes each row-parallel input with the
    rank's own scale instead of the all-reduced one."""
    import torch

    from bigdl_tpu_torch.nn.quantized import Quantizer

    mesh(n)
    if rank() >= n:
        return None
    local = _shard(cfg, params, n, int8=True)
    if local_scale:
        from bigdl_tpu_torch.parallel import collectives as C

        real = C.all_reduce

        def no_max(x, group=None, op="sum"):
            return x.clone() if op == "max" else real(x, group, op)

        C.all_reduce = no_max
    try:
        with torch.no_grad():
            got = local(torch.as_tensor(ids)).numpy()
    finally:
        if local_scale:
            C.all_reduce = real
    whole = Quantizer.quantize(lm(cfg, params))
    whole.evaluate()
    with torch.no_grad():
        want = whole(torch.as_tensor(ids)).numpy()
    return {"sharded": got, "whole": want}


def sharded_generate(cfg, params, prompt, n_new, n, temperature=0.0,
                     seed=0):
    """``generate`` on the shard with its heads-sharded caches (every rank
    of the mesh calls it and gets the same tokens)."""
    import torch

    msh = mesh(n)
    if rank() >= n:
        return None
    local = _shard(cfg, params, n)
    gen = torch.Generator().manual_seed(seed)
    out = local.generate(prompt, n_new, temperature=temperature,
                         generator=gen,
                         kv_cache_sharding=local.kv_cache_sharding(msh))
    caches = local.init_cache(1, 8, sharding=local.kv_cache_sharding(msh))
    return {"ids": out.numpy(), "cache_shape": tuple(caches[0][0].shape)}


def fetch_put_round_trip(n):
    """``fetch_to_host`` of a heads-sharded tree (every rank, then onto
    rank 0 alone) and ``put_from_host`` back (each rank cutting its own
    block, then scattered from rank 0)."""
    import torch

    from bigdl_tpu_torch.parallel.tp import (P, NamedSharding,
                                             fetch_to_host, put_from_host)

    msh = mesh(n)
    if rank() >= n:
        return None
    sh = NamedSharding(msh, P(None, "model", None, None))
    x = torch.arange(1 * 4 * 6 * 2, dtype=torch.float32).reshape(1, 4, 6, 2)
    idx = sh.index(tuple(x.shape))
    tree = {"k": x[idx].clone(), "v": (2 * x)[idx].clone()}
    host = fetch_to_host(tree, sh)
    host0 = fetch_to_host(tree, sh, dst=0)
    back = put_from_host(host, sh)
    like = {"k": torch.empty_like(tree["k"]), "v": torch.empty_like(
        tree["v"])}
    back0 = put_from_host(host0 if rank() == 0 else None, sh, src=0,
                          like=like)
    return {"host": host, "host0": host0, "local": tree["k"].numpy(),
            "back": {k: v.numpy() for k, v in back.items()},
            "back0": {k: v.numpy() for k, v in back0.items()},
            "index": [(s.start, s.stop) for s in idx]}


# ------------------------------------------------------------- the engine
def _mesh_2d():
    from bigdl_tpu_torch.parallel import Engine

    if "2d" not in _MESHES:
        _MESHES["2d"] = Engine.create_mesh([("data", 2), ("model", 2)])
    return _MESHES["2d"]


def serve(cfg, params, reqs, n, concurrent=False, warm=0, tenants=None,
          draft=False, stats_only=False, **engine_kw):
    """The sharded engine on an ``n``-way mesh: the leader serves
    ``reqs`` ((prompt, max_new) pairs; from one thread each when
    ``concurrent``, else in turn) and returns the rows, ``stats()`` after
    the first ``warm`` requests and at the end, the ledger's busy time,
    and the headers it sent; a follower returns the headers it ran."""
    from bigdl_tpu_torch.nn.quantized import Quantizer
    from bigdl_tpu_torch.serving import ContinuousBatchingEngine

    if n == "2d":
        # the (data 2, model 2) mesh of the world's 4 ranks, 2-D rules
        from bigdl_tpu_torch.parallel.tp import transformer_tp_rules

        msh = _mesh_2d()
        engine_kw["tp_rules"] = transformer_tp_rules("model", "data")
    else:
        msh = mesh(n)
        if rank() >= n:
            return None
    m = lm(cfg, params)
    if draft:
        d = Quantizer.quantize(m)
        d.evaluate()
        engine_kw["draft"] = d
    eng = ContinuousBatchingEngine(m, mesh=msh, **engine_kw)
    if stats_only:
        st = eng.stats() if eng.is_leader else None
        eng.stop(drain=False)
        if not eng.is_leader:
            eng.start()         # returns at the leader's stop header
        return {"stats": st, "leader": eng.is_leader}
    rows, errs = [None] * len(reqs), []
    out = {"leader": eng.is_leader}
    with eng:
        if not eng.is_leader:
            return {"leader": False, "headers": eng._tp.headers,
                    "crashed": repr(eng._crashed)}
        if concurrent:
            def worker(i, p, k):
                try:
                    rows[i] = eng.submit(p, k).result(timeout=120)
                except Exception as e:   # reported to the test
                    errs.append(repr(e))

            ts = [threading.Thread(target=worker, args=(i, p, k))
                  for i, (p, k) in enumerate(reqs)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        else:
            for i, (p, k) in enumerate(reqs):
                kw = {"tenant": tenants[i]} if tenants else {}
                rows[i] = eng.submit(p, k, **kw).result(timeout=120)
                if i + 1 == warm:
                    out["stats_warm"] = eng.stats()
        out["stats"] = eng.stats()
        out["busy"] = eng._usage.device_time()
    out.update(rows=rows, errs=errs, headers=eng._tp.headers)
    return out


def preempt_round(cfg, params, n, victim, urgent, **engine_kw):
    """The JAX preemption drill on the sharded engine: one slot, both
    request shapes warmed, a low decode provably in the slot, then a high
    request whose slack expires at once and preempts it."""
    from bigdl_tpu_torch.serving import ContinuousBatchingEngine

    msh = mesh(n)
    if rank() >= n:
        return None
    eng = ContinuousBatchingEngine(lm(cfg, params), max_slots=1,
                                   prefill_chunk=4, preempt_slack_s=0.002,
                                   mesh=msh, **engine_kw)
    with eng:
        if not eng.is_leader:
            return {"leader": False}
        eng.submit(victim, 2, priority="low").result(timeout=60)
        eng.submit(urgent, 2, priority="high").result(timeout=60)
        h_low = eng.submit(victim, 40, priority="low", tenant="batch")
        next(h_low.tokens())               # provably decoding in-slot
        h_high = eng.submit(urgent, 4, priority="high",
                            tenant="interactive")
        high = h_high.result(timeout=120)
        low = h_low.result(timeout=120)
        st = eng.stats()
    return {"leader": True, "high": high, "low": low,
            "preempted": (h_low.preempted, h_high.preempted),
            "qos_preempted": st["qos"]["preempted"],
            "finished": st["finished"]}


def tp_comparison(cfg, params, n, **kw):
    """``run_tp_comparison`` on every rank; the leader's result."""
    from bigdl_tpu_torch.serving import run_tp_comparison

    msh = mesh(n)
    if rank() >= n:
        return None
    m = lm(cfg, params)
    res = run_tp_comparison(m, tp=n, mesh=msh, **kw)
    return res


# ------------------------------------------------------ sharded checkpoints
def ckpt_two_ranks(path):
    """Each rank saves its half of a 64-element flat vector (``P(data)``
    over the world) and a replicated buffer; the state restores into the
    same layout, onto a replicated layout, and onto the other rank's
    half."""
    import os

    import torch

    from bigdl_tpu_torch.parallel import Engine
    from bigdl_tpu_torch.parallel.tp import P, NamedSharding
    from bigdl_tpu_torch.utils.sharded_ckpt import (restore_train_state,
                                                    save_train_state)

    msh = Engine.default_mesh()
    sh = NamedSharding(msh, P("data"))
    flat = torch.arange(64, dtype=torch.float32)
    local = flat[sh.index((64,))].clone()
    params = {"w": local}
    buffers = {"count": torch.tensor(7)}
    save_train_state(path, 3, params, buffers, (), {"Loss": 0.5},
                     shardings=({"w": sh}, None, None))
    step, rp, rb, _, state = restore_train_state(
        path, like=(params, buffers, ()), shardings=({"w": sh}, None, None))
    _, full, _, _, _ = restore_train_state(
        path, like=({"w": torch.empty(64)}, buffers, ()))
    return {"step": step, "state": state, "same": rp["w"].numpy(),
            "local": local.numpy(), "full": full["w"].numpy(),
            "count": int(rb["count"]),
            "files": sorted(os.listdir(path))}


def _tiny_opt(path, iters, fault_at=None):
    """A 2-rank DistriOptimizer over one record a rank (every epoch the
    same batch), SGD with momentum, f32 on the wire, sharded slot
    checkpoints every 3 iterations; ``fault_at`` injects one failure at
    that iteration."""
    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import Sample, ShardedDataSet
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.parallel import DistriOptimizer
    from torch_jobs_parallel import mlp

    r = np.random.RandomState(0)
    samples = [Sample(r.randn(8).astype(np.float32),
                      np.float32(1 + i % 3)) for i in range(2)]
    model = mlp(8, 16, 3)
    model.load_params_dict({
        k: {"~params": {n: torch.tensor(r.randn(*t.shape).astype(
            np.float32) * 0.3) for n, t in v["~params"].items()}}
        for k, v in model.params_dict().items()})
    # an f32 wire: the model's weights are then the f32 master copy a
    # retry rebuilds from (a bf16 wire rounds them)
    opt = DistriOptimizer(model=model, dataset=ShardedDataSet(samples),
                          criterion=nn.ClassNLLCriterion(), batch_size=2,
                          end_when=Trigger.max_iteration(iters),
                          compress_dtype=None)
    opt.set_optim_method(SGD(learning_rate=0.3, momentum=0.9,
                             dampening=0.0))
    opt.set_checkpoint(path, Trigger.several_iteration(3),
                       slots_backend="orbax")
    fired = []
    if fault_at is not None:
        def hook(state):
            if state["neval"] >= fault_at and not fired:
                fired.append(state["neval"])
                raise RuntimeError("injected executor failure")

        opt._fault_hook = hook
    return opt, fired


def orbax_continuation(path, iters, fault_at=None):
    """The final parameters of the tiny run, with a failure at
    ``fault_at`` (a retry from the newest sharded checkpoint) or
    without."""
    import os

    from bigdl_tpu_torch.utils import config as bt_config
    from bigdl_tpu_torch.utils.weights import params_to_numpy

    opt, fired = _tiny_opt(path, iters, fault_at)
    bt_config.set_property("bigdl.failure.retryTimes", 3)
    try:
        model = opt.optimize()
    finally:
        bt_config.clear_property("bigdl.failure.retryTimes")
    return {"params": params_to_numpy(model), "fired": fired,
            "neval": opt.optim_method.state["neval"],
            "files": sorted(os.listdir(path))}


def fault_and_abandon(cfg, params, n, prompt):
    """A chaos dispatch fault on the leader, then a ``stop(drain=False)``
    with a request in flight, each on its own engine: the leader's
    handles fail with ``EngineStopped`` and the followers leave their
    loop (a crash flagged)."""
    from bigdl_tpu_torch.serving import ChaosInjector, ContinuousBatchingEngine
    from bigdl_tpu_torch.serving.streams import EngineStopped

    msh = mesh(n)
    if rank() >= n:
        return None
    chaos = ChaosInjector()
    eng = ContinuousBatchingEngine(lm(cfg, params), max_slots=2,
                                   prefill_chunk=4, mesh=msh, chaos=chaos)
    out = {}
    with eng:
        if eng.is_leader:
            chaos.fail_dispatch(nth=3)
            h = eng.submit(prompt, 8)
            try:
                h.result(timeout=60)
                out["fault"] = "served"
            except EngineStopped:
                out["fault"] = "stopped"
    out["crashed"] = eng._crashed is not None
    eng = ContinuousBatchingEngine(lm(cfg, params), max_slots=2,
                                   prefill_chunk=4, mesh=msh)
    eng.start()
    if eng.is_leader:
        h = eng.submit(prompt, 30)
        next(h.tokens())
        eng.stop(drain=False)
        try:
            h.result(timeout=60)
            out["abandon"] = "served"
        except EngineStopped:
            out["abandon"] = "stopped"
    out["headers"] = eng._tp.headers
    return out


def serve_observed(cfg, params, reqs, n):
    """The sharded engine with every observability hook on (a fresh
    default registry and recorder on every rank, the sampler at 50 ms,
    the default detectors): the leader serves ``reqs`` in turn and
    returns the rows, its ``stats()`` and the names in its registry; a
    follower returns what its own process's registry, recorder and pool
    table hold after the leader's stop header."""
    from bigdl_tpu_torch import observability as obs
    from bigdl_tpu_torch.observability import memory as obs_memory
    from bigdl_tpu_torch.serving import ContinuousBatchingEngine

    msh = mesh(n)
    if rank() >= n:
        return None
    reg, rec = obs.MetricRegistry(), obs.FlightRecorder()
    prev_reg = obs.set_default_registry(reg)
    prev_rec = obs.set_default_recorder(rec)
    try:
        eng = ContinuousBatchingEngine(
            lm(cfg, params), mesh=msh, max_slots=2, prefill_chunk=4,
            service_name="tp_obs", timeseries_interval_s=0.05)
        with eng:
            if eng.is_leader:
                rows = [eng.submit(p, k).result(timeout=120)
                        for p, k in reqs]
                time.sleep(0.2)            # a few sampler points
                st = eng.stats()
        out = {"leader": eng.is_leader, "headers": eng._tp.headers,
               "names": sorted(m.name for m in reg.collect()),
               "events": len(rec),
               "pools": sorted(p for p in obs_memory.pool_sizes()
                               if p.startswith("serving/tp_obs/")),
               "sampler_ran": eng._ts.running or bool(
                   eng._ts.snapshot()["metrics"].get("queue_depth", {})
                   .get("points"))}
        if eng.is_leader:
            out.update(rows=rows, stats={
                k: st[k] for k in ("admitted", "finished", "jit_compiles",
                                   "incidents", "alerts")},
                admitted=reg.get("bdt_serving_admitted_total")
                .labels("tp_obs").get())
        return out
    finally:
        obs.set_default_registry(prev_reg)
        obs.set_default_recorder(prev_rec)
