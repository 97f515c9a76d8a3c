"""Rank-side jobs of ``tests/test_torch_sharded_kv.py`` and
``tests/test_torch_tp_leftovers.py`` (run in ``torch_world.World``; no
JAX here). Every rank of the world runs each job; a mesh is made on
every rank (``Engine.create_mesh`` is collective over the world)."""

from __future__ import annotations

import numpy as np

from torch_jobs_tp import lm

_MESHES: dict = {}


def mesh_of(axes):
    """The mesh of ``axes`` over the whole world, made once a rank."""
    from bigdl_tpu_torch.parallel import Engine

    key = tuple(axes)
    if key not in _MESHES:
        _MESHES[key] = Engine.create_mesh(list(axes))
    return _MESHES[key]


def kv_generate(cfg, params, prompt, n_new, max_len, axes, spec,
                ragged=None):
    """``generate`` of the port's LM with its caches laid out by
    ``NamedSharding(mesh_of(axes), spec)``: a batch split feeds each rank
    its own rows (``put_from_host``); returns this rank's tokens, the
    shape of its first cache and its first block's start, and for a
    sequence or head-dim split the logits of an int8 cache under the
    layout beside an unsplit int8 cache's. ``ragged`` (prompt lengths)
    runs ``generate_ragged`` beside it, sharded and whole."""
    import torch

    from bigdl_tpu_torch.nn.attention import KVShards
    from bigdl_tpu_torch.parallel.tp import P, NamedSharding, put_from_host

    m = lm(cfg, params)
    sh = NamedSharding(mesh_of(axes), P(*spec))
    rows = put_from_host(np.asarray(prompt),
                         NamedSharding(sh.mesh, P(spec[0], None)))
    got = m.generate(rows, n_new, max_len=max_len, kv_cache_sharding=sh)
    _, _, caches = m._decode_setup(rows, n_new, max_len,
                                   kv_cache_sharding=sh)
    out = {"tokens": got.numpy(), "cache": tuple(caches[0][0].shape),
           "start": (caches[0].start if isinstance(caches[0], KVShards)
                     else 0)}
    if spec[0] is None:     # int8 caches: the sharded logits of a prefill
        # and three steps beside the whole cache's
        t = len(prompt[0])
        logits = []
        for layout in (sh, None):
            c = m.init_cache(len(prompt), max_len, kv_dtype="int8",
                             sharding=layout)
            lg, c = m.prefill(rows, c)
            steps = [lg]
            for i in range(3):
                lg, c = m.decode_step(lg.argmax(-1), t + i, c)
                steps.append(lg)
            logits.append(torch.stack(steps).numpy())
        out["int8"], out["int8_whole"] = logits
    if ragged is not None:
        lengths = torch.as_tensor(ragged)
        out["ragged"] = m.generate_ragged(rows, lengths, n_new,
                                          max_len=max_len,
                                          kv_cache_sharding=sh).numpy()
        out["ragged_whole"] = m.generate_ragged(rows, lengths, n_new,
                                                max_len=max_len).numpy()
    return out


def int8_2d(cfg, params, ids, prompt, n_new):
    """The int8 clone sharded under 2-D ``data x model`` rules on a
    (2, 2) mesh: its logits and greedy tokens beside the unsharded int8
    clone's on this rank, and the shape of its first qkv codes."""
    import torch

    from bigdl_tpu_torch.nn.quantized import Quantizer
    from bigdl_tpu_torch.parallel.tp import shard_model, transformer_tp_rules

    q = Quantizer.quantize(lm(cfg, params))
    q.evaluate()
    local = shard_model(q, mesh_of((("data", 2), ("model", 2))),
                        transformer_tp_rules("model", "data"))
    with torch.no_grad():
        x = torch.as_tensor(ids)
        out = {"sharded": local(x).numpy(), "whole": q(x).numpy()}
    p = torch.as_tensor(prompt)
    out["tokens"] = local.generate(p, n_new).numpy()
    out["tokens_whole"] = q.generate(p, n_new).numpy()
    out["qkv_codes"] = tuple(local.block0.attn.qkv.weight_q.shape)
    return out


def moe_model_mesh(cfg, params, ids, prompt, n_new):
    """An ``n_experts`` LM sharded over a 4-way model mesh: its logits
    and greedy tokens, the local heads and the expert weights' shape
    (replicated)."""
    import torch

    from bigdl_tpu_torch.parallel.tp import shard_model

    local = shard_model(lm(cfg, params), mesh_of((("model", 4),)))
    with torch.no_grad():
        logits = local(torch.as_tensor(ids)).numpy()
    toks = local.generate(torch.as_tensor(prompt), n_new).numpy()
    return {"logits": logits, "tokens": toks,
            "heads": local.block0.attn.num_heads,
            "w1": tuple(local.block0.mlp.w1.shape)}


def seq_parallel_model_mesh(cfg, params, ids):
    """A ``sequence_parallel="seq"`` LM sharded over a (seq 2, model 2)
    mesh: this rank's block of the sequence in, its block of the logits
    out (the ring over "seq", the heads over "model")."""
    import torch

    from bigdl_tpu_torch.parallel.tp import P, NamedSharding, put_from_host
    from bigdl_tpu_torch.parallel.tp import shard_model

    msh = mesh_of((("seq", 2), ("model", 2)))
    local = shard_model(lm(cfg, params), msh)
    block = put_from_host(np.asarray(ids), NamedSharding(msh, P(None, "seq")))
    with torch.no_grad():
        out = local(block).numpy()
    return {"logits": out, "seq": msh.index("seq"),
            "heads": local.block0.attn.num_heads}
