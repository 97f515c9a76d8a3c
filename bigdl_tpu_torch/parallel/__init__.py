"""Distributed training and serving over ``torch.distributed`` (port of
``bigdl_tpu/parallel``): the engine and its named-axis mesh of ranks, the
flat-parameter collectives, the ZeRO-1 ``DistriOptimizer``, ring and
Ulysses attention, the GPipe pipeline, expert-parallel MoE, and the
tensor-parallel rules and sharded model (``tp.py``) behind the serving
engine's ``mesh=``."""

from bigdl_tpu_torch.parallel.engine import Engine, EngineType, Mesh
from bigdl_tpu_torch.parallel.all_reduce import (
    AllReduceParameter, flatten_params, unflatten_params, pad_to_multiple,
    compress, decompress,
)
from bigdl_tpu_torch.parallel.distri_optimizer import DistriOptimizer
from bigdl_tpu_torch.parallel.ring_attention import (ring_attention,
                                                     ulysses_attention)
from bigdl_tpu_torch.parallel.pipeline import pipeline_spmd, stack_stage_params
from bigdl_tpu_torch.parallel.moe import MoEMLP, moe_spmd
from bigdl_tpu_torch.parallel.tp import (
    NamedSharding, P, PartitionSpec, fetch_to_host, kv_pool_sharding,
    kv_pool_spec, put_from_host, replicate, shard_model, shard_params,
    spec_for_params, transformer_tp_rules,
)

__all__ = ["Engine", "EngineType", "Mesh", "AllReduceParameter",
           "flatten_params", "unflatten_params", "pad_to_multiple",
           "compress", "decompress", "DistriOptimizer", "ring_attention",
           "ulysses_attention", "pipeline_spmd", "stack_stage_params",
           "MoEMLP", "moe_spmd", "NamedSharding", "P", "PartitionSpec",
           "fetch_to_host", "kv_pool_sharding", "kv_pool_spec",
           "put_from_host", "replicate", "shard_model", "shard_params",
           "spec_for_params", "transformer_tp_rules"]
