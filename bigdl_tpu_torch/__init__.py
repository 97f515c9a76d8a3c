"""PyTorch/CUDA port of ``bigdl_tpu``.

The package mirrors the JAX package's layout (``nn/``, ``ops/``,
``models/``, ``optim/``, ``serving/``, ``utils/``) so each module's
counterpart is easy to find, but imports only ``torch`` and ``numpy``:
nothing of JAX and nothing of ``bigdl_tpu``. Entry points take an explicit
``device=`` that defaults to ``"cuda"``; on a machine without a GPU
they raise and ask for ``device="cpu"`` instead of falling back.

The only hand-written kernel so far is the flash-attention forward
(``ops/csrc/flash_attention.cu``), the port of the JAX package's one
Pallas kernel. Ported so far: inference of the TransformerLM (scoring,
generation, ``GenerationService``) and its training (differentiable
flash attention, criterions, SGD / Adam / AdamW, ``TrainStep``), the
vision path (convolution, BatchNorm, pooling, LeNet-5, ResNet, the
data path and the ``LocalOptimizer`` loop), whose layers are torch ops
as they are XLA ops in the JAX package, and the continuous-batching
engine (``serving/``: dense or paged KV, batched prefill, the prefix
cache and its host tier, speculative decoding, int8 KV and weights, QoS
and chaos drills) with the usage ledger and SLO watchdog that QoS reads
(``observability/``), and distributed training over ``torch.distributed``
(``parallel/``: the engine and its mesh of process groups, the ZeRO-1
``DistriOptimizer``, ring and Ulysses attention, MoE and pipeline stages;
``tools/launch.py`` starts the ranks), the graph container
(``nn/graph.py``, ``LookupTable``) and the recurrent family
(``nn/recurrent.py``, ``nn/tree_lstm.py``) with their models and mains,
the sparse stack with sparse samples (``nn/sparse.py``) and the
detection heads (``nn/detection.py``).
"""

from bigdl_tpu_torch.version import __version__

__all__ = ["resolve_device", "__version__"]


def __getattr__(name):
    # torch is imported with the first module that needs it, not with the
    # package: the launcher (tools/launch.py) only spawns and polls ranks
    if name == "resolve_device":
        from bigdl_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
