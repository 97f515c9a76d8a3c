"""PyTorch/CUDA port of ``bigdl_tpu``.

The package mirrors the JAX package's layout (``nn/``, ``ops/``,
``models/``, ``optim/``, ``utils/``) so each module's counterpart is
easy to find, but imports only ``torch`` and ``numpy``: nothing of JAX
and nothing of ``bigdl_tpu``. Entry points take an explicit
``device=`` that defaults to ``"cuda"``; on a machine without a GPU
they raise and ask for ``device="cpu"`` instead of falling back.

The only hand-written kernel so far is the flash-attention forward
(``ops/csrc/flash_attention.cu``), the port of the JAX package's one
Pallas kernel. Ported so far: inference of the TransformerLM (scoring,
generation, ``GenerationService``) and its training (differentiable
flash attention, criterions, SGD / Adam / AdamW, ``TrainStep``), and
the vision path (convolution, BatchNorm, pooling, LeNet-5, ResNet, the
data path and the ``LocalOptimizer`` loop), whose layers are torch ops
as they are XLA ops in the JAX package.
"""

from bigdl_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
