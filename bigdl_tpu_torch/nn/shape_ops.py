"""Shape layers (port of ``Reshape`` and ``View`` in
``bigdl_tpu/nn/shape_ops.py``), with the JAX package's batch inference:
the leading dimension is kept as a batch dimension when the element
count does not match the requested shape."""

from __future__ import annotations

import math

from bigdl_tpu_torch.nn.module import Module


class Reshape(Module):
    """Reshape the non-batch dims. ``batch_mode`` None infers: dim 0 is
    the batch iff the element count does not match ``size``."""

    def __init__(self, size, batch_mode=None):
        super().__init__()
        self.size = tuple(size)
        self.batch_mode = batch_mode

    def forward(self, input):
        numel = math.prod(self.size)
        if self.batch_mode is True or (
                self.batch_mode is None and input.numel() != numel):
            return input.reshape((input.shape[0],) + self.size)
        return input.reshape(self.size)


class View(Module):
    """Reshape with -1 support and batch passthrough.
    ``set_num_input_dims`` records the count, as the JAX layer does; the
    batch inference above does not read it there either."""

    def __init__(self, *sizes):
        super().__init__()
        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)):
            sizes = tuple(sizes[0])
        self.sizes = tuple(sizes)
        self.num_input_dims = 0

    def set_num_input_dims(self, n: int) -> "View":
        self.num_input_dims = n
        return self

    def forward(self, input):
        numel = math.prod(s for s in self.sizes if s != -1)
        infer = -1 in self.sizes
        if input.numel() == numel or (
                infer and input.numel() % max(1, numel) == 0
                and input.dim() <= len(self.sizes)):
            return input.reshape(self.sizes)
        return input.reshape((input.shape[0],) + self.sizes)
