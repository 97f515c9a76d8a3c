"""Embedding layers (port of ``LookupTable`` in
``bigdl_tpu/nn/embedding.py``).

Indices are 1-based, as in Torch: index i reads row i - 1 of the weight,
and an index outside ``[1, n_index]`` reads the nearest row (index 0
reads row 0) instead of raising. ``max_norm`` rescales the whole weight
functionally, every row by ``min(1, max_norm / max(norm, 1e-7))``, inside
autograd: ``F.embedding(max_norm=)`` renormalises the weight in place and
only the rows it looks up, which is another function with another
gradient.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn import init as bt_init
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.random import RandomGenerator


class LookupTable(Module):
    """Rows of an ``(n_index, n_output)`` weight drawn from N(0, 1), looked
    up by 1-based indices of any shape: output ``input.shape +
    (n_output,)``. ``padding_value != 0`` zeroes the output where the
    input equals it (the weight is not touched); ``max_norm`` bounds each
    row's ``norm_type``-norm as described above."""

    def __init__(self, n_index: int, n_output: int, padding_value: float = 0,
                 max_norm: float = float("inf"), norm_type: float = 2.0,
                 should_scale_grad_by_freq: bool = False,
                 w_regularizer=None, *, rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        if should_scale_grad_by_freq:
            raise NotImplementedError(
                "LookupTable(should_scale_grad_by_freq=True) is not "
                "supported: the JAX LookupTable accepts the option and "
                "ignores it, and the port never drops an option silently")
        dev = resolve_device(device)
        self._rng = rng or RandomGenerator()
        self.n_index, self.n_output = n_index, n_output
        self.padding_value = padding_value
        self.max_norm = max_norm
        self.norm_type = norm_type
        self.new_param("weight", self._draw(), dev, dtype, w_regularizer)

    def _draw(self) -> torch.Tensor:
        return bt_init.RandomNormal(0.0, 1.0)((self.n_index, self.n_output),
                                              self._rng)

    def reset(self) -> None:
        with torch.no_grad():
            self.weight.copy_(self._draw())

    def forward(self, input):
        idx = input.to(device=self.weight.device, dtype=torch.long) - 1
        w = self.weight
        if self.max_norm != float("inf"):
            norms = torch.linalg.vector_norm(w, ord=self.norm_type, dim=1,
                                             keepdim=True)
            scale = torch.minimum(
                torch.ones_like(norms),
                self.max_norm / torch.maximum(norms,
                                              torch.full_like(norms, 1e-7)))
            w = w * scale
        out = F.embedding(idx.clamp(0, self.n_index - 1), w)
        if self.padding_value != 0:
            mask = (input.to(out.device) != self.padding_value).to(out.dtype)
            out = out * mask[..., None]
        return out

    def extra_repr(self) -> str:
        return f"nIndex={self.n_index}, nOutput={self.n_output}"
