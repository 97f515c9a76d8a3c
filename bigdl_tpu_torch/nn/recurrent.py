"""Recurrent wrappers (port of ``TimeDistributed`` in
``bigdl_tpu/nn/recurrent.py``; the cells and the ``Recurrent`` loop are
ROADMAP.md Queue 1 item 12)."""

from __future__ import annotations

from bigdl_tpu_torch.nn.module import Module


class TimeDistributed(Module):
    """Apply ``layer`` to every time step of (batch, time, ...) by
    folding time into the batch: one batched call, no time loop."""

    def __init__(self, layer: Module):
        super().__init__()
        self.layer = layer

    def forward(self, input):
        b, t = input.shape[0], input.shape[1]
        out = self.layer(input.reshape((b * t,) + tuple(input.shape[2:])))
        return out.reshape((b, t) + tuple(out.shape[1:]))
