"""The SimpleRNN language model (port of ``bigdl_tpu/models/rnn/model.py``;
≙ models/rnn/SimpleRNN.scala): ``Recurrent(RnnCell(tanh))`` then
``TimeDistributed(Linear)``, (batch, time, input) to (batch, time,
output) scores."""

from __future__ import annotations

import torch

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn.activation import Tanh
from bigdl_tpu_torch.nn.container import Sequential
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.recurrent import Recurrent, RnnCell, TimeDistributed
from bigdl_tpu_torch.utils.random import RandomGenerator


class SimpleRNN:
    """``SimpleRNN(input_size, hidden_size, output_size)``, weights drawn
    from ``seed`` on ``device`` in ``dtype``."""

    def __new__(cls, input_size: int, hidden_size: int, output_size: int, *,
                seed: int = 1, device=DEFAULT_DEVICE,
                dtype=torch.float32) -> Sequential:
        kw = dict(rng=RandomGenerator(seed), device=resolve_device(device),
                  dtype=dtype)
        return (Sequential()
                .add(Recurrent().add(RnnCell(input_size, hidden_size, Tanh(),
                                             **kw)))
                .add(TimeDistributed(Linear(hidden_size, output_size, **kw))))
