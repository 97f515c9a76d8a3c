"""MiniBatch: the batch protocol the training loops consume (port of
``bigdl_tpu/dataset/minibatch.py``).

Batches are stacked numpy arrays on the host, staged on the device in
one copy each; variable-length records are padded at stack time by a
:class:`PaddingParam`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.utils.table import Table


class PaddingParam:
    """``padding_value``: fill value. ``fixed_length``: per-tensor target
    length along dim 0 of each record (-1 = pad to the longest)."""

    def __init__(self, padding_value: float = 0.0,
                 fixed_length: Optional[Sequence[int]] = None):
        self.padding_value = padding_value
        self.fixed_length = (list(fixed_length) if fixed_length is not None
                             else None)


def _stack(arrays: List[np.ndarray], padding: Optional[PaddingParam],
           idx: int) -> np.ndarray:
    shapes = {a.shape for a in arrays}
    if len(shapes) == 1 and padding is None:
        return np.stack(arrays)
    if padding is None:
        padding = PaddingParam()
    if padding.fixed_length is not None and padding.fixed_length[idx] > 0:
        target = padding.fixed_length[idx]
        longest = max(a.shape[0] for a in arrays)
        if longest > target:
            raise ValueError(
                f"record length {longest} exceeds fixed_length {target}; "
                f"truncate records upstream or raise fixed_length")
    else:
        target = max(a.shape[0] for a in arrays)
    rest = arrays[0].shape[1:]
    out = np.full((len(arrays), target) + rest, padding.padding_value,
                  dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0]] = a
    return out


class MiniBatch:
    """A stacked batch of Samples."""

    def __init__(self, inputs, targets=None):
        self.inputs = inputs if isinstance(inputs, list) else [inputs]
        if targets is None:
            self.targets = []
        else:
            self.targets = targets if isinstance(targets, list) else [targets]

    @staticmethod
    def from_samples(samples: List[Sample], feature_padding=None,
                     label_padding=None) -> "MiniBatch":
        n_f = samples[0].num_feature()
        n_l = samples[0].num_label()
        inputs = [_stack([s.features[i] for s in samples], feature_padding, i)
                  for i in range(n_f)]
        targets = [_stack([s.labels[i] for s in samples], label_padding, i)
                   for i in range(n_l)]
        return MiniBatch(inputs, targets)

    def size(self) -> int:
        return self.inputs[0].shape[0]

    def get_input(self):
        return self.inputs[0] if len(self.inputs) == 1 else Table(*self.inputs)

    def get_target(self):
        if not self.targets:
            return None
        return (self.targets[0] if len(self.targets) == 1
                else Table(*self.targets))

    def slice(self, offset: int, length: int) -> "MiniBatch":
        """1-based offset slice."""
        s = slice(offset - 1, offset - 1 + length)
        return MiniBatch([x[s] for x in self.inputs],
                         [t[s] for t in self.targets])

    def __repr__(self):
        return (f"MiniBatch(inputs={[x.shape for x in self.inputs]}, "
                f"targets={[t.shape for t in self.targets]})")
