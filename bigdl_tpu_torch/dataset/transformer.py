"""Transformer: composable iterator -> iterator transforms (port of
``Transformer``, ``Identity``, ``FuncTransformer``, ``SampleToMiniBatch``
and ``Normalizer`` in ``bigdl_tpu/dataset/transformer.py``; ``>>``
chains them)."""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from bigdl_tpu_torch.dataset.minibatch import MiniBatch, PaddingParam
from bigdl_tpu_torch.dataset.sample import Sample


class Transformer:
    """f: Iterator[A] -> Iterator[B], chainable with ``>>``."""

    def __call__(self, it: Iterator) -> Iterator:
        raise NotImplementedError

    def __rshift__(self, other: "Transformer") -> "ChainedTransformer":
        return ChainedTransformer(self, other)


class ChainedTransformer(Transformer):
    def __init__(self, first: Transformer, second: Transformer):
        self.first, self.second = first, second

    def __call__(self, it):
        return self.second(self.first(it))


class Identity(Transformer):
    """The records as they come."""

    def __call__(self, it):
        return it


class FuncTransformer(Transformer):
    """A per-record function as a transformer."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, it):
        return (self.fn(x) for x in it)


class SampleToMiniBatch(Transformer):
    """Group Samples into MiniBatches of ``total_batch / parallelism``
    records (the global batch must divide evenly); a last, partial batch
    only with ``partial_batch``."""

    def __init__(self, total_batch: int, parallelism: int = 1,
                 feature_padding: Optional[PaddingParam] = None,
                 label_padding: Optional[PaddingParam] = None,
                 partial_batch: bool = False):
        if total_batch % parallelism != 0:
            raise ValueError(
                f"total batch size {total_batch} must be divisible by "
                f"parallelism {parallelism}")
        self.batch_per_iter = total_batch // parallelism
        self.feature_padding = feature_padding
        self.label_padding = label_padding
        self.partial_batch = partial_batch

    def __call__(self, it):
        buf: List[Sample] = []
        for s in it:
            buf.append(s)
            if len(buf) == self.batch_per_iter:
                yield MiniBatch.from_samples(buf, self.feature_padding,
                                             self.label_padding)
                buf = []
        if buf and self.partial_batch:
            yield MiniBatch.from_samples(buf, self.feature_padding,
                                         self.label_padding)



class Normalizer(Transformer):
    """Per-record ``(x - mean) / std`` of every feature, in f32; the
    labels ride along."""

    def __init__(self, mean: float, std: float):
        self.mean, self.std = mean, std

    def __call__(self, it):
        for s in it:
            f = [(x.astype(np.float32) - self.mean) / self.std
                 for x in s.features]
            yield Sample(f, s.labels if s.labels else None)
