"""Transformer: composable iterator -> iterator transforms (port of
``Transformer`` and ``SampleToMiniBatch`` in
``bigdl_tpu/dataset/transformer.py``; ``>>`` chains them)."""

from __future__ import annotations

from typing import Iterator, List, Optional

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

