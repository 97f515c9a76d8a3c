"""DataSet: the training data abstraction (port of
``bigdl_tpu/dataset/dataset.py``).

The reference's semantics are kept: the training iterator is infinite
(it walks a shuffled index array modulo the length, from a random
offset), ``shuffle()`` re-permutes the index array only, and a
:class:`ShardedDataSet` holds one process's contiguous shard of the
records with its own shuffle. The JAX package picks the shard by JAX
process; here, by default, by rank of the ``torch.distributed`` process
group (shard 0 of 1 without one), the ranks the ``DistriOptimizer``
trains over.
"""

from __future__ import annotations

import itertools
from typing import Iterator, List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch, Transformer


class AbstractDataSet:
    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self) -> None:
        raise NotImplementedError

    def data(self, train: bool) -> Iterator:
        raise NotImplementedError

    def transform(self, transformer: Transformer) -> "TransformedDataSet":
        return TransformedDataSet(self, transformer)

    def __rshift__(self, transformer: Transformer) -> "TransformedDataSet":
        return self.transform(transformer)


def _infinite(records, index, rng):
    n = len(records)
    offset = int(rng.randint(0, n)) if n else 0

    def walk():
        i = offset
        while True:
            yield records[index[i % n]]
            i += 1

    return walk()


class LocalDataSet(AbstractDataSet):
    """In-memory dataset with the reference's infinite shuffled-index
    training iterator; ``data(train=False)`` walks the records once, in
    order."""

    def __init__(self, records: Sequence, seed: int = 1):
        self.records = list(records)
        self._index = np.arange(len(self.records))
        self._rng = np.random.RandomState(seed)

    def size(self) -> int:
        return len(self.records)

    def shuffle(self) -> None:
        self._rng.shuffle(self._index)

    def data(self, train: bool = True) -> Iterator:
        if train:
            # reads self._index live, so a shuffle applies mid-stream
            return _infinite(self.records, self._index, self._rng)
        return iter(self.records)


class ShardedDataSet(AbstractDataSet):
    """Shard ``shard_id`` of ``num_shards`` (contiguous, the remainder
    spread over the first shards; default: this rank of the world),
    shuffled by its own RNG (seed + shard_id). ``size()`` is the global
    record count."""

    def __init__(self, records: Sequence, shard_id: Optional[int] = None,
                 num_shards: Optional[int] = None, seed: int = 1):
        import torch.distributed as dist

        up = dist.is_initialized()
        self.num_shards = (num_shards if num_shards is not None
                           else dist.get_world_size() if up else 1)
        self.shard_id = (shard_id if shard_id is not None
                         else dist.get_rank() if up else 0)
        all_records = list(records)
        self._total_size = len(all_records)
        base, rem = divmod(self._total_size, self.num_shards)
        start = self.shard_id * base + min(self.shard_id, rem)
        length = base + (1 if self.shard_id < rem else 0)
        self.records: List = all_records[start:start + length]
        self._index = np.arange(len(self.records))
        self._rng = np.random.RandomState(seed + self.shard_id)

    def size(self) -> int:
        return self._total_size

    def local_size(self) -> int:
        return len(self.records)

    def shuffle(self) -> None:
        self._rng.shuffle(self._index)

    def data(self, train: bool = True) -> Iterator:
        if train:
            return _infinite(self.records, self._index, self._rng)
        return iter(self.records)


class TransformedDataSet(AbstractDataSet):
    def __init__(self, base: AbstractDataSet, transformer: Transformer):
        self.base = base
        self.transformer = transformer

    def size(self) -> int:
        return self.base.size()

    def local_size(self) -> int:
        return getattr(self.base, "local_size", self.base.size)()

    def shuffle(self) -> None:
        self.base.shuffle()

    def data(self, train: bool = True) -> Iterator:
        return self.transformer(self.base.data(train))

    @property
    def num_shards(self):
        return getattr(self.base, "num_shards", 1)


class DataSet:
    """Factory namespace."""

    @staticmethod
    def array(samples: Sequence, seed: int = 1) -> LocalDataSet:
        return LocalDataSet(samples, seed=seed)

    @staticmethod
    def sharded(samples: Sequence, shard_id: Optional[int] = None,
                num_shards: Optional[int] = None,
                seed: int = 1) -> ShardedDataSet:
        return ShardedDataSet(samples, shard_id=shard_id,
                              num_shards=num_shards, seed=seed)


def dataset_base(dataset):
    """Unwrap transformed datasets to the backing store."""
    base = dataset
    while hasattr(base, "base"):
        base = base.base
    return base


def as_dataset(dataset):
    """A list or tuple of records as a :class:`LocalDataSet`; a dataset
    as it is."""
    if isinstance(dataset, (list, tuple)):
        return LocalDataSet(list(dataset))
    return dataset


def minibatches(dataset: AbstractDataSet, batch_size: int, train: bool,
                partial_batch: bool = False) -> Iterator:
    """``dataset.data(train)`` as MiniBatches: Samples grouped by
    ``SampleToMiniBatch(batch_size, partial_batch=...)``, records that
    are batches already passed on as they are."""
    it = iter(dataset.data(train))
    first = next(it, None)
    if first is None:
        return iter(())
    records = itertools.chain([first], it)
    if isinstance(first, Sample):
        return SampleToMiniBatch(batch_size,
                                 partial_batch=partial_batch)(records)
    return records
