"""The data path of the port (counterparts of ``bigdl_tpu.dataset``):
samples, minibatches, the sample-to-minibatch transformer, in-memory
datasets with the reference's infinite shuffled training iterator, and
the background prefetch that stages batches on the device. The record
readers, image transforms and the native reader are not ported yet."""

from bigdl_tpu_torch.dataset.dataset import (
    AbstractDataSet, DataSet, LocalDataSet, ShardedDataSet,
    TransformedDataSet,
)
from bigdl_tpu_torch.dataset.minibatch import MiniBatch, PaddingParam
from bigdl_tpu_torch.dataset.prefetch import prefetch, to_device
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import (
    ChainedTransformer, SampleToMiniBatch, Transformer,
)

__all__ = ["AbstractDataSet", "ChainedTransformer", "DataSet",
           "LocalDataSet", "MiniBatch", "PaddingParam", "Sample",
           "SampleToMiniBatch", "ShardedDataSet", "TransformedDataSet",
           "Transformer", "prefetch", "to_device"]
