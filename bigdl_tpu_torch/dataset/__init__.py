"""The data path of the port (counterparts of ``bigdl_tpu.dataset``):
samples, minibatches, the sample-to-minibatch transformer, in-memory
datasets with the reference's infinite shuffled training iterator, the
background prefetch that stages batches on the device, the MNIST and
CIFAR readers, the image records and their augmentations
(``dataset/image.py``), and the sharded TFRecord files
(``RecordFileDataSet``). The text, news20 and movielens readers, sparse
samples and the C++ reader wait (ROADMAP.md, Queue 1 items 9 and 12)."""

from bigdl_tpu_torch.dataset.dataset import (
    AbstractDataSet, DataSet, LocalDataSet, ShardedDataSet,
    TransformedDataSet,
)
from bigdl_tpu_torch.dataset.minibatch import MiniBatch, PaddingParam
from bigdl_tpu_torch.dataset.prefetch import prefetch, to_device
from bigdl_tpu_torch.dataset.records import (
    RecordFileDataSet, decode_sample, encode_sample, write_record_shards,
)
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import (
    ChainedTransformer, SampleToMiniBatch, Transformer,
)
from bigdl_tpu_torch.dataset import cifar, image, mnist

__all__ = ["AbstractDataSet", "ChainedTransformer", "DataSet",
           "LocalDataSet", "MiniBatch", "PaddingParam", "RecordFileDataSet",
           "Sample", "SampleToMiniBatch", "ShardedDataSet",
           "TransformedDataSet", "Transformer", "cifar", "decode_sample",
           "encode_sample", "image", "mnist", "prefetch", "to_device",
           "write_record_shards"]
