"""The data path of the port (counterparts of ``bigdl_tpu.dataset``):
samples, minibatches, the sample-to-minibatch transformer, in-memory
datasets with the reference's infinite shuffled training iterator, the
background prefetch that stages batches on the device, the MNIST and
CIFAR readers, the image records and their augmentations
(``dataset/image.py``), the sharded TFRecord files
(``RecordFileDataSet``, read through the C++ reader of
``bigdl_tpu_torch/native``), and the text readers: tokenizers and
dictionaries (``text``), BPE (``bpe``), 20 Newsgroups and GloVe
(``news20``), MovieLens (``movielens``) and tabular rows
(``row_transformer``). A Sample's sparse features (``nn/sparse.py``'s
``SparseTensor``) batch into a ``SparseMiniBatch``."""

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
    ChainedTransformer, Identity, SampleToMiniBatch, Transformer,
)
from bigdl_tpu_torch.dataset import (bpe, cifar, image, mnist, movielens,
                                     news20, row_transformer, text)

__all__ = ["AbstractDataSet", "ChainedTransformer", "DataSet",
           "Identity", "LocalDataSet", "MiniBatch", "PaddingParam", "RecordFileDataSet",
           "Sample", "SampleToMiniBatch", "ShardedDataSet",
           "TransformedDataSet", "Transformer", "bpe", "cifar",
           "decode_sample", "encode_sample", "image", "mnist", "movielens",
           "news20", "prefetch", "row_transformer", "text", "to_device",
           "write_record_shards"]
