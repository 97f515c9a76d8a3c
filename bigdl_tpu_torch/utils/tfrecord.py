"""CRC32C and TFRecord framing: ``crc32c``, ``masked_crc32c``,
``tfrecord_frame`` and ``tfrecord_iter`` of the port's native runtime
(``bigdl_tpu_torch/native``), which run through the C++ codec where the
library is built and through its Python path where there is no
toolchain. The bytes are the JAX package's either way.
"""

from bigdl_tpu_torch.native import (crc32c, masked_crc32c, tfrecord_frame,
                                    tfrecord_iter)

__all__ = ["crc32c", "masked_crc32c", "tfrecord_frame", "tfrecord_iter"]
