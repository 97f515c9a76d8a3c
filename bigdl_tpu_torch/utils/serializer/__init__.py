"""Structured module serialization (port of
``bigdl_tpu/utils/serializer/``; ≙ the reference's protobuf format).

A zip archive holding ``module.json`` (the module tree: class path,
constructor config, child links, graph topology) and ``tensors.npz``
(all parameters and buffers as numpy arrays), in the JAX package's
format, written and read by
:mod:`bigdl_tpu_torch.utils.serializer.serializer`. Archives the JAX
package wrote load here too.
"""

from bigdl_tpu_torch.utils.serializer.serializer import (
    load_module, module_from_spec, module_to_spec, save_module,
)
