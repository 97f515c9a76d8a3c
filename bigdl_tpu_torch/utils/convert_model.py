"""ConvertModel CLI: convert models between bigdl/caffe/torch/tf/keras
(port of ``bigdl_tpu/utils/convert_model.py``).

Reference: utils/ConvertModel.scala — scopt CLI with --from/--to/--input/
--output/--prototxt/--tf_inputs/--tf_outputs/--quantize, wiring
Module.load{Caffe,Torch,TF}/save{Caffe,TF} and the quantizer. ``bigdl``
is the port's pickle format (``utils/file.py``), as in the JAX package.
Models load on ``--device`` (default the card; ``--device cpu`` on a
machine without one). ``--from tf`` imports a GraphDef between
``--tf-inputs`` and ``--tf-outputs`` (``utils/tf_import.py``); ``--from
keras`` loads an hdf5 file, its topology from ``--keras-json`` or the
file's own ``model_config`` (``keras/converter.py``). ``--to torch`` of
a module raises ``TypeError``, as in the JAX package: the .t7 writer
takes raw objects and ``TorchObject`` trees only.

Usage:
  python -m bigdl_tpu_torch.utils.convert_model \\
      --from caffe --to bigdl --input net.caffemodel --prototxt net.prototxt \\
      --output model.bigdl [--quantize] [--device cpu]
  python -m bigdl_tpu_torch.utils.convert_model \\
      --from tf --to bigdl --input graph.pb --tf-inputs x --tf-outputs y \\
      --output model.bigdl
  python -m bigdl_tpu_torch.utils.convert_model \\
      --from bigdl --to tf --input model.bigdl --output graph.pb \\
      --input-shape 8,8,3
"""

from __future__ import annotations

import argparse
from typing import Optional

from bigdl_tpu_torch.device import DEFAULT_DEVICE


def load_model(fmt: str, path: str, prototxt: Optional[str] = None,
               tf_inputs=None, tf_outputs=None, keras_json: Optional[str] = None,
               input_shape=None, device=DEFAULT_DEVICE):
    fmt = fmt.lower()
    if fmt == "bigdl":
        from bigdl_tpu_torch.utils.file import load_module

        return load_module(path, device=device)
    if fmt == "torch":
        from bigdl_tpu_torch.utils.torchfile import load_torch

        return load_torch(path, device=device)
    if fmt == "caffe":
        from bigdl_tpu_torch.utils.caffe import load_caffe

        if not prototxt:
            raise ValueError("--prototxt is required for --from caffe")
        return load_caffe(prototxt, path, device=device)
    if fmt in ("tf", "tensorflow"):
        from bigdl_tpu_torch.utils.tf_import import load_tf

        if not tf_inputs or not tf_outputs:
            raise ValueError("--tf-inputs/--tf-outputs are required "
                             "for --from tf")
        return load_tf(path, list(tf_inputs), list(tf_outputs),
                       device=device)
    if fmt == "keras":
        from bigdl_tpu_torch.keras.converter import load_keras

        # keras_json optional: model.save(...h5) embeds model_config
        return load_keras(json_path=keras_json or None, hdf5_path=path,
                          input_shape=input_shape, device=device)
    raise ValueError(f"unknown source format {fmt!r}")


def save_model(model, fmt: str, path: str, prototxt: Optional[str] = None,
               input_shape=None):
    fmt = fmt.lower()
    if fmt == "bigdl":
        from bigdl_tpu_torch.utils.file import save_module

        save_module(model, path, overwrite=True)
        return
    if fmt == "torch":
        from bigdl_tpu_torch.utils import torchfile

        torchfile.save(path, model)
        return
    if fmt == "caffe":
        if not prototxt:
            raise ValueError("--prototxt is required for --to caffe")
        from bigdl_tpu_torch.utils.caffe_export import save_caffe

        save_caffe(model, prototxt, path, input_shape=input_shape)
        return
    if fmt in ("tf", "tensorflow"):
        if input_shape is None:
            raise ValueError("--input-shape is required for --to tf")
        from bigdl_tpu_torch.utils.tf_export import save_tf

        save_tf(model, tuple(input_shape), path)
        return
    raise ValueError(f"unknown target format {fmt!r}")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert models between formats (≙ utils/ConvertModel.scala)")
    p.add_argument("--from", dest="src", required=True,
                   choices=["bigdl", "caffe", "torch", "tf", "keras"])
    p.add_argument("--to", dest="dst", required=True,
                   choices=["bigdl", "caffe", "torch", "tf"])
    p.add_argument("--input", required=True, help="source model path")
    p.add_argument("--output", required=True, help="target model path")
    p.add_argument("--prototxt", default=None,
                   help="caffe prototxt (source or target)")
    p.add_argument("--keras-json", default=None, help="keras json topology")
    p.add_argument("--tf-inputs", default=None,
                   help="comma-separated tf graph input names")
    p.add_argument("--tf-outputs", default=None,
                   help="comma-separated tf graph output names")
    p.add_argument("--input-shape", default=None,
                   help="comma-separated sample shape (tf/caffe export)")
    p.add_argument("--quantize", action="store_true",
                   help="int8-quantize before saving (bigdl target only)")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="device the model loads on (default: the card)")
    args = p.parse_args(argv)

    shape = (tuple(int(d) for d in args.input_shape.split(","))
             if args.input_shape else None)
    model = load_model(args.src, args.input, prototxt=args.prototxt,
                       tf_inputs=args.tf_inputs.split(",") if args.tf_inputs
                       else None,
                       tf_outputs=args.tf_outputs.split(",") if args.tf_outputs
                       else None,
                       keras_json=args.keras_json, input_shape=shape,
                       device=args.device)
    if args.quantize:
        if args.dst != "bigdl":
            raise ValueError("--quantize only supports --to bigdl "
                             "(≙ ConvertModel.scala's quantize gate)")
        from bigdl_tpu_torch.nn.quantized import Quantizer

        model = Quantizer.quantize(model)
    save_model(model, args.dst, args.output, prototxt=args.prototxt,
               input_shape=shape)
    print(f"converted {args.src} -> {args.dst}: {args.output}")


if __name__ == "__main__":
    main()
