"""Image classification inference (port of
``bigdl_tpu/example/imageclassification/predict.py``; ≙
example/imageclassification/ImagePredictor.scala + loadmodel/Predict.scala):
load a model in a supported format (bigdl / caffe / tf / torch), run an
ImageFrame pipeline, predict classes on ``--device`` (default the card).
``--model-type tf`` imports a GraphDef between ``--tf-inputs`` and
``--tf-outputs``; the graph takes the pipeline's NCHW batches as they
come.

Run: python -m bigdl_tpu_torch.example.imageclassification.predict \\
        --model model.bigdl --model-type bigdl --images 'dir/*.npy' \\
        [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.device import DEFAULT_DEVICE
from bigdl_tpu_torch.optim.predictor import LocalPredictor
from bigdl_tpu_torch.transform.vision import (
    ChannelNormalize, ImageFeatureToBatch, ImageFrame, LocalImageFrame,
    Resize,
)
from bigdl_tpu_torch.utils.convert_model import load_model


def predict(model, image_paths, resize=(32, 32),
            means=(0.5, 0.5, 0.5), stds=(0.25, 0.25, 0.25),
            batch_size: int = 8):
    frame = ImageFrame.read(image_paths)
    # decoded PNG/JPEG pixels are 0-255; rescale to [0,1] before normalize
    frame = LocalImageFrame([
        f.set_image(f.image() / 255.0) if f.image().max() > 1.5 else f
        for f in frame])
    frame = frame.transform(Resize(*resize)).transform(
        ChannelNormalize(means, stds))
    batches = list(ImageFeatureToBatch(batch_size, partial_batch=True)(
        iter(frame.features)))
    model.evaluate()
    predictor = LocalPredictor(model, batch_size=batch_size)
    preds = []
    for mb in batches:
        samples = [Sample(np.asarray(mb.get_input())[i])
                   for i in range(mb.get_input().shape[0])]
        preds.extend(int(c) for c in predictor.predict_class(samples))
    return preds


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True)
    p.add_argument("--model-type", default="bigdl",
                   choices=["bigdl", "caffe", "torch", "tf"])
    p.add_argument("--prototxt", default=None)
    p.add_argument("--tf-inputs", default=None)
    p.add_argument("--tf-outputs", default=None)
    p.add_argument("--images", required=True,
                   help="glob or list of .npy/.png image files")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--resize", default="32,32",
                   help="height,width the images are resized to")
    p.add_argument("--means", default="0.5,0.5,0.5")
    p.add_argument("--stds", default="0.25,0.25,0.25")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="device the model runs on (default: the card)")
    args = p.parse_args(argv)

    model = load_model(args.model_type, args.model, prototxt=args.prototxt,
                       tf_inputs=args.tf_inputs.split(",")
                       if args.tf_inputs else None,
                       tf_outputs=args.tf_outputs.split(",")
                       if args.tf_outputs else None,
                       device=args.device)
    preds = predict(model, args.images, batch_size=args.batch_size,
                    resize=tuple(int(v) for v in args.resize.split(",")),
                    means=tuple(float(v) for v in args.means.split(",")),
                    stds=tuple(float(v) for v in args.stds.split(",")))
    for i, c in enumerate(preds):
        print(f"image {i}: class {c}")
    return preds


if __name__ == "__main__":
    main()
