"""ImageNet record-shard generator (a copy of
``bigdl_tpu/models/imagenet_gen.py``; ≙ models/utils/ImageNetSeqFileGenerator.scala).

Converts an ImageFolder-style tree::

    root/<class_name>/<image>.{jpg,jpeg,png,npy}

into the sharded-TFRecord sample layout consumed by
``bigdl_tpu_torch.dataset.RecordFileDataSet`` (the reference's Hadoop-SequenceFile
analog, dataset/DataSet.scala:502-567).  Class names map to 1-based labels
in sorted order (≙ the reference's label mapping from the folder index).

``.npy`` images are loaded as they are; other formats are decoded with
imageio, and a machine without it raises its ImportError (nothing is
skipped). Each image is optionally shorter-side resized (the reference
generator center-scales to 256) and stored as uint8 HWC.

Run: ``python -m bigdl_tpu_torch.models.imagenet_gen -f <imagefolder> -o <out_dir>``.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Iterator, List, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.image import resize_bilinear
from bigdl_tpu_torch.dataset.records import write_record_shards
from bigdl_tpu_torch.dataset.sample import Sample

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".npy")

logger = logging.getLogger("bigdl_tpu_torch.imagenet_gen")


def list_image_folder(root: str) -> Tuple[List[Tuple[str, int]], List[str]]:
    """[(path, 1-based label)] + sorted class names."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise FileNotFoundError(f"no class subdirectories under {root}")
    entries = []
    for li, cname in enumerate(classes, start=1):
        cdir = os.path.join(root, cname)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(IMG_EXTS):
                entries.append((os.path.join(cdir, fname), li))
    return entries, classes


def decode_image(path: str) -> np.ndarray:
    """uint8 HWC RGB."""
    if path.endswith(".npy"):
        arr = np.load(path)
    else:
        import imageio.v2 as imageio

        arr = np.asarray(imageio.imread(path))
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.shape[-1] == 4:
        arr = arr[..., :3]
    return arr.astype(np.uint8)


def iter_samples(entries, resize: int = 0) -> Iterator[Sample]:
    for path, label in entries:
        img = decode_image(path).astype(np.float32)
        if resize:
            h, w = img.shape[:2]
            if h < w:
                oh, ow = resize, max(1, int(round(w * resize / h)))
            else:
                oh, ow = max(1, int(round(h * resize / w))), resize
            img = resize_bilinear(img, oh, ow)
        yield Sample(np.clip(img, 0, 255).astype(np.uint8),
                     np.array([float(label)], np.float32))


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(
        description="ImageFolder → sharded TFRecords "
                    "(≙ ImageNetSeqFileGenerator)")
    p.add_argument("-f", "--folder", required=True, help="ImageFolder root")
    p.add_argument("-o", "--output", required=True, help="output record dir")
    p.add_argument("-p", "--parallel", type=int, default=8,
                   help="number of shard files")
    p.add_argument("--resize", type=int, default=256,
                   help="shorter-side resize (0 = keep original)")
    args = p.parse_args(argv)

    entries, classes = list_image_folder(args.folder)
    logger.info("%d images across %d classes", len(entries), len(classes))
    rng = np.random.RandomState(0)
    rng.shuffle(entries)
    paths = write_record_shards(iter_samples(entries, args.resize),
                                args.output, num_shards=args.parallel)
    with open(os.path.join(args.output, "classes.txt"), "w") as f:
        f.write("\n".join(classes) + "\n")
    logger.info("wrote %d shards to %s", len(paths), args.output)
    return paths


if __name__ == "__main__":
    main()
