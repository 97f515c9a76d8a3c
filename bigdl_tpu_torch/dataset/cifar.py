"""CIFAR-10 binary-format loader (a copy of ``bigdl_tpu/dataset/cifar.py``:
numpy host code, the same bytes both ways).

Reference: models/vgg/Utils.scala + models/resnet/Utils.scala (both read the
CIFAR-10 *binary* distribution: each record is 1 label byte followed by
3072 bytes of R,G,B 32x32 planes) and dataset/image/BGRImgNormalizer usage
in models/vgg/Train.scala.  Per-channel train statistics match the
reference's (models/resnet/Utils.scala ``Cifar10DataSet`` mean/std).

Offline-first: reads ``data_batch_{1..5}.bin`` / ``test_batch.bin`` from a
directory; ``write_batch`` produces valid files for tools/tests.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample

RECORD_BYTES = 1 + 3 * 32 * 32

# (R, G, B) channel statistics on the 0..255 scale, train split.
TRAIN_MEAN = (125.3, 123.0, 113.9)
TRAIN_STD = (63.0, 62.1, 66.7)


def load_batch(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(images (N,3,32,32) uint8 CHW RGB, labels (N,) uint8 0-based)."""
    raw = np.fromfile(path, np.uint8)
    if raw.size % RECORD_BYTES != 0:
        raise ValueError(f"{path}: size {raw.size} not a multiple of {RECORD_BYTES}")
    raw = raw.reshape(-1, RECORD_BYTES)
    labels = raw[:, 0]
    images = raw[:, 1:].reshape(-1, 3, 32, 32)
    return images, labels


def write_batch(path: str, images: np.ndarray, labels: np.ndarray) -> None:
    """Write (N,3,32,32) uint8 + (N,) labels as a CIFAR binary batch."""
    images = np.asarray(images, np.uint8).reshape(-1, 3 * 32 * 32)
    labels = np.asarray(labels, np.uint8).reshape(-1, 1)
    np.concatenate([labels, images], axis=1).tofile(path)


def read_data_sets(data_dir: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(train_images, train_labels, test_images, test_labels)."""
    train_files = [os.path.join(data_dir, f"data_batch_{i}.bin") for i in range(1, 6)]
    train_files = [p for p in train_files if os.path.exists(p)]
    if not train_files:
        raise FileNotFoundError(f"no data_batch_*.bin in {data_dir}")
    imgs, labels = zip(*(load_batch(p) for p in train_files))
    ti, tl = np.concatenate(imgs), np.concatenate(labels)
    test_path = os.path.join(data_dir, "test_batch.bin")
    if os.path.exists(test_path):
        vi, vl = load_batch(test_path)
    else:
        vi = np.zeros((0, 3, 32, 32), np.uint8)
        vl = np.zeros((0,), np.uint8)
    return ti, tl, vi, vl


def to_samples(images: np.ndarray, labels: np.ndarray,
               mean=TRAIN_MEAN, std=TRAIN_STD) -> List[Sample]:
    """Per-channel-normalized float32 CHW Samples, 1-based labels."""
    mean = np.asarray(mean, np.float32).reshape(3, 1, 1)
    std = np.asarray(std, np.float32).reshape(3, 1, 1)
    images = (images.astype(np.float32) - mean) / std
    return [Sample(images[i], np.array([labels[i] + 1.0], np.float32))
            for i in range(images.shape[0])]
