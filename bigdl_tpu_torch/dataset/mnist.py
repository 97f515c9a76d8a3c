"""MNIST idx-format loader (a copy of ``bigdl_tpu/dataset/mnist.py``:
numpy host code, the same bytes both ways).

Reference: pyspark/bigdl/dataset/mnist.py:1-70 (idx parsing,
``read_data_sets``) and models/lenet/Utils.scala:100-150 (byte records →
``Sample`` with **1-based labels**, Appendix B.1; TRAIN_MEAN/STD constants).

Reads the standard ``train-images-idx3-ubyte`` / ``train-labels-idx1-ubyte``
files (optionally ``.gz``).  No downloading happens here (the reference
downloads from Yann LeCun's site; this build is offline-first) — point
``read_data_sets`` at a directory that already holds the files.  A writer is
provided so tools/tests can produce valid idx files.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import List, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample

TRAIN_MEAN = 0.13066047740239506 * 255
TRAIN_STD = 0.3081078 * 255
TEST_MEAN = 0.13251460696903547 * 255
TEST_STD = 0.31048024 * 255

_IMAGE_MAGIC = 2051
_LABEL_MAGIC = 2049


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _resolve(data_dir: str, name: str) -> str:
    for cand in (name, name + ".gz"):
        p = os.path.join(data_dir, cand)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(
        f"MNIST file {name}(.gz) not found in {data_dir}; download the "
        f"standard idx files there first")


def load_images(path: str) -> np.ndarray:
    """(N, H, W) uint8 from an idx3-ubyte file."""
    with _open(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != _IMAGE_MAGIC:
            raise ValueError(f"bad idx3 magic {magic} in {path}")
        buf = f.read(n * rows * cols)
    return np.frombuffer(buf, np.uint8).reshape(n, rows, cols)


def load_labels(path: str) -> np.ndarray:
    """(N,) uint8 from an idx1-ubyte file."""
    with _open(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != _LABEL_MAGIC:
            raise ValueError(f"bad idx1 magic {magic} in {path}")
        buf = f.read(n)
    return np.frombuffer(buf, np.uint8)


def write_images(path: str, images: np.ndarray) -> None:
    """Write (N, H, W) uint8 as idx3-ubyte (fixture/conversion tool)."""
    images = np.asarray(images, np.uint8)
    n, rows, cols = images.shape
    with open(path, "wb") as f:
        f.write(struct.pack(">IIII", _IMAGE_MAGIC, n, rows, cols))
        f.write(images.tobytes())


def write_labels(path: str, labels: np.ndarray) -> None:
    labels = np.asarray(labels, np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">II", _LABEL_MAGIC, labels.shape[0]))
        f.write(labels.tobytes())


def read_data_sets(data_dir: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(train_images, train_labels, test_images, test_labels); images
    (N, 28, 28) uint8, labels (N,) uint8 0-based raw digits."""
    ti = load_images(_resolve(data_dir, "train-images-idx3-ubyte"))
    tl = load_labels(_resolve(data_dir, "train-labels-idx1-ubyte"))
    vi = load_images(_resolve(data_dir, "t10k-images-idx3-ubyte"))
    vl = load_labels(_resolve(data_dir, "t10k-labels-idx1-ubyte"))
    return ti, tl, vi, vl


def to_samples(images: np.ndarray, labels: np.ndarray,
               mean: float = TRAIN_MEAN, std: float = TRAIN_STD) -> List[Sample]:
    """Normalized float32 Samples with 1-based labels
    (≙ models/lenet/Utils.scala:150 ``label + 1.0f``)."""
    images = (images.astype(np.float32) - mean) / std
    return [Sample(images[i], np.array([labels[i] + 1.0], np.float32))
            for i in range(images.shape[0])]
