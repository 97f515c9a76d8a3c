"""Image records + augmentation pipeline (pure numpy, host-side; a copy
of ``bigdl_tpu/dataset/image.py``: every transform draws from its own
``np.random.RandomState(seed)`` in the JAX order, so a chain gives the
JAX package's bytes for the same seeds).

Reference, classic pipeline: dataset/image/ — ``BytesToBGRImg``,
``BGRImgNormalizer``, ``BGRImgCropper`` (random/center), ``HFlip``,
``ColorJitter``, ``Lighting``, ``BGRImgToSample``.
Reference, OpenCV pipeline: transform/vision/image/augmentation/ —
Resize/Crop/HFlip/Brightness/Contrast/Saturation/Hue/ColorJitter/Expand/
RandomAlterAspect (19 ops over ``ImageFeature``).

TPU-native stance: augmentation stays on host CPU as record→record numpy
transforms feeding the device prefetcher (bigdl_tpu_torch.dataset.prefetch) —
only the stacked batch crosses the host↔HBM boundary once.  Images flow
through the pipeline as :class:`LabeledImage` (float32 HWC, **RGB** channel
order — the reference's BGR is an OpenCV artifact not inherited here); the
terminal :class:`ImgToSample` emits CHW Samples.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import Transformer


class LabeledImage:
    """One image record in the augmentation pipeline (≙ LabeledBGRImage,
    dataset/image/LabeledBGRImage.scala). ``image`` is float32 HWC."""

    __slots__ = ("image", "label")

    def __init__(self, image: np.ndarray, label=None):
        self.image = image
        self.label = label

    def height(self) -> int:
        return self.image.shape[0]

    def width(self) -> int:
        return self.image.shape[1]


# ------------------------------------------------------------ functional ops

def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize, HWC float. Align-corners=False (half-pixel centers),
    matching OpenCV's default INTER_LINEAR used by the reference's Resize
    (transform/vision/image/augmentation/Resize.scala)."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img
    ys = (np.arange(out_h, dtype=np.float32) + 0.5) * (h / out_h) - 0.5
    xs = (np.arange(out_w, dtype=np.float32) + 0.5) * (w / out_w) - 0.5
    ys = np.clip(ys, 0, h - 1)
    xs = np.clip(xs, 0, w - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    img = img.astype(np.float32)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def center_crop(img: np.ndarray, ch: int, cw: int) -> np.ndarray:
    h, w = img.shape[:2]
    y = max(0, (h - ch) // 2)
    x = max(0, (w - cw) // 2)
    return img[y:y + ch, x:x + cw]


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return img * factor


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    mean = img.mean()
    return (img - mean) * factor + mean


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    # RGB luma weights — this pipeline's channel convention is RGB (the
    # loaders in mnist/cifar/records emit RGB; the reference's BGR order is
    # an OpenCV artifact this build does not inherit)
    grey = img @ np.array([0.299, 0.587, 0.114], np.float32)
    return (img - grey[..., None]) * factor + grey[..., None]


# -------------------------------------------------------------- transformers

class ImageTransformer(Transformer):
    """Per-record image op; subclasses implement ``apply(LabeledImage, rng)``."""

    def __init__(self, seed: int = 1):
        self._rng = np.random.RandomState(seed)

    def apply(self, rec: LabeledImage, rng: np.random.RandomState) -> LabeledImage:
        raise NotImplementedError

    def __call__(self, it: Iterator) -> Iterator:
        return (self.apply(rec, self._rng) for rec in it)


class BytesToImg(ImageTransformer):
    """Raw (H, W, C) uint8 bytes → float32 LabeledImage
    (≙ BytesToBGRImg, dataset/image/BytesToBGRImg.scala). Accepts
    ``Sample``-like records (features[0] = HWC or CHW uint8) or
    (bytes, label) tuples with a fixed shape."""

    def __init__(self, height: Optional[int] = None, width: Optional[int] = None,
                 channels: int = 3):
        super().__init__()
        self.h, self.w, self.c = height, width, channels

    def apply(self, rec, rng):
        if isinstance(rec, LabeledImage):
            return rec
        if isinstance(rec, Sample):
            arr, label = rec.features[0], rec.label()
        elif isinstance(rec, tuple):
            arr, label = rec
        else:
            arr, label = rec, None
        if isinstance(arr, (bytes, bytearray)):
            arr = np.frombuffer(arr, np.uint8).reshape(self.h, self.w, self.c)
        arr = np.asarray(arr)
        if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3):
            arr = np.transpose(arr, (1, 2, 0))  # CHW → HWC
        elif arr.ndim == 2:
            arr = arr[..., None]
        return LabeledImage(arr.astype(np.float32), label)


class ChannelNormalize(ImageTransformer):
    """(x - mean) / std per channel (≙ BGRImgNormalizer,
    dataset/image/BGRImgNormalizer.scala)."""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        super().__init__()
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def apply(self, rec, rng):
        rec.image = (rec.image - self.mean) / self.std
        return rec


class Resize(ImageTransformer):
    """Bilinear resize; ``size`` as (h, w), or scalar = shorter-side resize
    preserving aspect (≙ augmentation/Resize.scala)."""

    def __init__(self, size, seed: int = 1):
        super().__init__(seed)
        self.size = size

    def apply(self, rec, rng):
        h, w = rec.image.shape[:2]
        if isinstance(self.size, (tuple, list)):
            oh, ow = self.size
        else:
            s = self.size
            if h < w:
                oh, ow = s, max(1, int(round(w * s / h)))
            else:
                oh, ow = max(1, int(round(h * s / w))), s
        rec.image = resize_bilinear(rec.image, oh, ow)
        return rec


class CenterCrop(ImageTransformer):
    """(≙ CenterCrop, augmentation/Crop.scala / BGRImgCropper CropCenter)."""

    def __init__(self, height: int, width: int):
        super().__init__()
        self.h, self.w = height, width

    def apply(self, rec, rng):
        rec.image = center_crop(rec.image, self.h, self.w)
        return rec


class RandomCrop(ImageTransformer):
    """Random crop with optional zero padding first (≙ BGRImgRdmCropper,
    dataset/image/LocalImgReader.scala path used by CIFAR training: pad 4 +
    random 32x32 crop)."""

    def __init__(self, height: int, width: int, padding: int = 0, seed: int = 1):
        super().__init__(seed)
        self.h, self.w, self.padding = height, width, padding

    def apply(self, rec, rng):
        img = rec.image
        if self.padding:
            p = self.padding
            img = np.pad(img, ((p, p), (p, p), (0, 0)))
        h, w = img.shape[:2]
        y = rng.randint(0, h - self.h + 1)
        x = rng.randint(0, w - self.w + 1)
        rec.image = img[y:y + self.h, x:x + self.w]
        return rec


class RandomResizedCrop(ImageTransformer):
    """Random area/aspect crop then resize — the Inception-style training
    crop (≙ RandomAlterAspect, augmentation/RandomAlterAspect.scala and
    RandomCropper w/ scales)."""

    def __init__(self, height: int, width: int, area=(0.08, 1.0),
                 ratio=(3 / 4, 4 / 3), seed: int = 1):
        super().__init__(seed)
        self.h, self.w, self.area, self.ratio = height, width, area, ratio

    def apply(self, rec, rng):
        img = rec.image
        h, w = img.shape[:2]
        for _ in range(10):
            target_area = rng.uniform(*self.area) * h * w
            aspect = np.exp(rng.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                y = rng.randint(0, h - ch + 1)
                x = rng.randint(0, w - cw + 1)
                rec.image = resize_bilinear(img[y:y + ch, x:x + cw], self.h, self.w)
                return rec
        rec.image = resize_bilinear(center_crop(img, min(h, w), min(h, w)),
                                    self.h, self.w)
        return rec


class HFlip(ImageTransformer):
    """Horizontal flip with probability p (≙ dataset/image/HFlip.scala)."""

    def __init__(self, p: float = 0.5, seed: int = 1):
        super().__init__(seed)
        self.p = p

    def apply(self, rec, rng):
        if rng.rand() < self.p:
            rec.image = rec.image[:, ::-1]
        return rec


class ColorJitter(ImageTransformer):
    """Random-order brightness/contrast/saturation jitter
    (≙ dataset/image/ColorJitter.scala: strengths 0.4)."""

    def __init__(self, brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4, seed: int = 1):
        super().__init__(seed)
        self.strengths = [
            (adjust_brightness, brightness),
            (adjust_contrast, contrast),
            (adjust_saturation, saturation),
        ]

    def apply(self, rec, rng):
        order = rng.permutation(len(self.strengths))
        img = rec.image
        for i in order:
            fn, s = self.strengths[i]
            if s > 0:
                img = fn(img, 1.0 + rng.uniform(-s, s))
        rec.image = img
        return rec


class Lighting(ImageTransformer):
    """AlexNet-style PCA lighting noise (≙ dataset/image/Lighting.scala:
    same ImageNet eigenvalues/eigenvectors, expressed here in this
    pipeline's RGB channel order)."""

    EIGVAL = np.array([0.2175, 0.0188, 0.0045], np.float32)
    EIGVEC = np.array([  # RGB rows
        [-0.5675, 0.7192, 0.4009],
        [-0.5808, -0.0045, -0.8140],
        [-0.5836, -0.6948, 0.4203],
    ], np.float32)

    def __init__(self, alpha_std: float = 0.1, seed: int = 1):
        super().__init__(seed)
        self.alpha_std = alpha_std

    def apply(self, rec, rng):
        alpha = rng.normal(0, self.alpha_std, 3).astype(np.float32)
        noise = self.EIGVEC @ (alpha * self.EIGVAL)
        rec.image = rec.image + noise
        return rec


class Expand(ImageTransformer):
    """Place the image on a larger mean-filled canvas (zoom-out, ≙
    augmentation/Expand.scala used by SSD)."""

    def __init__(self, max_ratio: float = 4.0, fill: Sequence[float] = (0, 0, 0),
                 p: float = 0.5, seed: int = 1):
        super().__init__(seed)
        self.max_ratio, self.fill, self.p = max_ratio, fill, p

    def apply(self, rec, rng):
        if rng.rand() >= self.p:
            return rec
        img = rec.image
        h, w, c = img.shape
        ratio = rng.uniform(1.0, self.max_ratio)
        nh, nw = int(h * ratio), int(w * ratio)
        canvas = np.empty((nh, nw, c), np.float32)
        canvas[:] = np.asarray(self.fill, np.float32)
        y = rng.randint(0, nh - h + 1)
        x = rng.randint(0, nw - w + 1)
        canvas[y:y + h, x:x + w] = img
        rec.image = canvas
        return rec


class PixelNormalizer(ImageTransformer):
    """Subtract a full per-pixel mean image (≙ augmentation/PixelNormalizer)."""

    def __init__(self, means: np.ndarray):
        super().__init__()
        self.means = np.asarray(means, np.float32)

    def apply(self, rec, rng):
        rec.image = rec.image - self.means.reshape(rec.image.shape)
        return rec


class ImgToSample(Transformer):
    """Terminal: HWC LabeledImage → CHW float32 Sample (≙ BGRImgToSample,
    dataset/image/BGRImgToSample.scala; labels stay 1-based upstream)."""

    def __init__(self, to_chw: bool = True):
        self.to_chw = to_chw

    def __call__(self, it):
        for rec in it:
            img = rec.image
            if self.to_chw:
                img = np.ascontiguousarray(np.transpose(img, (2, 0, 1)))
            label = rec.label
            if label is None:
                yield Sample(img.astype(np.float32))
            else:
                yield Sample(img.astype(np.float32),
                             np.asarray(label, np.float32).reshape(-1))
