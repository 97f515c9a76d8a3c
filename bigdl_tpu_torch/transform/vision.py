"""ImageFrame / ImageFeature vision pipeline with ROI label transforms
(a copy of ``bigdl_tpu/transform/vision.py``: numpy host code; every
random transform draws from its own ``np.random.RandomState(seed)`` in
the JAX order, so a chain gives the JAX package's bytes for the same
seeds). ``FusedCropFlipNormalize`` runs the C++ kernel ``native/augment.cc``
through the port's native runtime (``bigdl_tpu_torch/native``), with
the JAX package's numpy path, bit-identical to it, where the kernel does
not apply; ``workers`` keeps the JAX serial plans.

Reference: transform/vision/image/ImageFrame.scala:36 (Local/Distributed
frames + ``read``/``array`` factories), ImageFeature.scala (string-keyed
feature map: bytes/mat/label/originalSize/...), FeatureTransformer.scala
(transform one ImageFeature, chainable with ``->``), the augmentation
package (Resize/HFlip/ChannelNormalize/Expand/Crop...) and the ROI label
transforms (label/roi/RoiTransformer.scala: RoiNormalize, RoiHFlip,
RoiResize) that keep ground-truth boxes consistent with image ops.

TPU-native notes: images live as numpy HWC float arrays host-side (this is
the CPU data pipeline feeding the chip — same role as the reference's
OpenCVMat stage); ``ImageFeatureToBatch`` is the exit point that stacks to
device arrays (≙ MTImageFeatureToBatch.scala)."""

from __future__ import annotations

import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch import native
from bigdl_tpu_torch.dataset import image as dimage
from bigdl_tpu_torch.dataset.transformer import Transformer


def decode_image(path: str) -> np.ndarray:
    """An image file as an array: ``.npy`` as stored, PNG / JPEG as f32
    through PIL where it is installed."""
    if path.endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "reading encoded images needs PIL; store .npy arrays instead"
        ) from e
    return np.asarray(Image.open(path), np.float32)


class ImageFeature(dict):
    """String-keyed per-image record (≙ ImageFeature.scala). Well-known
    keys mirror the reference's constants."""

    bytes_key = "bytes"
    mat = "mat"            # decoded HWC float ndarray
    label = "label"
    uri = "uri"
    original_size = "originalSize"
    size = "size"
    boxes = "boxes"        # (n, 4) x1,y1,x2,y2 ground-truth ROIs
    classes = "classes"    # (n,) ROI labels

    def __init__(self, image: Optional[np.ndarray] = None, label=None,
                 uri: str = None, preserve_dtype: bool = False, **kw):
        """``preserve_dtype=True`` keeps the source dtype (e.g. uint8
        from a record shard) instead of the default float32 promotion —
        the reference's OpenCVMat holds uint8 until MatToFloats, and the
        native fused augment path needs the raw bytes: cropping 256²
        uint8 then converting 224² beats converting 256² f32 up front
        (4x the traffic) and slicing that."""
        super().__init__()
        if image is not None:
            image = (np.asarray(image) if preserve_dtype
                     else np.asarray(image, np.float32))
            self[self.mat] = image
            self[self.original_size] = image.shape
            self[self.size] = image.shape
        if label is not None:
            self[self.label] = label
        if uri is not None:
            self[self.uri] = uri
        self.update(kw)

    def image(self) -> np.ndarray:
        return self[self.mat]

    def set_image(self, arr: np.ndarray):
        self[self.mat] = np.asarray(arr, np.float32)
        self[self.size] = self[self.mat].shape
        return self

    def get_size(self):
        return self.get(self.size)

    def width(self) -> int:
        return int(self[self.mat].shape[1])

    def height(self) -> int:
        return int(self[self.mat].shape[0])


class FeatureTransformer(Transformer):
    """≙ FeatureTransformer.scala: per-ImageFeature op, ``->`` chainable
    (inherits Transformer's chaining)."""

    def transform(self, feature: ImageFeature) -> ImageFeature:
        raise NotImplementedError

    def __call__(self, it: Iterator) -> Iterator:
        for f in it:
            yield self.transform(f)


class ImageFrame:
    """≙ ImageFrame.scala:36. ``ImageFrame.read(paths)`` /
    ``ImageFrame.array(ndarray, labels)`` build a LocalImageFrame; the
    distributed analog is sharding the path list per process."""

    @staticmethod
    def read(paths) -> "LocalImageFrame":
        if isinstance(paths, str):
            import glob

            paths = sorted(glob.glob(paths))
        feats = []
        for p in paths:
            arr = decode_image(p)
            feats.append(ImageFeature(arr, uri=p))
        return LocalImageFrame(feats)

    @staticmethod
    def array(images: np.ndarray, labels=None) -> "LocalImageFrame":
        feats = []
        for i, img in enumerate(images):
            lab = None if labels is None else labels[i]
            feats.append(ImageFeature(img, label=lab))
        return LocalImageFrame(feats)


class LocalImageFrame(ImageFrame):
    def __init__(self, features: List[ImageFeature]):
        self.features = list(features)

    def transform(self, transformer) -> "LocalImageFrame":
        return LocalImageFrame(list(transformer(iter(self.features))))

    __rshift__ = transform

    def to_local(self) -> "LocalImageFrame":
        return self

    def is_local(self) -> bool:
        return True

    def __len__(self):
        return len(self.features)

    def __iter__(self):
        return iter(self.features)


# ------------------------------------------------------------- image ops
class Resize(FeatureTransformer):
    """≙ augmentation/Resize.scala (bilinear)."""

    def __init__(self, resize_h: int, resize_w: int):
        self.resize_h, self.resize_w = resize_h, resize_w

    def transform(self, f: ImageFeature) -> ImageFeature:
        f.set_image(dimage.resize_bilinear(f.image(), self.resize_h,
                                           self.resize_w))
        return f


class HFlip(FeatureTransformer):
    """≙ augmentation/HFlip.scala — always flips (randomness comes from
    RandomTransformer)."""

    def transform(self, f: ImageFeature) -> ImageFeature:
        f.set_image(f.image()[:, ::-1])
        return f


class ChannelNormalize(FeatureTransformer):
    """≙ augmentation/ChannelNormalize.scala."""

    def __init__(self, means: Sequence[float], stds: Sequence[float] = None):
        self.means = np.asarray(means, np.float32)
        self.stds = np.asarray(stds if stds is not None
                               else [1.0] * len(means), np.float32)

    def transform(self, f: ImageFeature) -> ImageFeature:
        f.set_image((f.image() - self.means) / self.stds)
        return f


class CenterCrop(FeatureTransformer):
    def __init__(self, crop_h: int, crop_w: int):
        self.crop_h, self.crop_w = crop_h, crop_w

    def transform(self, f: ImageFeature) -> ImageFeature:
        f.set_image(dimage.center_crop(f.image(), self.crop_h, self.crop_w))
        return f


class Brightness(FeatureTransformer):
    """≙ augmentation/Brightness.scala: add a delta drawn in [lo, hi]."""

    def __init__(self, delta_low: float, delta_high: float, seed: int = 1):
        self.lo, self.hi = delta_low, delta_high
        self._rng = np.random.RandomState(seed)

    def transform(self, f: ImageFeature) -> ImageFeature:
        f.set_image(f.image() + self._rng.uniform(self.lo, self.hi))
        return f


class Expand(FeatureTransformer):
    """≙ augmentation/Expand.scala: place the image on a larger mean-filled
    canvas (used by SSD augmentation); updates ROIs if present."""

    def __init__(self, means: Sequence[float] = (123, 117, 104),
                 max_expand_ratio: float = 4.0, seed: int = 1):
        self.means = np.asarray(means, np.float32)
        self.max_ratio = max_expand_ratio
        self._rng = np.random.RandomState(seed)

    def transform(self, f: ImageFeature) -> ImageFeature:
        img = f.image()
        h, w = img.shape[:2]
        ratio = self._rng.uniform(1.0, self.max_ratio)
        nh, nw = int(h * ratio), int(w * ratio)
        top = self._rng.randint(0, nh - h + 1)
        left = self._rng.randint(0, nw - w + 1)
        canvas = np.tile(self.means, (nh, nw, 1)).astype(np.float32)
        canvas[top:top + h, left:left + w] = img
        f.set_image(canvas)
        if ImageFeature.boxes in f:
            b = np.asarray(f[ImageFeature.boxes], np.float32)
            f[ImageFeature.boxes] = b + [left, top, left, top]
        return f


class RandomTransformer(FeatureTransformer):
    """≙ augmentation/RandomTransformer.scala: apply inner with prob p."""

    def __init__(self, inner: FeatureTransformer, prob: float,
                 seed: int = 1):
        self.inner = inner
        self.prob = prob
        self._rng = np.random.RandomState(seed)

    def transform(self, f: ImageFeature) -> ImageFeature:
        if self._rng.rand() < self.prob:
            return self.inner.transform(f)
        return f


class MatToTensor(FeatureTransformer):
    """≙ Convertor.scala MatToTensor: HWC -> CHW float under key 'tensor'."""

    def transform(self, f: ImageFeature) -> ImageFeature:
        f["tensor"] = np.transpose(f.image(), (2, 0, 1)).copy()
        return f


# -------------------------------------------------------- ROI label ops
class RoiNormalize(FeatureTransformer):
    """≙ label/roi/RoiTransformer.scala RoiNormalize: boxes to [0,1]."""

    def transform(self, f: ImageFeature) -> ImageFeature:
        if ImageFeature.boxes in f:
            h, w = f.image().shape[:2]
            b = np.asarray(f[ImageFeature.boxes], np.float32)
            f[ImageFeature.boxes] = b / [w, h, w, h]
        return f


class RoiHFlip(FeatureTransformer):
    """≙ RoiHFlip: mirror boxes after an HFlip; ``normalized`` tells
    whether boxes are in [0,1] or pixel coords."""

    def __init__(self, normalized: bool = True):
        self.normalized = normalized

    def transform(self, f: ImageFeature) -> ImageFeature:
        if ImageFeature.boxes in f:
            w = 1.0 if self.normalized else float(f.image().shape[1])
            b = np.asarray(f[ImageFeature.boxes], np.float32).copy()
            x1 = b[:, 0].copy()
            b[:, 0] = w - b[:, 2]
            b[:, 2] = w - x1
            f[ImageFeature.boxes] = b
        return f


class RoiResize(FeatureTransformer):
    """≙ RoiResize: rescale pixel-coordinate boxes when the image was
    resized from originalSize to the current size."""

    def transform(self, f: ImageFeature) -> ImageFeature:
        if ImageFeature.boxes in f and ImageFeature.original_size in f:
            oh, ow = f[ImageFeature.original_size][:2]
            nh, nw = f.image().shape[:2]
            sx, sy = nw / ow, nh / oh
            b = np.asarray(f[ImageFeature.boxes], np.float32)
            f[ImageFeature.boxes] = b * [sx, sy, sx, sy]
        return f


# ---------------------------------------------------------------- batching
class ImageFeatureToBatch(Transformer):
    """≙ MTImageFeatureToBatch.scala: stack N ImageFeatures to a device
    MiniBatch (CHW float) with labels."""

    def __init__(self, batch_size: int, to_chw: bool = True,
                 partial_batch: bool = False):
        self.batch_size = batch_size
        self.to_chw = to_chw
        self.partial_batch = partial_batch

    def _emit(self, buf):
        from bigdl_tpu_torch.dataset.minibatch import MiniBatch

        imgs = np.stack([np.transpose(f.image(), (2, 0, 1))
                         if self.to_chw else f.image() for f in buf])
        labels = None
        if all(ImageFeature.label in f for f in buf):
            labels = np.stack([np.asarray(f[ImageFeature.label])
                               for f in buf])
        return MiniBatch(imgs, labels)

    def __call__(self, it: Iterator) -> Iterator:
        buf = []
        for f in it:
            buf.append(f)
            if len(buf) == self.batch_size:
                yield self._emit(buf)
                buf = []
        if buf and self.partial_batch:
            yield self._emit(buf)


class Contrast(FeatureTransformer):
    """≙ augmentation/Contrast.scala: scale around the mean by a factor
    drawn in [lo, hi]."""

    def __init__(self, delta_low: float, delta_high: float, seed: int = 1):
        self.lo, self.hi = delta_low, delta_high
        self._rng = np.random.RandomState(seed)

    def transform(self, f: ImageFeature) -> ImageFeature:
        factor = self._rng.uniform(self.lo, self.hi)
        img = f.image()
        f.set_image((img - img.mean()) * factor + img.mean())
        return f


class Saturation(FeatureTransformer):
    """≙ augmentation/Saturation.scala: blend with the grayscale image."""

    def __init__(self, delta_low: float, delta_high: float, seed: int = 1):
        self.lo, self.hi = delta_low, delta_high
        self._rng = np.random.RandomState(seed)

    def transform(self, f: ImageFeature) -> ImageFeature:
        factor = self._rng.uniform(self.lo, self.hi)
        img = f.image()
        gray = img.mean(axis=-1, keepdims=True)
        f.set_image(gray + (img - gray) * factor)
        return f


class Hue(FeatureTransformer):
    """≙ augmentation/Hue.scala: rotate hue by a delta (degrees) drawn in
    [lo, hi] — linear RGB approximation of the HSV rotation."""

    def __init__(self, delta_low: float = -18.0, delta_high: float = 18.0,
                 seed: int = 1):
        self.lo, self.hi = delta_low, delta_high
        self._rng = np.random.RandomState(seed)

    def transform(self, f: ImageFeature) -> ImageFeature:
        theta = np.deg2rad(self._rng.uniform(self.lo, self.hi))
        c, s = np.cos(theta), np.sin(theta)
        # YIQ-space hue rotation matrix
        t = np.asarray([[0.299, 0.587, 0.114],
                        [0.596, -0.274, -0.322],
                        [0.211, -0.523, 0.312]], np.float32)
        rot = np.asarray([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
        m = np.linalg.inv(t) @ rot @ t
        f.set_image(f.image() @ m.T)
        return f


class ChannelOrder(FeatureTransformer):
    """≙ augmentation/ChannelOrder.scala: randomly permute channels (the
    reference's RGB<->BGR jitter)."""

    def __init__(self, seed: int = 1):
        self._rng = np.random.RandomState(seed)

    def transform(self, f: ImageFeature) -> ImageFeature:
        perm = self._rng.permutation(f.image().shape[-1])
        f.set_image(f.image()[..., perm])
        return f


class Crop(FeatureTransformer):
    """≙ augmentation/Crop.scala: fixed normalized ROI crop; updates boxes
    when present (shift + clip)."""

    def __init__(self, bbox, normalized: bool = True):
        self.bbox = tuple(bbox)  # (x1, y1, x2, y2)
        self.normalized = normalized

    def transform(self, f: ImageFeature) -> ImageFeature:
        h, w = f.image().shape[:2]
        x1, y1, x2, y2 = self.bbox
        if self.normalized:
            x1, x2 = int(x1 * w), int(x2 * w)
            y1, y2 = int(y1 * h), int(y2 * h)
        f.set_image(f.image()[int(y1):int(y2), int(x1):int(x2)])
        if ImageFeature.boxes in f:
            b = np.asarray(f[ImageFeature.boxes], np.float32)
            b = b - [x1, y1, x1, y1]
            b[:, 0::2] = np.clip(b[:, 0::2], 0, x2 - x1)
            b[:, 1::2] = np.clip(b[:, 1::2], 0, y2 - y1)
            f[ImageFeature.boxes] = b
        return f


class FusedCropFlipNormalize(FeatureTransformer):
    """RandomCrop + random HFlip + ChannelNormalize as one pass over the
    pixels: uint8 HWC in, float32 HWC out, through the C++ kernel
    (``native.fused_augment``: crop, flip, subtract the means, multiply
    by the f32 reciprocal of the stds), and through the same arithmetic
    in numpy where the kernel does not apply (no toolchain, a float or
    non-contiguous image, a window out of bounds, ``use_native=False``):
    bit-identical. ``native_images`` and ``numpy_images`` count the
    images each path served. ``workers > 1`` applies on a thread pool in
    stream order after drawing every plan serially, so the output does
    not depend on ``workers``; the kernel releases the interpreter lock,
    so the pool scales with host cores."""

    def __init__(self, crop_h: int, crop_w: int, means: Sequence[float],
                 stds: Sequence[float] = None, flip_prob: float = 0.5,
                 seed: int = 1, workers: int = 1, use_native: bool = True):
        self.crop_h, self.crop_w = crop_h, crop_w
        self.means = np.asarray(means, np.float32)
        self.stds = np.asarray(stds if stds is not None
                               else [1.0] * len(means), np.float32)
        # both paths multiply by the same f32 reciprocal
        self._inv_stds = (np.float32(1.0) / self.stds).astype(np.float32)
        self.flip_prob = flip_prob
        self.workers = workers
        self.use_native = use_native
        self.native_images = 0
        self.numpy_images = 0
        self._count_lock = threading.Lock()
        self._rng = np.random.RandomState(seed)

    def _plan(self, h: int, w: int):
        """One image's (top, left, flip), drawn in stream order (a
        RandomState is not thread-safe)."""
        top = self._rng.randint(0, max(1, h - self.crop_h + 1))
        left = self._rng.randint(0, max(1, w - self.crop_w + 1))
        # deterministic flip probs consume no randomness, so the crop rng
        # stream stays aligned with a seed-matched RandomCrop chain
        flip = (self.flip_prob >= 1.0 or
                (self.flip_prob > 0.0 and self._rng.rand() < self.flip_prob))
        return top, left, flip

    def _apply(self, f: ImageFeature, plan) -> ImageFeature:
        top, left, flip = plan
        img = f.image()
        out = None
        if self.use_native:
            out = native.fused_augment(img, top, left, self.crop_h,
                                       self.crop_w, flip, self.means,
                                       self._inv_stds)
        served_native = out is not None
        if out is None:
            crop = img[top:top + self.crop_h, left:left + self.crop_w]
            if flip:
                crop = crop[:, ::-1]
            out = (crop.astype(np.float32) - self.means) * self._inv_stds
        with self._count_lock:
            if served_native:
                self.native_images += 1
            else:
                self.numpy_images += 1
        f.set_image(out)
        return f

    def transform(self, f: ImageFeature) -> ImageFeature:
        return self._apply(f, self._plan(*f.image().shape[:2]))

    def __call__(self, it: Iterator) -> Iterator:
        if self.workers <= 1:
            yield from super().__call__(it)
            return
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        depth = self.workers * 4
        with ThreadPoolExecutor(self.workers) as ex:
            q = deque()
            for f in it:
                plan = self._plan(*f.image().shape[:2])
                q.append(ex.submit(self._apply, f, plan))
                if len(q) >= depth:
                    yield q.popleft().result()
            while q:
                yield q.popleft().result()


class RandomCrop(FeatureTransformer):
    """≙ augmentation/RandomCropper.scala: random fixed-size crop."""

    def __init__(self, crop_h: int, crop_w: int, seed: int = 1):
        self.crop_h, self.crop_w = crop_h, crop_w
        self._rng = np.random.RandomState(seed)

    def transform(self, f: ImageFeature) -> ImageFeature:
        h, w = f.image().shape[:2]
        top = self._rng.randint(0, max(1, h - self.crop_h + 1))
        left = self._rng.randint(0, max(1, w - self.crop_w + 1))
        return Crop((left, top, left + self.crop_w, top + self.crop_h),
                    normalized=False).transform(f)


class RandomResize(FeatureTransformer):
    """≙ augmentation/RandomResize.scala: resize to a side drawn from the
    given list (scale jitter)."""

    def __init__(self, sizes: Sequence[int], seed: int = 1):
        self.sizes = list(sizes)
        self._rng = np.random.RandomState(seed)

    def transform(self, f: ImageFeature) -> ImageFeature:
        s = int(self.sizes[self._rng.randint(len(self.sizes))])
        return Resize(s, s).transform(f)


class Filler(FeatureTransformer):
    """≙ augmentation/Filler.scala: fill a normalized subregion with a
    constant (occlusion augmentation)."""

    def __init__(self, x1: float, y1: float, x2: float, y2: float,
                 value: float = 255.0):
        self.region = (x1, y1, x2, y2)
        self.value = value

    def transform(self, f: ImageFeature) -> ImageFeature:
        img = f.image().copy()
        h, w = img.shape[:2]
        x1, y1, x2, y2 = self.region
        img[int(y1 * h):int(y2 * h), int(x1 * w):int(x2 * w)] = self.value
        f.set_image(img)
        return f


class PixelNormalizer(FeatureTransformer):
    """≙ augmentation/PixelNormalizer.scala: subtract a per-pixel mean
    image."""

    def __init__(self, means: np.ndarray):
        self.means = np.asarray(means, np.float32)

    def transform(self, f: ImageFeature) -> ImageFeature:
        f.set_image(f.image() - self.means)
        return f


class ChannelScaledNormalizer(FeatureTransformer):
    """≙ augmentation/ChannelScaledNormalizer.scala: per-channel mean
    subtract + global scale."""

    def __init__(self, mean_r: float, mean_g: float, mean_b: float,
                 scale: float):
        self.means = np.asarray([mean_r, mean_g, mean_b], np.float32)
        self.scale = scale

    def transform(self, f: ImageFeature) -> ImageFeature:
        f.set_image((f.image() - self.means) * self.scale)
        return f


class ColorJitter(FeatureTransformer):
    """≙ augmentation/ColorJitter.scala: random brightness/contrast/
    saturation in random order."""

    def __init__(self, brightness: float = 32.0, contrast: float = 0.5,
                 saturation: float = 0.5, seed: int = 1):
        self._rng = np.random.RandomState(seed)
        self.ops = [Brightness(-brightness, brightness, seed),
                    Contrast(1 - contrast, 1 + contrast, seed + 1),
                    Saturation(1 - saturation, 1 + saturation, seed + 2)]

    def transform(self, f: ImageFeature) -> ImageFeature:
        for i in self._rng.permutation(len(self.ops)):
            f = self.ops[i].transform(f)
        return f


class RandomErasing(FeatureTransformer):
    """Random-erasing augmentation (Zhong et al. 2020; beyond the
    reference's augmentation set): with probability ``p`` replace a random
    rectangle (relative area/aspect drawn from the given ranges) with
    ``value``. HWC float images."""

    def __init__(self, p: float = 0.5, area_range=(0.02, 0.33),
                 aspect_range=(0.3, 3.3), value: float = 0.0, seed: int = 1):
        self.p = p
        self.area_range = area_range
        self.aspect_range = aspect_range
        self.value = value
        self._rng = np.random.RandomState(seed)

    def transform(self, f: ImageFeature) -> ImageFeature:
        if self._rng.rand() >= self.p:
            return f
        img = f.image().copy()
        h, w = img.shape[:2]
        for _ in range(10):  # standard retry-until-it-fits
            area = self._rng.uniform(*self.area_range) * h * w
            aspect = self._rng.uniform(*self.aspect_range)
            eh = int(round(np.sqrt(area * aspect)))
            ew = int(round(np.sqrt(area / aspect)))
            if 0 < eh < h and 0 < ew < w:
                top = self._rng.randint(0, h - eh + 1)
                left = self._rng.randint(0, w - ew + 1)
                img[top:top + eh, left:left + ew] = self.value
                f.set_image(img)
                break
        return f


#: shared generator for the batch augments when no rng is passed
_AUG_RNG = np.random.RandomState(1)


def mixup_batch(x, y_onehot, alpha: float = 0.2, rng=None):
    """Mixup (Zhang et al. 2018): convexly combine a batch with a shuffled
    copy of itself; labels (one-hot/soft) mix with the same lambda.
    Batch-level numpy op for the input pipeline (images (B, ...),
    labels (B, C)); returns (x_mix, y_mix, lam). Without an explicit
    ``rng`` a shared module-level generator advances across calls (a
    per-call fresh seed would repeat the same lam/permutation forever)."""
    rng = rng if rng is not None else _AUG_RNG
    lam = float(rng.beta(alpha, alpha)) if alpha > 0 else 1.0
    perm = rng.permutation(len(x))
    x = np.asarray(x)
    y = np.asarray(y_onehot)
    return (lam * x + (1 - lam) * x[perm],
            lam * y + (1 - lam) * y[perm], lam)


def cutmix_batch(x, y_onehot, alpha: float = 1.0, rng=None):
    """CutMix (Yun et al. 2019): paste a random box from a shuffled copy;
    labels mix by the ACTUAL pasted-area fraction. Images (B, H, W, C)
    HWC; returns (x_mix, y_mix, lam). See mixup_batch for rng semantics."""
    rng = rng if rng is not None else _AUG_RNG
    x = np.asarray(x).copy()
    y = np.asarray(y_onehot)
    lam = float(rng.beta(alpha, alpha)) if alpha > 0 else 1.0
    perm = rng.permutation(len(x))
    h, w = x.shape[1:3]
    cut = np.sqrt(1.0 - lam)
    ch, cw = int(h * cut), int(w * cut)
    cy, cx = rng.randint(h), rng.randint(w)
    t, b = np.clip([cy - ch // 2, cy + ch // 2], 0, h)
    l, r = np.clip([cx - cw // 2, cx + cw // 2], 0, w)
    x[:, t:b, l:r] = x[perm, t:b, l:r]
    lam_adj = 1.0 - (b - t) * (r - l) / (h * w)  # actual area kept
    return x, lam_adj * y + (1 - lam_adj) * y[perm], lam_adj
