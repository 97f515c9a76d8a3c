"""The port's data path (bigdl_tpu_torch/dataset/{mnist,cifar,image,
records}.py, bigdl_tpu_torch/transform/vision.py) against the JAX
package's, and the cases of tests/test_dataset_io.py on the port.

Everything here is numpy host code on both sides, so the comparisons are
exact: the idx / binary / TFRecord files the two packages write are the
same bytes, each reads the other's, and every image transform and chain,
given the same records and seeds, gives the same arrays bit for bit (the
transforms draw from their own ``np.random.RandomState`` in the JAX
order). The fused one-pass augment is held bit-equal to the JAX numpy
path and within rtol 1e-6 / atol 1e-5 of the composed chain, as the JAX
test holds it. The JAX test's DistriOptimizer case waits for the
distributed slice (ROADMAP.md, Queue 1 item 10).
"""

import gzip

import numpy as np
import pytest
import torch

import bigdl_tpu.native as jnative
from bigdl_tpu.dataset import RecordFileDataSet as JaxRecordFileDataSet
from bigdl_tpu.dataset import Sample as JaxSample
from bigdl_tpu.dataset import cifar as jcifar
from bigdl_tpu.dataset import image as jimage
from bigdl_tpu.dataset import mnist as jmnist
from bigdl_tpu.dataset import records as jrecords
from bigdl_tpu.transform import vision as jvision
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import (DataSet, RecordFileDataSet, Sample,
                                     cifar, decode_sample, encode_sample,
                                     image, mnist, write_record_shards)
from bigdl_tpu_torch.optim import (SGD, Evaluator, LocalOptimizer,
                                   Top1Accuracy, Trigger)
from bigdl_tpu_torch.transform import vision
from tests.test_dataset_io import synth_digits

CPU = dict(device="cpu")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# ------------------------------------------------------------------ loaders
def test_mnist_idx_round_trip_both_ways(tmp_path):
    rng = np.random.RandomState(0)
    imgs, labels = synth_digits(64, rng)
    (tmp_path / "ours").mkdir()
    (tmp_path / "jax").mkdir()
    for pkg, d in ((mnist, tmp_path / "ours"), (jmnist, tmp_path / "jax")):
        pkg.write_images(str(d / "train-images-idx3-ubyte"), imgs)
        pkg.write_labels(str(d / "train-labels-idx1-ubyte"), labels)
        pkg.write_images(str(d / "t10k-images-idx3-ubyte"), imgs[:8])
        pkg.write_labels(str(d / "t10k-labels-idx1-ubyte"), labels[:8])
    for name in ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
                 "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"):
        assert _bytes(tmp_path / "ours" / name) == \
            _bytes(tmp_path / "jax" / name), name
    ti, tl, vi, vl = mnist.read_data_sets(str(tmp_path / "jax"))
    np.testing.assert_array_equal(ti, imgs)
    np.testing.assert_array_equal(tl, labels)
    assert vi.shape == (8, 28, 28) and vl.shape == (8,)
    jti, jtl, _, _ = jmnist.read_data_sets(str(tmp_path / "ours"))
    np.testing.assert_array_equal(jti, imgs)
    np.testing.assert_array_equal(jtl, labels)
    ours, theirs = mnist.to_samples(ti, tl), jmnist.to_samples(ti, tl)
    assert ours[0].label()[0] == labels[0] + 1.0
    assert ours[0].feature().dtype == np.float32
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.feature(), b.feature())
        np.testing.assert_array_equal(a.label(), b.label())


def test_mnist_gzip(tmp_path):
    rng = np.random.RandomState(1)
    imgs, _ = synth_digits(4, rng)
    mnist.write_images(str(tmp_path / "raw"), imgs)
    with gzip.open(tmp_path / "train-images-idx3-ubyte.gz", "wb") as f:
        f.write(_bytes(tmp_path / "raw"))
    got = mnist.load_images(str(tmp_path / "train-images-idx3-ubyte.gz"))
    np.testing.assert_array_equal(got, imgs)
    with pytest.raises(FileNotFoundError):
        mnist.read_data_sets(str(tmp_path / "missing"))


def test_cifar_bin_round_trip_both_ways(tmp_path):
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (20, 3, 32, 32)).astype(np.uint8)
    labels = rng.randint(0, 10, 20).astype(np.uint8)
    (tmp_path / "ours").mkdir()
    (tmp_path / "jax").mkdir()
    for pkg, d in ((cifar, tmp_path / "ours"), (jcifar, tmp_path / "jax")):
        pkg.write_batch(str(d / "data_batch_1.bin"), imgs, labels)
        pkg.write_batch(str(d / "test_batch.bin"), imgs[:5], labels[:5])
    for name in ("data_batch_1.bin", "test_batch.bin"):
        assert _bytes(tmp_path / "ours" / name) == \
            _bytes(tmp_path / "jax" / name)
    ti, tl, vi, vl = cifar.read_data_sets(str(tmp_path / "jax"))
    np.testing.assert_array_equal(ti, imgs)
    np.testing.assert_array_equal(tl, labels)
    assert vi.shape == (5, 3, 32, 32)
    s, js = cifar.to_samples(ti, tl)[0], jcifar.to_samples(ti, tl)[0]
    assert s.feature().shape == (3, 32, 32)
    assert s.label()[0] == labels[0] + 1.0
    np.testing.assert_array_equal(s.feature(), js.feature())
    assert cifar.TRAIN_MEAN == jcifar.TRAIN_MEAN
    assert cifar.TRAIN_STD == jcifar.TRAIN_STD
    with pytest.raises(ValueError, match="multiple"):
        (tmp_path / "bad.bin").write_bytes(b"\0" * 100)
        cifar.load_batch(str(tmp_path / "bad.bin"))


# ------------------------------------------------- dataset/image.py, exact
def _records(n=6, h=40, w=44, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.rand(h, w, 3).astype(np.float32) * 255,
             np.array([float(i % 3 + 1)], np.float32)) for i in range(n)]


def _run_image(pkg, make, recs):
    t = make(pkg)
    out = list(t(iter([pkg.LabeledImage(img.copy(), lab)
                       for img, lab in recs])))
    return [(np.asarray(r.image), r.label) for r in out]


IMAGE_TRANSFORMS = {
    "channel_normalize": lambda m: m.ChannelNormalize((120., 110., 100.),
                                                      (60., 50., 40.)),
    "resize_hw": lambda m: m.Resize((24, 30)),
    "resize_short_side": lambda m: m.Resize(32, seed=4),
    "center_crop": lambda m: m.CenterCrop(32, 30),
    "random_crop_padded": lambda m: m.RandomCrop(32, 32, padding=4, seed=3),
    "random_resized_crop": lambda m: m.RandomResizedCrop(24, 24, seed=7),
    "hflip": lambda m: m.HFlip(0.5, seed=4),
    "color_jitter": lambda m: m.ColorJitter(seed=5),
    "lighting": lambda m: m.Lighting(seed=6),
    "expand": lambda m: m.Expand(max_ratio=2.0, fill=(1., 2., 3.), p=0.6,
                                 seed=8),
    "pixel_normalizer": lambda m: m.PixelNormalizer(
        np.random.RandomState(9).rand(40, 44, 3).astype(np.float32)),
}


@pytest.mark.parametrize("name", sorted(IMAGE_TRANSFORMS))
def test_image_transform_is_byte_equal_to_jax(name):
    recs = _records()
    ours = _run_image(image, IMAGE_TRANSFORMS[name], recs)
    theirs = _run_image(jimage, IMAGE_TRANSFORMS[name], recs)
    assert len(ours) == len(theirs) == len(recs)
    for (a, la), (b, lb) in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(la, lb)


def test_image_chain_and_samples_are_byte_equal_to_jax():
    """BytesToImg (CHW uint8 Samples) through crop, flip, jitter,
    lighting, normalize to CHW samples: the JAX test's chain."""
    rs = np.random.RandomState(0)
    raw = [(rs.randint(0, 255, (3, 40, 40)).astype(np.uint8),
            np.array([float(i + 1)], np.float32)) for i in range(8)]

    def chain(m, S):
        pipe = (m.BytesToImg() >> m.RandomCrop(32, 32, padding=2, seed=3)
                >> m.HFlip(0.5, seed=4) >> m.ColorJitter(seed=5)
                >> m.Lighting(seed=6)
                >> m.ChannelNormalize((127.5,) * 3, (64.0,) * 3)
                >> m.ImgToSample())
        return list(pipe(iter([S(a, b) for a, b in raw])))

    ours, theirs = chain(image, Sample), chain(jimage, JaxSample)
    assert len(ours) == 8
    for a, b in zip(ours, theirs):
        assert a.feature().shape == (3, 32, 32)
        np.testing.assert_array_equal(a.feature(), b.feature())
        np.testing.assert_array_equal(a.label(), b.label())


def test_resize_bilinear_identity_and_scale():
    img = np.arange(16, dtype=np.float32).reshape(4, 4, 1)
    np.testing.assert_allclose(image.resize_bilinear(img, 4, 4), img)
    up = image.resize_bilinear(img, 8, 8)
    assert up.shape == (8, 8, 1) and abs(up.mean() - img.mean()) < 0.5
    np.testing.assert_array_equal(up, jimage.resize_bilinear(img, 8, 8))
    big = np.random.RandomState(1).rand(37, 29, 3).astype(np.float32)
    np.testing.assert_array_equal(image.resize_bilinear(big, 16, 50),
                                  jimage.resize_bilinear(big, 16, 50))


def test_hflip_flips_and_bytes_to_img_accepts_chw_and_sample():
    img = np.zeros((2, 3, 1), np.float32)
    img[:, 0] = 1.0
    out = image.HFlip(p=1.1).apply(image.LabeledImage(img.copy(), None),
                                   np.random.RandomState(0))
    assert out.image[0, 2, 0] == 1.0 and out.image[0, 0, 0] == 0.0
    chw = np.random.RandomState(0).randint(0, 255, (3, 8, 8)).astype(np.uint8)
    rec = image.BytesToImg().apply(Sample(chw, np.array([2.0])), None)
    assert rec.image.shape == (8, 8, 3) and rec.label[0] == 2.0
    rec = image.BytesToImg(8, 8, 3).apply((chw.tobytes(), None), None)
    assert rec.image.shape == (8, 8, 3)


# --------------------------------------------- transform/vision.py, exact
def _features(pkg, n=5, h=36, w=40, seed=1, boxes=True):
    rs = np.random.RandomState(seed)
    feats = []
    for i in range(n):
        kw = {}
        if boxes:
            kw["boxes"] = np.array([[2., 3., 20., 25.], [5., 1., 30., 33.]],
                                   np.float32)
        feats.append(pkg.ImageFeature(rs.rand(h, w, 3).astype(np.float32)
                                      * 255, label=np.float32(i + 1), **kw))
    return feats


def _feature_arrays(f):
    return {k: np.asarray(v) for k, v in f.items()}


VISION_TRANSFORMS = {
    "resize": lambda m: m.Resize(24, 30),
    "hflip": lambda m: m.HFlip(),
    "channel_normalize": lambda m: m.ChannelNormalize([120, 110, 100],
                                                      [60, 50, 40]),
    "center_crop": lambda m: m.CenterCrop(20, 24),
    "brightness": lambda m: m.Brightness(-20, 20, seed=3),
    "expand": lambda m: m.Expand(max_expand_ratio=2.0, seed=4),
    "random_transformer": lambda m: m.RandomTransformer(m.HFlip(), 0.5,
                                                        seed=5),
    "mat_to_tensor": lambda m: m.MatToTensor(),
    "roi_normalize": lambda m: m.RoiNormalize(),
    "roi_hflip": lambda m: m.HFlip() >> m.RoiHFlip(normalized=False),
    "roi_resize": lambda m: m.Resize(30, 20) >> m.RoiResize(),
    "contrast": lambda m: m.Contrast(0.5, 1.5, seed=6),
    "saturation": lambda m: m.Saturation(0.5, 1.5, seed=7),
    "hue": lambda m: m.Hue(seed=8),
    "channel_order": lambda m: m.ChannelOrder(seed=9),
    "crop_normalized": lambda m: m.Crop((0.1, 0.2, 0.8, 0.9)),
    "crop_pixels": lambda m: m.Crop((3, 4, 30, 28), normalized=False),
    "fused_crop_flip_normalize": lambda m: m.FusedCropFlipNormalize(
        24, 28, [120, 110, 100], [60, 50, 40], flip_prob=0.5, seed=10),
    "random_crop": lambda m: m.RandomCrop(24, 28, seed=11),
    "random_resize": lambda m: m.RandomResize([20, 28, 32], seed=12),
    "filler": lambda m: m.Filler(0.1, 0.2, 0.5, 0.6, value=7.0),
    "pixel_normalizer": lambda m: m.PixelNormalizer(
        np.random.RandomState(13).rand(36, 40, 3).astype(np.float32)),
    "channel_scaled_normalizer": lambda m: m.ChannelScaledNormalizer(
        120, 110, 100, 0.02),
    "color_jitter": lambda m: m.ColorJitter(seed=14),
    "random_erasing": lambda m: m.RandomErasing(p=0.7, value=3.0, seed=15),
}


@pytest.mark.parametrize("name", sorted(VISION_TRANSFORMS))
def test_feature_transformer_is_byte_equal_to_jax(name):
    make = VISION_TRANSFORMS[name]
    ours = list(make(vision)(iter(_features(vision))))
    theirs = list(make(jvision)(iter(_features(jvision))))
    assert len(ours) == len(theirs) == 5
    for a, b in zip(ours, theirs):
        fa, fb = _feature_arrays(a), _feature_arrays(b)
        assert sorted(fa) == sorted(fb), name
        for key in fa:
            assert fa[key].dtype == fb[key].dtype, (name, key)
            np.testing.assert_array_equal(fa[key], fb[key],
                                          err_msg=f"{name}: {key}")


def test_feature_chain_is_byte_equal_to_jax():
    """A multi-transform chain with several random stages and the ROI
    labels riding along, then the batch."""
    def chain(m):
        return (m.Expand(max_expand_ratio=1.5, seed=1)
                >> m.RandomTransformer(m.HFlip(), 0.5, seed=2)
                >> m.ColorJitter(seed=3) >> m.RandomResize([32, 40], seed=4)
                >> m.RandomCrop(28, 28, seed=5)
                >> m.ChannelNormalize([120, 110, 100], [60, 50, 40])
                >> m.ImageFeatureToBatch(2, partial_batch=True))

    ours = list(chain(vision)(iter(_features(vision, n=5))))
    theirs = list(chain(jvision)(iter(_features(jvision, n=5))))
    assert [b.size() for b in ours] == [2, 2, 1]
    for a, b in zip(ours, theirs):
        assert a.inputs[0].shape[1:] == (3, 28, 28)
        np.testing.assert_array_equal(a.inputs[0], b.inputs[0])
        np.testing.assert_array_equal(a.targets[0], b.targets[0])


def test_mixup_and_cutmix_are_byte_equal_to_jax():
    rs = np.random.RandomState(0)
    x = rs.rand(6, 16, 16, 3).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 6)]
    for fn in ("mixup_batch", "cutmix_batch"):
        ours = getattr(vision, fn)(x, y, rng=np.random.RandomState(3))
        theirs = getattr(jvision, fn)(x, y, rng=np.random.RandomState(3))
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_image_frame_array_and_read(tmp_path):
    rs = np.random.RandomState(0)
    imgs = rs.rand(3, 8, 9, 3).astype(np.float32)
    frame = vision.ImageFrame.array(imgs, labels=[1, 2, 3])
    assert frame.is_local() and len(frame) == 3
    out = frame.transform(vision.HFlip())
    np.testing.assert_array_equal(out.features[0].image(), imgs[0][:, ::-1])
    for i in range(2):
        np.save(tmp_path / f"{i}.npy", imgs[i])
    read = vision.ImageFrame.read(str(tmp_path / "*.npy"))
    assert len(read) == 2 and read.features[1].image().shape == (8, 9, 3)
    assert read.features[0][vision.ImageFeature.uri].endswith("0.npy")


def test_fused_augment_matches_composed_chain_and_jax():
    """The numpy one-pass augment: bit-equal to the JAX transformer's
    numpy path for each flip probability, within rtol 1e-6 / atol 1e-5 of
    the composed RandomCrop >> HFlip >> ChannelNormalize chain, the same
    stream with workers 1 and 3, and a short crop on an undersized
    image."""
    r = np.random.RandomState(3)
    imgs = [r.randint(0, 255, (40, 48, 3), np.uint8) for _ in range(4)]
    means, stds = [123.68, 116.779, 103.939], [58.393, 57.12, 57.375]

    def run(pkg, flip_prob):
        t = pkg.FusedCropFlipNormalize(32, 32, means, stds,
                                       flip_prob=flip_prob, seed=11)
        return [np.asarray(t.transform(pkg.ImageFeature(
            img.copy(), label=None, preserve_dtype=True)).image())
            for img in imgs]

    orig = jnative.fused_augment
    jnative.fused_augment = lambda *a, **k: None   # the JAX numpy path
    try:
        for flip_prob in (0.0, 0.5, 1.0):
            for a, b in zip(run(vision, flip_prob), run(jvision, flip_prob)):
                assert a.shape == (32, 32, 3) and a.dtype == np.float32
                np.testing.assert_array_equal(a, b)
    finally:
        jnative.fused_augment = orig

    small = r.randint(0, 255, (20, 24, 3), np.uint8)
    t = vision.FusedCropFlipNormalize(32, 32, means, stds, flip_prob=0.0)
    out = t.transform(vision.ImageFeature(small, label=None,
                                          preserve_dtype=True)).image()
    assert out.shape == (20, 24, 3)

    def stream(workers):
        t = vision.FusedCropFlipNormalize(32, 32, means, stds, flip_prob=0.5,
                                          seed=7, workers=workers)
        feats = (vision.ImageFeature(img.copy(), label=None,
                                     preserve_dtype=True) for img in imgs * 4)
        return [np.asarray(f.image()) for f in t(feats)]

    serial, threaded = stream(1), stream(3)
    assert len(serial) == len(threaded) == 16
    for a, b in zip(serial, threaded):
        np.testing.assert_array_equal(a, b)
    chain = (vision.RandomCrop(32, 32, seed=11) >> vision.HFlip()
             >> vision.ChannelNormalize(means, stds))
    want = [np.asarray(f.image()) for f in chain(
        vision.ImageFeature(img.copy(), label=None) for img in imgs)]
    for a, b in zip(run(vision, 1.0), want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-5)


# ------------------------------------------------------------- record files
def test_sample_codec_round_trip_and_jax_bytes():
    s = Sample([np.random.rand(3, 4).astype(np.float32),
                np.arange(5, dtype=np.int32), np.ones((2, 2), np.uint8)],
               np.array([7.0], np.float32))
    js = JaxSample(list(s.features), list(s.labels))
    assert encode_sample(s) == jrecords.encode_sample(js)
    got = decode_sample(jrecords.encode_sample(js))
    assert got.num_feature() == 3 and got.num_label() == 1
    for a, b in zip(got.features + got.labels, s.features + s.labels):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # an unknown dtype is stored as f32, as the JAX codec does
    odd = Sample(np.arange(3, dtype=np.int16))
    assert decode_sample(encode_sample(odd)).feature().dtype == np.float32


def _label_samples(n, width=6, seed=0, S=Sample):
    rng = np.random.RandomState(seed)
    return [S(rng.rand(width).astype(np.float32),
              np.array([float(i)], np.float32)) for i in range(n)]


def test_record_shards_are_the_jax_bytes_and_read_back(tmp_path):
    ours = write_record_shards(_label_samples(37), str(tmp_path / "ours"),
                               num_shards=4)
    theirs = jrecords.write_record_shards(
        _label_samples(37, S=JaxSample), str(tmp_path / "jax"), num_shards=4)
    assert [p.rsplit("/", 1)[1] for p in ours] == \
        [p.rsplit("/", 1)[1] for p in theirs]
    for a, b in zip(ours, theirs):
        assert _bytes(a) == _bytes(b)
    assert [len(jrecords.index_record_file(p)) for p in ours] == \
        [10, 9, 9, 9]
    ds = RecordFileDataSet(str(tmp_path / "jax"), shard_id=0, num_shards=1)
    assert ds.size() == ds.local_size() == 37
    got = sorted(float(s.label()[0]) for s in ds.data(train=False))
    assert got == [float(i) for i in range(37)]


def test_record_shards_disjoint_across_processes(tmp_path):
    write_record_shards(_label_samples(24, width=4), str(tmp_path),
                        num_shards=4)
    seen = []
    for sid in range(2):
        ds = RecordFileDataSet(str(tmp_path), shard_id=sid, num_shards=2)
        assert ds.size() == 24 and ds.local_size() == 12
        seen.append({float(s.label()[0]) for s in ds.data(train=False)})
    assert seen[0].isdisjoint(seen[1])
    assert len(seen[0] | seen[1]) == 24


def test_record_shard_defaults_to_the_process_group(tmp_path):
    """Without ``shard_id`` / ``num_shards`` a reader outside a process
    group reads everything; inside one, its rank's share."""
    import torch.distributed as dist

    write_record_shards(_label_samples(8, width=2), str(tmp_path),
                        num_shards=4)
    ds = RecordFileDataSet(str(tmp_path))
    assert (ds.shard_id, ds.num_shards, ds.local_size()) == (0, 1, 8)
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:0",
                            world_size=1, rank=0)
    try:
        ds = RecordFileDataSet(str(tmp_path))
        assert (ds.shard_id, ds.num_shards) == (0, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shard_id", [0, 1])
def test_record_infinite_train_iterator_matches_jax(tmp_path, shard_id):
    """The infinite shuffled walk wraps, reshuffles in place (reads
    already in flight, ``lookahead`` of them, keep the old order), and
    visits the records in the JAX reader's order for the same seed,
    shard (its generator is seeded ``seed + shard_id``) and
    lookahead."""
    samples = [Sample(np.full(2, i, np.float32), np.array([float(i)]))
               for i in range(10)]
    write_record_shards(samples, str(tmp_path), num_shards=2)
    ours = RecordFileDataSet(str(tmp_path), shard_id=shard_id, num_shards=2,
                             seed=3, lookahead=3, n_threads=2)
    theirs = JaxRecordFileDataSet(str(tmp_path), shard_id=shard_id,
                                  num_shards=2, seed=3, lookahead=3)
    walks = []
    for ds in (ours, theirs):
        it = ds.data(train=True)
        got = [float(next(it).label()[0]) for _ in range(12)]
        ds.shuffle()
        got += [float(next(it).label()[0]) for _ in range(12)]
        walks.append(got)
    assert walks[0] == walks[1]
    assert set(walks[0]) == {float(i) for i in range(shard_id, 10, 2)}


def test_record_reader_raises_on_an_empty_shard_and_no_files(tmp_path):
    with pytest.raises(FileNotFoundError):
        RecordFileDataSet(str(tmp_path))
    write_record_shards(_label_samples(4), str(tmp_path), num_shards=1)
    ds = RecordFileDataSet(str(tmp_path), shard_id=1, num_shards=2)
    with pytest.raises(ValueError, match="holds no files"):
        ds.data(train=True)


# --------------------------------------------------- end-to-end real formats
def test_lenet_trains_on_mnist_format(tmp_path):
    """LeNet through the LocalOptimizer on idx files written and read in
    the MNIST wire format."""
    from bigdl_tpu_torch.models import LeNet5

    rng = np.random.RandomState(0)
    imgs, labels = synth_digits(512, rng)
    mnist.write_images(str(tmp_path / "train-images-idx3-ubyte"), imgs)
    mnist.write_labels(str(tmp_path / "train-labels-idx1-ubyte"), labels)
    mnist.write_images(str(tmp_path / "t10k-images-idx3-ubyte"), imgs[:128])
    mnist.write_labels(str(tmp_path / "t10k-labels-idx1-ubyte"), labels[:128])
    ti, tl, vi, vl = mnist.read_data_sets(str(tmp_path))
    opt = LocalOptimizer(model=LeNet5(10, **CPU),
                         dataset=DataSet.array(mnist.to_samples(ti, tl)),
                         criterion=nn.ClassNLLCriterion(), batch_size=64,
                         end_when=Trigger.max_iteration(60))
    opt.set_optim_method(SGD(learning_rate=0.05))
    model = opt.optimize()
    res = Evaluator(model).test(mnist.to_samples(vi, vl), [Top1Accuracy()],
                                batch_size=64)
    assert res[0][1].result()[0] > 0.9


def test_vgg_style_train_on_cifar_format(tmp_path):
    """CIFAR binary files -> the augmentation pipeline -> a conv net
    learns."""
    rng = np.random.RandomState(1)
    imgs = np.zeros((256, 3, 32, 32), np.uint8)
    labels = rng.randint(0, 4, 256).astype(np.uint8)
    for i, lab in enumerate(labels):  # class = horizontal band
        imgs[i, :, 8 * int(lab):8 * int(lab) + 8, :] = 200
        imgs[i] += rng.randint(0, 30, (3, 32, 32)).astype(np.uint8)
    cifar.write_batch(str(tmp_path / "data_batch_1.bin"), imgs, labels)
    ti, tl, _, _ = cifar.read_data_sets(str(tmp_path))
    pipe = (image.BytesToImg()
            >> image.RandomCrop(32, 32, padding=2, seed=1)
            >> image.HFlip(0.5, seed=2)
            >> image.ChannelNormalize(cifar.TRAIN_MEAN, cifar.TRAIN_STD)
            >> image.ImgToSample())
    raw = [Sample(ti[i], np.array([tl[i] + 1.0], np.float32))
           for i in range(ti.shape[0])]
    model = nn.Sequential(
        nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1, **CPU), nn.ReLU(),
        nn.SpatialMaxPooling(4, 4, 4, 4), nn.Reshape([8 * 8 * 8]),
        nn.Linear(8 * 8 * 8, 4, **CPU), nn.LogSoftMax())
    opt = LocalOptimizer(model=model, dataset=DataSet.array(raw).transform(pipe),
                         criterion=nn.ClassNLLCriterion(), batch_size=32,
                         end_when=Trigger.max_iteration(50))
    opt.set_optim_method(SGD(learning_rate=0.05))
    trained = opt.optimize()
    eval_pipe = (image.BytesToImg()
                 >> image.ChannelNormalize(cifar.TRAIN_MEAN, cifar.TRAIN_STD)
                 >> image.ImgToSample())
    res = Evaluator(trained).test(list(eval_pipe(iter(raw))),
                                  [Top1Accuracy()], batch_size=32)
    assert res[0][1].result()[0] > 0.8


def test_record_pipeline_feeds_the_local_optimizer(tmp_path):
    """The ImageNet-shaped path on one process: TFRecord shards through
    the streaming reader into the training loop (the JAX case runs it
    through the DistriOptimizer, which waits for item 10)."""
    rng = np.random.RandomState(0)
    n = 64
    X = rng.randn(n, 8).astype(np.float32)
    labels = (X @ rng.randn(8, 3).astype(np.float32)).argmax(1) + 1.0
    samples = [Sample(X[i], np.array([labels[i]], np.float32))
               for i in range(n)]
    write_record_shards(samples, str(tmp_path), num_shards=4)
    model = nn.Sequential(nn.Linear(8, 16, **CPU), nn.Tanh(),
                          nn.Linear(16, 3, **CPU), nn.LogSoftMax())
    opt = LocalOptimizer(model=model,
                         dataset=RecordFileDataSet(str(tmp_path), seed=1),
                         criterion=nn.ClassNLLCriterion(), batch_size=32,
                         end_when=Trigger.max_iteration(40))
    opt.set_optim_method(SGD(learning_rate=0.5))
    trained = opt.optimize()
    assert opt.optim_method.state["epoch"] > 1
    res = Evaluator(trained).test(samples, [Top1Accuracy()], batch_size=32)
    assert res[0][1].result()[0] > 0.85
    assert isinstance(trained.m0.weight, torch.nn.Parameter)
