"""The zoo's train and test mains of the port (bigdl_tpu_torch/models/
{lenet,vgg,resnet,inception}/{train,test}.py, imagenet_gen.py,
train_utils.py): the cases of tests/test_zoo_mains.py, each main run
through its argument parser with ``--device cpu`` on files the test
writes, at a few iterations. The text and rnn cases wait for their
readers and models (ROADMAP.md, Queue 1 item 12).
"""

import os
import sys

import numpy as np
import pytest
import torch

from bigdl_tpu.models import imagenet_gen as jax_imagenet_gen
from bigdl_tpu_torch.dataset import RecordFileDataSet, cifar, mnist
from bigdl_tpu_torch.models import imagenet_gen
from bigdl_tpu_torch.nn.module import tree_leaves
from bigdl_tpu_torch.optim import load_latest_checkpoint
from tests.test_dataset_io import synth_digits

CPU = ["--device", "cpu"]


@pytest.fixture
def mnist_dir(tmp_path):
    rng = np.random.RandomState(0)
    imgs, labels = synth_digits(256, rng)
    d = tmp_path / "mnist"
    d.mkdir()
    mnist.write_images(str(d / "train-images-idx3-ubyte"), imgs)
    mnist.write_labels(str(d / "train-labels-idx1-ubyte"), labels)
    mnist.write_images(str(d / "t10k-images-idx3-ubyte"), imgs[:64])
    mnist.write_labels(str(d / "t10k-labels-idx1-ubyte"), labels[:64])
    return str(d)


def _params(model):
    return [(n, p.detach().clone()) for n, p in
            tree_leaves(model.params_dict())]


def test_lenet_train_main_with_checkpoint_and_resume(mnist_dir, tmp_path):
    """Eight iterations (two epochs of 256 at batch 64) with a checkpoint
    each epoch; a resume at the last iteration trains no more and gives
    back the checkpoint's weights; a resume to iteration 10 goes on from
    it."""
    from bigdl_tpu_torch.models.lenet import train as lenet_train

    ckpt = str(tmp_path / "ckpt")
    model = lenet_train.main(CPU + [
        "-f", mnist_dir, "-b", "64", "--max-iteration", "8",
        "--checkpoint", ckpt, "--overwrite", "-r", "0.05"])
    assert next(model.parameters()).device.type == "cpu"
    assert sorted(f for f in os.listdir(ckpt) if f.startswith("model.")) \
        == ["model.4", "model.8"]
    saved, method, tag = load_latest_checkpoint(ckpt, device="cpu")
    assert tag == 8 and method.state["neval"] == 9
    for (n, a), (_, b) in zip(_params(model), _params(saved)):
        assert torch.equal(a, b), n

    same = lenet_train.main(CPU + [
        "-f", mnist_dir, "-b", "64", "--max-iteration", "8",
        "--checkpoint", ckpt, "--resume", "--overwrite", "-r", "0.05"])
    for (n, a), (_, b) in zip(_params(same), _params(saved)):
        assert torch.equal(a, b), n

    more = lenet_train.main(CPU + [
        "-f", mnist_dir, "-b", "64", "--max-iteration", "10",
        "--checkpoint", ckpt, "--resume", "--overwrite", "-r", "0.05"])
    moved = [n for (n, a), (_, b) in zip(_params(more), _params(saved))
             if not torch.equal(a, b)]
    assert moved and [n for n, _ in _params(more)] == \
        [n for n, _ in _params(saved)]


def test_lenet_test_main(mnist_dir, tmp_path):
    from bigdl_tpu_torch.models.lenet import test as lenet_test
    from bigdl_tpu_torch.models.lenet import train as lenet_train

    model = lenet_train.main(CPU + [
        "-f", mnist_dir, "-b", "64", "--max-iteration", "40", "-r", "0.05"])
    snap = str(tmp_path / "lenet.model")
    model.save(snap)
    results = lenet_test.main(CPU + ["-f", mnist_dir, "--model", snap,
                                     "-b", "64"])
    assert results[0][1].result()[0] > 0.85


def test_lenet_train_main_summaries_and_explicit_snapshots(mnist_dir,
                                                           tmp_path):
    """--summary-dir writes the train and validation summaries; --model /
    --state resume from explicit snapshots."""
    from bigdl_tpu_torch.models.lenet import train as lenet_train
    from bigdl_tpu_torch.visualization import TrainSummary

    ckpt, logs = str(tmp_path / "ckpt"), str(tmp_path / "logs" / "lenet")
    lenet_train.main(CPU + ["-f", mnist_dir, "-b", "64", "--max-iteration",
                            "4", "--checkpoint", ckpt, "--summary-dir",
                            logs])
    assert [s for s, _, _ in TrainSummary(logs, "lenet").read_scalar(
        "Loss")] == [1, 2, 3, 4]
    model = lenet_train.main(CPU + [
        "-f", mnist_dir, "-b", "64", "--max-iteration", "5",
        "--model", os.path.join(ckpt, "model.4"),
        "--state", os.path.join(ckpt, "optimMethod.4")])
    assert model is not None
    # --distributed: the sharded DistriOptimizer over every rank, here a
    # world of one
    from bigdl_tpu_torch.parallel import DistriOptimizer
    from bigdl_tpu_torch.models import train_utils

    built = []
    real = train_utils.build_optimizer

    def spy(*a, **k):
        built.append(real(*a, **k))
        return built[-1]

    train_utils.build_optimizer = spy
    try:
        dist_model = lenet_train.main(CPU + ["-f", mnist_dir, "-b", "64",
                                             "--max-iteration", "2",
                                             "--distributed"])
    finally:
        train_utils.build_optimizer = real
    assert isinstance(built[0], DistriOptimizer)
    assert built[0].parameter_sync == "sharded" and built[0].n_data == 1
    assert built[0].optim_method.state["neval"] == 3
    assert dist_model is not None


@pytest.fixture
def cifar_dir(tmp_path):
    rng = np.random.RandomState(1)
    imgs = np.zeros((128, 3, 32, 32), np.uint8)
    labels = rng.randint(0, 10, 128).astype(np.uint8)
    for i, lab in enumerate(labels):
        imgs[i, :, 3 * int(lab):3 * int(lab) + 3, :] = 220
    d = tmp_path / "cifar"
    d.mkdir()
    cifar.write_batch(str(d / "data_batch_1.bin"), imgs, labels)
    cifar.write_batch(str(d / "test_batch.bin"), imgs[:32], labels[:32])
    return str(d)


def test_vgg_train_and_test_mains_smoke(cifar_dir, tmp_path):
    from bigdl_tpu_torch.models.vgg import test as vgg_test
    from bigdl_tpu_torch.models.vgg import train as vgg_train

    model = vgg_train.main(CPU + ["-f", cifar_dir, "-b", "16",
                                  "--max-iteration", "1"])
    assert model is not None
    snap = str(tmp_path / "vgg.model")
    model.save(snap)
    results = vgg_test.main(CPU + ["-f", cifar_dir, "--model", snap,
                                   "-b", "16"])
    assert 0.0 <= results[0][1].result()[0] <= 1.0


def test_resnet_cifar_train_and_test_mains_smoke(cifar_dir, tmp_path):
    from bigdl_tpu_torch.models.resnet import test as resnet_test
    from bigdl_tpu_torch.models.resnet import train as resnet_train

    model = resnet_train.main(CPU + [
        "-f", cifar_dir, "--dataset", "cifar10", "--depth", "20",
        "-b", "16", "--max-iteration", "1"])
    kinds = {type(m).__name__ for m in model.modules()}
    assert "MulConstant" in kinds          # shortcut A
    snap = str(tmp_path / "resnet.model")
    model.save(snap)
    results = resnet_test.main(CPU + ["-f", cifar_dir, "--model", snap])
    assert 0.0 <= results[0][1].result()[0] <= 1.0


def test_resnet_warmup_schedule_shape(cifar_dir):
    """Warmup ramps base -> max over the warm-up iterations, then holds
    max_lr (TrainImageNet.scala:106-124)."""
    from bigdl_tpu_torch.models.resnet import train as resnet_train
    from bigdl_tpu_torch.optim import SGD

    model = resnet_train.main(CPU + [
        "-f", cifar_dir, "--dataset", "cifar10", "--depth", "20",
        "-b", "64", "--max-iteration", "2", "--warmup-epochs", "1",
        "-r", "0.01", "--max-lr", "0.1"])
    assert model is not None
    # two iterations an epoch: 0.01 -> 0.055 -> 0.1, then 0.1
    schedule = resnet_train.warmup_schedule(2, 1, 0.01, 0.1)
    method = SGD(learning_rate=0.01, learning_rate_schedule=schedule)
    rates = []
    for neval in range(1, 6):
        state = {"neval": neval, "epoch": 1 + (neval - 1) // 2}
        rates.append(schedule.rate(method, state))
    np.testing.assert_allclose(rates, [0.01, 0.055, 0.1, 0.1, 0.1],
                               rtol=1e-6)


def _image_folder(root, ext, n=3, size=40):
    rng = np.random.RandomState(0)
    for cls in ["class_a", "class_b"]:
        (root / cls).mkdir(parents=True)
        for i in range(n):
            img = rng.randint(0, 255, (size, size, 3)).astype(np.uint8)
            if ext == "npy":
                np.save(root / cls / f"{i}.npy", img)
            else:
                import imageio.v2 as imageio

                imageio.imwrite(str(root / cls / f"{i}.png"), img)


@pytest.mark.parametrize("ext", ["npy", "png"])
def test_imagenet_gen_writes_the_jax_records(tmp_path, ext):
    """The generator's shards are the JAX generator's bytes (the same
    shuffle, resize and codec), for .npy images and for PNGs (decoded by
    imageio, which this case needs)."""
    if ext == "png":
        pytest.importorskip("imageio")
    root = tmp_path / "imgs"
    _image_folder(root, ext)
    paths = imagenet_gen.main(["-f", str(root), "-o", str(tmp_path / "ours"),
                               "-p", "2", "--resize", "36"])
    theirs = jax_imagenet_gen.main(["-f", str(root), "-o",
                                    str(tmp_path / "jax"), "-p", "2",
                                    "--resize", "36"])
    assert len(paths) == 2
    for a, b in zip(paths, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    with open(tmp_path / "ours" / "classes.txt") as f:
        assert f.read().split() == ["class_a", "class_b"]
    ds = RecordFileDataSet(str(tmp_path / "ours"))
    s = next(iter(ds.data(train=False)))
    assert s.feature().dtype == np.uint8 and s.feature().shape == (36, 36, 3)
    assert s.label()[0] in (1.0, 2.0)


def test_imagenet_gen_without_imageio_raises_for_encoded_images(
        tmp_path, monkeypatch):
    """A machine without imageio reads .npy folders and raises imageio's
    ImportError on an encoded image: nothing is skipped."""
    pytest.importorskip("imageio")
    root = tmp_path / "imgs"
    _image_folder(root, "png", n=1)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ImportError):
        imagenet_gen.main(["-f", str(root), "-o", str(tmp_path / "out"),
                           "-p", "1"])


def test_imagenet_gen_and_inception_train(tmp_path):
    """imagenet_gen over a .npy folder, then the Inception main on its
    records for one iteration at batch 2, with a checkpoint."""
    from bigdl_tpu_torch.models.inception import train as inception_train

    root = tmp_path / "imgs"
    _image_folder(root, "npy", n=2, size=48)
    out = str(tmp_path / "records")
    imagenet_gen.main(["-f", str(root), "-o", out, "-p", "2",
                       "--resize", "40"])
    ckpt = str(tmp_path / "ckpt")
    model = inception_train.main(CPU + [
        "-f", out, "-b", "2", "--max-iteration", "2", "--classes", "2",
        "--checkpoint", ckpt, "--max-epoch", "1"])
    assert model is not None
    assert os.path.exists(os.path.join(ckpt, "model.2"))


_DRIVE = """
import sys
import numpy as np
from bigdl_tpu_torch.dataset import cifar, mnist, RecordFileDataSet
from bigdl_tpu_torch.models import imagenet_gen, perf
from bigdl_tpu_torch.models.lenet import train as lenet_train
from bigdl_tpu_torch.models.vgg import train as vgg_train
from bigdl_tpu_torch.optim import EMA
from bigdl_tpu_torch.transform import vision
folder = sys.argv[1]
rng = np.random.RandomState(0)
imgs = rng.randint(0, 255, (64, 28, 28)).astype(np.uint8)
labels = rng.randint(0, 10, 64).astype(np.uint8)
for split in ("train", "t10k"):
    mnist.write_images(f"{folder}/{split}-images-idx3-ubyte", imgs)
    mnist.write_labels(f"{folder}/{split}-labels-idx1-ubyte", labels)
lenet_train.main(["-f", folder, "-b", "32", "--max-iteration", "2",
                  "--device", "cpu"])
cifar.write_batch(f"{folder}/data_batch_1.bin",
                  rng.randint(0, 255, (16, 3, 32, 32)), labels[:16])
vgg_train.main(["-f", folder, "-b", "8", "--max-iteration", "1",
                "--device", "cpu"])
rows = perf.run_input_pipeline_perf(8, 16, 40, 32, depths=(0,),
                                    log=lambda *_: None, device="cpu")
assert len(rows) >= 2
for name in ("jax", "jaxlib", "bigdl_tpu"):
    assert name not in sys.modules, name
print("ISOLATED")
"""


def test_mains_and_data_path_run_without_jax(tmp_path):
    """A fresh process trains LeNet and VGG through their mains on files
    it writes, and runs the input-pipeline bench, with neither JAX nor the
    JAX package imported."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    out = subprocess.run([sys.executable, "-c", _DRIVE, str(tmp_path)],
                         cwd=repo, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ISOLATED" in out.stdout
