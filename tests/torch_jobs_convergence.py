"""Rank-side jobs of ``tests/test_torch_convergence.py`` (run in
``torch_world.World``; no JAX here): the JAX package's two convergence
cases (``tests/test_convergence.py``) through the port's sharded
``DistriOptimizer``, with the same data generators."""

from __future__ import annotations

import numpy as np

_GLYPHS = {  # 3x5 digit bitmaps (classic seven-segment-ish font)
    0: ["111", "101", "101", "101", "111"],
    1: ["010", "110", "010", "010", "111"],
    2: ["111", "001", "111", "100", "111"],
    3: ["111", "001", "111", "001", "111"],
    4: ["101", "101", "111", "001", "001"],
    5: ["111", "100", "111", "001", "111"],
    6: ["111", "100", "111", "101", "111"],
    7: ["111", "001", "010", "010", "010"],
    8: ["111", "101", "111", "101", "111"],
    9: ["111", "101", "111", "001", "111"],
}


def draw_digits(n, seed):
    """28 x 28 uint8 digit images (rendered glyphs at random places, with
    sensor noise) and their 0-based labels, as the JAX test draws
    them."""
    rng = np.random.RandomState(seed)
    imgs = np.zeros((n, 28, 28), np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    for i, c in enumerate(labels):
        glyph = np.array([[int(ch) for ch in row] for row in _GLYPHS[c]],
                         np.float32)
        up = np.kron(glyph, np.ones((4, 5), np.float32))    # (20, 15)
        dy, dx = rng.randint(0, 28 - 20), rng.randint(0, 28 - 15)
        canvas = np.zeros((28, 28), np.float32)
        canvas[dy:dy + 20, dx:dx + 15] = up * 255.0
        canvas += rng.randn(28, 28) * 16.0                  # sensor noise
        imgs[i] = np.clip(canvas, 0, 255).astype(np.uint8)
    return imgs, labels


def class_template_cifar(n_per_class=24, n_classes=10, seed=0):
    """(x (N, 3, 32, 32), 1-based labels): a fixed template per class plus
    noise, shuffled, as the JAX test's samples."""
    rng = np.random.RandomState(seed)
    templates = rng.randn(n_classes, 3, 32, 32).astype(np.float32)
    xs, ys = [], []
    for c in range(n_classes):
        for _ in range(n_per_class):
            xs.append(templates[c]
                      + 0.3 * rng.randn(3, 32, 32).astype(np.float32))
            ys.append(np.float32(c + 1))
    order = np.arange(len(xs))
    rng.shuffle(order)
    return np.stack(xs)[order], np.asarray(ys, np.float32)[order]


def lenet_mnist(data_dir: str):
    """LeNet-5 trained 360 sharded steps (batch 64 over the world) on the
    rendered digits after their round trip through the MNIST idx files
    in ``data_dir``; returns the held-out Top1 accuracy and whether the
    idx round trip kept the images."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, mnist
    from bigdl_tpu_torch.models import LeNet5
    from bigdl_tpu_torch.optim import SGD, Top1Accuracy, Trigger
    from bigdl_tpu_torch.parallel import DistriOptimizer

    ti, tl, vi, vl = mnist.read_data_sets(data_dir)
    model = LeNet5(10, device="cpu")
    opt = DistriOptimizer(model=model,
                          dataset=DataSet.array(mnist.to_samples(ti, tl)),
                          criterion=nn.ClassNLLCriterion(), batch_size=64,
                          end_when=Trigger.max_iteration(360),
                          parameter_sync="sharded")
    opt.set_optim_method(SGD(learning_rate=0.05, momentum=0.9))
    trained = opt.optimize()
    results = trained.evaluate_on(mnist.to_samples(vi, vl), [Top1Accuracy()],
                                  batch_size=128)
    acc, _ = results[0][1].result()
    same = bool(np.array_equal(ti, draw_digits(1536, 0)[0]))
    return {"acc": float(acc), "idx_round_trip": same}


def resnet20_cifar():
    """ResNet-20 trained 40 sharded steps (batch 80 over the world) on the
    class-template set; returns its train accuracy and loss."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, Sample
    from bigdl_tpu_torch.models import DatasetType, ResNet
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.parallel import DistriOptimizer

    x, y = class_template_cifar()
    model = ResNet(10, {"depth": 20, "dataSet": DatasetType.CIFAR10},
                   device="cpu")
    opt = DistriOptimizer(model=model,
                          dataset=DataSet.array([Sample(a, b)
                                                 for a, b in zip(x, y)]),
                          criterion=nn.CrossEntropyCriterion(),
                          batch_size=80, end_when=Trigger.max_iteration(40),
                          parameter_sync="sharded")
    opt.set_optim_method(SGD(learning_rate=0.05, momentum=0.9))
    opt.optimize()
    model.evaluate()
    with torch.no_grad():
        out = model(torch.from_numpy(x))
        loss = float(nn.CrossEntropyCriterion()(out, torch.from_numpy(y)))
    acc = float((out.argmax(1).numpy() + 1 == y).mean())
    return {"acc": acc, "loss": loss}
