"""Distributed convergence of the port (the JAX package's
``tests/test_convergence.py``, ≙ DistriOptimizerSpec training real
models to accuracy thresholds): the same data, steps and thresholds
through the port's ``DistriOptimizer`` with ``parameter_sync="sharded"``
(ZeRO-1) on a world of 4 ranks over gloo on the CPU (the JAX tests use
an 8-device mesh; the global batch is the same).

- LeNet-5 on rendered digits after a round trip through the genuine
  MNIST idx format (``dataset/mnist.py`` writer, then
  ``read_data_sets``): 360 sharded steps, held-out accuracy >= 0.97;
- ResNet-20 at CIFAR-10 shapes on the class-template set: 40 sharded
  steps, train accuracy > 0.85 and loss < 0.8.

Slow, as the JAX cases are: each run trains tens of seconds.
"""

import numpy as np
import pytest

import torch_jobs_convergence as jobs
from torch_world import World


@pytest.fixture(scope="module")
def world():
    return World.shared(4)


@pytest.mark.slow
def test_lenet_trains_to_97pct_on_mnist_idx_fixture(world, tmp_path):
    from bigdl_tpu_torch.dataset import mnist

    train_imgs, train_labels = jobs.draw_digits(1536, seed=0)
    test_imgs, test_labels = jobs.draw_digits(256, seed=1)
    mnist.write_images(str(tmp_path / "train-images-idx3-ubyte"), train_imgs)
    mnist.write_labels(str(tmp_path / "train-labels-idx1-ubyte"),
                       train_labels)
    mnist.write_images(str(tmp_path / "t10k-images-idx3-ubyte"), test_imgs)
    mnist.write_labels(str(tmp_path / "t10k-labels-idx1-ubyte"), test_labels)
    out = world.run(jobs.lenet_mnist, str(tmp_path))
    for o in out:
        assert o["idx_round_trip"]
        assert o["acc"] >= 0.97, \
            f"held-out accuracy {o['acc']} after 360 sharded steps"
    assert len({o["acc"] for o in out}) == 1    # one model on every rank


@pytest.mark.slow
def test_resnet20_converges_sharded_on_mesh(world):
    out = world.run(jobs.resnet20_cifar)
    for o in out:
        assert o["acc"] > 0.85, f"train accuracy {o['acc']} after 40 steps"
        assert o["loss"] < 0.8, f"train loss {o['loss']} after 40 steps"
    np.testing.assert_array_equal([o["loss"] for o in out],
                                  [out[0]["loss"]] * len(out))
