"""LeNet-5 MNIST evaluation main (port of
``bigdl_tpu/models/lenet/test.py``; ≙ models/lenet/Test.scala).

Run: ``python -m bigdl_tpu_torch.models.lenet.test -f <mnist_dir>
--model <snapshot>``.
"""

from __future__ import annotations

import logging

from bigdl_tpu_torch.dataset import mnist
from bigdl_tpu_torch.models import train_utils
from bigdl_tpu_torch.optim import Evaluator, Top1Accuracy
from bigdl_tpu_torch.utils import file as bt_file


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = train_utils.test_parser(
        "Evaluate LeNet-5 on MNIST (≙ models/lenet/Test.scala)"
    ).parse_args(argv)

    vi = mnist.load_images(
        mnist._resolve(args.folder, "t10k-images-idx3-ubyte"))
    vl = mnist.load_labels(
        mnist._resolve(args.folder, "t10k-labels-idx1-ubyte"))
    samples = mnist.to_samples(vi, vl, mnist.TEST_MEAN, mnist.TEST_STD)

    model = bt_file.load_module(args.model, device=args.device)
    results = Evaluator(model).test(samples, [Top1Accuracy()],
                                    batch_size=args.batch_size)
    for method, result in results:
        print(f"{result} is {method}")
    return results


if __name__ == "__main__":
    main()
