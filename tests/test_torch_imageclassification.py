"""The image-classification main (bigdl_tpu_torch/example/
imageclassification/predict.py) against the JAX package's
(tests/test_examples.py::test_imageclassification_example, run through
the port).

The same images go through the port's main with ``--model-type bigdl``
and ``caffe`` on the CPU and through the JAX main on the same weights:
the classes are equal. ``--model-type tf`` raises naming its ROADMAP.md
item.
"""

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.example.imageclassification.predict import main as jmain
from bigdl_tpu.utils import file as jfile
from bigdl_tpu.utils.caffe_export import save_caffe as jsave_caffe
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.example.imageclassification.predict import main
from bigdl_tpu_torch.utils import file as tfile
from bigdl_tpu_torch.utils.caffe_export import save_caffe
from bigdl_tpu_torch.utils.weights import load_jax_params
from tests.jax_numpy_init import numpy_weight_draws


def _model(nn, d):
    return (nn.Sequential()
            .add(nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, **d))
            .add(nn.ReLU())
            .add(nn.SpatialAveragePooling(32, 32, global_pooling=True))
            .add(nn.View(4)).add(nn.Linear(4, 3, **d)).add(nn.SoftMax()))


def _images(tmp_path, n, seed=0):
    rng = np.random.RandomState(seed)
    for i in range(n):
        np.save(str(tmp_path / f"img{i:02d}.npy"),
                rng.rand(16, 16, 3).astype(np.float32))
    return str(tmp_path / "img*.npy")


def test_imageclassification_example(tmp_path):
    with numpy_weight_draws(3):
        jm = _model(jnn, {})
    tm = _model(tnn, dict(device="cpu"))
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    jpath, tpath = str(tmp_path / "j.bigdl"), str(tmp_path / "t.bigdl")
    jfile.save_module(jm, jpath)
    tfile.save_module(tm, tpath)
    images = _images(tmp_path, 3)
    preds = main(["--model", tpath, "--model-type", "bigdl",
                  "--images", images, "--device", "cpu"])
    assert len(preds) == 3 and all(1 <= c <= 3 for c in preds)
    assert preds == jmain(["--model", jpath, "--model-type", "bigdl",
                           "--images", images])


def test_bigdl_and_caffe_models_give_the_jax_mains_classes(tmp_path):
    """A caffe pair exported from the same weights: the port's main with
    ``--model-type caffe`` and with ``bigdl`` classify the images as the
    JAX main does."""
    with numpy_weight_draws(5):
        jm = _model(jnn, {})
    tm = _model(tnn, dict(device="cpu"))
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    images = _images(tmp_path, 11, seed=1)
    jpath, tpath = str(tmp_path / "j.bigdl"), str(tmp_path / "t.bigdl")
    jfile.save_module(jm, jpath)
    tfile.save_module(tm, tpath)
    want = jmain(["--model", jpath, "--model-type", "bigdl", "--images",
                  images, "--batch-size", "4"])
    got = main(["--model", tpath, "--model-type", "bigdl", "--images",
                images, "--batch-size", "4", "--device", "cpu"])
    assert got == want and len(got) == 11

    jp, jc = str(tmp_path / "j.prototxt"), str(tmp_path / "j.caffemodel")
    tp, tc = str(tmp_path / "t.prototxt"), str(tmp_path / "t.caffemodel")
    jsave_caffe(_caffe_body(jnn, jm), jp, jc, input_shape=(3, 32, 32))
    save_caffe(_caffe_body(tnn, tm), tp, tc, input_shape=(3, 32, 32))
    assert open(tc, "rb").read() == open(jc, "rb").read()
    got_caffe = main(["--model", tc, "--model-type", "caffe", "--prototxt",
                      tp, "--images", images, "--batch-size", "4",
                      "--device", "cpu"])
    assert got_caffe == jmain(["--model", jc, "--model-type", "caffe",
                               "--prototxt", jp, "--images", images,
                               "--batch-size", "4"])
    assert got_caffe == want


def _caffe_body(nn, m):
    """``m`` without its View, sharing its layers (caffe's InnerProduct
    flattens (N, 4, 1, 1) itself)."""
    body = nn.Sequential()
    for i in range(len(m._modules)):
        if not isinstance(m[i], nn.View):
            body.add(m[i])
    return body


def test_tf_model_type_raises_naming_its_item(tmp_path):
    images = _images(tmp_path, 1)
    with pytest.raises(NotImplementedError, match="item 12.6"):
        main(["--model", str(tmp_path / "m.pb"), "--model-type", "tf",
              "--images", images, "--device", "cpu"])
