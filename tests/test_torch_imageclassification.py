"""The image-classification main (bigdl_tpu_torch/example/
imageclassification/predict.py) against the JAX package's
(tests/test_examples.py::test_imageclassification_example, run through
the port).

The same images go through the port's main with ``--model-type bigdl``
and ``caffe`` on the CPU and through the JAX main on the same weights:
the classes are equal. ``--model-type tf`` (which waited on ROADMAP.md
item 12.6) classifies a GraphDef as the JAX main does.
"""

import jax
import numpy as np

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


def _tf_graph(path, seed):
    """A frozen-style GraphDef taking the pipeline's NCHW batch: a
    Transpose to NHWC, a SAME Conv2D with bias and ReLU, a spatial Mean,
    then MatMul, BiasAdd and Softmax."""
    from bigdl_tpu.utils import protowire as pw

    def attr(key, value):
        return pw.enc_bytes(5, pw.enc_string(1, key) + pw.enc_bytes(2, value))

    def tensor(arr, dt):
        shape = b"".join(pw.enc_bytes(2, pw.enc_varint(1, d))
                         for d in arr.shape)
        return attr("value", pw.enc_bytes(8, pw.enc_varint(1, dt)
                                          + pw.enc_bytes(2, shape)
                                          + pw.enc_bytes(4, arr.tobytes())))

    def ints(key, vals):
        return attr(key, pw.enc_bytes(1, b"".join(pw.enc_varint(3, v)
                                                  for v in vals)))

    def node(name, op, inputs=(), attrs=b""):
        out = pw.enc_string(1, name) + pw.enc_string(2, op)
        for i in inputs:
            out += pw.enc_string(3, i)
        return pw.enc_bytes(1, out + attrs)

    rng = np.random.RandomState(seed)
    f32 = lambda *s: (rng.randn(*s) * 0.5).astype(np.float32)  # noqa: E731
    gd = b"".join([
        node("x", "Placeholder"),
        node("perm", "Const", attrs=tensor(np.asarray([0, 2, 3, 1],
                                                      np.int32), 3)),
        node("nhwc", "Transpose", ["x", "perm"]),
        node("w", "Const", attrs=tensor(f32(3, 3, 3, 4), 1)),
        node("conv", "Conv2D", ["nhwc", "w"],
             attrs=ints("strides", [1, 1, 1, 1])
             + attr("padding", pw.enc_string(2, "SAME"))),
        node("b", "Const", attrs=tensor(f32(4), 1)),
        node("bias", "BiasAdd", ["conv", "b"]),
        node("relu", "Relu", ["bias"]),
        node("axes", "Const", attrs=tensor(np.asarray([1, 2], np.int32), 3)),
        node("mean", "Mean", ["relu", "axes"]),
        node("w2", "Const", attrs=tensor(f32(4, 3), 1)),
        node("mm", "MatMul", ["mean", "w2"]),
        node("b2", "Const", attrs=tensor(f32(3), 1)),
        node("logits", "BiasAdd", ["mm", "b2"]),
        node("prob", "Softmax", ["logits"])])
    with open(path, "wb") as f:
        f.write(gd)


def test_tf_model_type_raises_naming_its_item(tmp_path):
    """``--model-type tf``, which waited on ROADMAP.md item 12.6, now
    classifies: a GraphDef taking the pipeline's NCHW batches gives the
    JAX main's classes, and the same graph converted to the port's
    ``bigdl`` format gives them too."""
    from bigdl_tpu_torch.utils import convert_model as tconv

    rng = np.random.RandomState(2)
    for i in range(9):     # each image its own channel brightness
        np.save(str(tmp_path / f"img{i:02d}.npy"),
                (rng.rand(16, 16, 3) * rng.rand(3)).astype(np.float32))
    images = str(tmp_path / "img*.npy")
    pb = str(tmp_path / "m.pb")
    _tf_graph(pb, seed=16)   # a seed whose graph parts the images
    tf_args = ["--model-type", "tf", "--tf-inputs", "x", "--tf-outputs",
               "prob", "--images", images, "--batch-size", "4"]
    want = jmain(["--model", pb] + tf_args)
    got = main(["--model", pb] + tf_args + ["--device", "cpu"])
    assert got == want and len(got) == 9 and len(set(got)) > 1
    dst = str(tmp_path / "m.bigdl")
    tconv.main(["--from", "tf", "--to", "bigdl", "--input", pb,
                "--tf-inputs", "x", "--tf-outputs", "prob", "--output", dst,
                "--device", "cpu"])
    assert main(["--model", dst, "--model-type", "bigdl", "--images", images,
                 "--batch-size", "4", "--device", "cpu"]) == want


def test_resize_option_sets_the_pipelines_image_size(tmp_path):
    """``--resize H,W`` (the port's option; the JAX main resizes to its
    ``predict``'s default 32 x 32) gives the classes of the JAX
    ``predict`` called with the same ``resize``: a flattening model
    takes only 8 x 8 inputs."""
    from bigdl_tpu.example.imageclassification.predict import (
        predict as jpredict)

    def flat(nn, d):
        return (nn.Sequential().add(nn.View(3 * 8 * 8))
                .add(nn.Linear(3 * 8 * 8, 5, **d)).add(nn.SoftMax()))

    with numpy_weight_draws(4):
        jm = flat(jnn, {})
    tm = flat(tnn, dict(device="cpu"))
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    tpath = str(tmp_path / "t.bigdl")
    tfile.save_module(tm, tpath)
    images = _images(tmp_path, 6, seed=3)
    got = main(["--model", tpath, "--model-type", "bigdl", "--images",
                images, "--resize", "8,8", "--device", "cpu"])
    assert got == jpredict(jm, images, resize=(8, 8))
    assert len(got) == 6 and len(set(got)) > 1
