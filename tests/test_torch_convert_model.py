"""The ConvertModel CLI (bigdl_tpu_torch/utils/convert_model.py) against
the JAX package's (tests/test_convert.py's CLI case, run through the
port).

The same model is saved in each package's ``bigdl`` (pickle) format with
the same weights, and each package's CLI converts it: the port's GraphDef
and Caffe pair are the JAX CLI's bytes (the GraphDef's run in
TensorFlow is ``tests/test_torch_tf_export.py``'s), and the Caffe pair
loads back to the model's output. ``--quantize`` writes the port's int8
clone; ``--from tf`` and ``--from keras`` (which waited on ROADMAP.md
items 12.6 and 12.7) convert as the JAX CLI does; ``--to torch`` of a
module raises ``TypeError``, as in the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.utils import convert_model as jconv
from bigdl_tpu.utils import file as jfile
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.utils import convert_model as tconv
from bigdl_tpu_torch.utils import file as tfile
from bigdl_tpu_torch.utils.caffe import load_caffe
from bigdl_tpu_torch.utils.weights import load_jax_params
from tests.jax_numpy_init import numpy_weight_draws

CPU = ["--device", "cpu"]


def _mlp(nn, d):
    return (nn.Sequential().add(nn.Linear(4, 8, **d)).add(nn.ReLU())
            .add(nn.Linear(8, 2, **d)))


@pytest.fixture
def saved(tmp_path):
    with numpy_weight_draws(7):
        jm = _mlp(jnn, {})
    jm.evaluate()
    tm = _mlp(tnn, dict(device="cpu"))
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    tm.evaluate()
    jsrc, tsrc = str(tmp_path / "j.bigdl"), str(tmp_path / "t.bigdl")
    jfile.save_module(jm, jsrc)
    tfile.save_module(tm, tsrc)
    return jm, tm, jsrc, tsrc


def test_cli_bigdl_to_tf_and_caffe(saved, tmp_path):
    jm, tm, jsrc, tsrc = saved
    tpb, jpb = str(tmp_path / "t.pb"), str(tmp_path / "j.pb")
    tconv.main(["--from", "bigdl", "--to", "tf", "--input", tsrc, "--output",
                tpb, "--input-shape", "4"] + CPU)
    jconv.main(["--from", "bigdl", "--to", "tf", "--input", jsrc, "--output",
                jpb, "--input-shape", "4"])
    assert open(tpb, "rb").read() == open(jpb, "rb").read()

    files = {}
    for side, main, src, extra in (("t", tconv.main, tsrc, CPU),
                                   ("j", jconv.main, jsrc, [])):
        proto = str(tmp_path / f"{side}.prototxt")
        cm = str(tmp_path / f"{side}.caffemodel")
        main(["--from", "bigdl", "--to", "caffe", "--input", src, "--output",
              cm, "--prototxt", proto, "--input-shape", "4"] + extra)
        files[side] = (open(proto).read(), open(cm, "rb").read(), proto, cm)
    assert files["t"][:2] == files["j"][:2]
    back = load_caffe(files["t"][2], files["t"][3], device="cpu")
    back.evaluate()
    x = np.random.RandomState(4).randn(3, 4).astype(np.float32)
    with torch.no_grad():
        got = back(torch.from_numpy(x)).numpy()
        want = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(want, np.asarray(jm(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def test_cli_caffe_to_bigdl_quantized(saved, tmp_path):
    _, tm, _, tsrc = saved
    proto, cm = str(tmp_path / "m.prototxt"), str(tmp_path / "m.caffemodel")
    tconv.main(["--from", "bigdl", "--to", "caffe", "--input", tsrc,
                "--output", cm, "--prototxt", proto, "--input-shape", "4"]
               + CPU)
    dst = str(tmp_path / "q.bigdl")
    tconv.main(["--from", "caffe", "--to", "bigdl", "--input", cm,
                "--prototxt", proto, "--output", dst, "--quantize"] + CPU)
    q = tfile.load_module(dst, device="cpu")
    from bigdl_tpu_torch.nn.quantized import Quantizer

    ref = Quantizer.quantize(load_caffe(proto, cm, device="cpu"))
    kinds = [f"{type(m).__module__}.{type(m).__name__}" for m in q.modules()]
    assert kinds == [f"{type(m).__module__}.{type(m).__name__}"
                     for m in ref.modules()]
    assert kinds.count("bigdl_tpu_torch.nn.quantized.Linear") == 2, kinds
    x = torch.from_numpy(
        np.random.RandomState(5).randn(6, 4).astype(np.float32))
    q.evaluate()
    ref.evaluate()
    with torch.no_grad():
        out, want, full = q(x), ref(x), tm(x)
    assert torch.equal(out, want)
    assert float((out - full).abs().max()) < 0.05 * float(full.abs().max())
    with pytest.raises(ValueError, match="--quantize only supports"):
        tconv.main(["--from", "bigdl", "--to", "tf", "--input", tsrc,
                    "--output", str(tmp_path / "x.pb"), "--input-shape", "4",
                    "--quantize"] + CPU)


def _keras1_files(tm, tmp_path):
    """The MLP ``tm`` as a Keras-1.2.2 json topology + hdf5 weights."""
    import json

    import h5py

    spec = {"class_name": "Sequential", "config": [
        {"class_name": "Dense", "config": {
            "output_dim": 8, "activation": "relu",
            "batch_input_shape": [None, 4]}},
        {"class_name": "Dense", "config": {"output_dim": 2}}]}
    jpath, hpath = str(tmp_path / "k.json"), str(tmp_path / "k.h5")
    with open(jpath, "w") as f:
        json.dump(spec, f)
    lins = [m for m in tm.modules() if isinstance(m, tnn.Linear)]
    with h5py.File(hpath, "w") as f:
        f.attrs["layer_names"] = [b"dense_1", b"dense_2"]
        for i, lin in enumerate(lins):
            g = f.create_group(f"dense_{i + 1}")
            g.attrs["weight_names"] = [b"W", b"b"]
            g.create_dataset("W", data=lin.weight.detach().numpy().T)
            g.create_dataset("b", data=lin.bias.detach().numpy())
    return jpath, hpath


@pytest.mark.parametrize("src,item", [("tf", "item 12.6"),
                                      ("keras", "item 12.7")])
def test_sources_still_waiting_raise_naming_their_item(src, item, saved,
                                                       tmp_path):
    """The two sources that waited on ROADMAP.md items 12.6 (TF import)
    and 12.7 (Keras) now convert: ``--from tf`` and ``--from keras`` to
    ``bigdl`` through the port's CLI and through the JAX package's give
    the same forward as the source model, and the CLI names neither item
    any more."""
    _, tm, _, tsrc = saved
    if src == "tf":
        pb = str(tmp_path / "m.pb")
        tconv.main(["--from", "bigdl", "--to", "tf", "--input", tsrc,
                    "--output", pb, "--input-shape", "4"] + CPU)
        args = ["--input", pb, "--tf-inputs", "input", "--tf-outputs",
                "output"]
    else:
        jpath, hpath = _keras1_files(tm, tmp_path)
        args = ["--input", hpath, "--keras-json", jpath]
    tdst, jdst = str(tmp_path / "o.bigdl"), str(tmp_path / "oj.bigdl")
    tconv.main(["--from", src, "--to", "bigdl", "--output", tdst] + args
               + CPU)
    jconv.main(["--from", src, "--to", "bigdl", "--output", jdst] + args)
    back, jback = tfile.load_module(tdst, device="cpu"), jfile.load_module(jdst)
    back.evaluate()
    jback.evaluate()
    x = np.random.RandomState(6).randn(5, 4).astype(np.float32)
    with torch.no_grad():
        got, want = back(torch.from_numpy(x)).numpy(), \
            tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jback(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with open(tconv.__file__) as f:
        assert item not in f.read()


def test_to_torch_of_a_module_raises_as_in_jax(saved, tmp_path):
    _, _, jsrc, tsrc = saved
    with pytest.raises(TypeError, match="cannot write"):
        jconv.main(["--from", "bigdl", "--to", "torch", "--input", jsrc,
                    "--output", str(tmp_path / "j.t7")])
    out = tmp_path / "t.t7"
    with pytest.raises(TypeError, match="cannot write"):
        tconv.main(["--from", "bigdl", "--to", "torch", "--input", tsrc,
                    "--output", str(out)] + CPU)
    assert not out.exists()


def test_cli_loads_on_the_card_by_default(saved, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, _, _, tsrc = saved
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tconv.main(["--from", "bigdl", "--to", "tf", "--input", tsrc,
                    "--output", str(tmp_path / "m.pb"), "--input-shape", "4"])
