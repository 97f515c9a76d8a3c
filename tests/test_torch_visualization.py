"""The port's TensorBoard summaries (bigdl_tpu_torch/visualization and
the framing of bigdl_tpu_torch/utils/tfrecord.py) against the JAX
package's: the CRC32C test vector, framing byte for byte against the
JAX package's Python codec, round trips and corruption, the event
proto, scalar and histogram writes, the LocalOptimizer's train and
validation summaries, and event files read across the packages.
"""

import os

import numpy as np
import pytest

from bigdl_tpu import native
from bigdl_tpu.visualization import TrainSummary as JTrainSummary
from bigdl_tpu.visualization import read_scalar as jax_read_scalar
from bigdl_tpu_torch.utils import tfrecord
from bigdl_tpu_torch.visualization import (TrainSummary, ValidationSummary,
                                           proto, read_scalar)


def test_crc32c_known_vector():
    assert tfrecord.crc32c(b"123456789") == 0xE3069283
    assert tfrecord.crc32c(b"") == 0x0


def test_framing_matches_the_jax_codec():
    """The JAX package's Python fallback (its C++ library set aside)
    gives the same CRCs and frames."""
    lib, tried = native._lib, native._tried
    native._lib, native._tried = None, True
    try:
        for data in (b"abc", b"", b"\x00\xff" * 300):
            assert tfrecord.crc32c(data) == native.crc32c(data)
            assert tfrecord.masked_crc32c(data) == native.masked_crc32c(data)
            assert tfrecord.tfrecord_frame(data) == native.tfrecord_frame(data)
    finally:
        native._lib, native._tried = lib, tried


def test_tfrecord_roundtrip():
    recs = [b"a", b"payload-two", b"", b"\x00\xff" * 100]
    blob = b"".join(tfrecord.tfrecord_frame(r) for r in recs)
    assert list(tfrecord.tfrecord_iter(blob)) == recs
    assert list(native.tfrecord_iter(blob)) == recs


def test_tfrecord_detects_corruption():
    blob = bytearray(tfrecord.tfrecord_frame(b"hello world"))
    blob[14] ^= 0xFF
    with pytest.raises(ValueError, match="crc"):
        list(tfrecord.tfrecord_iter(bytes(blob)))
    with pytest.raises(ValueError, match="truncated"):
        list(tfrecord.tfrecord_iter(tfrecord.tfrecord_frame(b"xyz")[:-6]))


def test_event_roundtrip():
    s = proto.summary([proto.scalar_value("Loss", 1.5)])
    ev = proto.event(123.25, step=7, summary_bytes=s)
    parsed = proto.parse_event(ev)
    assert parsed["wall_time"] == 123.25
    assert parsed["step"] == 7
    assert parsed["values"] == [("Loss", 1.5)]


def test_write_read_scalars(tmp_path):
    ts = TrainSummary(str(tmp_path), "app")
    for i in range(5):
        ts.add_scalar("Loss", 2.0 / (i + 1), i + 1)
    rows = ts.read_scalar("Loss")
    ts.close()
    assert [r[0] for r in rows] == [1, 2, 3, 4, 5]
    np.testing.assert_allclose([r[2] for r in rows],
                               [2.0, 1.0, 2 / 3, 0.5, 0.4], rtol=1e-6)


def test_histogram_write(tmp_path):
    ts = TrainSummary(str(tmp_path), "app")
    ts.add_histogram("weights", np.random.RandomState(0).randn(100), 1)
    ts.flush()
    files = os.listdir(os.path.join(str(tmp_path), "app", "train"))
    assert any(".tfevents." in f for f in files)
    ts.close()


def test_optimizer_writes_summaries(tmp_path):
    """The LocalOptimizer's Loss / LearningRate / Throughput scalars each
    iteration, parameter histograms on the Parameters trigger, and the
    validation scalars at the iteration just finished."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.optim import SGD, Optimizer, Top1Accuracy, Trigger
    from bigdl_tpu_torch.visualization import tensorboard

    rng = np.random.RandomState(0)
    samples = [Sample(rng.randn(4).astype(np.float32),
                      np.array([1.0 + (i % 2)], np.float32))
               for i in range(32)]
    model = nn.Sequential(nn.Linear(4, 4, device="cpu"), nn.Tanh(),
                          nn.Linear(4, 2, device="cpu"), nn.LogSoftMax())
    ts = TrainSummary(str(tmp_path), "job")
    ts.set_summary_trigger("Parameters", Trigger.several_iteration(2))
    vs = ValidationSummary(str(tmp_path), "job")
    hist = []
    real = tensorboard.FileWriter.add_histogram

    def spy(self, tag, values, step):
        hist.append((tag, step))
        return real(self, tag, values, step)

    tensorboard.FileWriter.add_histogram = spy
    try:
        opt = Optimizer(model=model, dataset=samples,
                        criterion=nn.ClassNLLCriterion(), batch_size=16,
                        end_when=Trigger.max_iteration(4))
        opt.set_optim_method(SGD(learning_rate=0.1))
        opt.set_train_summary(ts)
        opt.set_validation_summary(vs)
        opt.set_validation(Trigger.several_iteration(2), samples,
                           [Top1Accuracy()], batch_size=16)
        opt.optimize()
    finally:
        tensorboard.FileWriter.add_histogram = real
    loss_rows = ts.read_scalar("Loss")
    lr_rows = ts.read_scalar("LearningRate")
    tp_rows = ts.read_scalar("Throughput")
    acc_rows = vs.read_scalar("Top1Accuracy")
    ts.close()
    vs.close()
    assert [r[0] for r in loss_rows] == [1, 2, 3, 4]
    assert len(tp_rows) == 4 and all(r[2] > 0 for r in tp_rows)
    np.testing.assert_allclose([r[2] for r in lr_rows], [0.1] * 4)
    # validation fires on the counter after it moved (neval 2 and 4) and
    # tags the iteration just finished, as the JAX loop does
    assert [r[0] for r in acc_rows] == [1, 3]
    assert sorted({t for t, _ in hist}) == [
        "m0.~params.bias", "m0.~params.weight", "m2.~params.bias",
        "m2.~params.weight"]
    assert sorted({s for _, s in hist}) == [2, 4]


def test_event_files_read_across_packages(tmp_path):
    """A file the port writes reads back through the JAX package's
    ``read_scalar``, and one the JAX package writes through the port's,
    with the same steps and values."""
    port = TrainSummary(str(tmp_path / "port"), "app")
    jaxs = JTrainSummary(str(tmp_path / "jax"), "app")
    for i in range(4):
        port.add_scalar("Loss", 1.0 / (i + 2), i + 1)
        jaxs.add_scalar("Loss", 1.0 / (i + 2), i + 1)
    port.flush()
    jaxs.flush()
    from_port = jax_read_scalar(str(tmp_path / "port" / "app" / "train"),
                                "Loss")
    from_jax = read_scalar(str(tmp_path / "jax" / "app" / "train"), "Loss")
    port.close()
    jaxs.close()
    assert [(s, v) for s, _, v in from_port] == \
        [(s, v) for s, _, v in from_jax]
    assert [s for s, _, _ in from_port] == [1, 2, 3, 4]
