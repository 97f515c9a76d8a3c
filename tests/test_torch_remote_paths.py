"""Object-store paths through the port's file layer
(bigdl_tpu_torch/utils/file.py's ``_epath`` seam) and the sharded
checkpoints' meta-last protocol (utils/sharded_ckpt.py), against the JAX
package's ``tests/test_remote_paths.py``.

The fake bucket maps ``gs://bucket/...`` onto an ``etils.epath`` tmp dir
by replacing the single ``_epath`` seam, as the JAX test does, so
everything downstream (pickled modules, optim-method snapshots, the sync
and the async checkpoint trigger and its latest-scan, summary event
files, sharded checkpoints) runs the REAL remote code path: epath open /
mkdir / iterdir, no ``os.*`` on a remote path. The JAX package's four
cases run as their counterparts; the port adds the async checkpoint, a
two-rank sharded checkpoint to the bucket that restores equal, bit for
bit, to the same checkpoint written locally, and a bucket checkpoint
whose sidecar is missing, which restore refuses. Values are compared
exactly (no tolerance).
"""

import os

import numpy as np
import pytest
import torch

import torch_jobs_remote as jobs
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet, Sample
from bigdl_tpu_torch.optim import SGD, Trigger
from bigdl_tpu_torch.optim.optimizer import (LocalOptimizer,
                                             load_latest_checkpoint)
from bigdl_tpu_torch.utils import file as bt_file
from bigdl_tpu_torch.utils import sharded_ckpt
from torch_world import World


@pytest.fixture
def bucket(monkeypatch, tmp_path):
    root = tmp_path / "bucket"
    monkeypatch.setattr(bt_file, "_epath", bt_file._epath)
    jobs.fake_bucket(str(root))
    return root


def _samples(n=32):
    rng = np.random.RandomState(0)
    return [Sample(rng.rand(2).astype(np.float32),
                   np.array([1.0 + (i % 2)], np.float32)) for i in range(n)]


def _net():
    return nn.Sequential(nn.Linear(2, 4, device="cpu"), nn.Tanh(),
                         nn.Linear(4, 2, device="cpu"), nn.LogSoftMax())


def test_module_roundtrip_through_bucket(bucket):
    m = nn.Sequential(nn.Linear(2, 4, device="cpu"), nn.Tanh(),
                      nn.Linear(4, 2, device="cpu"))
    bt_file.makedirs("gs://bucket/models")
    bt_file.save_module(m, "gs://bucket/models/net")
    assert bt_file.exists("gs://bucket/models/net")
    assert (bucket / "models" / "net").is_file()
    with pytest.raises(FileExistsError):  # the overwrite guard sees it
        bt_file.save_module(m, "gs://bucket/models/net")
    back = bt_file.load_module("gs://bucket/models/net", device="cpu")
    for a, b in zip(back.parameters(), m.parameters()):
        assert torch.equal(a, b)


def test_generic_save_load_through_bucket(bucket):
    obj = {"w": torch.arange(4.0), "meta": "x"}
    bt_file.makedirs("gs://bucket/obj")
    bt_file.save(obj, "gs://bucket/obj/state")
    back = bt_file.load("gs://bucket/obj/state")
    assert torch.equal(back["w"], obj["w"])
    assert back["meta"] == "x"


@pytest.mark.parametrize("async_write", [False, True])
def test_checkpoint_trigger_writes_to_bucket(bucket, async_write):
    """The checkpoint trigger (sync, or written on a thread) targets a
    gs:// path end to end: snapshots land in the bucket under their
    final names and the latest-scan recovery reads them back."""
    model = _net()
    opt = LocalOptimizer(model=model, training_set=DataSet.array(_samples()),
                         criterion=nn.ClassNLLCriterion(), batch_size=16,
                         end_when=Trigger.max_iteration(3))
    opt.set_optim_method(SGD(learning_rate=0.1))
    opt.set_checkpoint("gs://bucket/run1", Trigger.several_iteration(1),
                       async_write=async_write)
    trained = opt.optimize()
    names = set(bt_file.listdir("gs://bucket/run1"))
    assert names == set(os.listdir(bucket / "run1"))
    assert {"model.3", "optimMethod.3"} <= names
    assert not any(n.startswith(".") for n in names)   # no temp names
    m2, method, tag = load_latest_checkpoint("gs://bucket/run1",
                                             device="cpu")
    assert tag == 3 and method.state["neval"] >= 1
    for a, b in zip(m2.parameters(), trained.parameters()):
        assert torch.equal(a, b)


def test_train_summary_events_to_bucket(bucket):
    """TrainSummary writes TFRecord event files into the bucket and the
    reader scans them back through the same seam."""
    from bigdl_tpu_torch.visualization import TrainSummary
    from bigdl_tpu_torch.visualization.tensorboard import read_scalar

    ts = TrainSummary("gs://bucket/logs", "app")
    ts.add_scalar("Loss", 1.25, 1)
    ts.add_scalar("Loss", 0.75, 2)
    ts.close()
    assert any(".tfevents." in n
               for n in os.listdir(bucket / "logs" / "app" / "train"))
    rows = read_scalar("gs://bucket/logs/app/train", "Loss")
    assert [r[0] for r in rows] == [1, 2]
    assert rows[0][2] == pytest.approx(1.25)


def test_bucket_checkpoint_without_meta_is_refused(bucket):
    params = {"w": torch.arange(6.0)}
    sharded_ckpt.save_train_state("gs://bucket/ck", 2, params, {}, (), {})
    assert sharded_ckpt.exists("gs://bucket/ck")
    assert (bucket / "ck.meta.json").is_file()
    step, p, _, _, _ = sharded_ckpt.restore_train_state(
        "gs://bucket/ck", like=(params, {}, ()))
    assert step == 2 and torch.equal(p["w"], params["w"])
    os.remove(bucket / "ck.meta.json")    # a save cut after its blocks
    assert not sharded_ckpt.exists("gs://bucket/ck")
    with pytest.raises(ValueError, match="incomplete"):
        sharded_ckpt.restore_train_state("gs://bucket/ck",
                                         like=(params, {}, ()))


def test_sharded_checkpoint_to_bucket_equals_local(tmp_path):
    """Two ranks save one sharded state locally (the swap protocol over
    ``torch.distributed.checkpoint``) and to the bucket (meta last);
    every restore from the bucket equals the local one bit for bit, and
    a block two ranks hold is written once."""
    got = World.shared(2).run(jobs.sharded_roundtrip,
                              str(tmp_path / "bucket"),
                              str(tmp_path / "local" / "ck"),
                              "gs://bucket/run/ck")
    for r, out in enumerate(got):
        loc, rem = out["local"], out["remote"]
        assert rem["step"] == loc["step"] == 4
        assert rem["state"] == loc["state"] == {"Loss": 0.25}
        assert rem["count"] == loc["count"] == 11
        for k in ("w", "b", "whole"):
            assert rem[k].tobytes() == loc[k].tobytes(), (r, k)
        np.testing.assert_array_equal(rem["w"], out["local_w"])
        # rank 1 writes only its half of w; the bias is rank 0's
        assert out["bucket"] == ["blocks.0.pt", "blocks.1.pt"]
    np.testing.assert_array_equal(
        got[0]["remote"]["whole"],
        np.arange(48, dtype=np.float32).reshape(8, 6) / np.float32(7.0))
