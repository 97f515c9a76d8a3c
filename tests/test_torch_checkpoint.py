"""The LocalOptimizer's checkpoints (bigdl_tpu_torch/optim/optimizer.py
``set_checkpoint``, ``load_latest_checkpoint``) against the JAX loop's:
the file names and tags at the same triggers, sync and async; a run
resumed from its newest checkpoint equal, bit for bit on the CPU, to
the run that never stopped (parameters, optimizer slots and state); the
async snapshot taken before the next step can change a tensor (a slow
writer must still write the checkpoint's own iteration); a failed
write leaving no torn newest pair; orbax slots refused.
"""

import os
import time

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import MiniBatch, Sample
from bigdl_tpu_torch.optim import (Optimizer, RMSprop, Trigger,
                                   load_latest_checkpoint)
from bigdl_tpu_torch.utils import file as bt_file


def _model():
    torch.manual_seed(0)
    return nn.Sequential(nn.Linear(6, 12, device="cpu"), nn.Tanh(),
                         nn.Linear(12, 3, device="cpu"), nn.LogSoftMax())


def _batch():
    """One MiniBatch record: every iteration trains on the same batch, so
    a resumed run sees what the uninterrupted one saw."""
    rs = np.random.RandomState(0)
    return [MiniBatch(rs.randn(16, 6).astype(np.float32),
                      rs.randint(1, 4, 16).astype(np.float32))]


def _run(model, method, iters, path=None, every=2, async_write=False):
    opt = Optimizer(model=model, dataset=_batch(),
                    criterion=nn.ClassNLLCriterion(), batch_size=16,
                    end_when=Trigger.max_iteration(iters))
    opt.set_optim_method(method)
    if path is not None:
        opt.set_checkpoint(str(path), Trigger.several_iteration(every),
                           async_write=async_write)
    opt.optimize()
    return opt


def _params(model):
    return [p.detach().clone() for p in model.parameters()]


@pytest.mark.parametrize("async_write", [False, True], ids=["sync", "async"])
def test_file_names_and_tags_match_the_jax_loop(tmp_path, async_write):
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.dataset.sample import Sample as JSample
    from bigdl_tpu.optim import SGD as JSGD
    from bigdl_tpu.optim import Trigger as JTrigger
    from bigdl_tpu.optim.optimizer import Optimizer as JOptimizer

    rs = np.random.RandomState(1)
    xs, ys = rs.randn(32, 6).astype(np.float32), rs.randint(1, 4, 32)
    jm = jnn.Sequential(jnn.Linear(6, 3), jnn.LogSoftMax())
    jopt = JOptimizer(model=jm, dataset=[JSample(a, np.float32(b))
                                         for a, b in zip(xs, ys)],
                      criterion=jnn.ClassNLLCriterion(), batch_size=16,
                      end_when=JTrigger.max_iteration(7))
    jopt.set_optim_method(JSGD(learning_rate=0.1))
    jopt.set_checkpoint(str(tmp_path / "jax"), JTrigger.several_iteration(3),
                        async_write=async_write)
    jopt.optimize()
    tm = nn.Sequential(nn.Linear(6, 3, device="cpu"), nn.LogSoftMax())
    from bigdl_tpu_torch.optim import SGD

    topt = Optimizer(model=tm, dataset=[Sample(a, np.float32(b))
                                        for a, b in zip(xs, ys)],
                     criterion=nn.ClassNLLCriterion(), batch_size=16,
                     end_when=Trigger.max_iteration(7))
    topt.set_optim_method(SGD(learning_rate=0.1))
    topt.set_checkpoint(str(tmp_path / "port"), Trigger.several_iteration(3),
                        async_write=async_write)
    topt.optimize()
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert names == ["model.2", "model.5", "optimMethod.2",
                     "optimMethod.5"]
    _, _, tag = load_latest_checkpoint(str(tmp_path / "port"), device="cpu")
    assert tag == 5


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """Six iterations straight against four, a reload of the newest
    checkpoint into a fresh model and method, and two more: bit for bit.
    The reloaded parameters, slots and state equal those written."""
    full = _model()
    _run(full, RMSprop(learning_rate=0.01), 6, tmp_path / "full", every=4)
    part = _model()
    _run(part, RMSprop(learning_rate=0.01), 4, tmp_path / "part", every=4,
         async_write=True)
    model, method, tag = load_latest_checkpoint(str(tmp_path / "part"),
                                                device="cpu")
    assert tag == 3
    # what the async writer wrote is what the sync one wrote at the
    # same iteration of the other run
    sync_model, sync_method, sync_tag = load_latest_checkpoint(
        str(tmp_path / "full"), device="cpu")
    assert sync_tag == 3
    for a, b in zip(model.parameters(), sync_model.parameters()):
        assert torch.equal(a, b)
    assert method.state == sync_method.state
    slots, sync_slots = method._train_slots, sync_method._train_slots
    assert all(torch.equal(a, b) for a, b in
               zip(slots[0]["accum"], sync_slots[0]["accum"]))
    assert all(t.device.type == "cpu" for t in slots[0]["accum"])
    _run(model, method, 6)
    for a, b in zip(model.parameters(), full.parameters()):
        assert torch.equal(a, b)
    assert method.state["neval"] == 7


def test_async_snapshot_is_taken_before_the_next_step(tmp_path,
                                                      monkeypatch):
    """With a writer slower than the steps after it, each checkpoint
    still holds its own iteration's parameters: those of a synchronous
    run at the same tag."""
    _run(_model(), RMSprop(learning_rate=0.01), 6, tmp_path / "sync")
    real = bt_file.save_module

    def slow(*args, **kwargs):
        time.sleep(0.3)
        return real(*args, **kwargs)

    monkeypatch.setattr(bt_file, "save_module", slow)
    _run(_model(), RMSprop(learning_rate=0.01), 6, tmp_path / "async",
         async_write=True)
    for tag in (1, 3, 5):
        a = bt_file.load_module(str(tmp_path / "async" / f"model.{tag}"),
                                device="cpu")
        s = bt_file.load_module(str(tmp_path / "sync" / f"model.{tag}"),
                                device="cpu")
        for pa, ps in zip(a.parameters(), s.parameters()):
            assert torch.equal(pa, ps), tag
        ma = bt_file.load(str(tmp_path / "async" / f"optimMethod.{tag}"))
        ms = bt_file.load(str(tmp_path / "sync" / f"optimMethod.{tag}"))
        assert ma.state == ms.state
        assert all(torch.equal(x, y) for x, y in zip(
            ma._train_slots[0]["accum"], ms._train_slots[0]["accum"]))


def test_failed_write_leaves_no_torn_newest_checkpoint(tmp_path,
                                                       monkeypatch):
    """The write of the second checkpoint dies after half a file: the
    loop raises at its next join, and the newest complete pair on disk
    is the first checkpoint's."""
    real = bt_file.save
    calls = []

    def failing(obj, path, overwrite=False, snapshot=None):
        calls.append(path)
        if len(calls) == 2:
            with open(path, "wb") as f:
                f.write(b"half a pickle")
            raise OSError("disk full")
        return real(obj, path, overwrite=overwrite, snapshot=snapshot)

    monkeypatch.setattr(bt_file, "save", failing)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        _run(_model(), RMSprop(learning_rate=0.01), 6, tmp_path,
             async_write=True)
    names = set(os.listdir(tmp_path))
    assert {"model.1", "optimMethod.1"} <= names
    assert "optimMethod.3" not in names and "model.3" not in names
    _, method, tag = load_latest_checkpoint(str(tmp_path), device="cpu")
    assert tag == 1 and method.state["neval"] == 2


def test_orbax_slots_and_unknown_backends_are_refused(tmp_path):
    """The local loop accepts ``slots_backend="orbax"`` (JAX's option,
    "DistriOptimizer only") and writes its slots as usual, inside the
    method file; an unknown backend is refused."""
    opt = Optimizer(model=_model(), dataset=_batch(),
                    criterion=nn.ClassNLLCriterion(), batch_size=16,
                    end_when=Trigger.max_iteration(2))
    opt.set_optim_method(RMSprop(learning_rate=0.01))
    assert opt.set_checkpoint(str(tmp_path), Trigger.several_iteration(1),
                              slots_backend="orbax") is opt
    assert opt.checkpoint_slots_backend == "orbax"
    opt.optimize()
    names = set(os.listdir(tmp_path))
    assert {"model.1", "optimMethod.1"} <= names
    assert not any(n.startswith("optimSlots") for n in names)
    _, method, _ = load_latest_checkpoint(str(tmp_path), device="cpu")
    assert method._train_slots is not None
    with pytest.raises(ValueError, match="slots_backend"):
        opt.set_checkpoint("/unused", Trigger.every_epoch(),
                           slots_backend="zarr")
    assert load_latest_checkpoint("/no/such/dir", device="cpu") == (
        None, None, None)
