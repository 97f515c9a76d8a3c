"""The port's sharded training-state checkpoints
(``bigdl_tpu_torch/utils/sharded_ckpt.py``, the counterpart of
``bigdl_tpu/utils/orbax_ckpt.py``): the cases of
``tests/test_orbax_ckpt.py``, the ``DistriOptimizer`` retry from sharded
slots (``tests/test_fault_tolerance.py``'s orbax case) and the two-rank
save / restore (``tests/test_multihost.py``'s orbax case).

The single-process cases run here, as the JAX ones do; the multi-rank
cases run in one world of 2 ranks over gloo on the CPU
(``torch_world.World``). Every restored value must equal what was saved
(no tolerance), and a retried run must equal the uninterrupted run bit
for bit.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import torch_jobs_parallel
import torch_jobs_tp as jobs
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.optim import SGD
from bigdl_tpu_torch.optim.optimizer import make_train_step
from bigdl_tpu_torch.parallel.engine import Mesh
from bigdl_tpu_torch.parallel.tp import P, NamedSharding
from bigdl_tpu_torch.utils.sharded_ckpt import (restore_train_state,
                                                save_train_state)
from torch_world import World

N = 2


@pytest.fixture(scope="module")
def world():
    return World.shared(N)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _shift(tree, c):
    if isinstance(tree, dict):
        return {k: _shift(v, c) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_shift(v, c) for v in tree)
    return tree + c if torch.is_tensor(tree) else tree


def test_roundtrip_plain_arrays(tmp_path):
    m = nn.Sequential(nn.Linear(4, 8, device="cpu"), nn.ReLU(),
                      nn.Linear(8, 2, device="cpu"))
    ts = make_train_step(m, nn.MSECriterion(),
                         SGD(learning_rate=0.1, momentum=0.9))
    params = m.params_dict()
    buffers = m.buffers_dict()
    slots = _shift(ts.init_slots(params), 1.5)   # momentum, not zeros
    p = str(tmp_path / "ckpt")
    save_train_state(p, 7, params, buffers, slots, {"Loss": 0.5})
    step, rp, rb, rs, state = restore_train_state(
        p, like=(params, buffers, slots))
    assert step == 7 and state["Loss"] == 0.5
    for a, b in zip(_leaves(params), _leaves(rp)):
        assert torch.equal(a, b)
    assert len(_leaves(slots)) == len(_leaves(rs))
    for a, b in zip(_leaves(slots), _leaves(rs)):
        assert torch.equal(a, b)


def test_roundtrip_restores_into_mesh_sharding(world, tmp_path):
    """Each rank writes its own half of a flat vector (and the planner
    one copy of a replicated buffer); the state comes back into the same
    layout and onto a replicated one."""
    path = str(tmp_path / "ckpt")
    out = world.run(jobs.ckpt_two_ranks, path)
    flat = np.arange(64, dtype=np.float32)
    for r, o in enumerate(out):
        assert o["step"] == 3 and o["state"] == {"Loss": 0.5}
        np.testing.assert_array_equal(o["local"], flat[r * 32:(r + 1) * 32])
        np.testing.assert_array_equal(o["same"], o["local"])
        np.testing.assert_array_equal(o["full"], flat)
        assert o["count"] == 7
    # both ranks wrote block files, rank 0 the metadata
    files = os.listdir(path)
    assert sum(f.endswith(".distcp") for f in files) == N, files
    assert os.path.exists(path + ".meta.json")


def test_restore_onto_another_layout(tmp_path):
    """A state saved whole restores onto a 4-way layout: this process is
    rank 0 of a 4-rank mesh and receives the first quarter."""
    p = str(tmp_path / "ck")
    flat = torch.arange(16, dtype=torch.float32)
    save_train_state(p, 1, {"w": flat}, {}, ())
    mesh4 = Mesh([("data", 4)], ranks=[0, 1, 2, 3])
    _, rp, _, _, _ = restore_train_state(
        p, like=({"w": torch.empty(4)}, {}, ()),
        shardings=({"w": NamedSharding(mesh4, P("data"))}, None, None))
    assert torch.equal(rp["w"], flat[:4])


def test_missing_meta_raises_and_state_roundtrips_types(tmp_path,
                                                        monkeypatch):
    m = nn.Sequential(nn.Linear(3, 2, device="cpu"))
    params = m.params_dict()
    p = str(tmp_path / "ck")
    save_train_state(p, 5, params, {}, (),
                     {"epoch": 3, "phase": "warmup", "Loss": 0.25,
                      "obj": object()})
    step, _, _, _, state = restore_train_state(p, like=(params, {}, ()))
    assert step == 5
    assert state == {"epoch": 3, "phase": "warmup", "Loss": 0.25}
    assert isinstance(state["epoch"], int)
    os.remove(p + ".meta.json")
    with pytest.raises(ValueError, match="incomplete"):
        restore_train_state(p, like=(params, {}, ()))
    # an object-store path: the meta-last protocol through the file
    # layer's seam, here a fake bucket under tmp_path
    from etils import epath

    from bigdl_tpu_torch.utils import file as bt_file

    monkeypatch.setattr(bt_file, "_epath", lambda path: epath.Path(
        tmp_path / "bucket" / str(path).split("://", 1)[1]))
    save_train_state("gs://bucket/ck", 1, params, {}, ())
    assert (tmp_path / "bucket" / "bucket" / "ck.meta.json").is_file()
    assert restore_train_state("gs://bucket/ck",
                               like=(params, {}, ()))[0] == 1


def test_interrupted_overwrite_preserves_prior_checkpoint(tmp_path):
    """A crash mid-save never destroys the previous checkpoint: every
    window of the rename dance leaves a complete pair a restore finds,
    and the next save finishes an interrupted swap and clears the
    leftovers."""
    m = nn.Sequential(nn.Linear(3, 2, device="cpu"))
    params = m.params_dict()
    p = str(tmp_path / "ck")
    save_train_state(p, 1, params, {}, ())

    # window A: new blocks + meta fully written to .tmp-save, swap not
    # started: .tmp-save is newer and wins
    shutil.copytree(p, p + ".tmp-save")
    with open(p + ".meta.json") as f:
        meta = f.read().replace('"step": 1', '"step": 2')
    with open(p + ".tmp-save.meta.json", "w") as f:
        f.write(meta)
    step, _, _, _, _ = restore_train_state(p, like=(params, {}, ()))
    assert step == 2
    # the next save finishes that swap (promotes step 2), then lands 3
    save_train_state(p, 3, params, {}, ())
    assert not os.path.exists(p + ".old")
    assert not os.path.exists(p + ".tmp-save")
    step, _, _, _, _ = restore_train_state(p, like=(params, {}, ()))
    assert step == 3

    # window B: the live pair retired to .old, the promotion never ran
    os.rename(p, p + ".old")
    os.rename(p + ".meta.json", p + ".old.meta.json")
    step, _, _, _, _ = restore_train_state(p, like=(params, {}, ()))
    assert step == 3
    # a partial tmp (blocks, no meta) is ignored, and the next save
    # clears it and every leftover
    os.makedirs(p + ".tmp-save")
    step, _, _, _, _ = restore_train_state(p, like=(params, {}, ()))
    assert step == 3
    os.rename(p + ".old", p)
    os.rename(p + ".old.meta.json", p + ".meta.json")
    save_train_state(p, 4, params, {}, ())
    assert not os.path.exists(p + ".old")
    assert not os.path.exists(p + ".tmp-save")
    step, _, _, _, _ = restore_train_state(p, like=(params, {}, ()))
    assert step == 4


def test_retry_restores_orbax_sharded_slots(world, tmp_path):
    """``slots_backend="orbax"``: the slots are written shard by shard
    (no pickle of the gathered slots) and a failure retries from them."""
    path = str(tmp_path / "ck")
    out = world.run(torch_jobs_parallel.retry_from_checkpoint, path,
                    "orbax")
    for o in out:
        assert o["fired"] and o["neval"] >= 30
        assert o["accuracy"] > 0.9
        assert any(f.startswith("optimSlots.") and f.endswith(".orbax")
                   for f in o["files"])
        assert not any(f.startswith("optimSlots.") and ".orbax" not in f
                       for f in o["files"])


def test_retry_from_sharded_slots_equals_the_uninterrupted_run(world,
                                                               tmp_path):
    """A 2-rank run killed at iteration 8, after its iteration-5
    checkpoint, and retried from it ends with the parameters of the
    uninterrupted run, bit for bit (each rank restores its own slice of
    the momentum)."""
    whole = world.run(jobs.orbax_continuation, str(tmp_path / "a"), 10)
    broken = world.run(jobs.orbax_continuation, str(tmp_path / "b"), 10, 8)
    for w, b in zip(whole, broken):
        assert b["fired"] == [8] and not w["fired"]
        assert w["neval"] == b["neval"] == 11
        for x, y in zip(_leaves(w["params"]), _leaves(b["params"])):
            np.testing.assert_array_equal(x, y)
        assert "optimSlots.5.orbax" in b["files"]
