"""Rank-side jobs of ``tests/test_torch_remote_paths.py`` (run in
``torch_world.World``; no JAX here)."""

from __future__ import annotations


def fake_bucket(root: str) -> None:
    """Map ``gs://bucket/...`` onto ``root`` through the file layer's one
    seam, ``_epath``, with ``etils.epath`` (the JAX test's fake)."""
    from etils import epath

    from bigdl_tpu_torch.utils import file as bt_file

    def fake_epath(path):
        s = str(path)
        assert "://" in s, f"_epath must only see remote paths, got {s}"
        tail = s.split("://", 1)[1].split("/", 1)
        return epath.Path(root) / (tail[1] if len(tail) > 1 else "")

    bt_file._epath = fake_epath


def sharded_roundtrip(root: str, local_path: str, remote_path: str):
    """Each rank saves its half of a (8, 6) weight (``P("data")``), a
    replicated bias and a step counter to ``local_path`` and to
    ``remote_path`` (a ``gs://`` URL on the fake bucket), then restores
    both onto its half and onto the whole; returns the four restores,
    the bucket's files and the blocks the rank wrote there."""
    import os

    import torch

    from bigdl_tpu_torch.parallel import Engine
    from bigdl_tpu_torch.parallel.tp import P, NamedSharding
    from bigdl_tpu_torch.utils.sharded_ckpt import (restore_train_state,
                                                    save_train_state)

    fake_bucket(root)
    sh = NamedSharding(Engine.default_mesh(), P("data"))
    full = torch.arange(48, dtype=torch.float32).reshape(8, 6) / 7.0
    params = {"w": full[sh.index((8, 6))].clone(),
              "b": torch.linspace(-1, 1, 6)}
    buffers = {"count": torch.tensor(11)}
    shardings = ({"w": sh, "b": None}, None, None)
    out = {}
    for name, path in (("local", local_path), ("remote", remote_path)):
        save_train_state(path, 4, params, buffers, (), {"Loss": 0.25},
                         shardings=shardings)
        step, p, b, _, state = restore_train_state(
            path, like=(params, buffers, ()), shardings=shardings)
        _, whole, _, _, _ = restore_train_state(
            path, like=({"w": torch.empty(8, 6), "b": torch.empty(6)},
                        buffers, ()))
        out[name] = {"step": step, "state": state, "w": p["w"].numpy(),
                     "b": p["b"].numpy(), "count": int(b["count"]),
                     "whole": whole["w"].numpy()}
    tail = remote_path.split("://", 1)[1].split("/", 1)[1]
    out["bucket"] = sorted(os.listdir(os.path.join(root, tail)))
    out["local_w"] = params["w"].numpy()
    return out
