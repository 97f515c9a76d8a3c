"""The port's perf harness (bigdl_tpu_torch/models/perf.py) beyond
ResNet and LeNet: ``build_model``'s zoo rows and the JAX refusals,
``run_perf`` over a zoo model, ``transformer_perf`` with parameters
stored at the compute dtype (``master_f32=False``) and with the dense
attention (``use_flash=False``), and ``run_input_pipeline_perf`` on 64
records, on the CPU. Times on the CPU say nothing about the card; these
tests check what the harness builds, counts and returns."""

import math

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.models import perf as jperf
from bigdl_tpu_torch.models import perf
from tests.jax_numpy_init import numpy_weight_draws, seed_of

QUIET = dict(log=lambda *_: None, device="cpu")


@pytest.mark.parametrize("name,fmt", [
    ("vggcifar", "NCHW"), ("inception_v1", "NCHW"), ("inception", "NCHW"),
    ("mobilenet", "NHWC"), ("mobilenet_v1", "NCHW"), ("mobilenet_0.5", "NHWC"),
])
def test_build_model_zoo_rows_match_jax(name, fmt):
    """The same architecture as the JAX row (parameter count, input
    shape, classes) and the same output shape. The JAX row's weights
    are drawn by numpy (``tests/jax_numpy_init.py``): only its shapes
    are read."""
    model, shape, classes = perf.build_model(name, 10, format=fmt,
                                             device="cpu")
    with numpy_weight_draws(seed_of(name)):
        jm, jshape, jclasses = jperf.build_model(name, 10, format=fmt)
    assert (tuple(shape), classes) == (tuple(jshape), jclasses)
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(jm.params_dict()))
    model.evaluate()
    with torch.no_grad():
        out = model(torch.zeros((2,) + tuple(shape)))
    assert out.shape == (2, classes)


def test_build_model_vgg16_row():
    model, shape, classes = perf.build_model("vgg16", 7, device="cpu",
                                             dtype=torch.bfloat16)
    assert shape == (3, 224, 224) and classes == 7
    assert sum(p.numel() for p in model.parameters()) == \
        138_357_544 - 4096 * 993 - 993
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())


@pytest.mark.parametrize("name,match", [
    ("mobilenet_x", "unknown mobilenet variant"),
    ("mobilenet_v2", "unknown mobilenet variant"),
    ("alexnet", "unknown perf model"),
])
def test_build_model_refusals_are_the_jax_ones(name, match):
    with pytest.raises(ValueError, match=match):
        perf.build_model(name, device="cpu")
    with pytest.raises(ValueError, match=match):
        jperf.build_model(name)


def test_run_perf_over_a_zoo_model_picks_the_jax_criterion():
    """MobileNet (a zoo model without a LogSoftMax head) trains with
    ClassNLLCriterion as in the JAX harness; every step's loss finite."""
    s = perf.run_perf("mobilenet_0.25", batch_size=2, iterations=2,
                      warmup=1, format="NHWC", **QUIET)
    assert s["model"] == "mobilenet_0.25" and len(s["losses"]) == 3
    assert all(math.isfinite(v) for v in s["losses"])
    s = perf.run_perf("vggcifar", batch_size=4, iterations=1, warmup=1,
                      dtype=torch.bfloat16, master_f32=True, **QUIET)
    assert all(math.isfinite(v) for v in s["losses"])


TINY_LM = dict(seq_len=16, vocab=64, embed_dim=32, layers=2, heads=4)


def test_transformer_perf_master_f32_and_dense_options():
    """f32: parameters stored at the compute dtype give the f32 masters'
    losses; the dense attention the flash path's (the CPU runs the
    kernel's plain version). bf16 stored parameters train too."""
    base = perf.transformer_perf(2, 2, 1, torch.float32, **TINY_LM, **QUIET)
    stored = perf.transformer_perf(2, 2, 1, torch.float32, master_f32=False,
                                   **TINY_LM, **QUIET)
    dense = perf.transformer_perf(2, 2, 1, torch.float32, use_flash=False,
                                  **TINY_LM, **QUIET)
    assert base["master_f32"] and not stored["master_f32"]
    assert base["use_flash"] and not dense["use_flash"]
    np.testing.assert_array_equal(stored["losses"], base["losses"])
    np.testing.assert_allclose(dense["losses"], base["losses"], rtol=1e-5)
    bf = perf.transformer_perf(2, 3, 1, torch.bfloat16, master_f32=False,
                               **TINY_LM, **QUIET)
    assert len(bf["losses"]) == 4
    assert all(math.isfinite(v) for v in bf["losses"])


def test_run_input_pipeline_perf_on_64_records():
    from bigdl_tpu_torch import native

    logs = []
    rows = perf.run_input_pipeline_perf(batch_size=16, n_records=64,
                                        image=48, crop=40, depths=(0, 2),
                                        shards=4, log=logs.append,
                                        device="cpu")
    # composed with the C++ reader then the Python pool, the C++ kernel,
    # its numpy twin, each at each depth, then the kernel on workers
    asked = [(r["asked"]["native_reader"], r["asked"]["native_augment"],
              r["augment"] != "composed", r["prefetch_depth"]) for r in rows]
    assert asked[:8] == [(True, False, False, 0), (True, False, False, 2),
                         (False, False, False, 0), (False, False, False, 2),
                         (True, True, True, 0), (True, True, True, 2),
                         (True, False, True, 0), (True, False, True, 2)]
    assert all(r["asked"]["native_augment"] and r["augment_workers"] > 1
               and r["prefetch_depth"] == 2 for r in rows[8:])
    assert [r["augment"] for r in rows[6:8]] == ["numpy one pass"] * 2
    assert not any(r["native_reader"] for r in rows[2:4])
    if native.native_available():
        # the native rows ran natively: the reader's pool and the kernel
        assert all(r["native_reader"] for r in rows[:2] + rows[4:])
        assert all(r["fused_augment"] and r["augment"] == "native kernel"
                   for r in rows[4:6] + rows[8:])
        assert not any(r["fused_augment"] for r in rows[:4] + rows[6:8])
    else:
        assert any("not available" in line for line in logs)
        assert not any(r["native_reader"] or r["fused_augment"]
                       for r in rows)
    jax_keys = {"mode", "native_reader", "fused_augment", "prefetch_depth",
                "batch_size", "records", "image", "crop", "records_per_sec",
                "time_s"}
    for r in rows:
        assert jax_keys <= set(r) and r["records"] == 64
        assert r["records_per_sec"] > 0
    rows = perf.run_input_pipeline_perf(batch_size=16, n_records=40,
                                        image=48, crop=40, depths=(0,),
                                        native_modes=(False,),
                                        log=logs.append, device="cpu")
    assert all(r["records"] == 32 for r in rows)
