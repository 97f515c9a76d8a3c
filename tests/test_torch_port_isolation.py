"""The port stands alone: bigdl_tpu_torch imports neither JAX nor the JAX
package (a subprocess that serves and trains with it on the CPU, a
ResNet-20 through the LocalOptimizer included, and a scan of every
module's imports), and its entry points run on the card
unless asked for the CPU, never falling back to it by themselves."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_DRIVE = """
import sys
import torch
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.optim import GenerationService
m = TransformerLM(64, 32, 4, 2, 64, num_kv_heads=2, use_rope=True,
                  use_flash=True, device="cpu")
out = m.generate(torch.arange(6)[None], 4)
assert out.shape == (1, 10), out.shape
assert m(out).shape == (1, 10, 64)
row = GenerationService(m, bucket_tokens=4).generate(list(range(5)), 3)
assert row.shape == (8,), row.shape
from bigdl_tpu_torch.models.perf import transformer_perf
s = transformer_perf(2, 1, 1, torch.float32, log=lambda *_: None,
                     seq_len=16, vocab=64, embed_dim=32, layers=1, heads=4,
                     remat=True, device="cpu")
assert len(s["losses"]) == 2, s
import numpy as np
from bigdl_tpu_torch.dataset import Sample
from bigdl_tpu_torch.models import ResNet
from bigdl_tpu_torch.nn import CrossEntropyCriterion
from bigdl_tpu_torch.optim import Optimizer, SGD, Trigger
net = ResNet(10, {"depth": 20, "dataSet": "CIFAR10", "shortcutType": "A"},
             device="cpu")
rs = np.random.RandomState(0)
data = [Sample(rs.randn(3, 32, 32).astype(np.float32), float(i % 10 + 1))
        for i in range(8)]
opt = Optimizer(model=net, dataset=data, criterion=CrossEntropyCriterion(),
                batch_size=4, end_when=Trigger.max_iteration(1))
opt.set_optim_method(SGD(learning_rate=0.01)).optimize()
assert opt.optim_method.state["neval"] == 2
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "bigdl_tpu"))
assert not bad, bad
print("ISOLATED")
"""


def test_port_runs_without_importing_jax():
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, "-c", _DRIVE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED" in proc.stdout


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_or_jax_package_import_in_the_port():
    files = sorted((REPO / "bigdl_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    files += sorted((REPO / "scripts").glob("torch_*.py"))
    assert len(files) > 10
    found = [(str(f.relative_to(REPO)), name) for f in files
             for name in _imports(f)
             if name.split(".")[0] in ("jax", "jaxlib", "bigdl_tpu")]
    assert not found, found


def test_entry_points_default_to_the_card_and_never_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    from bigdl_tpu_torch.device import resolve_device
    from bigdl_tpu_torch.models import LeNet5, ResNet, TransformerLM
    from bigdl_tpu_torch.models.perf import (build_model, run_perf,
                                             transformer_perf)
    from bigdl_tpu_torch.nn import (BatchNormalization, LayerNorm, Linear,
                                    MultiHeadAttention, SpatialConvolution)
    from bigdl_tpu_torch.utils.random import RandomGenerator

    for make in (lambda: TransformerLM(64, 32, 4, 2, 64),
                 lambda: MultiHeadAttention(32, 4),
                 lambda: LayerNorm(8), lambda: Linear(4, 4),
                 lambda: resolve_device(),
                 lambda: transformer_perf(2, 1, 1, seq_len=16),
                 lambda: RandomGenerator(0).next_generator(),
                 lambda: SpatialConvolution(3, 4, 3, 3),
                 lambda: BatchNormalization(4), lambda: LeNet5(),
                 lambda: ResNet(10, {"depth": 20}),
                 lambda: build_model("lenet5"),
                 lambda: run_perf("lenet5", 2, 1, 1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")
    assert RandomGenerator(0).next_generator("cpu").device.type == "cpu"
