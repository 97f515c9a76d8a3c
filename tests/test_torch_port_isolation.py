"""The port stands alone: bigdl_tpu_torch imports neither JAX nor the JAX
package (a subprocess that serves and trains with it on the CPU, the
continuous-batching engine, int8 with a prefix host tier, QoS with
preemption, shedding, a token bucket, the chaos injector, the usage
ledger and the SLO watchdog, a ResNet-20 through the LocalOptimizer,
beam search, the PredictionService, the eager Module API and a loop
with an async checkpoint and a train summary, the native runtime, the
text-classification main, BPE and the table layers included, the
long-context main with MoE and the flash kernel's plain version, the
DistriOptimizer and ring attention at a world of one, and a scan of
every module's imports), and its entry points run on the card
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
from bigdl_tpu_torch.serving import ContinuousBatchingEngine
with ContinuousBatchingEngine(m, max_slots=2, prefill_chunk=4,
                              prefill_rows=2) as eng:
    hs, rows = [], []
    for prompt in (list(range(9)), list(range(8)) + [5]):
        hs.append(eng.submit(prompt, 3))
        rows.append(hs[-1].result(timeout=60))
assert [r.shape for r in rows] == [(12,), (12,)], rows
assert hs[1].prefix_tokens == 8, hs[1].prefix_tokens
d = TransformerLM(64, 16, 2, 1, 64, num_kv_heads=1, use_rope=True,
                  device="cpu")
with ContinuousBatchingEngine(m, max_slots=2, prefill_chunk=4,
                              page_size=4, draft=d, spec_gamma=2) as eng:
    row = eng.submit(list(range(9)), 5).result(timeout=60)
    assert eng.submit(list(range(9)) + [1], 3).result(
        timeout=60).shape == (13,)
assert row.shape == (14,), row.shape
assert eng._pages.pages_in_use == 0 and eng._d_pages.pages_in_use == 0
assert m.speculative_generate(torch.arange(6)[None], 4, draft=d).shape == \
    (1, 10)
with ContinuousBatchingEngine(m, max_slots=2, prefill_chunk=4,
                              kv_dtype="int8", weights_dtype="int8",
                              prefix_cache_rows=1,
                              prefix_host_rows=4) as eng:
    for head in (list(range(8)), list(range(8, 16)), list(range(8))):
        eng.submit(head + [1, 2], 3).result(timeout=60)
    pc = eng.stats()["prefix_cache"]
assert pc["demotions"] >= 1 and pc["promotions"] >= 1, pc
assert eng.stats()["quantization"]["row_bytes_ratio"] < 1.0
from bigdl_tpu_torch.serving import (ChaosInjector, RequestShed,
                                     run_paged_comparison, run_qos_storm,
                                     run_speculative_comparison)
chaos = ChaosInjector()
with ContinuousBatchingEngine(
        m, max_slots=1, prefill_chunk=4, preempt_slack_s=0.002,
        chaos=chaos, tenant_rate_limits={"t": (1.0, 1.0)},
        slo_objectives=[dict(name="x", metric="ttft", threshold_s=1.0)],
        page_size=4) as eng:
    low = eng.submit(list(range(6)), 30, priority="low", tenant="t")
    next(low.tokens())
    high = eng.submit(list(range(4)), 3, priority="high")
    assert high.result(timeout=60).shape == (7,)
    assert low.result(timeout=60).shape == (36,)
    chaos.force_burn(True)
    try:
        eng.submit([1, 2], 2, priority="low")
        raise AssertionError("not shed")
    except RequestShed:
        pass
    st = eng.stats()
assert low.preempted >= 1 and st["qos"]["shed"] == 1, st["qos"]
assert st["usage"]["tenants"]["t"]["device_s"] > 0, st["usage"]
assert eng._pages.pages_in_use == 0
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
import tempfile
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import MiniBatch
from bigdl_tpu_torch.optim import (PredictionService, RMSprop,
                                   load_latest_checkpoint)
from bigdl_tpu_torch.visualization import TrainSummary
assert m.beam_search(torch.arange(6)[None], 4, num_beams=2,
                     eos_id=3).shape == (1, 10)
nc = TransformerLM(64, 32, 4, 1, 64, use_flash=True, causal=False,
                   device="cpu")
assert nc(torch.arange(6)[None]).shape == (1, 6, 64)
svc = PredictionService(m, max_batch=2, sample_ndim=1)
assert svc.predict(np.arange(6)).shape == (6, 64)
lin = nn.Sequential(nn.Linear(4, 3, device="cpu"), nn.Dropout(0.2),
                    nn.LogSoftMax())
x, y = torch.randn(5, 4), torch.tensor([1.0, 2.0, 3.0, 1.0, 2.0])
crit = nn.ClassNLLCriterion()
lin.zero_grad_parameters()
out = lin(x)
lin.backward(x, crit.backward(out, y))
lin.update_parameters(0.1)
d = tempfile.mkdtemp()
opt = Optimizer(model=lin, dataset=[MiniBatch(x.numpy(), y.numpy())],
                criterion=crit, batch_size=5,
                end_when=Trigger.max_iteration(4))
opt.set_optim_method(RMSprop(0.01))
opt.set_checkpoint(d, Trigger.several_iteration(2), async_write=True)
opt.set_train_summary(TrainSummary(d, "app"))
opt.optimize()
assert len(opt.train_summary.read_scalar("Loss")) == 4
assert load_latest_checkpoint(d, device="cpu")[2] == 3
from bigdl_tpu_torch import native
from bigdl_tpu_torch.dataset import bpe, news20
from bigdl_tpu_torch.example.textclassification import train as text_train
assert native.native_available(), native.unavailable_reason()
_, acc = text_train.main(["--samples", "32", "--class-num", "2",
                          "--max-epoch", "1", "--device", "cpu"])
tok = bpe.BPETokenizer.train([t for t, _ in news20.synthetic_news20(20)], 200)
assert tok.decode(tok.encode("the orbit")) == "the orbit"
table = nn.Sequential(nn.ConcatTable(nn.Identity(), nn.Identity()),
                      nn.JoinTable(2), nn.Max(2))
assert table(torch.randn(2, 4)).shape == (2,)
from bigdl_tpu_torch.dataset import ShardedDataSet
from bigdl_tpu_torch.example.longcontext import train as lc_train
from bigdl_tpu_torch.parallel import (DistriOptimizer, MoEMLP, pipeline_spmd,
                                      ring_attention, ulysses_attention)
from bigdl_tpu_torch.tools import launch
lc = lc_train.main(["--seq-len", "16", "--batch", "2", "--layers", "1",
                    "--embed", "16", "--heads", "2", "--vocab", "32",
                    "--steps", "2", "--experts", "2", "--flash",
                    "--device", "cpu"])
assert len(lc) == 2, lc
dopt = Optimizer(model=nn.Sequential(nn.Linear(4, 3, device="cpu"),
                                     nn.LogSoftMax()),
                 dataset=ShardedDataSet([Sample(np.ones(4, np.float32), 1.0)
                                         for _ in range(8)]),
                 criterion=nn.ClassNLLCriterion(), batch_size=4,
                 end_when=Trigger.max_iteration(2))
assert isinstance(dopt, DistriOptimizer)
dopt.set_optim_method(SGD(learning_rate=0.1)).optimize()
q = torch.randn(1, 2, 8, 4)
assert ring_attention(q, q, q, causal=True, use_flash=True).shape == q.shape
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
    assert {"__init__", "benchmark", "chaos", "engine", "paging",
            "prefix_cache", "scheduler", "streams"} <= {
        f.stem for f in files if f.parent.name == "serving"}
    assert {"__init__", "accounting", "anomaly", "capacity", "chrometrace",
            "costmodel", "events", "exporters", "incidents", "instruments",
            "memory", "metrics", "postmortem", "profiler", "slo_budget",
            "timeseries", "tracing", "watchdog"} <= {
        f.stem for f in files if f.parent.name == "observability"}
    assert {"attention", "criterion", "linear", "module", "quantized"} <= {
        f.stem for f in files if f.parent.name == "nn"}
    assert {"__init__", "proto", "tensorboard"} <= {
        f.stem for f in files if f.parent.name == "visualization"}
    assert {"optimizer", "predictor", "prediction_service"} <= {
        f.stem for f in files if f.parent.name == "optim"}
    assert {"file", "tfrecord", "config"} <= {
        f.stem for f in files if f.parent.name == "utils"}
    assert {"__init__", "engine", "all_reduce", "collectives",
            "distri_optimizer", "ring_attention", "moe", "pipeline"} <= {
        f.stem for f in files if f.parent.name == "parallel"}
    assert {"launch"} <= {f.stem for f in files if f.parent.name == "tools"}
    assert {"train"} <= {f.stem for f in files
                         if f.parent.name == "longcontext"}
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
    from bigdl_tpu_torch.nn.module import Module
    from bigdl_tpu_torch.example.longcontext import train as lc_train
    from bigdl_tpu_torch.optim import load_latest_checkpoint
    from bigdl_tpu_torch.parallel import Engine, MoEMLP
    from bigdl_tpu_torch.serving import ContinuousBatchingEngine
    from bigdl_tpu_torch.utils.random import RandomGenerator

    for make in (lambda: TransformerLM(64, 32, 4, 2, 64),
                 lambda: MultiHeadAttention(32, 4),
                 lambda: LayerNorm(8), lambda: Linear(4, 4),
                 lambda: resolve_device(),
                 lambda: Module.load("/nonexistent/model.1"),
                 lambda: load_latest_checkpoint("/nonexistent"),
                 lambda: transformer_perf(2, 1, 1, seq_len=16),
                 lambda: RandomGenerator(0).next_generator(),
                 lambda: SpatialConvolution(3, 4, 3, 3),
                 lambda: BatchNormalization(4), lambda: LeNet5(),
                 lambda: ResNet(10, {"depth": 20}),
                 lambda: build_model("lenet5"),
                 lambda: run_perf("lenet5", 2, 1, 1),
                 lambda: Engine.init(), lambda: MoEMLP(8, 16, 2),
                 lambda: lc_train.main(["--steps", "1"]),
                 lambda: ContinuousBatchingEngine(
                     TransformerLM(64, 32, 4, 2, 64, device="cpu"),
                     device="cuda"),
                 lambda: ContinuousBatchingEngine(
                     TransformerLM(64, 32, 4, 2, 64, device="cpu"),
                     page_size=4, device="cuda"),
                 lambda: ContinuousBatchingEngine(
                     TransformerLM(64, 32, 4, 2, 64, device="cpu"),
                     draft=TransformerLM(64, 32, 4, 1, 64, device="cpu"),
                     device="cuda"),
                 lambda: ContinuousBatchingEngine(
                     TransformerLM(64, 32, 4, 2, 64, device="cpu"),
                     kv_dtype="int8", weights_dtype="int8",
                     prefix_host_rows=2, device="cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")
    assert RandomGenerator(0).next_generator("cpu").device.type == "cpu"
