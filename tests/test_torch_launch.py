"""The port's launcher (``bigdl_tpu_torch/tools/launch.py``) and the
long-context main (``bigdl_tpu_torch/example/longcontext/train.py``),
held against their JAX counterparts (``tests/test_multihost.py``'s
launcher cases, ``tests/test_examples.py:75``).

The launcher's local grid runs on the CPU over gloo, rendezvousing
through a file under ``tmp_path`` (no TCP port to collide under
``pytest -n``). The long-context main starts from the JAX main's
weights (``--init-params``, an ``.npz`` of the JAX tree built with the
JAX main's seed) and its losses equal the JAX main's at every step
within rtol 1e-5 (f32), with and without ``--seq-parallel 2``: the
launched 2-rank run against the JAX ``shard_map`` main over the same
global batch (JAX's mesh is 4 data x 2 seq on the conftest's 8
devices; a dense model's mean loss does not depend on how the rows are
split).
"""

import json
import os
import re
import subprocess
import sys

import jax
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=REPO)
LC_ARGS = ["--seq-len", "32", "--batch", "4", "--layers", "1", "--embed",
           "16", "--heads", "2", "--vocab", "32", "--steps", "3", "--rope",
           "--kv-heads", "1"]


def _launch(tmp_path, *argv, timeout=240):
    cmd = [sys.executable, "-m", "bigdl_tpu_torch.tools.launch",
           "--device", "cpu", "--store-file", str(tmp_path / "store"),
           *argv]
    return subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                          env=ENV, timeout=timeout)


_LENET = '''
"""LeNet through the DistriOptimizer under the launcher."""
import numpy as np
import torch.distributed as dist
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import Sample, ShardedDataSet
from bigdl_tpu_torch.models import LeNet5
from bigdl_tpu_torch.optim import SGD, Trigger
from bigdl_tpu_torch.parallel import DistriOptimizer, Engine

samples = [Sample(np.random.RandomState(i).randn(28, 28).astype(np.float32),
                  np.array([1.0 + (i % 10)], np.float32)) for i in range(32)]
opt = DistriOptimizer(model=LeNet5(10, device="cpu"),
                      dataset=ShardedDataSet(samples),
                      criterion=nn.ClassNLLCriterion(), batch_size=16,
                      end_when=Trigger.max_iteration(2),
                      mesh=Engine.default_mesh())
opt.set_optim_method(SGD(learning_rate=0.01))
opt.optimize()
print(f"LAUNCH OK {dist.get_rank()} {dist.get_world_size()} "
      f"{Engine.total_devices()} {Engine.backend()}", flush=True)
'''


def test_launcher_trains_lenet_on_a_local_grid(tmp_path):
    script = tmp_path / "train_lenet.py"
    script.write_text(_LENET)
    proc = _launch(tmp_path, "--procs", "2", str(script))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "LAUNCH OK 0 2 2 gloo" in proc.stdout, proc.stdout
    assert "LAUNCH OK 1 2 2 gloo" in proc.stdout, proc.stdout


def test_launcher_module_mode(tmp_path):
    pkg = tmp_path / "launchmod"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "main.py").write_text(
        "import sys, torch.distributed as dist\n"
        "print('MOD OK', dist.get_world_size(), sys.argv[1:], flush=True)\n")
    env = dict(ENV, PYTHONPATH=os.pathsep.join([REPO, str(tmp_path)]))
    proc = subprocess.run(
        [sys.executable, "-m", "bigdl_tpu_torch.tools.launch", "--device",
         "cpu", "--store-file", str(tmp_path / "store"), "--procs", "1",
         "-m", "launchmod.main", "--flag"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-1000:]
    assert "MOD OK 1 ['--flag']" in proc.stdout, proc.stdout


def test_launcher_failure_kills_stranded_ranks(tmp_path):
    """A rank that fails ends the launch with its exit code: the rank left
    waiting for it is killed, not waited for."""
    script = tmp_path / "fail_rank.py"
    script.write_text(
        "import sys, time, torch.distributed as dist\n"
        "if dist.get_rank() == 1:\n"
        "    sys.exit(3)\n"
        "time.sleep(600)   # rank 0 stranded waiting for its dead peer\n")
    proc = _launch(tmp_path, "--procs", "2", str(script), timeout=120)
    assert proc.returncode == 3, (proc.returncode, proc.stderr[-500:])


def test_launcher_reports_a_rank_killed_by_a_signal(tmp_path):
    """A rank that SIGABRT kills ends the launch with 128 + 6 (as a shell
    reports it, not ``sys.exit(-6)``'s 250), and the launcher names the
    rank and the signal; the stranded rank is killed."""
    script = tmp_path / "abort_rank.py"
    script.write_text(
        "import os, signal, time, torch.distributed as dist\n"
        "if dist.get_rank() == 1:\n"
        "    os.kill(os.getpid(), signal.SIGABRT)\n"
        "time.sleep(600)   # rank 0 stranded\n")
    proc = _launch(tmp_path, "--procs", "2", str(script), timeout=120)
    assert proc.returncode == 134, (proc.returncode, proc.stderr[-500:])
    assert "rank 1 was killed by SIGABRT" in proc.stderr, proc.stderr[-500:]


def test_launcher_refuses_virtual_devices(tmp_path):
    proc = _launch(tmp_path, "--procs", "2", "--cpu-devices", "4", "x.py",
                   timeout=60)
    assert proc.returncode == 2
    assert "one process on one device" in proc.stderr


# ----------------------------------------------------------- long context
def _jax_main(tmp_path, extra):
    """The JAX main's losses, and its initial weights saved as an .npz."""
    from bigdl_tpu.example.longcontext import train as jtrain
    from bigdl_tpu.models.transformer import TransformerLM as JaxLM
    from bigdl_tpu.utils import random as rnd

    rnd.set_seed(1)
    model = JaxLM(32, embed_dim=16, num_heads=2, num_layers=1, max_len=32,
                  causal=True, remat=True, use_rope=True, num_kv_heads=1)
    flat = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat["/".join(path + (k,))] = np.asarray(v)

    walk(jax.tree.map(np.asarray, model.params_dict()), ())
    path = tmp_path / "init.npz"
    np.savez(path, **flat)
    return jtrain.main(LC_ARGS + extra), str(path)


def test_longcontext_main_matches_the_jax_main(tmp_path):
    from bigdl_tpu_torch.example.longcontext import train

    want, init = _jax_main(tmp_path, [])
    got = train.main(LC_ARGS + ["--device", "cpu", "--init-params", init])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    flash = train.main(LC_ARGS + ["--device", "cpu", "--init-params", init,
                                  "--flash"])
    np.testing.assert_allclose(flash, want, rtol=1e-5)


def _launched_losses(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")]
    steps = [float(x) for x in re.findall(r"step \d+: loss ([\d.]+)",
                                          proc.stdout)]
    assert sorted(r["rank"] for r in rows) == [0, 1]
    return rows, steps


def test_longcontext_main_seq_parallel_matches_the_jax_main(tmp_path,
                                                           capsys):
    """``--seq-parallel 2`` through the launcher (the flash ring on the
    CPU's plain version) equals the JAX ``shard_map`` main, and its
    gradient norms equal the port's main in one process."""
    from bigdl_tpu_torch.example.longcontext import train

    want, init = _jax_main(tmp_path, ["--seq-parallel", "2"])
    capsys.readouterr()
    train.main(LC_ARGS + ["--device", "cpu", "--init-params", init])
    alone = json.loads(capsys.readouterr().out.splitlines()[-1])
    proc = _launch(tmp_path, "--procs", "2", "-m",
                   "bigdl_tpu_torch.example.longcontext.train", *LC_ARGS,
                   "--seq-parallel", "2", "--flash", "--device", "cpu",
                   "--init-params", init)
    rows, steps = _launched_losses(proc)
    for r in rows:
        np.testing.assert_allclose(r["losses"], want, rtol=1e-5)
        assert r["transport"] == "gloo" and r["world"] == 2
        np.testing.assert_allclose(r["grad_norms"], alone["grad_norms"],
                                   rtol=1e-5)
    np.testing.assert_allclose(steps, want, rtol=1e-5)


def test_longcontext_main_with_experts_trains(tmp_path):
    """``--experts 2`` at ``--seq-parallel 2`` (JAX's test_examples
    config): each rank routes its own tokens; the loss falls and the
    routing stats are reported."""
    proc = _launch(tmp_path, "--procs", "2", "-m",
                   "bigdl_tpu_torch.example.longcontext.train",
                   "--seq-len", "32", "--batch", "2", "--layers", "1",
                   "--embed", "16", "--heads", "2", "--vocab", "32",
                   "--steps", "3", "--experts", "2", "--seq-parallel", "2",
                   "--device", "cpu")
    rows, steps = _launched_losses(proc)
    assert len(steps) == 3 and steps[-1] < steps[0]
    for r in rows:
        assert 0.0 <= r["moe"]["drop_rate"] <= 1.0
        assert 0.5 <= r["moe"]["max_expert_fraction"] <= 1.0
