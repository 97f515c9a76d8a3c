"""The port's perf CLI and decode perf (bigdl_tpu_torch/models/perf.py:
``main``, ``run_decode_perf``, ``_append_rows_to_history``, and
``run_perf``'s ``profile_dir``) against the JAX package's
(bigdl_tpu/models/perf.py). On the CPU: the CLI's argument errors are
the JAX CLI's, word for word; a decode row carries exactly the JAX row's
keys under the same (CPU-clamped) arguments; the incompatible draft
choices raise the JAX errors; the history rows go where the JAX contract
puts them (``BIGDL_BENCH_HISTORY``, else the working directory), never
into the repository's ``bench_history.jsonl``; a profiled run leaves a
Chrome trace that parses as JSON.
"""

import glob
import hashlib
import json
import os

import jax.numpy as jnp
import pytest
import torch

from bigdl_tpu.models import perf as jperf
from bigdl_tpu_torch.models import perf as tperf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HISTORY = os.path.join(REPO, "bench_history.jsonl")
QUIET = dict(log=lambda *a, **k: None)


def _digest(path):
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture
def history(tmp_path, monkeypatch):
    """Rows go to a file under ``tmp_path``; afterwards the repository's
    bench history must be byte for byte what it was."""
    before = _digest(HISTORY)
    path = tmp_path / "history.jsonl"
    monkeypatch.setenv("BIGDL_BENCH_HISTORY", str(path))
    yield path
    assert _digest(HISTORY) == before


@pytest.mark.parametrize("argv", [
    ["--decode", "--model", "vgg16"],
    ["--decode", "--master-f32"],
    ["--decode", "--format", "NHWC"],
    ["--decode", "--new-tokens", "0"],
    ["--decode", "--prompt-len", "0"],
    ["--dtype", "float16"],
], ids=["decode_model", "decode_master_f32", "decode_format",
        "decode_new_tokens", "decode_prompt_len", "dtype_choice"])
def test_cli_errors_are_the_jax_errors(argv, capsys, monkeypatch):
    import bigdl_tpu.utils.compile_cache as cc

    # the JAX CLI first points XLA at its compile cache: not under test
    monkeypatch.setattr(cc, "enable_persistent_cache", lambda: None)
    with pytest.raises(SystemExit) as jexit:
        jperf.main(argv)
    jerr = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as texit:
        tperf.main(argv + ["--device", "cpu"])
    terr = capsys.readouterr().err.strip().splitlines()[-1]
    assert texit.value.code == jexit.value.code == 2
    assert terr == jerr


def test_cli_without_a_device_runs_on_the_card(monkeypatch):
    """The default ``--device cuda`` raises where there is no card; it
    never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tperf.main(["--model", "lenet5", "--iterations", "1"])


DECODE_CASES = {
    "mha": dict(),
    "gqa": dict(num_kv_heads=2),
    "int8": dict(int8=True),
    "speculative": dict(speculative=1),
    "int8_draft": dict(spec_int8_draft=True),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_row_has_the_jax_keys(case):
    kw = DECODE_CASES[case]
    size = dict(batch_size=2, prompt_len=8, new_tokens=6)
    want = jperf.run_decode_perf(dtype=jnp.float32, **size, **kw, **QUIET)
    got = tperf.run_decode_perf(dtype=torch.float32, **size, **kw,
                                device="cpu", **QUIET)
    assert set(got) == set(want)
    for key in ("model", "int8", "batch_size", "prompt_len", "new_tokens",
                "num_kv_heads", "speculative_draft_layers", "spec_gamma"):
        assert got.get(key) == want.get(key), key
    for key in ("decode_tokens_per_sec", "prefill_tokens_per_sec",
                "ms_per_token", "time_s", "spec_tokens_per_sec",
                "spec_vs_plain"):
        if key in want:
            assert got[key] > 0, key
    if "spec_accept_rate" in want:
        assert 0.0 <= got["spec_accept_rate"] <= 1.0
        assert got["spec_rounds"] >= 1


@pytest.mark.parametrize("kw", [dict(speculative=1, spec_int8_draft=True),
                                dict(int8=True, spec_int8_draft=True),
                                dict(int8=True, speculative=1)],
                         ids=["two_drafts", "int8_int8_draft",
                              "int8_speculative"])
def test_incompatible_draft_choices_raise_the_jax_errors(kw):
    with pytest.raises(ValueError) as jerr:
        jperf.run_decode_perf(batch_size=2, **kw, **QUIET)
    with pytest.raises(ValueError) as terr:
        tperf.run_decode_perf(batch_size=2, **kw, device="cpu", **QUIET)
    assert str(terr.value) == str(jerr.value)


def test_cli_input_pipeline_and_decode_rows_go_to_the_history(history,
                                                              capsys):
    tperf.main(["--input-pipeline", "--records", "16", "--batch-size", "8",
                "--device", "cpu"])
    rows = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rows and all(r["mode"] == "input_pipeline" and r["records"] == 16
                        and r["records_per_sec"] > 0 for r in rows)
    tperf.main(["--decode", "--batch-size", "2", "--new-tokens", "4",
                "--device", "cpu"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["device"] == "cpu" and row["new_tokens"] == 4
    written = [json.loads(line) for line in history.read_text().splitlines()]
    assert len(written) == len(rows) + 1
    assert all("ts" in r for r in written)
    assert written[-1]["decode_tokens_per_sec"] == \
        row["decode_tokens_per_sec"]


def test_history_defaults_to_the_working_directory(tmp_path, monkeypatch):
    before = _digest(HISTORY)
    monkeypatch.delenv("BIGDL_BENCH_HISTORY", raising=False)
    monkeypatch.chdir(tmp_path)
    tperf._append_rows_to_history([{"a": 1}])
    (row,) = [json.loads(line) for line in
              (tmp_path / "bench_history.jsonl").read_text().splitlines()]
    assert row["a"] == 1 and row["ts"] > 0
    assert _digest(HISTORY) == before


def test_profile_dir_writes_a_chrome_trace(tmp_path, history, capsys):
    trace_dir = tmp_path / "trace"
    tperf.main(["--model", "lenet5", "--batch-size", "4", "--iterations",
                "2", "--profile", str(trace_dir), "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["model"] == "lenet5" and summary["records_per_sec"] > 0
    (path,) = glob.glob(str(trace_dir / "*.json"))
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
    # the training summary is printed, not appended, as in JAX
    assert not history.exists()
