"""The port's serving walkthrough (bigdl_tpu_torch/example/serving/serve.py),
case for case with tests/test_examples.py::test_serving_example, plus its
``--fleet 2`` form.

The default steps (generate, sampling, beam, ragged, the int8 draft with
speculation, ``GenerationService``, the engine with its ops surface)
return the concurrently-served rows, held as the JAX test holds them:
exactly prompt + n tokens each. The fleet form returns every streamed
row of its second lap and of its drain drill; each equals the lone
``generate`` of the walkthrough's own seeded model, and the drill's
request lands on a live replica. The walkthrough takes ``--device``
(the card by default, raising without one), and the chaos drill's
history row goes to ``BIGDL_BENCH_HISTORY``."""

import json

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.example.serving import serve
from bigdl_tpu_torch.example.serving.serve import main


def test_serving_example():
    """The serving walkthrough runs end to end and returns the
    concurrently-served rows (exactly prompt + n tokens each — the
    service contract)."""
    rows = main(["--tokens", "8", "--vocab", "64", "--device", "cpu"])
    assert len(rows) == 4
    for row, (t0, want_n) in zip(rows, ((5, 8), (9, 4), (12, 8), (7, 4))):
        assert row is not None and row.ndim == 1
        assert row.shape[0] == t0 + want_n


def test_serving_example_fleet():
    """``--fleet 2``: every streamed row equals the lone greedy
    ``generate`` of the walkthrough's model, and the drill's request,
    sent while r0 drains, is served by r1."""
    from bigdl_tpu_torch.models.transformer import TransformerLM

    rows = main(["--tokens", "8", "--vocab", "64", "--device", "cpu",
                 "--fleet", "2"])
    assert len(rows) == 2 * 2 + 1
    model = TransformerLM(64, embed_dim=32, num_heads=4, num_kv_heads=2,
                          num_layers=2, max_len=96, use_rope=True,
                          seed=0, device="cpu")
    model.evaluate()
    for row in rows:
        assert row["meta"]["replica"] in ("r0", "r1")
        assert row["meta"]["route"] in ("affinity", "spilled")
        want = model.generate(np.asarray(row["prompt"]), 8)[0]
        assert row["tokens"] == want[len(row["prompt"]):].tolist()
    assert rows[-1]["meta"]["replica"] == "r1"


def test_serving_example_needs_the_card_unless_asked_for_cpu():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--tokens", "8", "--vocab", "64"])


def test_chaos_history_row_goes_to_the_override(tmp_path, monkeypatch):
    hist = tmp_path / "history.jsonl"
    monkeypatch.setenv("BIGDL_BENCH_HISTORY", str(hist))
    serve._append_chaos_history({"slo": 1, "stall": 1, "crash": 1},
                                torch.device("cpu"))
    (row,) = [json.loads(ln) for ln in hist.read_text().splitlines()]
    assert row["metric"] == "serving_chaos_incidents"
    assert row["value"] == 3 and row["unit"] == "incidents"
    assert row["detail"]["device"] == "cpu"
    assert row["detail"]["incidents"]["by_kind"] == {
        "slo": 1, "stall": 1, "crash": 1}
