"""The API gaps of ported modules (ROADMAP.md Queue 1 item 9.2) against the
JAX package on the same weights (``load_jax_params``) and inputs, at
rtol 1e-5 / atol 1e-6 in f32: ``LayerNorm(affine=)``,
``MultiHeadAttention(with_bias=)``, ``dot_product_attention(mask=)``,
``Linear`` / ``SpatialConvolution(init_weight=, init_bias=)`` and their
``reset()``, ``View.set_num_input_dims``, the ``Module`` API
(``set_training``, ``reset``, ``is_container``, the host timings,
``quantize``), ``MAE`` / ``BinaryAccuracy`` / ``AUC``,
``FuncTransformer`` / ``Normalizer``, ``device_prefetch``, and the
``TransformerLM`` decode flags: ``generate(host_loop=, bucket_tokens=)``,
``generate_ragged(bucket_tokens=)``, ``decode_scan`` (greedy tokens equal
to JAX's) and ``analytic_bytes`` (equal exactly).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import transformer as jtr
from bigdl_tpu.dataset.sample import Sample as JaxSample
from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.nn.module import pure_apply
from bigdl_tpu.optim import validation as jval
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.dataset import transformer as ttr
from bigdl_tpu_torch.dataset.minibatch import MiniBatch
from bigdl_tpu_torch.dataset.prefetch import device_prefetch
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.nn.module import tree_leaves
from bigdl_tpu_torch.nn.quantized import Quantizer
from bigdl_tpu_torch.optim import validation as tval
from bigdl_tpu_torch.utils.weights import load_jax_params

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = dict(device="cpu")
LM = dict(vocab_size=32, embed_dim=16, num_heads=4, num_kv_heads=2,
          num_layers=2, max_len=48, use_rope=True)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _carry(jm, tm):
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    jm.evaluate()
    tm.evaluate()


def _check_layer(jm, tm, x):
    """Forward, input gradient and parameter gradients for one random
    cotangent, the JAX layer through ``jax.vjp`` of its pure form."""
    fn = pure_apply(jm)
    bufs = jm.buffers_dict()
    j_out, vjp = jax.vjp(lambda p, xx: fn(p, bufs, xx, training=False)[0],
                         jm.params_dict(), jnp.asarray(x))
    g = _rand(*j_out.shape, seed=9)
    j_gp, j_gx = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    params = [p for _, p in tree_leaves(tm.params_dict())]
    out = tm(xt)
    grads = torch.autograd.grad(out, [xt] + params, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(j_gx), **TOL)
    j_gp = [np.asarray(a) for a in jax.tree.leaves(j_gp)]
    assert len(j_gp) == len(params)
    for ours, theirs in zip(grads[1:], j_gp):
        np.testing.assert_allclose(ours.numpy(), theirs, **TOL)


# ------------------------------------------------------------------ nn
def test_layer_norm_without_affine_matches_jax():
    jm, tm = jnn.LayerNorm(6, affine=False), tnn.LayerNorm(6, affine=False,
                                                           **CPU)
    assert not list(tm.parameters()) and tm.params_dict() == {}
    _carry(jm, tm)
    _check_layer(jm, tm, _rand(3, 4, 6) * 3 + 1)


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_without_bias_matches_jax(causal):
    jm = jnn.MultiHeadAttention(8, 2, with_bias=False, causal=causal,
                                num_kv_heads=1)
    tm = tnn.MultiHeadAttention(8, 2, causal=causal, num_kv_heads=1,
                                with_bias=False, **CPU)
    assert {n for n, _ in tm.named_parameters()} == {"qkv.weight",
                                                      "out_proj.weight"}
    _carry(jm, tm)
    _check_layer(jm, tm, _rand(2, 5, 8, seed=1))


@pytest.mark.parametrize("causal", [False, True])
def test_dot_product_attention_mask_matches_jax(causal):
    q, k, v = (_rand(2, 3, 6, 4, seed=s) for s in (1, 2, 3))
    mask = np.random.RandomState(4).rand(2, 1, 6, 6) > 0.4
    mask[0, 0, 2] = False               # a row that keeps no key
    ref = jnn.attention.dot_product_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, mask=jnp.asarray(mask))
    out = tnn.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal,
                                    mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert (out[0, :, 2] == 0).all()


@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_init_weight_and_bias_and_reset(kind):
    if kind == "linear":
        w, b, x = _rand(3, 5, seed=1), _rand(3, seed=2), _rand(4, 5, seed=3)
        jm = jnn.Linear(5, 3, init_weight=w, init_bias=b)
        tm = tnn.Linear(5, 3, init_weight=w, init_bias=b, **CPU)
        fan_in, fan_out = 5, 3
    else:
        w, b = _rand(4, 2, 3, 3, seed=1), _rand(4, seed=2)
        x = _rand(2, 2, 6, 5, seed=3)
        jm = jnn.SpatialConvolution(2, 4, 3, 3, 1, 1, 1, 1, init_weight=w,
                                    init_bias=b)
        tm = tnn.SpatialConvolution(2, 4, 3, 3, 1, 1, 1, 1, init_weight=w,
                                    init_bias=b, **CPU)
        fan_in, fan_out = 2 * 9, 4 * 9
    np.testing.assert_array_equal(tm.weight.detach().numpy(), w)
    np.testing.assert_array_equal(tm.bias.detach().numpy(), b)
    jm.evaluate()
    tm.evaluate()
    _check_layer(jm, tm, x)
    with pytest.raises(ValueError, match="init_weight"):
        (tnn.Linear(5, 3, init_weight=w.T, **CPU) if kind == "linear"
         else tnn.SpatialConvolution(2, 4, 3, 2, init_weight=w, **CPU))
    # reset: a new Xavier draw in place (the same Parameter), a zero bias
    weight = tm.weight
    tm.reset()
    jm.reset()
    assert tm.weight is weight
    limit = np.sqrt(6.0 / (fan_in + fan_out))
    new = tm.weight.detach().numpy()
    assert not np.allclose(new, w) and np.abs(new).max() <= limit
    assert (tm.bias == 0).all() and (np.asarray(jm.bias) == 0).all()
    assert new.std() > limit / 4


def test_view_records_num_input_dims():
    jm, tm = jnn.View(2, 6), tnn.View(2, 6)
    assert tm.set_num_input_dims(3) is tm and tm.num_input_dims == 3
    jm.set_num_input_dims(3)
    x = _rand(4, 3, 4)
    np.testing.assert_array_equal(tm(torch.from_numpy(x)).numpy(),
                                  np.asarray(jm.forward(jnp.asarray(x))))


def _models():
    jm = jnn.Sequential(jnn.Linear(4, 6), jnn.Tanh(), jnn.Linear(6, 2))
    tm = tnn.Sequential(tnn.Linear(4, 6, **CPU), tnn.Tanh(),
                        tnn.Linear(6, 2, **CPU))
    _carry(jm, tm)
    return jm, tm


def test_module_modes_containers_and_reset():
    jm, tm = _models()
    assert tm.is_container() == jm.is_container() is True
    assert tm[0].is_container() == jm[0].is_container() is False
    assert tm.set_training(True) is tm
    assert all(m.is_training() for m in tm.modules())
    tm.set_training(False)
    assert not any(m.is_training() for m in tm.modules())
    before = [p.detach().clone() for p in tm.parameters()]
    tm.reset()
    after = list(tm.parameters())
    for b, a, name in zip(before, after, ("w0", "b0", "w1", "b1")):
        if name.startswith("w"):
            assert not torch.equal(a, b)
        else:
            assert (a == 0).all()


def test_module_times_match_the_jax_structure():
    jm, tm = _models()
    x = _rand(3, 4)
    g = _rand(3, 2, seed=1)
    for _ in range(2):
        jm.forward(jnp.asarray(x))
        jm.backward(jnp.asarray(x), jnp.asarray(g))
        tm(torch.from_numpy(x))
        tm.backward(torch.from_numpy(x), torch.from_numpy(g))
    jt, tt = jm.get_times(), tm.get_times()
    assert [type(m).__name__ for m, _, _ in tt] == \
        [type(m).__name__ for m, _, _ in jt]
    assert tt[0][0] is tm and all(f > 0 for _, f, _ in tt)
    assert tt[0][2] > 0 and all(b == 0 for _, _, b in tt[1:])
    grouped = tm.get_times_group_by_module_type()
    assert set(grouped) == set(jm.get_times_group_by_module_type()) \
        == {"Sequential", "Linear", "Tanh"}
    assert grouped["Linear"][0] == pytest.approx(tt[1][1] + tt[3][1])
    tm.reset_times()
    assert all(f == b == 0 for _, f, b in tm.get_times())


def test_module_quantize_is_the_quantizer_clone():
    _, tm = _models()
    x = torch.from_numpy(_rand(5, 4))
    from bigdl_tpu_torch.nn import quantized

    q = tm.quantize()
    assert q is not tm and isinstance(q[0], quantized.Linear)
    assert isinstance(tm[0], tnn.Linear)
    torch.testing.assert_close(q(x), Quantizer.quantize(tm)(x), rtol=0,
                               atol=0)


# -------------------------------------------------------------- optim
def test_mae_binary_accuracy_and_auc_match_jax():
    rs = np.random.RandomState(3)
    batches = [(rs.rand(16, 1).astype(np.float32),
                (rs.rand(16, 1) > 0.5).astype(np.float32))
               for _ in range(3)]
    # ties across the histogram's bins and within one
    batches.append((np.array([[0.25], [0.25], [1.0], [0.0]], np.float32),
                    np.array([[1], [0], [1], [0]], np.float32)))
    for jmeth, tmeth in ((jval.MAE(), tval.MAE()),
                         (jval.BinaryAccuracy(0.4),
                          tval.BinaryAccuracy(0.4)),
                         (jval.AUC(50), tval.AUC(50))):
        jres = tres = None
        for out, tgt in batches:
            j = jmeth(jnp.asarray(out), jnp.asarray(tgt))
            t = tmeth(torch.from_numpy(out), torch.from_numpy(tgt))
            assert t.result() == j.result()
            jres = j if jres is None else jres + j
            tres = t if tres is None else tres + t
        assert tres.result() == jres.result()
        assert tmeth.name() == jmeth.name()
    with pytest.raises(ValueError, match="non-finite"):
        tval.AUC()(torch.tensor([0.5, float("nan")]), torch.tensor([1, 0]))


# ------------------------------------------------------------ dataset
def test_func_transformer_and_normalizer_match_jax():
    rs = np.random.RandomState(5)
    feats = [rs.randint(0, 255, (3, 4)).astype(np.uint8) for _ in range(4)]
    labels = [np.array([i + 1.0], np.float32) for i in range(4)]
    js = [JaxSample(f, l) for f, l in zip(feats, labels)]
    ts = [Sample(f, l) for f, l in zip(feats, labels)]
    jchain = jtr.FuncTransformer(
        lambda s: JaxSample(np.asarray(s.features[0]) * 2,
                            np.asarray(s.labels[0]))) \
        >> jtr.Normalizer(100.0, 50.0)
    tchain = ttr.FuncTransformer(
        lambda s: Sample(s.features[0] * 2, s.labels[0])) \
        >> ttr.Normalizer(100.0, 50.0)
    for j, t in zip(jchain(iter(js)), tchain(iter(ts))):
        np.testing.assert_array_equal(t.features[0],
                                      np.asarray(j.features[0]))
        assert t.features[0].dtype == np.float32
        np.testing.assert_array_equal(t.labels[0], np.asarray(j.labels[0]))


def test_device_prefetch_stages_batches_on_the_device():
    rs = np.random.RandomState(6)
    batches = [MiniBatch(rs.rand(4, 3).astype(np.float32),
                         rs.rand(4, 1).astype(np.float32)),
               {"x": rs.rand(2, 2), "y": [rs.rand(2), rs.rand(3)]}]
    out = list(device_prefetch(iter(batches), device="cpu"))
    assert isinstance(out[0], MiniBatch)
    np.testing.assert_array_equal(out[0].inputs[0].numpy(),
                                  batches[0].inputs[0])
    np.testing.assert_array_equal(out[0].targets[0].numpy(),
                                  batches[0].targets[0])
    assert torch.is_tensor(out[1]["x"]) and torch.is_tensor(out[1]["y"][1])
    np.testing.assert_array_equal(out[1]["y"][1].numpy(),
                                  batches[1]["y"][1])
    # sharding= places each rank's contiguous shard of the batch (the JAX
    # placement over a mesh's data axis): a 2-rank world over gloo
    import torch_jobs_parallel as jobs
    from torch_world import World

    batch = np.arange(24, dtype=np.float32).reshape(6, 4)
    got = World.shared(2).run(jobs.prefetch_shard, batch)
    for r, (mb_rows, rows) in enumerate(got):
        np.testing.assert_array_equal(mb_rows, batch[3 * r:3 * r + 3])
        np.testing.assert_array_equal(rows, batch[3 * r:3 * r + 3])


# ------------------------------------------------ TransformerLM flags
@pytest.fixture(scope="module")
def lms():
    from bigdl_tpu.utils import random as rnd

    rnd.set_seed(23)
    jm = JaxLM(**LM)
    tm = TransformerLM(**LM, device="cpu")
    _carry(jm, tm)
    return jm, tm


@pytest.mark.parametrize("host_loop,bucket", [(False, None), (False, 4),
                                              (True, None), (True, 4)])
@pytest.mark.parametrize("max_len", [None, 40])
def test_generate_flags_keep_the_jax_tokens(lms, host_loop, bucket,
                                            max_len):
    jm, tm = lms
    prompt = np.random.RandomState(7).randint(0, 32, (3, 6))
    want = np.asarray(jm.generate(jnp.asarray(prompt), 7, max_len=max_len,
                                  host_loop=host_loop, bucket_tokens=bucket))
    got = tm.generate(prompt, 7, max_len=max_len, host_loop=host_loop,
                      bucket_tokens=bucket)
    np.testing.assert_array_equal(got.numpy(), want)
    # the cut-back tail: return_logits keeps max_new_tokens rows
    ids, seen = tm.generate(prompt, 7, max_len=max_len, bucket_tokens=bucket,
                            host_loop=host_loop, return_logits=True)
    assert seen.shape == (3, 7, 32)
    np.testing.assert_array_equal(seen.argmax(-1).numpy(), want[:, 6:])


def test_on_token_needs_the_host_loop_as_in_jax(lms):
    jm, tm = lms
    prompt = np.arange(1, 6)[None]
    with pytest.raises(ValueError) as jerr:
        jm.generate(jnp.asarray(prompt), 3, on_token=lambda t: None)
    with pytest.raises(ValueError) as terr:
        tm.generate(prompt, 3, on_token=lambda t: None)
    assert str(terr.value) == str(jerr.value)
    steps = []
    tm.generate(prompt, 3, host_loop=True, on_token=steps.append)
    assert len(steps) == 3 and steps[0].shape == (1,)


@pytest.mark.parametrize("bucket", [None, 4, 16])
def test_generate_ragged_bucket_tokens_keep_the_jax_tokens(lms, bucket):
    jm, tm = lms
    rs = np.random.RandomState(8)
    prompt = rs.randint(0, 32, (3, 7))
    lengths = np.array([7, 3, 5])
    want = np.asarray(jm.generate_ragged(jnp.asarray(prompt),
                                         jnp.asarray(lengths), 6,
                                         bucket_tokens=bucket))
    got = tm.generate_ragged(prompt, lengths, 6, bucket_tokens=bucket)
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_scan_matches_jax(lms):
    jm, tm = lms
    prompt = np.random.RandomState(9).randint(0, 32, (2, 5))
    jc = jm.init_cache(2, 16)
    j_logits, jc = jm.prefill(jnp.asarray(prompt), jc)
    want = np.asarray(jm.decode_scan(j_logits, 5, jc, jax.random.PRNGKey(0),
                                     1.0, 8))
    with torch.no_grad():
        t_logits, tc = tm.prefill(torch.from_numpy(prompt), tm.init_cache(2,
                                                                          16))
    got = tm.decode_scan(t_logits, 5, tc, None, 1.0, 8)
    assert got.shape == (8, 2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tokens,context,dtype_bytes", [
    (1, 0, 4), (8, 40, 2), (3, 17, 1)])
def test_analytic_bytes_equal_jax(lms, tokens, context, dtype_bytes):
    jm, tm = lms
    assert tm.analytic_bytes(tokens, context, dtype_bytes) == \
        jm.analytic_bytes(tokens, context, dtype_bytes)
    assert tm.num_kv_heads == jm.num_kv_heads == 2
