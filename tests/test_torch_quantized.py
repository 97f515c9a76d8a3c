"""Int8 inference layers of the port (bigdl_tpu_torch/nn/quantized.py and
the int8 KV forms of nn/attention.py) against the JAX package's.

The JAX package's int8 tests (tests/test_quantized.py) run on the port:
closeness to the float layers, the Quantizer's walk (a clone, the float
model untouched), the LeNet accuracy claims, NHWC and SAME convolutions,
the int8 TransformerLM with its untied head. Beside them the port is held
to the JAX package byte for byte: the codes and scales of every
quantizer (half-way values, all-zero slices and +-amax included), the
Quantizer clone's buffers, and the int8 Linear's and convolution's
outputs on the same inputs. The JAX case that jits the int8 clone
becomes a check that the clone runs under ``torch.inference_mode`` with
no host sync in any Linear.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models.lenet import LeNet5 as JaxLeNet5
from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.nn import quantized as jq
from bigdl_tpu.nn.attention import quantize_kv as jax_quantize_kv
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.nn import quantized as tq
from bigdl_tpu_torch.nn.attention import quantize_kv
from bigdl_tpu_torch.nn.module import tree_leaves
from bigdl_tpu_torch.utils.weights import load_jax_params

LM_CFG = dict(vocab_size=32, embed_dim=16, num_heads=2, num_layers=2,
              max_len=16, tie_embeddings=False)


def _same_bytes(jax_arr, t):
    a = np.asarray(jax_arr)
    b = t.detach().cpu().numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


def _awkward(shape, seed):
    """Random values with the cases rounding can get wrong: a slice that
    is all zero, one holding +-amax and exact half-way codes (x / scale
    = k + 0.5 for amax 127), and a constant slice."""
    r = np.random.RandomState(seed)
    x = (r.randn(*shape) * 3).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.0
    half = np.asarray([127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5],
                      np.float32)
    flat[1] = np.resize(half, shape[-1])
    flat[2] = 0.25
    return flat.reshape(shape)


def _pair_linear(n_in, n_out, seed, with_bias=True, weight=None):
    from bigdl_tpu.utils import random as rnd

    rnd.set_seed(seed)
    kw = {} if weight is None else dict(
        init_weight=weight, init_bias=np.zeros(n_out, np.float32))
    jm = jnn.Linear(n_in, n_out, with_bias=with_bias, **kw)
    tm = tnn.Linear(n_in, n_out, with_bias, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    return jm, tm


def _pair_lm(seed=0, **over):
    from bigdl_tpu.utils import random as rnd

    rnd.set_seed(seed)
    jm = JaxLM(**{**LM_CFG, **over})
    jm.evaluate()
    tm = TransformerLM(**{**LM_CFG, **over}, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    tm.evaluate()
    return jm, tm


def _rel_err(got, want):
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-9)


# ------------------------------------------- byte identity with JAX
def test_quantize_kv_bytes_match_jax():
    x = _awkward((2, 3, 5, 8), 0)
    q, s = quantize_kv(torch.from_numpy(x))
    jq_, js = jax_quantize_kv(jnp.asarray(x))
    _same_bytes(jq_, q)
    _same_bytes(js, s)
    assert s[0, 0, 0, 0].item() == np.float32(1.0) / np.float32(127.0)
    # bf16 blocks quantize in f32, as JAX's astype(float32) does
    xb = torch.from_numpy(x).bfloat16()
    _same_bytes(jax_quantize_kv(jnp.asarray(xb.float().numpy(),
                                            jnp.bfloat16))[0],
                quantize_kv(xb)[0])


@pytest.mark.parametrize("fn,axis", [("quantize_weight", (1,)),
                                     ("quantize_weight_minmax", (1,)),
                                     ("quantize_weight", (1, 2, 3))])
def test_quantize_weight_bytes_match_jax(fn, axis):
    shape = (8, 16) if len(axis) == 1 else (8, 2, 3, 3)
    w = _awkward(shape, 1)
    ours = getattr(tq, fn)(torch.from_numpy(w), axis)
    theirs = getattr(jq, fn)(jnp.asarray(w), axis)
    assert len(ours) == len(theirs)
    for a, b in zip(theirs, ours):
        _same_bytes(a, b)
    if fn == "quantize_weight":
        # the zero-amax rule of weights: scale 1, not 1/127
        assert ours[1].reshape(-1)[0].item() == 1.0


@pytest.mark.parametrize("shape", [(8, 32), (3, 4, 16), (3, 5)])
def test_quantize_activation_bytes_match_jax(shape):
    x = _awkward(shape, 2)
    for arr in (x, np.zeros(shape, np.float32)):
        for a, b in zip(jq.quantize_activation(jnp.asarray(arr)),
                        tq.quantize_activation(torch.from_numpy(arr))):
            _same_bytes(a, b)


def test_quantizer_clone_buffers_match_jax():
    """The Quantizer clone of the untied TransformerLM and of LeNet-5:
    every buffer (codes, scales, zero points, biases) byte-identical to
    the JAX clone's, under the same tree keys; the float parameters left
    in the clone (embeddings, norms) equal the float model's."""
    jm, tm = _pair_lm()
    lj = JaxLeNet5(10)
    lt = LeNet5(10, device="cpu")
    load_jax_params(lt, jax.tree.map(np.asarray, lj.params_dict()))
    for jmod, tmod in ((jm, tm), (lj, lt)):
        jc, tc = jq.Quantizer.quantize(jmod), tq.Quantizer.quantize(tmod)
        jb = tree_leaves(jax.tree.map(np.asarray, jc.buffers_dict()))
        tb = tree_leaves(tc.buffers_dict())
        assert [n for n, _ in jb] == [n for n, _ in tb]
        assert any(n.endswith("w_zp") for n, _ in tb)
        for (name, a), (_, b) in zip(jb, tb):
            _same_bytes(a, b)
        jp = tree_leaves(jax.tree.map(np.asarray, jc.params_dict()))
        tp = tree_leaves(tc.params_dict())
        assert [n for n, _ in jp] == [n for n, _ in tp]
        for (_, a), (_, b) in zip(jp, tp):
            np.testing.assert_array_equal(a, b.detach().numpy())


@pytest.mark.parametrize("scheme,with_bias,rows", [
    ("minmax", True, 8), ("symmetric", True, 8), ("minmax", False, 3),
    ("symmetric", False, 1)])
def test_int8_linear_equals_jax(scheme, with_bias, rows):
    jm, tm = _pair_linear(32, 24, 5, with_bias)
    x = np.random.RandomState(6).randn(rows, 32).astype(np.float32)
    if rows == 1:
        x = x[0]                                    # unbatched input
    jl = jq.Linear.from_float(jm, scheme=scheme)
    tl = tq.Linear.from_float(tm, scheme=scheme)
    want = np.asarray(jl(jnp.asarray(x)))
    got = tl(torch.from_numpy(x)).numpy()
    # the same int32 accumulators and the same f32 epilogue
    np.testing.assert_array_equal(got, want)
    # and the int32 product itself, codes never leaving int8
    x_q, _ = tq.quantize_activation(torch.from_numpy(x).reshape(-1, 32))
    acc = tq.int8_matmul(x_q, tl.weight_q)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(
        acc.numpy(), x_q.numpy().astype(np.int64)
        @ tl.weight_q.numpy().astype(np.int64).T)


@pytest.mark.parametrize("fmt,pad,groups,dil,stride", [
    ("NCHW", 1, 1, (1, 1), 1), ("NHWC", 1, 1, (1, 1), 1),
    ("NCHW", -1, 2, (1, 1), 2), ("NHWC", -1, 1, (2, 2), 1),
    ("NCHW", 0, 4, (2, 1), 1)])
def test_int8_conv_equals_jax(fmt, pad, groups, dil, stride):
    """The int8 convolution against the JAX layer built from the same
    codes: NCHW and NHWC, SAME padding (-1), groups, dilation."""
    r = np.random.RandomState(7)
    w = r.randn(8, 8 // groups, 3, 3).astype(np.float32)
    bias = r.randn(8).astype(np.float32)
    w_q, scale = jq.quantize_weight(jnp.asarray(w), axis=(1, 2, 3))
    args = ((stride, stride), (pad, pad), groups, dil)
    jl = jq.SpatialConvolution(w_q, scale, jnp.asarray(bias), *args,
                               format=fmt)
    tl = tq.SpatialConvolution(torch.from_numpy(np.asarray(w_q)),
                               torch.from_numpy(np.asarray(scale)),
                               torch.from_numpy(bias), *args, format=fmt)
    shape = (2, 8, 9, 9) if fmt == "NCHW" else (2, 9, 9, 8)
    x = r.randn(*shape).astype(np.float32)
    want = np.asarray(jl(jnp.asarray(x)))
    got = tl(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_untied_head_and_bias_free_linear_match_jax():
    """The pieces the int8 tests need: a bias-free Linear (no bias
    parameter, JAX's tree) and the untied head, forward within 1e-5."""
    jm, tm = _pair_lm()
    assert "bias" not in dict(tm.head.named_parameters())
    assert tm.matmul_param_count() == jm.matmul_param_count()
    ids = np.random.RandomState(0).randint(0, 32, (2, 8))
    np.testing.assert_allclose(tm(torch.from_numpy(ids)).detach().numpy(),
                               np.asarray(jm(jnp.asarray(ids))),
                               rtol=1e-5, atol=1e-5)


def test_int8_clone_cache_dtype_comes_from_the_model():
    """The clone's Linears hold codes, not ``weight``: the caches take
    their dtype from the token table (bf16 model, bf16 cache) and their
    device from the layer's tensors."""
    m = TransformerLM(32, 16, 2, 1, 16, device="cpu", dtype=torch.bfloat16)
    q = tq.Quantizer.quantize(m)
    assert not hasattr(q.block0.attn.qkv, "weight")
    k, v = q.init_cache(2, 8)[0]
    assert k.dtype == torch.bfloat16 and k.device.type == "cpu"
    assert [t.dtype for t in q.init_page_pool(3, 4, kv_dtype="int8")[0]] \
        == [torch.int8, torch.int8, torch.float32, torch.float32]
    out = q.generate(torch.arange(4)[None], 3)
    assert out.shape == (1, 7)


# ------------------------------- tests/test_quantized.py on the port
def test_linear_quantized_close():
    rng = np.random.RandomState(0)
    m = tnn.Linear(32, 16, device="cpu")
    x = torch.from_numpy(rng.randn(8, 32).astype(np.float32))
    want = m(x).detach().numpy()
    q = tq.Linear.from_float(m)
    got = q(x).numpy()
    # int8 dynamic quantization: ~1% relative error budget
    assert _rel_err(got, want) < 0.02
    assert q.weight_q.dtype == torch.int8


def test_conv_quantized_close():
    rng = np.random.RandomState(1)
    m = tnn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1, device="cpu")
    x = torch.from_numpy(rng.randn(2, 3, 12, 12).astype(np.float32))
    want = m(x).detach().numpy()
    got = tq.SpatialConvolution.from_float(m)(x).numpy()
    assert _rel_err(got, want) < 0.02


def test_quantizer_walks_and_swaps():
    m = LeNet5(10, device="cpu")
    q = tq.Quantizer.quantize(m)
    assert not [mm for mm in q.modules()
                if type(mm) in (tnn.Linear, tnn.SpatialConvolution)]
    n_q = sum(isinstance(mm, (tq.Linear, tq.SpatialConvolution))
              for mm in q.modules())
    assert n_q == 4  # 2 convs + 2 linears
    # the original model is unchanged
    assert not [mm for mm in m.modules()
                if isinstance(mm, (tq.Linear, tq.SpatialConvolution))]
    assert m.m1.weight.dtype == torch.float32


def test_quantized_model_accuracy_preserved():
    """Train a tiny model, quantize, and the predictions agree."""
    from bigdl_tpu_torch.optim import SGD, make_train_step

    rng = np.random.RandomState(0)
    x0 = rng.randn(64, 28, 28).astype(np.float32) - 1.0
    x1 = rng.randn(64, 28, 28).astype(np.float32) + 1.0
    x = torch.from_numpy(np.concatenate([x0, x1]))
    y = torch.from_numpy(np.array([1] * 64 + [2] * 64, np.float32))
    m = LeNet5(2, device="cpu")
    ts = make_train_step(m, tnn.ClassNLLCriterion(), SGD(learning_rate=0.1))
    params, buffers = m.params_dict(), m.buffers_dict()
    slots = ts.init_slots(params)
    for _ in range(40):
        loss, params, buffers, slots = ts.step(params, buffers, slots, x, y,
                                               ts.current_lrs(), None)
    m.load_params_dict(params)
    m.evaluate()
    with torch.inference_mode():
        float_pred = m(x).argmax(-1)
        q = tq.Quantizer.quantize(m)
        q.evaluate()
        q_pred = q(x).argmax(-1)
    agreement = (float_pred == q_pred).float().mean().item()
    assert agreement >= 0.99, agreement


def test_quantized_size_reduction():
    m = tnn.Linear(256, 256, device="cpu")
    q = tq.Linear.from_float(m)
    float_bytes = m.weight.nbytes
    q_bytes = q.weight_q.nbytes + q.w_scale.nbytes
    assert q_bytes * 3.5 < float_bytes  # ~4x smaller


def test_quantized_runs_in_inference_mode_without_host_sync(monkeypatch):
    """The JAX case jits the int8 clone; here the clone runs under
    ``torch.inference_mode`` and no Linear reads a device value back to
    the host (every conversion of a tensor to a Python value raises
    during the forward)."""
    m = tq.Quantizer.quantize(TransformerLM(32, 16, 2, 2, 16,
                                            tie_embeddings=False,
                                            device="cpu"))
    m.evaluate()
    ids = torch.randint(0, 32, (2, 8))

    def sync(*_a, **_k):
        raise AssertionError("host sync inside the int8 forward")

    for name in ("item", "tolist", "numpy", "__bool__", "__int__",
                 "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, sync)
    with torch.inference_mode():
        out = m(ids)
    monkeypatch.undo()
    assert out.shape == (2, 8, 32)
    assert torch.isfinite(out).all()


def test_minmax_scheme_closer_than_symmetric_on_shifted_weights():
    """The asymmetric min/max scheme wins on a shifted weight
    distribution."""
    rng = np.random.RandomState(0)
    w = (rng.rand(16, 32).astype(np.float32) * 0.5 + 1.0)  # all-positive
    jm, m = _pair_linear(32, 16, 0, weight=w)
    x = torch.from_numpy(rng.randn(8, 32).astype(np.float32))
    ref = m(x).detach().numpy()
    sym = tq.Linear.from_float(m, scheme="symmetric")(x).numpy()
    mm = tq.Linear.from_float(m, scheme="minmax")(x).numpy()
    err_sym = np.abs(sym - ref).max()
    err_mm = np.abs(mm - ref).max()
    assert err_mm < err_sym, (err_mm, err_sym)
    assert err_mm < 0.05 * np.abs(ref).max()


def test_end_to_end_accuracy_drop_on_lenet():
    """Train LeNet on an easy synthetic digit task, quantize the whole
    model, compare Top1: the drop stays within 0.02."""
    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.optim import (Adam, Evaluator, Optimizer,
                                       Top1Accuracy, Trigger)

    rng = np.random.RandomState(1)

    def make(n):
        out = []
        for i in range(n):
            c = i % 4
            img = rng.rand(28, 28).astype(np.float32) * 0.2
            oy, ox = (c // 2) * 14, (c % 2) * 14
            img[oy + 3:oy + 11, ox + 3:ox + 11] += 0.8
            out.append(Sample(img, np.asarray([c + 1], np.float32)))
        return out

    train, test = make(128), make(64)
    model = LeNet5(10, seed=7, device="cpu")
    opt = Optimizer(model=model, dataset=train,
                    criterion=tnn.ClassNLLCriterion(), batch_size=32,
                    end_when=Trigger.max_epoch(4))
    opt.set_optim_method(Adam(learning_rate=2e-3))
    trained = opt.optimize()

    def top1(m):
        res = Evaluator(m).test(test, [Top1Accuracy()], batch_size=32)
        return res[0][1].result()[0]

    acc_f = top1(trained)
    assert acc_f > 0.9, acc_f
    acc_q = top1(tq.Quantizer.quantize(trained))
    assert acc_f - acc_q <= 0.02, (acc_f, acc_q)


def test_quantized_conv_nhwc_matches_nchw():
    # the float layer's NHWC format carries into the int8 swap
    m = tnn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1, format="NHWC",
                               device="cpu")
    q = tq.SpatialConvolution.from_float(m)
    assert q.format == "NHWC"
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 8, 8, 3)
                         .astype(np.float32))
    out = q(x)
    assert out.shape == (2, 8, 8, 8)
    m_nchw = tnn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1, device="cpu")
    with torch.no_grad():
        m_nchw.weight.copy_(m.weight)
        m_nchw.bias.copy_(m.bias)
    ref = tq.SpatialConvolution.from_float(m_nchw)(x.permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.numpy(), ref.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_quantized_conv_same_padding():
    # pad = -1 means SAME; it must not become a crop by one
    m = tnn.SpatialConvolution(3, 4, 3, 3, 1, 1, -1, -1, device="cpu")
    q = tq.SpatialConvolution.from_float(m)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 8, 8)
                         .astype(np.float32))
    assert q(x).shape == m(x).shape == (2, 4, 8, 8)


def test_quantized_transformer_lm_serves():
    """Post-training int8 of the flagship LM: every Linear swaps (the
    untied head too), forward logits stay close, and KV-cache generation
    runs end to end on the clone."""
    jm, m = _pair_lm()
    q = tq.Quantizer.quantize(m)
    swapped = [sub for sub in q.modules() if isinstance(sub, tq.Linear)]
    assert len(swapped) >= 9  # qkv/out_proj/fc1/fc2 per block + head
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 32, (2, 8)))
    with torch.inference_mode():
        want = m(ids).numpy()
        got = q(ids).numpy()
        np.testing.assert_allclose(got, want, rtol=0.5, atol=0.5)
        out = q.generate(ids[:, :3], 4)
        assert out.shape == (2, 7)
        assert torch.isfinite(q(out)).all()
        # and the clone's logits are the JAX clone's
        jclone = jq.Quantizer.quantize(jm)
        np.testing.assert_allclose(
            got, np.asarray(jclone.forward(jnp.asarray(ids.numpy()))),
            rtol=1e-5, atol=1e-5)


def test_quantized_lm_greedy_tokens_match_float():
    """Weight and activation int8 decode: greedy generation from the
    quantized GQA + RoPE LM reproduces the float model's tokens on a
    confident toy model, and the JAX clone's tokens exactly."""
    from bigdl_tpu.utils import random as rnd

    cfg = dict(vocab_size=64, embed_dim=32, num_heads=4, num_kv_heads=2,
               num_layers=2, max_len=24, use_rope=True)
    rnd.set_seed(0)
    jm = JaxLM(**cfg)
    jm.evaluate()
    m = TransformerLM(**cfg, device="cpu")
    load_jax_params(m, jax.tree.map(np.asarray, jm.params_dict()))
    m.evaluate()
    prompt = np.random.RandomState(0).randint(0, 64, (2, 8))
    want = m.generate(prompt, 8).numpy()
    q = tq.Quantizer.quantize(m)
    q.evaluate()
    got = q.generate(prompt, 8).numpy()
    assert (got == want).mean() >= 0.95
    jq_m = jq.Quantizer.quantize(jm)
    jq_m.evaluate()
    np.testing.assert_array_equal(
        got, np.asarray(jq_m.generate(jnp.asarray(prompt), 8)))
