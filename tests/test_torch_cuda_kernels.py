"""The port's CUDA kernels on the card, against their plain PyTorch
versions. Every test here needs a CUDA card and skips without one; the
file imports no JAX, so on a GPU machine without it run

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Tolerances: f32 at rtol 2e-4 / atol 2e-5 (sums in another order). bf16
as ``chip_smoke.py``: each element within 2e-2 times the sum of its own
|ref| and the RMS of its reference row (outputs round to 8 mantissa bits
and the kernel rounds P to bf16 for the tensor cores; the row term scales
the allowance to what a row holds, so a dropped kv tile fails where a
fixed atol would hide it). Dead rows are exact zeros with lse -1e30 in
both dtypes; lse is f32 math on both sides.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.ops import flash_attention as fa

F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_RTOL = 2e-2

# (B, H, H_kv, t, tk, d, causal, dtype)
FLASH_CASES = [
    (2, 4, 4, 128, 128, 64, True, torch.float32),
    (2, 4, 1, 100, 100, 32, True, torch.float32),    # ragged tails, GQA 4
    (2, 4, 2, 64, 200, 72, False, torch.float32),    # d not a multiple of 16
    (2, 8, 2, 256, 512, 64, True, torch.bfloat16),   # t < tk
    (2, 8, 2, 512, 256, 64, True, torch.bfloat16),   # t > tk: dead rows
    (1, 2, 2, 77, 77, 128, False, torch.bfloat16),   # largest head dim
    (4, 8, 2, 2048, 2048, 64, True, torch.bfloat16),  # the flagship shape
    (2, 8, 2, 129, 129, 64, True, torch.bfloat16),   # a q tile plus one row
    (2, 8, 2, 1, 300, 64, True, torch.bfloat16),     # one query row
    (2, 8, 2, 100, 65, 64, False, torch.bfloat16),   # kv tile + 1, t != tk
    (2, 8, 2, 300, 100, 64, True, torch.bfloat16),   # GQA 4, dead rows
    (2, 4, 2, 200, 200, 32, True, torch.bfloat16),   # d = 32
    (2, 4, 2, 96, 160, 72, False, torch.bfloat16),   # d = 72, padded to 128
    (2, 4, 2, 300, 300, 128, True, torch.bfloat16),  # d = 128, causal
    (2, 4, 1, 100, 100, 77, True, torch.bfloat16),   # odd d: no TMA
    (2, 4, 2, 70, 90, 20, False, torch.bfloat16),    # d = 20, padded to 64
]


def _row_rms_excess(out, ref, rtol):
    """Largest |out - ref| / (rtol * (|ref| + RMS of ref's row)): below 1
    passes; a row of zeros allows no error at all."""
    o, r = out.float(), ref.float()
    allow = rtol * (r.abs() + r.pow(2).mean(-1, keepdim=True).sqrt())
    err = (o - r).abs()
    return torch.where(err == 0, torch.zeros_like(err), err / allow).max()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 plain version
    return torch.device("cuda")


@pytest.mark.parametrize("b,h,h_kv,t,tk,d,causal,dtype", FLASH_CASES)
def test_flash_kernel_matches_plain_version(card, b, h, h_kv, t, tk, d,
                                            causal, dtype):
    g = torch.Generator(device=card).manual_seed(t + tk + d)
    q, k, v = (torch.randn(s, device=card, generator=g).to(dtype)
               for s in ((b, h, t, d), (b, h_kv, tk, d), (b, h_kv, tk, d)))
    before = fa.launches
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1     # a CUDA tensor launches the kernel
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal)
    if dtype == torch.float32:
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   ref_out.float().cpu().numpy(), **F32_TOL)
    else:
        excess = _row_rms_excess(out, ref_out, BF16_RTOL).item()
        assert excess <= 1.0, excess
    np.testing.assert_allclose(lse.cpu().numpy(), ref_lse.cpu().numpy(),
                               **F32_TOL)
    dead = ref_lse <= fa.NEG_INF / 2
    assert torch.equal(lse <= fa.NEG_INF / 2, dead)
    assert (out[dead] == 0).all()


def test_flash_kernel_reads_strided_qkv_in_place(card):
    """q, k, v as the fused projection's split views (non-contiguous
    heads, contiguous last dim) give the same result as contiguous
    copies; a non-contiguous last dim raises."""
    b, t, h, h_kv, d = 2, 96, 8, 2, 64
    qkv = torch.randn(b, t, (h + 2 * h_kv) * d, device=card,
                      dtype=torch.bfloat16)
    q = qkv[..., :h * d].reshape(b, t, h, d).transpose(1, 2)
    k = qkv[..., h * d:(h + h_kv) * d].reshape(b, t, h_kv, d).transpose(1, 2)
    v = qkv[..., (h + h_kv) * d:].reshape(b, t, h_kv, d).transpose(1, 2)
    strided = fa.flash_attention(q, k, v, causal=True)
    packed = fa.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=True)
    assert torch.equal(strided, packed)
    with pytest.raises(ValueError, match="contiguous last dim"):
        fa.flash_attention(q.transpose(2, 3), k.transpose(2, 3),
                           v.transpose(2, 3))


def test_forward_launches_flash_once_per_layer(card):
    from bigdl_tpu_torch.models import TransformerLM

    model = TransformerLM(256, 128, 2, 3, 256, num_kv_heads=1, use_rope=True,
                          use_flash=True, device=card, dtype=torch.bfloat16)
    ids = torch.randint(0, 256, (2, 130), device=card)
    with torch.inference_mode():
        before = fa.launches
        logits = model(ids)
        assert fa.launches == before + model.num_layers
        for blk in model.blocks():
            blk.attn.use_flash = False
        dense = model(ids)
    assert fa.launches == before + model.num_layers
    rel = ((logits.float() - dense.float()).abs().max()
           / dense.float().abs().max()).item()
    assert rel <= 5e-2, rel


@pytest.mark.parametrize("scale", [-0.3, 0.0, 0.7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_a_scale_of_any_sign(card, scale, dtype):
    g = torch.Generator(device=card).manual_seed(5)
    q, k, v = (torch.randn(s, device=card, generator=g).to(dtype)
               for s in ((2, 4, 150, 64), (2, 2, 150, 64), (2, 2, 150, 64)))
    out, lse = fa.flash_attention_with_lse(q, k, v, True, scale)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, True, scale)
    if dtype == torch.float32:
        np.testing.assert_allclose(out.cpu().numpy(), ref_out.cpu().numpy(),
                                   **F32_TOL)
    else:
        assert _row_rms_excess(out, ref_out, BF16_RTOL).item() <= 1.0
    np.testing.assert_allclose(lse.cpu().numpy(), ref_lse.cpu().numpy(),
                               **F32_TOL)
