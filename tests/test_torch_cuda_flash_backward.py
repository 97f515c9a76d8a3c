"""The flash backward kernels on the card, against the plain backward
(``flash_attention_backward_reference``) on the same saved (q, k, v, out,
lse) and cotangents. Every test here needs a CUDA card and skips without
one; the file imports no JAX, so on a GPU machine without it run

    python -m pytest --noconftest tests/test_torch_cuda_flash_backward.py -q

Tolerance: each gradient row (over the head dim) within rtol (5e-2 bf16,
2e-4 f32) times the sum of its reference row's L2 norm and the RMS of all
the reference's row norms, the rule of ``chip_smoke.py``'s phase 7 and of
``tests/test_torch_cuda_kernels.py``: the kernels round P and dS to bf16
for the tensor cores where the plain version keeps f32, and f32 sums run in
another order.
"""

import pytest
import torch

from bigdl_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

GRAD_RTOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}

# (B, H, H_kv, t, tk, d, causal, dtype)
CASES = [
    (2, 8, 8, 1024, 1024, 64, True, torch.bfloat16),   # the training shape
    (2, 8, 2, 300, 300, 40, True, torch.bfloat16),     # d 40, ragged
    (2, 4, 2, 200, 200, 128, True, torch.bfloat16),    # d 128
    (2, 8, 2, 256, 256, 64, False, torch.bfloat16),    # GQA 4, non-causal
    (2, 8, 2, 1, 300, 64, True, torch.bfloat16),       # one query row
    (2, 8, 2, 512, 256, 64, True, torch.bfloat16),     # dead rows
    (2, 8, 2, 256, 1024, 64, True, torch.bfloat16),    # t < tk
    (2, 4, 1, 100, 100, 77, True, torch.bfloat16),     # odd d: element copies
    (2, 4, 2, 300, 700, 64, False, torch.bfloat16),    # non-causal t != tk
    (2, 4, 2, 300, 300, 64, True, torch.float32),
    (2, 4, 1, 129, 200, 40, True, torch.float32),      # f32 GQA 4, d 40
    (1, 2, 2, 77, 77, 128, False, torch.float32),      # f32 d 128
]


def _grad_excess(grad, ref, rtol):
    ref_norm = ref.float().norm(dim=-1)
    err = (grad.float() - ref.float()).norm(dim=-1)
    allow = rtol * (ref_norm + ref_norm.pow(2).mean().sqrt())
    return torch.where(err == 0, torch.zeros_like(err), err / allow).max()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 plain version
    return torch.device("cuda")


def _saved(card, b, h, h_kv, t, tk, d, causal, dtype, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    q, k, v = (torch.randn(s, device=card, generator=g).to(dtype)
               for s in ((b, h, t, d), (b, h_kv, tk, d), (b, h_kv, tk, d)))
    out, lse = fa.flash_attention_with_lse(q, k, v, causal)
    d_out = torch.randn((b, h, t, d), device=card, generator=g).to(dtype)
    d_lse = torch.randn((b, h, t), device=card, generator=g)
    return q, k, v, out, lse, d_out, d_lse


@pytest.mark.parametrize("cotangent", ["out", "out_lse", "lse"])
@pytest.mark.parametrize("b,h,h_kv,t,tk,d,causal,dtype", CASES)
def test_backward_kernel_matches_plain_backward(card, b, h, h_kv, t, tk, d,
                                                causal, dtype, cotangent):
    q, k, v, out, lse, d_out, d_lse = _saved(card, b, h, h_kv, t, tk, d,
                                             causal, dtype, t + tk + d)
    scale = d ** -0.5
    g_out = None if cotangent == "lse" else d_out
    g_lse = None if cotangent == "out" else d_lse
    before = fa.backward_launches
    got = fa._launch_backward(q, k, v, out, lse, g_out, g_lse, causal, scale)
    torch.cuda.synchronize()
    assert fa.backward_launches == before + 1
    ref = fa.flash_attention_backward_reference(
        q, k, v, out, lse, torch.zeros_like(out) if g_out is None else g_out,
        causal, scale, g_lse)
    for x, a, r in zip((q, k, v), got, ref):
        assert a.dtype == x.dtype and a.shape == x.shape
        assert torch.isfinite(a).all()
        assert _grad_excess(a, r, GRAD_RTOL[dtype]).item() <= 1.0
    dead = lse <= fa.NEG_INF / 2
    assert (got[0][dead] == 0).all()


def test_backward_reads_views_and_a_stride_zero_cotangent(card):
    """q, k, v as views of one fused projection (GQA), through autograd
    with the cotangent of ``out.sum()`` (every stride 0), against the plain
    backward on the same saved tensors."""
    b, h, h_kv, t, d = 2, 8, 2, 300, 64
    g = torch.Generator(device=card).manual_seed(3)
    qkv = torch.randn((b, t, (h + 2 * h_kv) * d), device=card,
                      generator=g).to(torch.bfloat16).requires_grad_(True)
    cuts = (0, h * d, (h + h_kv) * d, (h + 2 * h_kv) * d)
    q, k, v = (qkv[..., lo:hi].unflatten(-1, (-1, d)).transpose(1, 2)
               for lo, hi in zip(cuts, cuts[1:]))
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
    before = fa.backward_launches, fa.plain_backward_cuda_calls
    (grad,) = torch.autograd.grad(out.sum(), qkv)
    assert (fa.backward_launches, fa.plain_backward_cuda_calls) == (
        before[0] + 1, before[1])
    ones = torch.ones_like(out).expand(out.shape)
    ref = fa.flash_attention_backward_reference(
        q.detach(), k.detach(), v.detach(), out.detach(), lse.detach(),
        ones, True, d ** -0.5)
    want = torch.cat([x.transpose(1, 2).flatten(-2) for x in ref], -1)
    assert _grad_excess(grad.unflatten(-1, (-1, d)),
                        want.unflatten(-1, (-1, d)), GRAD_RTOL[torch.bfloat16]
                        ).item() <= 1.0


def test_backward_is_deterministic(card):
    saved = _saved(card, 4, 8, 8, 1024, 1024, 64, True, torch.bfloat16, 9)
    runs = [fa._launch_backward(*saved, True, 0.125) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_backward_takes_a_negative_scale(card):
    q, k, v, _, _, d_out, d_lse = _saved(card, 2, 4, 2, 200, 200, 64, True,
                                         torch.bfloat16, 5)
    out, lse = fa.flash_attention_with_lse(q, k, v, True, -0.125)
    got = fa._launch_backward(q, k, v, out, lse, d_out, d_lse, True, -0.125)
    ref = fa.flash_attention_backward_reference(q, k, v, out, lse, d_out,
                                                True, -0.125, d_lse)
    for a, r in zip(got, ref):
        assert _grad_excess(a, r, GRAD_RTOL[torch.bfloat16]).item() <= 1.0
