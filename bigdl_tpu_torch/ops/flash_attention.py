"""Flash attention (port of ``bigdl_tpu/ops/flash_attention.py``).

The JAX package's one Pallas kernel, ``_flash_kernel``, becomes the
hand-written CUDA kernel ``csrc/flash_attention.cu`` (see the note at its
top for what it computes, its bound on the card and its design). This
module is its Python side:

- :func:`flash_attention` / :func:`flash_attention_with_lse` take the JAX
  package's layout, q (B, H, T, D) and k, v (B, H_kv, Tk, D) with
  ``H % H_kv == 0`` (grouped-query attention: consecutive groups of
  ``H // H_kv`` query heads share a kv head, read in place, never
  repeated). Outputs are out (B, H, T, D) in q's dtype and lse (B, H, T)
  in f32. Both outputs are differentiable (the JAX package's ``_flash``
  and ``flash_with_lse`` custom VJPs): the forward is the kernel, the
  backward :func:`flash_attention_backward_reference`.
- :func:`flash_attention_reference` is the plain PyTorch version of the
  forward: a blocked online softmax with the kernel's recurrence, its
  last-query-aligned causal mask and its dead-row rule (out 0, lse
  -1e30).
- :func:`flash_attention_backward_reference` is the JAX package's
  ``_flash_bwd``, which is XLA there (no Pallas kernel), in plain
  PyTorch: the blocked recurrence over 256-key kv blocks from the saved
  lse, f32 math, grads cast back to each input's dtype.

A CPU tensor takes the plain forward; a CUDA tensor launches the kernel
or raises. The kernel guards its ragged tails, so unlike the JAX wrapper
(which falls back to dense attention when t or tk does not tile) every
length launches it, and the backward takes every length too.

``launches`` counts kernel launches; it never counts the plain version.
The backward launches no kernel of its own.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

#: the JAX kernel's _NEG_INF: m's initial value and a dead row's lse
NEG_INF = -1e30
MAX_HEAD_DIM = 128
BLOCK_K = 64  # keys per kv tile, as in the kernel
#: keys per kv block of the backward (the JAX package's auto_block(1024))
BWD_BLOCK_K = 256

#: CUDA kernel launches since import (or since the caller last reset it)
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LIB: Optional[ctypes.CDLL] = None    # the kernel library, once bound


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes q (B, H, T, D) and k, v "
                         f"(B, H_kv, Tk, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"q heads {h} not a multiple of kv heads "
                         f"{k.shape[1]}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"mixed dtypes q {q.dtype}, k {k.dtype}, "
                        f"v {v.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")


def flash_attention_reference(q, k, v, causal: bool = False,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch (out, lse): the kernel's blocked online softmax over
    kv blocks of the kernel's 64 keys, all query rows at once, in f32."""
    b, h, t, d = q.shape
    h_kv, tk = k.shape[1], k.shape[2]
    g = h // h_kv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kv_offset = tk - t
    qf = q.float().reshape(b, h_kv, g, t, d)
    kf = k.float()[:, :, None]                 # (B, H_kv, 1, Tk, D)
    vf = v.float()[:, :, None]
    m = torch.full((b, h_kv, g, t, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h_kv, g, t, 1), device=q.device)
    acc = torch.zeros((b, h_kv, g, t, d), device=q.device)
    rows = torch.arange(t, device=q.device)[:, None]
    for j0 in range(0, tk, BLOCK_K):
        if causal and j0 > t - 1 + kv_offset:
            break  # every later block lies wholly above the diagonal
        kj = kf[..., j0:j0 + BLOCK_K, :]
        vj = vf[..., j0:j0 + BLOCK_K, :]
        s = torch.matmul(qf, kj.transpose(-1, -2)) * scale
        mask = None
        if causal:
            cols = j0 + torch.arange(kj.shape[-2], device=q.device)[None]
            mask = rows + kv_offset >= cols
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        if mask is not None:
            # a fully masked row has m_new == NEG_INF and exp(0) == 1 at
            # its masked entries: zero them so l stays 0
            p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vj)
        m = m_new
    safe = torch.where(l > 0, l, 1.0)
    out = (acc / safe).to(q.dtype).reshape(b, h, t, d)
    lse = torch.where(l > 0, m + torch.log(safe), NEG_INF)
    return out, lse.reshape(b, h, t)


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from bigdl_tpu_torch.ops import build

        lib = build.load()
        fn = lib.bigdl_flash_attention_fwd
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([ptr] * 5 + [i32] * 6 + [i64] * 9
                       + [i32, i32, ctypes.c_float, i32, i32, ptr])
        fn.restype = i32
        lib.bigdl_cuda_error_string.argtypes = [i32]
        lib.bigdl_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _vectorizable(*tensors) -> bool:
    """The kernel may load through TMA tensor maps (16-byte copies): D,
    every stride and every base pointer are multiples of 16 bytes, and no
    stride is 0 (an expanded view)."""
    per = 16 // tensors[0].element_size()
    for x in tensors:
        sb, sh, st, _ = x.stride()
        if (x.shape[-1] % per or x.data_ptr() % 16 or sb % per or sh % per
                or st % per or not (sb and sh and st)):
            return False
    return True


def _launch(q, k, v, causal: bool, scale: float):
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA flash kernel needs CUDA tensors, got "
                         f"{q.device}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash attention needs a contiguous last dim in "
                         "q, k and v")
    b, h, t, d = q.shape
    h_kv, tk = k.shape[1], k.shape[2]
    out = torch.empty((b, h, t, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _library()
    dev = q.device.index             # set on every CUDA tensor
    err = lib.bigdl_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, h_kv, t, tk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        _DTYPE_CODES[q.dtype], int(causal), float(scale),
        int(_vectorizable(q, k, v)), dev,
        torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        msg = lib.bigdl_cuda_error_string(err).decode()
        raise RuntimeError(f"flash attention kernel launch failed: {msg} "
                           f"(code {err})")
    launches += 1
    return out, lse


def flash_attention_backward_reference(q, k, v, out, lse, d_out,
                                       causal: bool = False,
                                       scale: Optional[float] = None,
                                       d_lse=None):
    """(dq, dk, dv) of flash attention from its saved (q, k, v, out, lse)
    and the cotangent ``d_out`` (and ``d_lse`` of the lse output, when
    given): the JAX package's blocked ``_flash_bwd``. With
    P = exp(S·scale - lse) and D = rowsum(dO ∘ O) - d_lse,

        dS = P ∘ (dO Vᵀ - D) · scale,  dQ = Σ_j dS_j K_j,
        dK_j = dS_jᵀ Q,  dV_j = P_jᵀ dO,

    one kv block of ``BWD_BLOCK_K`` keys at a time, so live memory is
    O(t·block_k), never the (t, tk) matrix. Under the causal mask a kv
    block starting at key j0 is seen only by rows r >= j0 - (tk - t), so
    the rows above are skipped, and only the rows that see part of the
    block are masked; a dead row (t > tk: it sees no key, lse -1e30)
    lies above every block and gets no gradient. The q heads of a GQA
    group share kv head ``h // group``: k and v are repeated per q head,
    as in the JAX package, and dk, dv summed back over the group. f32
    math; each grad in its input's dtype."""
    b, h, t, d = q.shape
    h_kv, tk = k.shape[1], k.shape[2]
    g, n = h // h_kv, b * h
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kv_offset = tk - t
    # contiguous f32 copies, so every block below is a view that the
    # batched products take without another copy
    f32 = dict(dtype=torch.float32, memory_format=torch.contiguous_format)
    qf = q.to(**f32).reshape(n, t, d)
    do = d_out.to(**f32).reshape(n, t, d)
    kf, vf = k.to(**f32), v.to(**f32)
    if g > 1:
        kf, vf = kf.repeat_interleave(g, 1), vf.repeat_interleave(g, 1)
    kf, vf = kf.reshape(n, tk, d), vf.reshape(n, tk, d)
    lse = lse.reshape(n, t, 1)
    rowsum = (do * out.to(**f32).reshape(n, t, d)).sum(-1, keepdim=True)
    if d_lse is not None:
        rowsum = rowsum - d_lse.float().reshape(n, t, 1)
    dq = torch.zeros_like(qf)
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    for j0 in range(0, tk, BWD_BLOCK_K):
        # the causal mask is aligned to the last query, which sees every
        # key, so r0 < t: every block is written
        r0 = max(0, j0 - kv_offset) if causal else 0
        kj, vj = kf[:, j0:j0 + BWD_BLOCK_K], vf[:, j0:j0 + BWD_BLOCK_K]
        qr, dor = qf[:, r0:], do[:, r0:]
        # p = exp(s·scale - lse)
        p = torch.baddbmm(lse[:, r0:], qr, kj.transpose(1, 2), beta=-1.0,
                          alpha=scale).exp_()
        if causal:
            # rows r < j0 + len - 1 - kv_offset miss some of the block
            n_part = min(t, j0 + kj.shape[1] - 1 - kv_offset) - r0
            if n_part > 0:
                rows = torch.arange(r0, r0 + n_part, device=q.device)
                cols = j0 + torch.arange(kj.shape[1], device=q.device)
                p[:, :n_part].masked_fill_(
                    rows[:, None] + kv_offset < cols[None], 0.0)
        # ds / scale = p ∘ (dO Vᵀ - D); the scale enters dq and dk below
        ds = torch.baddbmm(rowsum[:, r0:], dor, vj.transpose(1, 2),
                           beta=-1.0).mul_(p)
        dq[:, r0:].baddbmm_(ds, kj)
        dk[:, j0:j0 + BWD_BLOCK_K] = torch.bmm(ds.transpose(1, 2), qr)
        dv[:, j0:j0 + BWD_BLOCK_K] = torch.bmm(p.transpose(1, 2), dor)
    if g > 1:
        dk = dk.reshape(b * h_kv, g, tk, d).sum(1)
        dv = dv.reshape(b * h_kv, g, tk, d).sum(1)
    return ((dq * scale).reshape(b, h, t, d).to(q.dtype),
            (dk * scale).reshape(b, h_kv, tk, d).to(k.dtype),
            dv.reshape(b, h_kv, tk, d).to(v.dtype))


def _forward(q, k, v, causal: bool, scale: float):
    """(out, lse): the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    return _launch(q, k, v, causal, scale)


class FlashAttention(torch.autograd.Function):
    """(out, lse) with both outputs differentiable: the forward of
    :func:`_forward`, the backward of
    :func:`flash_attention_backward_reference` from the saved
    (q, k, v, out, lse); the lse cotangent enters only when the lse
    output was used."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = _forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, d_out, d_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if d_out is None:
            d_out = torch.zeros_like(out)
        dq, dk, dv = flash_attention_backward_reference(
            q, k, v, out, lse, d_out, ctx.causal, ctx.scale, d_lse)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, H, T, D), lse (B, H, T) f32): the kernel on CUDA tensors,
    its plain version on CPU tensors; differentiable in q, k and v
    through :class:`FlashAttention`."""
    _check(q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return FlashAttention.apply(q, k, v, causal, scale)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """(B, H, T, D) flash attention (see :func:`flash_attention_with_lse`)."""
    return flash_attention_with_lse(q, k, v, causal, scale)[0]
