"""The flash backward kernels' Python side, checked without nvcc or a card:
the ctypes binding against the C signature in ``flash_attention_bwd.cu``,
the one ``nvcc`` call over every source under ``csrc/``, the routing of
``FlashAttention.backward`` (the plain backward for CPU tensors, the
kernels or an error for CUDA ones), and the CPU route at the edges the
kernels add against ``jax.vjp`` of the JAX package's ``flash_attention`` /
``flash_with_lse`` (its Pallas kernel in interpret mode with the
``_flash_bwd`` custom VJP; lengths that do not tile into its 128-blocks
take its dense fallback).

Tolerance: rtol 2e-4 / atol 2e-5 in f32, as ``test_torch_flash_backward``
(sums in another order and over other blocks).
"""

import ctypes
import math
import re
import shutil
import subprocess
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.flash_attention import flash_attention as jax_flash
from bigdl_tpu.ops.flash_attention import flash_with_lse as jax_flash_lse
from bigdl_tpu_torch.ops import build
from bigdl_tpu_torch.ops import flash_attention as fa

TOL = dict(rtol=2e-4, atol=2e-5)
BWD_SOURCE = build.CSRC / "flash_attention_bwd.cu"
_CTYPES = {"ptr": ctypes.c_void_p, "int": ctypes.c_int,
           "long long": ctypes.c_longlong, "float": ctypes.c_float}


def _c_signature(source, name):
    """The ctypes kinds of the parameters of ``int name(...)`` in an
    ``extern "C"`` block of ``source``."""
    text = source.read_text()
    found = re.search(rf"int {name}\((.*?)\)\s*\{{", text, re.S)
    assert found, f"{name} not found in {source.name}"
    kinds = []
    for param in found.group(1).split(","):
        decl = " ".join(param.split()[:-1])       # drop the name
        kinds.append(_CTYPES["ptr" if "*" in decl else
                             decl.replace("const ", "")])
    return kinds


@pytest.fixture
def bound(monkeypatch):
    """``fa._library()`` over a stand-in for the loaded library: what the
    binding sets on each function, without building anything."""
    names = ("bigdl_flash_attention_fwd", "bigdl_flash_attention_bwd",
             "bigdl_cuda_error_string")
    lib = types.SimpleNamespace(**{n: types.SimpleNamespace()
                                   for n in names})
    monkeypatch.setattr(fa, "_LIB", None)
    monkeypatch.setattr(build, "load", lambda: lib)
    return fa._library()


@pytest.mark.parametrize("name,source", [
    ("bigdl_flash_attention_bwd", BWD_SOURCE),
    ("bigdl_flash_attention_fwd", build.SOURCE)])
def test_ctypes_binding_matches_the_c_signature(bound, name, source):
    want = _c_signature(source, name)
    got = getattr(bound, name).argtypes
    assert len(got) == len(want)
    assert got == want
    assert getattr(bound, name).restype is ctypes.c_int


def test_one_nvcc_call_builds_every_source(tmp_path, monkeypatch):
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, 0, stdout="ptxas info\n")

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.subprocess, "run", fake_run)
    out = build.build()
    assert out.exists() and out.parent == tmp_path
    assert len(calls) == 1
    sources = {p for p in calls[0] if p.endswith(".cu")}
    assert sources == {str(p) for p in build.CSRC.glob("*.cu")}
    assert str(BWD_SOURCE) in sources and str(build.SOURCE) in sources
    assert build.build() == out and len(calls) == 1    # built once


def test_library_path_follows_the_backward_source(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.library_path()
    src = csrc / BWD_SOURCE.name
    src.write_text(src.read_text() + "\n// edited\n")
    assert build.library_path() != before
    assert [p.name for p in build.sources()] == sorted(
        p.name for p in csrc.glob("*.cu"))


def test_cpu_backward_takes_the_plain_version(monkeypatch):
    calls = []
    plain = fa.flash_attention_backward_reference

    def spy(*a, **k):
        calls.append(a[0].device.type)
        return plain(*a, **k)

    monkeypatch.setattr(fa, "flash_attention_backward_reference", spy)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g).requires_grad_(True)
               for s in ((1, 4, 70, 16), (1, 2, 70, 16), (1, 2, 70, 16)))
    before = (fa.backward_launches, fa.plain_backward_cuda_calls)
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
    (out.sum() + lse.sum()).backward()
    assert calls == ["cpu"]
    assert (fa.backward_launches, fa.plain_backward_cuda_calls) == before
    assert all(x.grad is not None for x in (q, k, v))


def test_launch_backward_raises_on_cpu_tensors():
    q = torch.zeros(1, 2, 8, 16)
    k = v = torch.zeros(1, 2, 8, 16)
    out, lse = fa.flash_attention_reference(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa._launch_backward(q, k, v, out, lse, torch.ones_like(out), None,
                            False, 0.25)


def _inputs(b, h, h_kv, t, tk, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32)
            for s in ((b, h, t, d), (b, h_kv, tk, d), (b, h_kv, tk, d),
                      (b, h, t, d), (b, h, t))]


# (B, H, H_kv, t, tk, d, causal, cotangent): "out" (a seeded cotangent of
# out), "sum" (out.sum(): one expanded scalar, every stride 0) or "lse"
# (the lse output alone: the Function gets None for out)
EDGES = [
    (2, 4, 2, 128, 128, 40, True, "out"),       # d 40
    (1, 4, 2, 128, 128, 128, True, "out"),      # d 128
    (2, 4, 2, 128, 128, 32, True, "sum"),       # a stride-0 cotangent
    (2, 4, 1, 128, 256, 16, True, "lse"),       # the lse cotangent alone
    (2, 4, 2, 1, 300, 16, True, "out"),         # one row, 300 keys
]


@pytest.mark.parametrize("b,h,h_kv,t,tk,d,causal,cotangent", EDGES)
def test_cpu_backward_matches_jax_at_the_kernel_edges(b, h, h_kv, t, tk, d,
                                                      causal, cotangent):
    q, k, v, g_out, g_lse = _inputs(b, h, h_kv, t, tk, d, seed=t + tk + d)
    if cotangent == "sum":
        g_out = np.ones_like(g_out)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out, lse = fa.flash_attention_with_lse(qt, kt, vt, causal)
    if cotangent == "sum":
        obj = out.sum()
    elif cotangent == "lse":
        obj = (lse * torch.from_numpy(g_lse)).sum()
    else:
        obj = (out * torch.from_numpy(g_out)).sum()
    got = [x.numpy() for x in torch.autograd.grad(obj, (qt, kt, vt))]

    if cotangent == "lse":
        group, scale = h // h_kv, 1.0 / math.sqrt(d)
        flat = [jnp.asarray(a.reshape(-1, *a.shape[2:])) for a in (q, k, v)]

        def f(q_, k_, v_):
            return jax_flash_lse(q_, k_, v_, causal, scale, 128, 128, True,
                                 group)

        _, vjp = jax.vjp(f, *flat)
        want = vjp((jnp.zeros(flat[0].shape, jnp.float32),
                    jnp.asarray(g_lse.reshape(b * h, t, 1))))
    else:
        def f(q_, k_, v_):
            return jax_flash(q_, k_, v_, causal=causal)

        _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
        want = vjp(jnp.asarray(g_out))
    for name, ours, theirs in zip("qkv", got, want):
        np.testing.assert_allclose(ours, np.asarray(theirs).reshape(
            ours.shape), **TOL, err_msg=f"d{name}")
