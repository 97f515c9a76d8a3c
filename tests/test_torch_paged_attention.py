"""Paged KV attention in the port (bigdl_tpu_torch/nn/attention.py and the
TransformerLM's paged and verify entry points) against the JAX package's
on the same weights, pools, block tables and positions.

``_gather_pages`` and ``_write_kv_paged`` must give the JAX package's
pool and row views (idle lanes on the scratch page, a padded chunk tail
past a row's reservation); the attention layer's and the model's paged
steps, chunks and verify chunks must give its logits and pools at 1e-5
(f32, RoPE and learned positions); a paged run must hold, page by page,
the same logical K/V as a dense run and give the same logits. The
indices must stay in range where the engine drives them: CUDA asserts
on an out-of-range index where JAX clamps, and torch on the CPU raises,
so the edges (the last decodable position with the verify headroom, a
chunk ending on a page boundary) are driven on purpose here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.nn import attention as jattn
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.nn import attention as tattn
from bigdl_tpu_torch.serving import ContinuousBatchingEngine
from bigdl_tpu_torch.utils.weights import load_jax_params

CFG = dict(vocab_size=32, embed_dim=16, num_heads=4, num_kv_heads=2,
           num_layers=2, max_len=48)
PS = 4
TOL = dict(rtol=1e-5, atol=1e-5)
# per-row page lists (B = 3, table_len = 4): row 1 is an idle lane on the
# all-scratch table; row 2 holds three pages, so the fourth table slot
# (positions 12..15) is the scratch page
TABLES = np.asarray([[3, 7, 1, 8], [0, 0, 0, 0], [5, 2, 9, 0]], np.int64)


def _pair(use_rope: bool, seed: int):
    from bigdl_tpu.utils import random as rnd

    rnd.set_seed(seed)
    jm = JaxLM(**CFG, use_rope=use_rope)
    jm.evaluate()
    tm = TransformerLM(**CFG, use_rope=use_rope, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    tm.evaluate()
    return jm, tm


@pytest.fixture(scope="module", params=[True, False],
                ids=["rope", "learned"])
def lms(request):
    return _pair(request.param, 31)


def _close(t, j):
    if torch.is_tensor(t):
        t = t.detach()
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **TOL)


def _pools_close(tpools, jpools):
    for (tk, tv), (jk, jv) in zip(tpools, jpools):
        _close(tk, jk)
        _close(tv, jv)


def test_gather_and_write_match_jax():
    """One scatter of a ragged chunk through the tables and the gathered
    row views, against JAX's on the same random pool: row 2's chunk at
    offset 8 runs past its reservation (positions 12..15 are the scratch
    page, a padded tail), row 1 is an idle lane; then a decode write."""
    r = np.random.RandomState(0)
    pool_np = [r.randn(10, 2, PS, 8).astype(np.float32) for _ in range(2)]
    k_t = r.randn(3, 2, 8, 8).astype(np.float32)
    v_t = r.randn(3, 2, 8, 8).astype(np.float32)
    pos0 = np.asarray([0, 0, 8])
    positions = pos0[:, None] + np.arange(8)[None]
    jpool, jk, jv = jattn._write_kv_paged(
        tuple(jnp.asarray(p) for p in pool_np), jnp.asarray(k_t),
        jnp.asarray(v_t), jnp.asarray(TABLES, jnp.int32),
        jnp.asarray(positions, jnp.int32))
    tpool = tuple(torch.from_numpy(p.copy()) for p in pool_np)
    tables = torch.from_numpy(TABLES)
    out, tk, tv = tattn._write_kv_paged(
        tpool, torch.from_numpy(k_t), torch.from_numpy(v_t), tables,
        torch.from_numpy(positions))
    assert out is tpool          # written in place
    assert tk.shape == (3, 2, 16, 8)
    # the idle lane and the padded tail collide on page 0, where the
    # order of duplicate writes is undefined: compare the live pages
    live = [p for p in range(1, 10)]
    for t, j in zip(tpool, jpool):
        _close(t[live], np.asarray(j)[live])
    for row, cols in ((0, slice(0, 16)), (2, slice(0, 12))):
        _close(tk[row, :, cols], np.asarray(jk)[row, :, cols])
        _close(tv[row, :, cols], np.asarray(jv)[row, :, cols])
    np.testing.assert_array_equal(
        tattn._gather_pages(tpool[0], tables).numpy()[:, :, :12][[0, 2]],
        np.asarray(jattn._gather_pages(jpool[0], jnp.asarray(
            TABLES, jnp.int32)))[:, :, :12][[0, 2]])
    # row 2's written positions landed on its own pages 9 (8..11) only
    np.testing.assert_array_equal(
        tpool[0][9].numpy(), k_t[2, :, :4])
    # decode write: one position a row, (B,) form
    pos = torch.tensor([5, 0, 11])
    k1 = torch.from_numpy(r.randn(3, 2, 1, 8).astype(np.float32))
    tattn._write_kv_paged(tpool, k1, k1, tables, pos)
    np.testing.assert_array_equal(tpool[0][7][:, 1], k1[0, :, 0])
    np.testing.assert_array_equal(tpool[1][9][:, 3], k1[2, :, 0])


def test_write_raises_where_cuda_would_assert():
    """A position past the table (what JAX would clamp into the row's
    last page) raises on the CPU, in the float pool and in the int8 pool
    (codes and scales share the index math)."""
    pool = (torch.zeros(10, 2, PS, 8), torch.zeros(10, 2, PS, 8))
    kv = torch.zeros(3, 2, 1, 8)
    with pytest.raises((IndexError, RuntimeError)):
        tattn._write_kv_paged(pool, kv, kv, torch.from_numpy(TABLES),
                              torch.tensor([16, 0, 0]))
    q8 = (torch.zeros(10, 2, PS, 8, dtype=torch.int8),
          torch.zeros(10, 2, PS, 8, dtype=torch.int8),
          torch.zeros(10, 2, PS, 1), torch.zeros(10, 2, PS, 1))
    with pytest.raises((IndexError, RuntimeError)):
        tattn._write_kv_paged(q8, kv, kv, torch.from_numpy(TABLES),
                              torch.tensor([16, 0, 0]))


def _prefilled(jm, tm):
    """Both pools after a ragged chunk at offsets (0, 0, 4): returns the
    JAX pools, the port's pools, and the chunk's logits both ways."""
    r = np.random.RandomState(1)
    ids = r.randint(0, 32, (3, 8))
    pos0 = np.asarray([0, 0, 4])
    last = np.asarray([7, 7, 5])
    jpools = jm.init_page_pool(10, PS)
    tpools = tm.init_page_pool(10, PS)
    jl, jpools = jm.prefill_chunk_at_paged(
        jnp.asarray(ids), jpools, jnp.asarray(TABLES, jnp.int32),
        jnp.asarray(pos0, jnp.int32), jnp.asarray(last, jnp.int32))
    tl, tpools = tm.prefill_chunk_at_paged(
        ids, tpools, torch.from_numpy(TABLES), torch.from_numpy(pos0),
        last)
    return jpools, tpools, jl, tl


def _live_pools(pools):
    """Every page but the scratch page (written by idle lanes)."""
    return [(k[1:], v[1:]) for k, v in pools]


def test_model_paged_entry_points_match_jax(lms):
    jm, tm = lms
    jpools, tpools, jl, tl = _prefilled(jm, tm)
    _close(tl[[0, 2]], np.asarray(jl)[[0, 2]])
    _pools_close(_live_pools(tpools), _live_pools(jpools))
    tables_j = jnp.asarray(TABLES, jnp.int32)
    tables_t = torch.from_numpy(TABLES)
    # a decode step at per-row positions (row 0 on a page boundary)
    tok = np.asarray([3, 0, 17])
    pos = np.asarray([8, 0, 10])
    jl, jpools = jm.decode_step_paged(jnp.asarray(tok, jnp.int32),
                                      jnp.asarray(pos, jnp.int32),
                                      jpools, tables_j)
    tl, tpools = tm.decode_step_paged(tok, torch.from_numpy(pos), tpools,
                                      tables_t)
    _close(tl[[0, 2]], np.asarray(jl)[[0, 2]])
    _pools_close(_live_pools(tpools), _live_pools(jpools))
    # a verify chunk of gamma + 1 = 3 at the next positions: row 0 ends
    # on the page boundary 11, row 2's runs to 13 (its table's last slot
    # is the scratch page)
    chunk = np.asarray([[4, 9, 1], [0, 0, 0], [30, 2, 5]])
    pos = np.asarray([9, 0, 11])
    jv, jpools = jm.verify_chunk_paged(jnp.asarray(chunk, jnp.int32),
                                       jpools, tables_j,
                                       jnp.asarray(pos, jnp.int32))
    tv, tpools = tm.verify_chunk_paged(chunk, tpools, tables_t,
                                       torch.from_numpy(pos))
    assert tv.shape == (3, 3, 32)
    _close(tv[0], np.asarray(jv)[0])
    _close(tv[2, :1], np.asarray(jv)[2, :1])
    _pools_close(_live_pools(tpools), _live_pools(jpools))


def test_attention_layer_paged_methods_match_jax(lms):
    jm, tm = lms
    r = np.random.RandomState(2)
    x = r.randn(3, 8, 16).astype(np.float32)
    pos0 = np.asarray([0, 0, 4])
    ja, ta = jm.block0.attn, tm.block0.attn
    jpool, tpool = ja.init_page_pool(10, PS), ta.init_page_pool(10, PS)
    tables_j = jnp.asarray(TABLES, jnp.int32)
    tables_t = torch.from_numpy(TABLES)
    jo, jpool = ja.forward_chunk_paged(jnp.asarray(x), jpool, tables_j,
                                       jnp.asarray(pos0, jnp.int32))
    to, tpool = ta.forward_chunk_paged(torch.from_numpy(x), tpool,
                                       tables_t, torch.from_numpy(pos0))
    _close(to[[0, 2]], np.asarray(jo)[[0, 2]])
    x1 = r.randn(3, 1, 16).astype(np.float32)
    pos = np.asarray([8, 0, 12])
    jo, jpool = ja.forward_step_paged(jnp.asarray(x1), jpool, tables_j,
                                      jnp.asarray(pos, jnp.int32))
    to, tpool = ta.forward_step_paged(torch.from_numpy(x1), tpool,
                                      tables_t, torch.from_numpy(pos))
    _close(to[0], np.asarray(jo)[0])
    _close(tpool[0][1:], np.asarray(jpool[0])[1:])
    _close(tpool[1][1:], np.asarray(jpool[1])[1:])
    # the block twins
    jb, tb = jm.block1, tm.block1
    jo, _ = jb.forward_step_paged(jnp.asarray(x1), jb.attn.init_page_pool(
        10, PS), tables_j, jnp.asarray(pos, jnp.int32))
    to, _ = tb.forward_step_paged(torch.from_numpy(x1),
                                  tb.attn.init_page_pool(10, PS), tables_t,
                                  torch.from_numpy(pos))
    _close(to[[0, 2]], np.asarray(jo)[[0, 2]])


def test_verify_chunk_matches_jax_dense(lms):
    """The dense ragged verify (every chunk position's logits) and its
    lockstep int form, against JAX's."""
    jm, tm = lms
    r = np.random.RandomState(3)
    head = r.randint(0, 32, (2, 8))
    chunk = r.randint(0, 32, (2, 5))
    cj, ct = jm.init_cache(2, 20), tm.init_cache(2, 20)
    _, cj = jm.prefill(jnp.asarray(head), cj)
    _, ct = tm.prefill(head, ct)
    pos0 = np.asarray([8, 3])
    jv, cj = jm.verify_chunk(jnp.asarray(chunk), cj,
                             jnp.asarray(pos0, jnp.int32))
    tv, ct = tm.verify_chunk(chunk, ct, torch.from_numpy(pos0))
    assert tv.shape == (2, 5, 32)
    _close(tv, jv)
    for (jk, jvv), (tk, tvv) in zip(cj, ct):
        _close(tk, jk)
        _close(tvv, jvv)
    jv, _ = jm.verify_chunk(jnp.asarray(chunk), cj, 13)
    tv, _ = tm.verify_chunk(chunk, ct, 13)
    _close(tv, jv)


def test_paged_holds_the_dense_logical_kv(lms):
    """The same tokens through the paged entry points and the dense ones
    give the same logits, and gathering each row's pages reproduces its
    dense cache row over the positions written."""
    _, tm = lms
    r = np.random.RandomState(4)
    ids = r.randint(0, 32, (3, 8))
    pos0 = torch.tensor([0, 0, 4])
    last = torch.tensor([7, 7, 5])
    tables = torch.from_numpy(TABLES)
    pools = tm.init_page_pool(10, PS)
    caches = tm.init_cache(3, 16)
    lp, _ = tm.prefill_chunk_at_paged(ids, pools, tables, pos0, last)
    ld, _ = tm.prefill_chunk_at(ids, caches, pos0, last)
    # row 1 is an idle lane: its eight positions collide on page 0
    torch.testing.assert_close(lp[[0, 2]], ld[[0, 2]], rtol=0, atol=0)
    # every compared position inside its row's reservation (row 2's
    # ends at 11: its position 12 would be the scratch page)
    tok, pos = torch.tensor([1, 0, 2]), torch.tensor([8, 0, 11])
    sp, _ = tm.decode_step_paged(tok, pos, pools, tables)
    sd, _ = tm.decode_step(tok, pos, caches)
    torch.testing.assert_close(sp[[0, 2]], sd[[0, 2]], rtol=0, atol=0)
    chunk = torch.tensor([[5, 6, 7], [0, 0, 0], [8, 9, 10]])
    vp, _ = tm.verify_chunk_paged(chunk, pools, tables,
                                  torch.tensor([9, 0, 9]))
    vd, _ = tm.verify_chunk(chunk, caches, torch.tensor([9, 0, 9]))
    torch.testing.assert_close(vp[[0, 2]], vd[[0, 2]], rtol=0, atol=0)
    for (pk, pv), (dk, dv) in zip(pools, caches):
        for pbuf, dbuf in ((pk, dk), (pv, dv)):
            rows = tattn._gather_pages(pbuf, tables)
            torch.testing.assert_close(rows[0, :, :12], dbuf[0, :, :12],
                                       rtol=0, atol=0)
            torch.testing.assert_close(rows[2, :, 4:12], dbuf[2, :, 4:12],
                                       rtol=0, atol=0)


@pytest.mark.parametrize("use_rope", [True, False],
                         ids=["rope", "learned"])
def test_window_edges_stay_in_range(use_rope):
    """The engine at the edges of its window: a request that fills the
    serving window exactly (t0 + n == max_len, so the last verify round
    writes gamma positions past it, into the headroom), a prompt ending
    on a page boundary, and a chunk ending on one; paged with a draft,
    where the table is sized to the headroom. Every row equals the lone
    ``generate``; an index out of range would raise here."""
    _, tm = _pair(use_rope, 33)
    _, td = _pair(use_rope, 34)
    r = np.random.RandomState(6)
    reqs = [(r.randint(0, 32, (40,)), 8),     # t0 + n == max_len
            (r.randint(0, 32, (16,)), 32),    # prompt ends on a page
            (r.randint(0, 32, (8,)), 40),     # chunk ends on a page
            (r.randint(0, 32, (47,)), 1)]     # the longest prompt
    for draft in (td, tm):
        with ContinuousBatchingEngine(tm, max_slots=2, prefill_chunk=8,
                                      prefill_rows=2, page_size=PS,
                                      draft=draft, spec_gamma=4) as eng:
            assert eng._table_len * PS >= 48 + 4
            rows = [eng.submit(p, n) for p, n in reqs]
            rows = [h.result(timeout=120) for h in rows]
        for (p, n), row in zip(reqs, rows):
            np.testing.assert_array_equal(row, tm.generate(p, n)[0].numpy())
