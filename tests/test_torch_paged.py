"""The port's paged KV cache, page allocator, prefix cache and the plain
versions of its two paged attention kernels, against the JAX package.

Writes, gathers and page copies are bit-exact (the port's pool carries one
extra page, the write sink, where the JAX package drops writes). The
allocators and prefix caches walk the same operation sequence and must hold
the same tables, refcounts and plans. The plain attention versions are held
to the JAX Pallas kernels (interpret mode, as the JAX package's own CPU
tests run them) and to their XLA gather twins within 1e-4 in f32, over GQA
groups 1 and 4, head_dim 64 and 128, left pads and mid-page bounds, shuffled
physical pages with an unmapped entry past the live range, softcap and a
gated window, and the cold, suffix and verify chunk shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models.llama import paged_cache as JP
from cake_tpu.ops.pallas.paged_attention import (
    paged_decode_attention as jax_paged_decode,
    paged_decode_attention_xla as jax_paged_decode_xla,
)
from cake_tpu.ops.pallas.paged_prefill import (
    paged_chunk_attention as jax_paged_chunk,
    paged_chunk_attention_xla as jax_paged_chunk_xla,
)
from cake_tpu.runtime.prefix_cache import PrefixCache as JaxPrefixCache
from cake_tpu_torch.models.llama import paged_cache as P
from cake_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
)
from cake_tpu_torch.ops.paged_prefill import (
    paged_chunk_attention,
    paged_chunk_attention_plain,
    paged_kernel_supported,
)
from cake_tpu_torch.runtime.prefix_cache import PrefixCache
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-4  # f32 attention: the port's plain arithmetic vs the JAX package's
SENTINEL = 2**30  # the JAX package's pad-key position


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------- cache writes

N_PAGES, N_KV, PS_W, HD_W = 6, 2, 16, 8


@pytest.mark.parametrize("with_starts", [False, True])
@pytest.mark.parametrize("pos,chunk", [(0, 40), (30, 5), (60, 12)])
def test_paged_write_layer_matches_jax_bitwise(with_starts, pos, chunk):
    rng = np.random.default_rng(pos + chunk)
    # Row 0 maps 3 logical pages; row 1 has an unmapped hole at logical 1 and
    # a 4-page table, so (60, 12) also writes past the table.
    tables = np.array([[4, 1, 5, -1], [0, -1, 2, 3]], np.int32)
    pool_k = rng.normal(size=(N_PAGES, N_KV, PS_W, HD_W)).astype(np.float32)
    pool_v = rng.normal(size=(N_PAGES, N_KV, PS_W, HD_W)).astype(np.float32)
    k_new = rng.normal(size=(2, chunk, N_KV, HD_W)).astype(np.float32)
    v_new = rng.normal(size=(2, chunk, N_KV, HD_W)).astype(np.float32)
    starts = np.array([pos + 3, pos], np.int32) if with_starts else None

    jk, jv = JP.paged_write_layer(
        jnp.asarray(pool_k), jnp.asarray(pool_v), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.int32(pos), jnp.asarray(tables), None if starts is None else jnp.asarray(starts),
    )
    sink = np.zeros((1, N_KV, PS_W, HD_W), np.float32)
    pk = _t(np.concatenate([pool_k, sink]))
    pv = _t(np.concatenate([pool_v, sink]))
    P.paged_write_layer(
        pk, pv, _t(k_new), _t(v_new), pos, _t(tables),
        None if starts is None else _t(starts),
    )
    np.testing.assert_array_equal(pk[:N_PAGES].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pv[:N_PAGES].numpy(), np.asarray(jv))


def test_gather_and_copy_pages_match_jax_bitwise():
    rng = np.random.default_rng(1)
    pool = rng.normal(size=(3, N_PAGES, N_KV, PS_W, HD_W)).astype(np.float32)
    tables = np.array([[4, 1, -1], [0, 5, 2]], np.int32)
    got = P.gather_pages(_t(pool[0]), _t(tables))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JP.gather_pages(jnp.asarray(pool[0]), jnp.asarray(tables)))
    )
    src, dst = [4, 0], [3, 1]
    want = JP.copy_pages(
        JP.PagedKVCache(jnp.asarray(pool), jnp.asarray(pool + 1)), np.array(src), np.array(dst)
    )
    cache = P.PagedKVCache(_t(pool), _t(pool + 1))
    P.copy_pages(cache, src, dst)
    np.testing.assert_array_equal(cache.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(cache.v.numpy(), np.asarray(want.v))


def test_init_paged_cache_adds_the_write_sink():
    cache = P.init_paged_cache(2, 5, N_KV, PS_W, HD_W, torch.float32)
    assert cache.k.shape == (2, 6, N_KV, PS_W, HD_W)
    assert cache.n_pages == 5 and cache.page_size == PS_W and cache.n_layers == 2


# ------------------------------------------------------------- allocators


def _allocator_ops(alloc, mod):
    """One operation sequence; returns the states seen along the way."""
    seen = []

    def snap():
        seen.append((alloc.block_tables.copy(), alloc.refcount.copy(), alloc.pages_free,
                     alloc.pages_shared))

    alloc.map_range(0, 5, 40)
    alloc.map_range(1, 0, 17)
    snap()
    alloc.map_range(0, 40, 50)  # growth within the mapped page and across one
    alloc.retain_pages([int(alloc.block_tables[0, 0])])
    snap()
    alloc.fork_chain(2, [int(p) for p in alloc.block_tables[0, :2]], 0)
    pair = alloc.make_private(2, 1)
    snap()
    alloc.release(0)
    alloc.unmap_page(2, 0)
    snap()
    with pytest.raises(mod.PageExhausted):
        alloc.map_range(3, 0, 16 * 8)  # 8 pages, fewer free
    alloc.release_lanes(batch=4)
    snap()
    alloc.release_pages([int(np.flatnonzero(alloc.refcount)[0])])
    alloc.reset(batch=2)
    snap()
    return seen, pair, alloc.can_admit(30)


def test_page_allocator_matches_jax():
    got = _allocator_ops(P.PageAllocator(10, 16, 4, 8, reserve_pages=1), P)
    want = _allocator_ops(JP.PageAllocator(10, 16, 4, 8, reserve_pages=1), JP)
    assert got[1:] == want[1:]
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2:] == w[2:]


def _prefix_ops(cache, alloc):
    """Insert, fork (full, partial and across alignment classes), reclaim."""
    ps = alloc.page_size
    ids = list(range(100, 100 + 3 * ps + 5))
    out = []
    alloc.map_range(0, 3, 3 + len(ids))
    out.append(cache.insert(0, ids, 3))
    out.append(cache.match_tokens(ids, 3))
    out.append(cache.match_tokens(ids, 4))  # another alignment class: a miss
    plan = cache.fork(1, ids[: 2 * ps] + [7, 7, 7], 3)
    out.append((plan.served, plan.cow_logical))
    alloc.map_range(2, 3, 3 + ps)
    out.append(cache.insert(2, ids[:5] + [1] * (ps - 8), 3))  # diverges mid-page: a sibling
    out.append(cache.radix_key(ids, 3) is not None)
    cache.release(plan.lease)
    alloc.release(0)
    alloc.release(1)
    alloc.release(2)
    out.append(cache.reclaim(2))
    out.append(alloc.pages_free)
    out.append(cache.clear())
    out.append(alloc.pages_free)
    return out


def test_prefix_cache_matches_jax():
    alloc = P.PageAllocator(16, 16, 3, 8)
    jalloc = JP.PageAllocator(16, 16, 3, 8)
    got = _prefix_ops(PrefixCache(alloc, max_pages=8), alloc)
    want = _prefix_ops(JaxPrefixCache(jalloc, max_pages=8), jalloc)
    assert got == want
    np.testing.assert_array_equal(alloc.block_tables, jalloc.block_tables)


# ------------------------------------------------------------- attention

PS = 128  # the kernels' page (the JAX Pallas kernels take only 128-multiples)


def _pool(rng, n_pages, n_kv, hd):
    shape = (n_pages, n_kv, PS, hd)
    return rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32)


def _port_pool(kp, vp):
    """The JAX pool plus the port's write sink."""
    sink = np.zeros((1,) + kp.shape[1:], np.float32)
    return _t(np.concatenate([kp, sink])), _t(np.concatenate([vp, sink]))


# Shuffled physical pages; row 1 has an unmapped entry past its live range.
TABLES = np.array([[7, 2, 9], [5, 0, -1], [1, 8, 3]], np.int32)


def _decode_grids(lengths, starts, width):
    """Position grids the XLA twin masks with (slot - pad; pad keys get the
    sentinel), for one query at slot length - 1."""
    kslots = np.arange(width)[None, :]
    k_pos = kslots - starts[:, None]
    k_pos = np.where(k_pos < 0, SENTINEL, k_pos)
    k_pos = np.where(kslots >= lengths[:, None], SENTINEL, k_pos)
    q_pos = (lengths - 1 - starts)[:, None]
    return jnp.asarray(q_pos, jnp.int32), jnp.asarray(k_pos, jnp.int32)


DECODE_KNOBS = {
    "plain": {},
    "softcap": {"softcap": 30.0, "scale": 0.2},
    "window_on": {"window": 100, "window_flag": True},
    "window_off": {"window": 100, "window_flag": False},
}


@pytest.mark.parametrize("knobs", list(DECODE_KNOBS))
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("group", [1, 4])
def test_paged_decode_plain_matches_jax(group, hd, knobs):
    kw = dict(DECODE_KNOBS[knobs])
    flag = kw.pop("window_flag", None)
    rng = np.random.default_rng(group * hd)
    n_kv = 2
    kp, vp = _pool(rng, 10, n_kv, hd)
    q = rng.normal(size=(3, 1, n_kv * group, hd)).astype(np.float32)
    lengths = np.array([300, 200, 384], np.int32)  # mid-page ends
    starts = np.array([0, 70, 130], np.int32)  # left pads, mid-page
    jflag = None if flag is None else jnp.asarray(flag)
    want = jax_paged_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lengths),
        jnp.asarray(TABLES), jnp.asarray(starts), jflag, **kw,
    )
    q_pos, k_pos = _decode_grids(lengths, starts, TABLES.shape[1] * PS)
    twin = jax_paged_decode_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), q_pos, k_pos, jnp.asarray(TABLES),
        window_flag=jflag, **kw,
    )
    pk, pv = _port_pool(kp, vp)
    pflag = None if flag is None else torch.tensor(flag)
    before = paged_decode_attention_plain.launches
    got = paged_decode_attention(
        _t(q), pk, pv, _t(lengths), _t(TABLES), _t(starts), pflag, **kw
    ).numpy()
    assert paged_decode_attention_plain.launches == before + 1  # a CPU tensor: the plain version
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(twin), atol=TOL, rtol=0)


def _chunk_grids(q_starts, chunk, pads, width):
    q_pos = q_starts[:, None] + np.arange(chunk)[None, :] - pads[:, None]
    k_pos = np.arange(width)[None, :] - pads[:, None]
    k_pos = np.where(k_pos < 0, SENTINEL, k_pos)
    return jnp.asarray(q_pos, jnp.int32), jnp.asarray(k_pos, jnp.int32)


# (q_starts, chunk): a cold prefill from slot 0, a warm suffix window at its
# start, and a verify-shaped chunk at the shared slot.
CHUNK_SHAPES = {
    "cold": ([0, 0, 0], 160),
    "suffix": ([128, 128, 128], 96),
    "verify": ([300, 300, 300], 5),
}


@pytest.mark.parametrize("shape", list(CHUNK_SHAPES))
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("group", [1, 4])
def test_paged_chunk_plain_matches_jax(group, hd, shape):
    rng = np.random.default_rng(7 * group + hd)
    n_kv = 2
    kp, vp = _pool(rng, 10, n_kv, hd)
    q_starts_l, chunk = CHUNK_SHAPES[shape]
    q_starts = np.array(q_starts_l, np.int32)
    lengths = q_starts + chunk
    # Row 1's pad lies beyond some of its queries: those rows see no key.
    pads = np.array([3, 150, 0], np.int32)
    tables = TABLES.copy()
    tables[1, 2] = -1 if lengths[1] <= 2 * PS else 4
    q = rng.normal(size=(3, chunk, n_kv * group, hd)).astype(np.float32)
    for knobs in ({}, {"window": 64, "softcap": 25.0}):
        flag = jnp.asarray(True) if knobs else None
        want = jax_paged_chunk(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(q_starts),
            jnp.asarray(lengths), jnp.asarray(pads), jnp.asarray(tables), flag, **knobs,
        )
        pk, pv = _port_pool(kp, vp)
        got = paged_chunk_attention(
            _t(q), pk, pv, _t(q_starts), _t(lengths), _t(pads), _t(tables),
            None if flag is None else torch.tensor(True), **knobs,
        ).numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)
        q_pos, k_pos = _chunk_grids(q_starts, chunk, pads, tables.shape[1] * PS)
        twin = np.asarray(jax_paged_chunk_xla(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), q_pos, k_pos, jnp.asarray(tables),
            window_flag=flag, **knobs,
        ))
        # The twin computes clamped garbage for queries below their pad;
        # everything else must agree.
        for r in range(3):
            lo = max(0, int(pads[r] - q_starts[r]))
            np.testing.assert_allclose(got[r, lo:], twin[r, lo:], atol=TOL, rtol=0)


def test_paged_chunk_query_below_its_pad_is_exactly_zero():
    rng = np.random.default_rng(5)
    kp, vp = _pool(rng, 4, 2, 64)
    pk, pv = _port_pool(kp, vp)
    q = _t(rng.normal(size=(1, 40, 4, 64)).astype(np.float32))
    out = paged_chunk_attention_plain(
        q, pk, pv, torch.zeros(1, dtype=torch.int32), torch.full((1,), 40, dtype=torch.int32),
        torch.full((1,), 25, dtype=torch.int32), torch.tensor([[2]], dtype=torch.int32),
    )
    assert torch.equal(out[:, :25], torch.zeros_like(out[:, :25]))
    assert torch.isfinite(out).all() and out[:, 25:].abs().sum() > 0


def test_paged_plain_equals_dense_plain_bitwise():
    """Gathering pages rebuilds the dense layout at every mapped slot, so the
    paged plain versions are the dense plain arithmetic on equal widths."""
    from cake_tpu_torch.ops.chunk_prefill import chunk_prefill_attention_plain
    from cake_tpu_torch.ops.decode_attention import decode_attention_plain

    rng = np.random.default_rng(9)
    kp, vp = _pool(rng, 10, 2, 64)
    pk, pv = _port_pool(kp, vp)
    tables = _t(TABLES)
    dk, dv = P.gather_pages(pk, tables), P.gather_pages(pv, tables)
    lengths = _t(np.array([300, 200, 384], np.int32))
    starts = _t(np.array([0, 70, 130], np.int32))
    q1 = _t(rng.normal(size=(3, 1, 8, 64)).astype(np.float32))
    assert torch.equal(
        paged_decode_attention(q1, pk, pv, lengths, tables, starts),
        decode_attention_plain(q1, dk, dv, lengths, starts),
    )
    qc = _t(rng.normal(size=(3, 64, 8, 64)).astype(np.float32))
    q_starts = _t(np.array([100, 100, 300], np.int32))
    assert torch.equal(
        paged_chunk_attention(qc, pk, pv, q_starts, q_starts + 64, starts, tables),
        chunk_prefill_attention_plain(qc, dk, dv, q_starts, q_starts + 64, None, starts),
    )


def test_kernel_page_rule():
    assert paged_kernel_supported(128) and paged_kernel_supported(256)
    assert not paged_kernel_supported(64) and not paged_kernel_supported(0)
