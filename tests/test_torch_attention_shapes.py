"""The plain versions of the four attention kernels and the ingest at the
shapes the sparse-MoE and Phi-3 families bring: head dim 96 (Phi-3-mini)
and GQA groups above 8 (12, 16 and 32; Qwen3-235B-A22B has 64 query heads
over 4 KV heads), against the JAX package's Pallas kernels in interpret
mode, on the CPU.

Inputs come from numpy with a fixed seed, in f32, through both packages;
attention within 2e-5 max-abs (XLA and torch reduce in different orders).
The ingest is bitwise against the JAX package's twin evaluated op by op and
within 2e-6 of its interpret kernel (which XLA contracts into FMAs, as
tests/test_torch_fusion.py sets out), v bitwise against both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.ops.pallas.chunk_prefill import chunk_prefill_attention as jax_chunk
from cake_tpu.ops.pallas.decode_attention import decode_attention as jax_decode
from cake_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from cake_tpu.ops.pallas.fused_ingest import fused_qkv_ingest as jax_ingest
from cake_tpu.ops.pallas.paged_attention import paged_decode_attention as jax_paged_decode
from cake_tpu.ops.pallas.paged_prefill import paged_chunk_attention as jax_paged_chunk
from cake_tpu_torch.ops.chunk_prefill import chunk_prefill_attention
from cake_tpu_torch.ops.decode_attention import HEAD_DIMS, decode_attention, max_heads, plan
from cake_tpu_torch.ops.flash_attention import flash_attention
from cake_tpu_torch.ops.fused_ingest import fused_qkv_ingest
from cake_tpu_torch.ops.paged_attention import paged_decode_attention
from cake_tpu_torch.ops.paged_prefill import paged_chunk_attention
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)

ATOL = 2e-5
# (head_dim, query heads, KV heads): Phi-3-mini's head dim, then groups 12,
# 16 and 32 (one pass of 16 heads at most, then two).
SHAPES = [(96, 4, 4), (96, 8, 2), (64, 24, 2), (128, 16, 1), (64, 64, 2), (96, 32, 1)]
IDS = [f"hd{hd}-g{nq // nkv}" for hd, nq, nkv in SHAPES]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("hd,n_q,n_kv", SHAPES, ids=IDS)
@pytest.mark.parametrize("win,softcap", [(None, None), (48, 20.0)], ids=["plain", "window"])
def test_decode_plain_matches_pallas(hd, n_q, n_kv, win, softcap):
    rng = np.random.default_rng(hd + n_q)
    b, max_seq = 3, 256
    q, k, v = _rand(rng, b, 1, n_q, hd), _rand(rng, b, n_kv, max_seq, hd), \
        _rand(rng, b, n_kv, max_seq, hd)
    lengths = np.asarray([1, 130, 256], np.int32)
    starts = np.asarray([0, 37, 3], np.int32)
    ref = jax_decode(*map(jnp.asarray, (q, k, v, lengths, starts)), None, window=win,
                     softcap=softcap, interpret=True)
    out = decode_attention(*_t(q, k, v, lengths, starts), window=win, softcap=softcap)
    _close(out, ref)


@pytest.mark.parametrize("hd,n_q,n_kv", SHAPES, ids=IDS)
def test_chunk_and_flash_plain_match_pallas(hd, n_q, n_kv):
    rng = np.random.default_rng(2 * hd + n_q)
    b, max_seq, chunk = 2, 160, 40
    q, k, v = _rand(rng, b, chunk, n_q, hd), _rand(rng, b, n_kv, max_seq, hd), \
        _rand(rng, b, n_kv, max_seq, hd)
    qs = np.asarray([60, 10], np.int32)
    lengths = qs + chunk
    ks = np.asarray([0, 7], np.int32)
    for win, flag in ((None, None), (24, True)):
        ref = jax_chunk(*map(jnp.asarray, (q, k, v, qs, lengths)),
                        None if flag is None else jnp.bool_(flag), jnp.asarray(ks),
                        window=win, interpret=True)
        out = chunk_prefill_attention(*_t(q, k, v, qs, lengths),
                                      None if flag is None else torch.tensor(flag),
                                      torch.from_numpy(ks), window=win)
        _close(out, ref)
    fk, fv = _rand(rng, b, chunk, n_kv, hd), _rand(rng, b, chunk, n_kv, hd)
    ref = jax_flash(*map(jnp.asarray, (q, fk, fv)), None, window=16, softcap=25.0,
                    interpret=True)
    _close(flash_attention(*_t(q, fk, fv), None, window=16, softcap=25.0), ref)


def _jax_pool(rng, n_pages, n_kv, ps, hd):
    return _rand(rng, n_pages, n_kv, ps, hd), _rand(rng, n_pages, n_kv, ps, hd)


def _port_pool(kp, vp):
    """The port's pool carries one more page, the write sink."""
    sink = np.zeros((1, *kp.shape[1:]), np.float32)
    return _t(np.concatenate([kp, sink]), np.concatenate([vp, sink]))


@pytest.mark.parametrize("hd,n_q,n_kv", SHAPES, ids=IDS)
def test_paged_plain_match_pallas(hd, n_q, n_kv):
    rng = np.random.default_rng(3 * hd + n_q)
    b, ps, n_pages = 2, 128, 6
    kp, vp = _jax_pool(rng, n_pages, n_kv, ps, hd)
    tables = np.asarray([[3, 0, 5], [4, 1, -1]], np.int32)
    k, v = _port_pool(kp, vp)
    # decode: row 1 ends before its unmapped entry
    q = _rand(rng, b, 1, n_q, hd)
    lengths = np.asarray([300, 200], np.int32)
    starts = np.asarray([0, 5], np.int32)
    ref = jax_paged_decode(*map(jnp.asarray, (q, kp, vp, lengths, tables, starts)),
                           interpret=True)
    _close(paged_decode_attention(*_t(q), k, v, *_t(lengths, tables, starts)), ref)
    # a chunk of 12 queries at slots 130..141 over the cached prefix
    qc = _rand(rng, b, 12, n_q, hd)
    qs = np.asarray([130, 130], np.int32)
    lengths = qs + 12
    pads = np.asarray([0, 9], np.int32)
    ref = jax_paged_chunk(*map(jnp.asarray, (qc, kp, vp, qs, lengths, pads, tables)),
                          interpret=True)
    _close(paged_chunk_attention(*_t(qc), k, v, *_t(qs, lengths, pads, tables)), ref)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("n_q,n_kv", [(32, 32), (8, 2)], ids=["phi3", "gqa"])
def test_ingest_plain_at_head_dim_96_matches_jax(n_q, n_kv, jax_impl, paged):
    rng = np.random.default_rng(n_q)
    b, hd, slot = 3, 96, 21
    qkv = _rand(rng, b, 1, (n_q + 2 * n_kv) * hd)
    cos, sin = _rand(rng, b, 1, hd // 2), _rand(rng, b, 1, hd // 2)
    kw = dict(n_q=n_q, n_kv=n_kv)
    if paged:
        kp, vp = _jax_pool(rng, 7, n_kv, 8, hd)
        tab = np.asarray([[3, 5, -1], [6, 2, 0], [-1, 4, 1]], np.int32)
        jq, jk, jv = jax_ingest(*map(jnp.asarray, (qkv, cos, sin)), jnp.int32(slot),
                                jnp.asarray(kp), jnp.asarray(vp), block_tables=jnp.asarray(tab),
                                impl=jax_impl, interpret=True, **kw)
        k, v = _port_pool(kp, vp)
        q = fused_qkv_ingest(*_t(qkv, cos, sin), slot, k, v, block_tables=torch.from_numpy(tab),
                             **kw)
        k, v = k[:-1], v[:-1]  # the sink aside
    else:
        base = _rand(rng, b, n_kv, 32, hd)
        jq, jk, jv = jax_ingest(*map(jnp.asarray, (qkv, cos, sin)), jnp.int32(slot),
                                jnp.asarray(base), jnp.asarray(base + 1.0), impl=jax_impl,
                                interpret=True, **kw)
        k, v = _t(base, base + 1.0)
        q = fused_qkv_ingest(*_t(qkv, cos, sin), slot, k, v, **kw)
    tol = dict(atol=0.0 if jax_impl == "xla" else 2e-6, rtol=0)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), **tol)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **tol)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("group", [1, 4, 8, 12, 16, 17, 32, 48])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_decode_plan_cuts_large_groups_into_passes(group, hd):
    """A block takes at most max_heads(hd) query heads; larger groups run in
    the fewest passes, of equal size but the last, and the scratch holds
    every unit's partials."""
    n_kv, b, limit = 4, 2, 1024
    p = plan(b, n_kv, group, hd, limit)
    passes = p.units // n_kv
    assert p.heads <= max_heads(hd) and passes == -(-group // max_heads(hd))
    assert (passes - 1) * p.heads < group <= passes * p.heads
    assert p.scratch == b * p.units * p.n_split * p.heads * (hd + 2)
    if group <= max_heads(hd):
        assert (p.heads, p.units) == (group, n_kv)
