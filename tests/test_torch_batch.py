"""The port's lockstep batch forward (``models/llama/batch.py``) against the
JAX package's, at a tiny config in f32 on the CPU.

The logits of the dense prefill, the paged prefill, the paged suffix
prefill and one decode step match the JAX functions within 1e-3; greedy
lockstep streams of three ragged prompts equal the JAX package's
``lockstep_decode`` token for token, dense and paged; and on the port's
plain path the paged forward is the dense forward bit for bit, as
tests/test_paged_serving.py pins it for the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models.llama import batch as JB
from cake_tpu.models.llama import model as JM
from cake_tpu.models.llama import paged_cache as JP
from cake_tpu.models.llama.cache import init_cache as jax_init_cache
from cake_tpu.models.llama.config import LlamaConfig as JaxConfig
from cake_tpu.models.llama.generator import SamplingConfig as JaxSampling
from cake_tpu_torch.models.llama import batch as B
from cake_tpu_torch.models.llama import model as M
from cake_tpu_torch.models.llama.cache import init_cache
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import SamplingConfig
from cake_tpu_torch.models.llama.paged_cache import PageAllocator, gather_pages, init_paged_cache
from cake_tpu_torch.ops.rope import model_rope_tables
from cake_tpu_torch.ops.threefry import prng_key
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)

MAX_SEQ = 256
PAGE = 16
LOGIT_TOL = 1e-3
GREEDY = dict(temperature=0.0, repeat_penalty=1.0)
RNG = np.random.default_rng(0)
# Three ragged prompts over the tiny byte vocab: pads 29, 0 and 17.
PROMPTS = [list(RNG.integers(0, 256, n)) for n in (19, 48, 31)]


@pytest.fixture(scope="module")
def model():
    jcfg = JaxConfig.tiny(num_hidden_layers=2)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(11), jnp.float32)
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    params = M.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, jparams, cfg, params


def _paged_setup(cfg, pads, end, n_pages=48):
    """A pool and block tables mapping each row's [pad, end) from a shuffled
    free list (the LIFO allocator hands out high pages first)."""
    alloc = PageAllocator(n_pages, PAGE, len(pads), MAX_SEQ // PAGE)
    for r, p in enumerate(pads):
        alloc.map_range(r, int(p), end)
    kv = init_paged_cache(
        cfg.num_hidden_layers, n_pages, cfg.num_key_value_heads, PAGE, cfg.head_dim,
        torch.float32,
    )
    return alloc, kv


def _jax_paged_kv(jcfg, n_pages):
    return JP.init_paged_cache(
        jcfg.num_hidden_layers, n_pages, jcfg.num_key_value_heads, PAGE, jcfg.head_dim,
        jnp.float32,
    )


def test_prefill_and_decode_logits_match_jax(model):
    jcfg, jparams, cfg, params = model
    tokens, pads, bucket = B.layout_prompts(PROMPTS, MAX_SEQ)
    jkv = jax_init_cache(jcfg.num_hidden_layers, 3, MAX_SEQ, jcfg.num_key_value_heads,
                         jcfg.head_dim, jnp.float32)
    jlogits, jkv = JB.batched_prefill(jparams, jnp.asarray(tokens), jkv, jnp.asarray(pads), jcfg)
    kv = init_cache(cfg.num_hidden_layers, 3, MAX_SEQ, cfg.num_key_value_heads, cfg.head_dim,
                    torch.float32)
    logits, kv = B.batched_prefill(params, torch.as_tensor(tokens), kv, torch.as_tensor(pads), cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGIT_TOL, rtol=0)

    tok = np.asarray(jlogits).argmax(-1)
    jfwd = JB.batched_forward_one(jparams, jnp.asarray(pads), jcfg, MAX_SEQ)
    jstep, _ = jfwd(jnp.asarray(tok, jnp.int32)[:, None], jkv, jnp.int32(bucket))
    fwd = B.batched_forward_one(params, torch.as_tensor(pads), cfg,
                                model_rope_tables(cfg, MAX_SEQ))
    step, _ = fwd(torch.as_tensor(tok)[:, None], kv, bucket)
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), atol=LOGIT_TOL, rtol=0)


def test_paged_prefill_and_suffix_logits_match_jax(model):
    jcfg, jparams, cfg, params = model
    tokens, pads, bucket = B.layout_prompts(PROMPTS, MAX_SEQ)
    alloc, kv = _paged_setup(cfg, pads, bucket + 8)
    tables = alloc.block_tables
    jkv = _jax_paged_kv(jcfg, alloc.n_pages)
    jlogits, jkv = JB.paged_prefill(
        jparams, jnp.asarray(tokens), jkv, jnp.asarray(pads), jnp.asarray(tables), jcfg
    )
    logits, kv = B.paged_prefill(
        params, torch.as_tensor(tokens), kv, torch.as_tensor(pads), torch.as_tensor(tables), cfg
    )
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGIT_TOL, rtol=0)
    # The pools agree at every live slot (pad slots hold garbage nobody reads:
    # the JAX package ropes them at its sentinel position, the port at 0).
    for layer in range(cfg.num_hidden_layers):
        got = gather_pages(kv.k[layer], torch.as_tensor(tables)).numpy()
        want = np.asarray(JP.gather_pages(jkv.k[layer], jnp.asarray(tables)))
        for r, p in enumerate(pads):
            np.testing.assert_allclose(got[r, :, p:bucket], want[r, :, p:bucket], atol=1e-5, rtol=0)

    # A warm suffix window over the prefix just written: only [start, bucket)
    # is recomputed, every write below it sinks.
    start = bucket - 16
    ws = np.full((3,), start, np.int32)
    jsuf, _ = JB.paged_suffix_prefill(
        jparams, jnp.asarray(tokens[:, start:]), jkv, jnp.asarray(pads), jnp.asarray(ws),
        jnp.asarray(tables), jcfg, jnp.int32(start),
    )
    suf, _ = B.paged_suffix_prefill(
        params, torch.as_tensor(tokens[:, start:]), kv, torch.as_tensor(pads),
        torch.as_tensor(ws), torch.as_tensor(tables), cfg, start,
    )
    np.testing.assert_allclose(suf.numpy(), np.asarray(jsuf), atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(suf.numpy(), logits.numpy(), atol=LOGIT_TOL, rtol=0)


def _port_lockstep(cfg, params, paged: bool, n_chunks: int, chunk: int = 4, penalty=1.0):
    """Prefill, first sample, ``n_chunks`` decode chunks: the raw ids [3, 1 +
    n_chunks * chunk], as the JAX package's ``lockstep_decode`` hands them over)."""
    s = SamplingConfig(temperature=0.0, repeat_penalty=penalty, repeat_last_n=8)
    tokens, pads, bucket = B.layout_prompts(PROMPTS, MAX_SEQ)
    pads_t = torch.as_tensor(pads)
    rope = model_rope_tables(cfg, MAX_SEQ)
    if paged:
        alloc, kv = _paged_setup(cfg, pads, bucket + n_chunks * chunk)
        tables = torch.as_tensor(alloc.block_tables)
        logits, kv = B.paged_prefill(params, torch.as_tensor(tokens), kv, pads_t, tables, cfg,
                                     rope=rope)
    else:
        kv = init_cache(cfg.num_hidden_layers, 3, MAX_SEQ, cfg.num_key_value_heads,
                        cfg.head_dim, torch.float32)
        logits, kv = B.batched_prefill(params, torch.as_tensor(tokens), kv, pads_t, cfg, rope=rope)
    ring, ring_idx = B.seed_rings(PROMPTS, s.repeat_last_n)
    first, keys, ring, ring_idx = B.first_sample(logits, s, ring, ring_idx, prng_key([0] * 3))
    out = [torch.as_tensor(first, dtype=torch.int64)[:, None]]
    tok, slot = out[0][:, 0], bucket
    ring_t, ring_idx_t = torch.as_tensor(ring, dtype=torch.int64), torch.as_tensor(ring_idx).long()
    for _ in range(n_chunks):
        if paged:
            toks, kv, keys, ring_t, ring_idx_t = B.paged_decode_chunk(
                params, kv, tok, slot, pads_t, tables, keys, ring_t, ring_idx_t, cfg, chunk, s, rope
            )
        else:
            toks, kv, keys, ring_t, ring_idx_t = B.decode_chunk(
                params, kv, tok, slot, pads_t, keys, ring_t, ring_idx_t, cfg, chunk, s, rope
            )
        out.append(toks)
        tok, slot = toks[:, -1], slot + chunk
    return torch.cat(out, dim=1).numpy()


def _jax_lockstep(jcfg, jparams, n_chunks: int, chunk: int = 4, penalty=1.0):
    got = []

    def on_tokens(toks):
        got.append(np.asarray(toks))
        return len(got) <= n_chunks

    JB.lockstep_decode(
        jcfg, jparams, PROMPTS,
        JaxSampling(temperature=0.0, repeat_penalty=penalty, repeat_last_n=8), max_seq_len=MAX_SEQ,
        cache_dtype=jnp.float32, decode_chunk_size=chunk, on_tokens=on_tokens,
        row_keys=jnp.stack([jax.random.PRNGKey(0)] * 3),
    )
    return np.concatenate(got, axis=1)


@pytest.mark.parametrize("penalty", [1.0, 1.3])
def test_greedy_lockstep_streams_match_jax_dense_and_paged(model, penalty):
    """With a repeat penalty the per-row rings (seeded from each prompt's
    tail, advanced on the device every step) steer the streams too."""
    jcfg, jparams, cfg, params = model
    want = _jax_lockstep(jcfg, jparams, n_chunks=4, penalty=penalty)
    dense = _port_lockstep(cfg, params, paged=False, n_chunks=4, penalty=penalty)
    paged = _port_lockstep(cfg, params, paged=True, n_chunks=4, penalty=penalty)
    np.testing.assert_array_equal(dense, want)
    np.testing.assert_array_equal(paged, want)


def test_sample_step_matches_jax_greedy_with_penalty():
    from cake_tpu.models.llama.fused import sample_step as jax_sample_step
    from cake_tpu_torch.ops.sampling import sample_step

    rng = np.random.default_rng(3)
    logits = rng.normal(size=(3, 40)).astype(np.float32)
    logits[0, 7] = logits[0].max() + 0.01  # row 0's argmax was seen: the penalty moves it
    ring = np.array([[7, 2, -1, -1], [1, 2, 3, 4], [-1, -1, -1, -1]], np.int32)
    ring_idx = np.array([2, 0, 0], np.int32)
    jkeys = jnp.stack([jax.random.PRNGKey(i) for i in range(3)])
    want = jax_sample_step(
        jnp.asarray(logits), jkeys, jnp.asarray(ring), jnp.asarray(ring_idx),
        temperature=0.0, top_k=None, top_p=None, repeat_penalty=1.3,
    )
    got = sample_step(
        torch.as_tensor(logits), prng_key([0, 1, 2]), torch.as_tensor(ring).long(),
        torch.as_tensor(ring_idx).long(), temperature=0.0, top_k=None, top_p=None,
        repeat_penalty=1.3,
    )
    for g, w in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0][0].item() != 7


def test_per_row_draws_do_not_depend_on_the_batch():
    """A row's sampled draw depends on its own key only (the serving
    engine's reproducibility contract), and splitting advances it as the
    JAX package's ``vmap(split)`` does."""
    from cake_tpu_torch.ops.sampling import sample_per_row
    from cake_tpu_torch.ops.threefry import split

    logits = torch.as_tensor(np.random.default_rng(4).normal(size=(4, 64)).astype(np.float32))
    seeds = [11, 22, 33, 44]
    keys = prng_key(seeds)
    batch = sample_per_row(logits, keys, temperature=0.9, top_k=20)
    for r in range(4):
        solo = sample_per_row(logits[r : r + 1], keys[r : r + 1], temperature=0.9, top_k=20)
        assert solo.item() == batch[r].item()
    nxt, sub = split(keys)
    pair = jax.vmap(jax.random.split)(jnp.stack([jax.random.PRNGKey(s) for s in seeds]))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(pair[:, 0]).astype(np.int64))
    np.testing.assert_array_equal(sub.numpy(), np.asarray(pair[:, 1]).astype(np.int64))
    draws = {tuple(sample_per_row(logits, k, temperature=5.0).tolist())
             for k in (keys, nxt, split(nxt)[0])}
    assert len(draws) > 1  # the stream moves


def test_paged_forward_is_the_dense_forward_bitwise(model):
    """Same widths (max_seq 256 = 16 pages of 16): the gathered views are
    the dense cache at every live slot, so logits agree to the bit."""
    _, _, cfg, params = model
    tokens, pads, bucket = B.layout_prompts(PROMPTS, MAX_SEQ)
    rope = model_rope_tables(cfg, MAX_SEQ)
    kv = init_cache(cfg.num_hidden_layers, 3, MAX_SEQ, cfg.num_key_value_heads, cfg.head_dim,
                    torch.float32)
    dl, kv = B.batched_prefill(params, torch.as_tensor(tokens), kv, torch.as_tensor(pads), cfg,
                               rope=rope)
    alloc, pkv = _paged_setup(cfg, pads, MAX_SEQ)
    tables = torch.as_tensor(alloc.block_tables)
    pl, pkv = B.paged_prefill(params, torch.as_tensor(tokens), pkv, torch.as_tensor(pads), tables,
                              cfg, rope=rope)
    assert torch.equal(dl, pl)
    tok = dl.argmax(-1)[:, None]
    d1, _ = B.batched_forward_one(params, torch.as_tensor(pads), cfg, rope)(tok, kv, bucket)
    p1, _ = B.paged_forward_one(params, torch.as_tensor(pads), tables, cfg, rope)(tok, pkv, bucket)
    assert torch.equal(d1, p1)


def test_position_helpers():
    pads = torch.tensor([2, 0], dtype=torch.int32)
    q_pos, lengths = B.prefill_positions(6, pads, torch.tensor([5, 6], dtype=torch.int32))
    assert q_pos.tolist() == [[0, 0, 0, 1, 2, 0], [0, 1, 2, 3, 4, 5]]
    assert lengths.tolist() == [5, 6]
    q_pos, lengths = B.decode_positions(9, pads)
    assert q_pos.tolist() == [[7], [9]] and lengths.tolist() == [10, 10]
    q_pos, lengths = B.verify_positions(3, pads, 1)
    assert q_pos.tolist() == [[-1, 0, 1], [1, 2, 3]] and lengths.tolist() == [4, 4]
    assert B.prompt_bucket(17, 256) == 32 and B.prompt_bucket(250, 256) == 256


def test_unported_branches_raise(model):
    _, _, cfg, params = model
    kv = init_cache(cfg.num_hidden_layers, 1, 32, cfg.num_key_value_heads, cfg.head_dim,
                    torch.float32)
    x = torch.zeros(1, 1, cfg.hidden_size)
    rope = model_rope_tables(cfg, 128)
    args = (params["layers"], x, kv, *rope, torch.zeros(1, 1, dtype=torch.long), cfg)
    kw = dict(decode=True, pads=torch.zeros(1, dtype=torch.int32),
              lengths=torch.ones(1, dtype=torch.int32), write_pos=0)
    for extra in ({"tp_axis": "tp"}, {"row_offset": 0}, {"valid": torch.ones(2, dtype=bool)}):
        with pytest.raises(NotImplementedError):
            B.batched_blocks_forward(*args, **kw, **extra)
