"""The decode chunk as one CUDA graph (``models/llama/fused.py``
``DecodeChunk``), held on the CPU, where it runs its loop uncaptured.

A tiny model from a numpy seed (the JAX package's init, moved over), in bf16
and with int4 weights (every product through ``int4_matmul_plain``), dense,
paged and the generator's step, under the decode fusions ``none``,
``ingest,tail`` and ``all`` (plain versions on the CPU):

  * the one-token forward with the slot as a 0-d tensor is the forward with
    the slot as a host int, logits and KV to the bit;
  * the step the graph captures, run from its static buffers over chunks at
    moving slots (a page-table change between them, paged), is
    ``sampled_decode_loop`` with a host-int slot to the bit: ids, KV and the
    carries, with per-row threefry keys and with one shared key, greedy and
    sampled;
  * greedy streams equal the JAX package's ``decode_scan`` (the generator's
    fused decode), ``_decode_fn`` and ``_paged_decode_fn`` (the engine's),
    token for token, as the existing engine and generator tests hold them;
  * replay safety, the CPU stand-in for a capture: a ``TorchDispatchMode``
    records the step's ops (op, shapes, dtypes, every non-tensor argument)
    at two different slots, pads, block tables, ring contents and keys. The
    two sequences must be the same (a Python value baked into a graph shows
    up as a differing argument), with no host read among them;
  * ``fused_qkv_ingest_plain`` with the slot as a 0-d tensor equals the
    Pallas ingest in interpret mode, dense and paged, at the tolerances of
    tests/test_torch_fusion.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cake_tpu.models.llama import batch as JB
from cake_tpu.models.llama import model as JM
from cake_tpu.models.llama import paged_cache as JP
from cake_tpu.models.llama.cache import init_cache as jax_init_cache
from cake_tpu.models.llama.config import LlamaConfig as JaxConfig
from cake_tpu.models.llama.fused import decode_scan as jax_decode_scan
from cake_tpu.ops.pallas.fused_ingest import fused_qkv_ingest as jax_ingest
from cake_tpu_torch.models.llama import batch as B
from cake_tpu_torch.models.llama import model as M
from cake_tpu_torch.models.llama.cache import KVCache
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.fused import DecodeChunk, sampled_decode_loop
from cake_tpu_torch.models.llama.generator import LocalForwardStep, SamplingConfig
from cake_tpu_torch.models.llama.paged_cache import PagedKVCache
from cake_tpu_torch.ops.fuse import resolve_fusion
from cake_tpu_torch.ops.fused_ingest import fused_qkv_ingest_plain
from cake_tpu_torch.ops.quant import quantize_params
from cake_tpu_torch.ops.threefry import prng_key
from cake_tpu_torch.runtime.batch_backend import LocalBatchBackend, PagedLocalBackend
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)

MAX_SEQ = 128
PAGE = 8
CHUNK = 4
WINDOW = 8
RNG = np.random.default_rng(21)
# Three ragged prompts over the tiny vocab: left pads 13, 0 and 6.
PROMPTS = [list(RNG.integers(0, 512, n)) for n in (19, 32, 26)]
GREEDY = SamplingConfig(temperature=0.0, repeat_penalty=1.3, repeat_last_n=WINDOW)
SAMPLED = SamplingConfig(temperature=0.8, top_k=20, repeat_penalty=1.1, repeat_last_n=WINDOW,
                         seed=5)
KNOBS = {"greedy": GREEDY, "sampled": SAMPLED}
FUSIONS = ["none", "ingest,tail", "all"]
MODES = ["dense", "paged", "generator"]


@pytest.fixture(scope="module")
def jax_model():
    jcfg = JaxConfig.tiny(num_hidden_layers=2)
    return jcfg, JM.init_params(jcfg, jax.random.PRNGKey(17), jnp.float32)


def _port_params(jax_model, dtype: str):
    """The JAX package's tree moved over: f32, bf16, or int4 weights over
    bf16 activations."""
    tree = M.params_from_jax(jax.tree_util.tree_map(np.asarray, jax_model[1]))
    if dtype == "f32":
        return tree
    cast = jax.tree_util.tree_map(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t, tree)
    return quantize_params(cast, "int4") if dtype == "int4" else cast


def _config(fusion: str) -> LlamaConfig:
    return dataclasses.replace(LlamaConfig.tiny(num_hidden_layers=2), fusion_impl=fusion)


def _dtype(params) -> torch.dtype:
    return params["embed"].dtype


def _clone_kv(kv):
    return type(kv)(kv.k.clone(), kv.v.clone())


def _engine(mode: str, cfg, params):
    """A backend with the three prompts prefilled and their first tokens
    sampled: (backend, kv, carries dict, slot)."""
    dt = _dtype(params)
    if mode == "paged":
        be = PagedLocalBackend(cfg, params, max_seq_len=MAX_SEQ, cache_dtype=dt, page_size=PAGE,
                               max_pages=32, device="cpu")
    else:
        be = LocalBatchBackend(cfg, params, max_seq_len=MAX_SEQ, cache_dtype=dt, device="cpu")
    tokens, pads, bucket = B.layout_prompts(PROMPTS, MAX_SEQ)
    with torch.inference_mode():
        kv = be.init_kv(len(PROMPTS))
        if mode == "paged":
            for lane, pad in enumerate(pads):
                be.allocator.map_range(lane, int(pad), bucket + CHUNK)
        logits, kv = be.prefill(tokens, kv, pads)
        ring, ring_idx = B.seed_rings(PROMPTS, WINDOW)
        first, keys, ring, ring_idx = B.first_sample(
            logits, GREEDY, ring, ring_idx, prng_key([7, 8, 9]))
    carries = {"tok": torch.as_tensor(first, dtype=torch.int64), "pads": torch.as_tensor(pads),
               "keys": keys, "ring": torch.as_tensor(ring, dtype=torch.int64),
               "ring_idx": torch.as_tensor(ring_idx, dtype=torch.int64)}
    return be, kv, carries, bucket


def _generator_state(cfg, params):
    """A generator step with one prompt prefilled: (step, last token, pos)."""
    step = LocalForwardStep(cfg, params, max_seq_len=MAX_SEQ, cache_dtype=_dtype(params),
                            device="cpu")
    prompt = np.asarray([PROMPTS[0]], np.int64)
    logits = step(prompt, 0, prompt.shape[1])
    return step, int(logits.argmax(-1)[0]), prompt.shape[1]


def _forward_one(mode: str, be_or_step, carries=None, tables=None):
    if mode == "generator":
        step = be_or_step

        def forward_one(tok, kv, p):
            return M.forward(step.params, tok, kv, p, 1, step.config, rope=step._rope)

        return forward_one
    be = be_or_step
    if mode == "paged":
        return B.paged_forward_one(be.params, carries["pads"], tables, be.config, be.rope)
    return B.batched_forward_one(be.params, carries["pads"], be.config, be.rope)


# ------------------------------------------------------------- the forward


@pytest.mark.parametrize("dtype", ["bf16", "int4"])
@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("mode", MODES)
def test_forward_with_a_device_slot_is_the_int_forward(jax_model, mode, fusion, dtype):
    cfg = _config(fusion)
    params = _port_params(jax_model, dtype)
    with torch.inference_mode():
        if mode == "generator":
            step, last, slot = _generator_state(cfg, params)
            kv, fwd, tok = step._kv, _forward_one(mode, step), torch.tensor([last])
        else:
            be, kv, carries, slot = _engine(mode, cfg, params)
            tables = torch.as_tensor(be.allocator.block_tables) if mode == "paged" else None
            fwd, tok = _forward_one(mode, be, carries, tables), carries["tok"]
        kv_int, kv_dev = _clone_kv(kv), _clone_kv(kv)
        want, _ = fwd(tok[:, None], kv_int, slot)
        got, _ = fwd(tok[:, None], kv_dev, torch.tensor(slot))
    assert torch.equal(got, want)
    assert torch.equal(kv_dev.k, kv_int.k) and torch.equal(kv_dev.v, kv_int.v)
    assert not torch.equal(kv_int.k, kv.k)  # the step wrote its slot


# ------------------------------------------------ the captured step, eagerly


def _assert_kv_equal(a, b):
    assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)


@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("dtype", ["bf16", "int4"])
@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_engine_chunks_equal_the_eager_loop(jax_model, mode, fusion, dtype, knobs):
    """Three chunks through the backend's DecodeChunk (per-row keys; paged:
    a page mapped between chunks 1 and 2 changes the table) against
    ``batch.decode_chunk`` / ``paged_decode_chunk`` on a clone of the
    cache, with the slot a host int."""
    cfg = _config(fusion)
    s = KNOBS[knobs]
    be, kv, c, slot = _engine(mode, cfg, _port_params(jax_model, dtype))
    ref_kv = _clone_kv(kv)
    tok, keys, ring, ring_idx = c["tok"], c["keys"], c["ring"], c["ring_idx"]
    r_tok, r_keys, r_ring, r_idx = tok.clone(), keys.clone(), ring.clone(), ring_idx.clone()
    for i in range(3):
        if mode == "paged" and i == 1:  # two more pages a lane
            for lane in range(len(PROMPTS)):
                be.allocator.map_range(lane, slot, slot + 4 * CHUNK)
        with torch.inference_mode():
            ids, kv, keys, ring, ring_idx = be.decode(
                kv, tok, slot, c["pads"], keys, ring, ring_idx, CHUNK, s)
            if mode == "paged":
                tables = torch.as_tensor(be._host_tables())
                want, ref_kv, r_keys, r_ring, r_idx = B.paged_decode_chunk(
                    be.params, ref_kv, r_tok, slot, c["pads"], tables, r_keys, r_ring, r_idx,
                    cfg, CHUNK, s, be.rope)
            else:
                want, ref_kv, r_keys, r_ring, r_idx = B.decode_chunk(
                    be.params, ref_kv, r_tok, slot, c["pads"], r_keys, r_ring, r_idx, cfg,
                    CHUNK, s, be.rope)
        assert torch.equal(ids, want), (i, ids, want)
        for got, ref in ((keys, r_keys), (ring, r_ring), (ring_idx, r_idx)):
            assert torch.equal(got, ref)
        _assert_kv_equal(kv, ref_kv)
        tok, r_tok, slot = ids[:, -1].clone(), want[:, -1].clone(), slot + CHUNK
    chunks = list(be._chunks.values())
    assert len(chunks) == 1 and chunks[0].graph is None  # one key, never captured on the CPU


@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("dtype", ["bf16", "int4"])
@pytest.mark.parametrize("fusion", ["none", "all"])
def test_generator_chunks_equal_the_eager_loop(jax_model, fusion, dtype, knobs):
    """Three chunks of the step's ``decode_chunk`` (one shared threefry key,
    carried on the device and split in the chunk) against
    ``sampled_decode_loop`` from a copy of the key, on a clone of the cache:
    ids, KV and the advanced key."""
    cfg = _config(fusion)
    s = KNOBS[knobs]
    step, last, pos = _generator_state(cfg, _port_params(jax_model, dtype))
    ref_kv = _clone_kv(step._kv)
    key, ref_key = prng_key(s.seed), prng_key(s.seed)
    fwd = _forward_one("generator", step)
    history = list(PROMPTS[0]) + [last]
    for _ in range(3):
        ring = np.full((1, WINDOW), -1, np.int64)
        recent = history[-WINDOW:]
        ring[0, : len(recent)] = recent
        ring_idx = min(len(history), WINDOW) % WINDOW
        with torch.inference_mode():
            got, key = step.decode_chunk(np.asarray([history[-1]]), pos, CHUNK, s, key, ring,
                                         ring_idx)
            want, ref_kv, ref_key, _, _ = sampled_decode_loop(
                fwd, ref_kv, torch.tensor([history[-1]]), pos, ref_key, torch.from_numpy(ring),
                torch.full((1,), ring_idx, dtype=torch.int64), n_steps=CHUNK, s=s,
                fused_tail="tail" in resolve_fusion(cfg))
        np.testing.assert_array_equal(got, want.numpy())
        history += got[0].tolist()
        pos += CHUNK
    _assert_kv_equal(step._kv, ref_kv)
    assert torch.equal(key, ref_key)
    assert torch.equal(key, prng_key(s.seed)) == (knobs == "greedy")  # sampled steps split it


# ---------------------------------------------------------- against JAX


def _jax_engine_streams(jax_model, mode: str, n_chunks: int, fusion: str):
    jcfg = dataclasses.replace(jax_model[0], fusion_impl=fusion)
    jparams = jax_model[1]
    tokens, pads, bucket = B.layout_prompts(PROMPTS, MAX_SEQ)
    b = len(PROMPTS)
    if mode == "paged":
        tables = np.full((b, MAX_SEQ // PAGE), -1, np.int32)
        tables[:, : MAX_SEQ // PAGE] = np.arange(b * (MAX_SEQ // PAGE)).reshape(b, -1)
        jkv = JP.init_paged_cache(jcfg.num_hidden_layers, b * (MAX_SEQ // PAGE),
                                  jcfg.num_key_value_heads, PAGE, jcfg.head_dim, jnp.float32)
        logits, jkv = JB.paged_prefill(jparams, jnp.asarray(tokens), jkv, jnp.asarray(pads),
                                       jnp.asarray(tables), jcfg)
        fn = JB._paged_decode_fn(jcfg, MAX_SEQ, CHUNK, 0.0, None, None, GREEDY.repeat_penalty)
        extra = (jnp.asarray(pads), jnp.asarray(tables))
    else:
        jkv = jax_init_cache(jcfg.num_hidden_layers, b, MAX_SEQ, jcfg.num_key_value_heads,
                             jcfg.head_dim, jnp.float32)
        logits, jkv = JB.batched_prefill(jparams, jnp.asarray(tokens), jkv, jnp.asarray(pads),
                                         jcfg)
        fn = JB._decode_fn(jcfg, MAX_SEQ, CHUNK, 0.0, None, None, GREEDY.repeat_penalty)
        extra = (jnp.asarray(pads),)
    ring, ring_idx = B.seed_rings(PROMPTS, WINDOW)
    penalized = np.asarray(logits).copy()
    first = []
    for r in range(b):  # the first token: penalty over the prompt ring, argmax
        row = penalized[r]
        seen = np.unique(ring[r][ring[r] >= 0])
        row[seen] = np.where(row[seen] > 0, row[seen] / GREEDY.repeat_penalty,
                             row[seen] * GREEDY.repeat_penalty)
        first.append(int(row.argmax()))
    ring[np.arange(b), ring_idx] = first
    ring_idx = (ring_idx + 1) % WINDOW
    tok, slot = jnp.asarray(first, jnp.int32), bucket
    keys = jnp.stack([jax.random.PRNGKey(0)] * b)
    ring_j, idx_j = jnp.asarray(ring, jnp.int32), jnp.asarray(ring_idx, jnp.int32)
    out = [np.asarray(first)[:, None]]
    for _ in range(n_chunks):
        toks, jkv, keys, ring_j, idx_j = fn(jparams, jkv, tok, jnp.int32(slot), *extra, keys,
                                             ring_j, idx_j)
        out.append(np.asarray(toks))
        tok, slot = toks[:, -1], slot + CHUNK
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("fusion", ["none", "all"])
@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_engine_greedy_streams_match_jax(jax_model, mode, fusion):
    """The backend's DecodeChunk against ``_decode_fn`` / ``_paged_decode_fn``
    (greedy, with a repeat penalty over per-row rings), f32."""
    cfg = _config(fusion)
    be, kv, c, slot = _engine(mode, cfg, _port_params(jax_model, "f32"))
    if mode == "paged":
        for lane in range(len(PROMPTS)):
            be.allocator.map_range(lane, slot, slot + 3 * CHUNK)
    out = [c["tok"][:, None]]
    tok, keys, ring, ring_idx = c["tok"], c["keys"], c["ring"], c["ring_idx"]
    for _ in range(3):
        with torch.inference_mode():
            ids, kv, keys, ring, ring_idx = be.decode(
                kv, tok, slot, c["pads"], keys, ring, ring_idx, CHUNK, GREEDY)
        out.append(ids.clone())
        tok, slot = ids[:, -1].clone(), slot + CHUNK
    got = torch.cat(out, dim=1).numpy()
    np.testing.assert_array_equal(got, _jax_engine_streams(jax_model, mode, 3, fusion))


@pytest.mark.parametrize("fusion", ["none", "all"])
def test_generator_greedy_chunks_match_jax_decode_scan(jax_model, fusion):
    """The step's decode_chunk against the JAX package's ``decode_scan``
    over the same prefilled cache (greedy, penalty ring), f32."""
    jcfg = dataclasses.replace(jax_model[0], fusion_impl=fusion)
    cfg = _config(fusion)
    step, last, pos = _generator_state(cfg, _port_params(jax_model, "f32"))
    prompt = np.asarray([PROMPTS[0]], np.int32)
    jkv = jax_init_cache(jcfg.num_hidden_layers, 1, MAX_SEQ, jcfg.num_key_value_heads,
                         jcfg.head_dim, jnp.float32)
    jlogits, jkv = JM.forward(jax_model[1], jnp.asarray(prompt), jkv, jnp.int32(0),
                              jnp.int32(prompt.shape[1]), jcfg)
    assert int(jnp.argmax(jlogits, -1)[0]) == last
    history = list(PROMPTS[0]) + [last]
    key = jax.random.PRNGKey(0)
    for _ in range(3):
        ring = np.full((1, WINDOW), -1, np.int64)
        recent = history[-WINDOW:]
        ring[0, : len(recent)] = recent
        ring_idx = min(len(history), WINDOW) % WINDOW
        with torch.inference_mode():
            got, _ = step.decode_chunk(np.asarray([history[-1]]), pos, CHUNK, GREEDY,
                                       prng_key(0), ring, ring_idx)
        want, jkv, key, _, _ = jax_decode_scan(
            jax_model[1], jkv, jnp.asarray([history[-1]], jnp.int32), jnp.int32(pos), key,
            jnp.asarray(ring, jnp.int32), jnp.int32(ring_idx), jcfg, n_steps=CHUNK,
            temperature=0.0, top_k=None, top_p=None, repeat_penalty=GREEDY.repeat_penalty)
        np.testing.assert_array_equal(got, np.asarray(want))
        history += got[0].tolist()
        pos += CHUNK


# ------------------------------------------------------------ replay safety

# Ops that read a device value on the host (or depend on one for a shape):
# a captured graph would bake the value in or fail to capture.
HOST_READS = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select", "aten.item",
              "aten.is_nonzero", "aten.equal", "aten.unique")


def _signature(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), str(x.dtype), str(x.device))
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _signature(v)) for k, v in x.items()))
    return repr(x)


class OpLog(TorchDispatchMode):
    """Every op dispatched, with its tensors' shapes and dtypes and every
    other argument's value."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops.append((str(func), _signature(args), _signature(kwargs)))
        return func(*args, **kwargs)


def _recorded_body(chunk: DecodeChunk, **inputs):
    with torch.inference_mode():
        chunk.load(**inputs)
        with OpLog() as log:
            chunk.body()
    return log.ops


@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("mode", MODES)
def test_the_captured_step_bakes_in_no_value(jax_model, mode, fusion, knobs):
    cfg = _config(fusion)
    s = KNOBS[knobs]
    params = _port_params(jax_model, "bf16")
    with torch.inference_mode():
        if mode == "generator":
            step, last, slot = _generator_state(cfg, params)
            chunk = DecodeChunk(_forward_one(mode, step), step._kv, batch=1, window=WINDOW,
                                n_steps=CHUNK, s=s,
                                fused_tail="tail" in resolve_fusion(cfg), per_row=False,
                                device=torch.device("cpu"))
            first = dict(tok=np.asarray([last]), slot=slot, ring=np.full((1, WINDOW), -1),
                         ring_idx=np.zeros(1, np.int64), keys=prng_key(3))
            second = dict(tok=np.asarray([3]), slot=slot + 9, ring=np.arange(WINDOW)[None],
                          ring_idx=np.full(1, 5), keys=prng_key(4))
        else:
            be, kv, c, slot = _engine(mode, cfg, params)
            be.decode(kv, c["tok"], slot, c["pads"], c["keys"], c["ring"], c["ring_idx"],
                      CHUNK, s)
            (chunk,) = be._chunks.values()
            first = dict(tok=c["tok"], slot=slot, ring=c["ring"], ring_idx=c["ring_idx"],
                         keys=c["keys"], pads=c["pads"])
            second = dict(tok=c["tok"] + 1, slot=slot + 11, ring=c["ring"].flip(1),
                          ring_idx=(c["ring_idx"] + 3) % WINDOW, keys=c["keys"] + 5,
                          pads=c["pads"] // 2)
            if mode == "paged":
                tables = be._host_tables()
                first["tables"] = tables
                second["tables"] = np.roll(tables, 1, axis=0)
    ops1 = _recorded_body(chunk, **first)
    ops2 = _recorded_body(chunk, **second)
    assert len(ops1) > 100
    assert [op for op, *_ in ops1 if op.rsplit(".", 1)[0] in HOST_READS] == []
    assert ops1 == ops2
    # Every input moved and the loop still ran one sequence of ops.
    assert int(chunk.slot) == second["slot"] + CHUNK


# -------------------------------------------------------------- the ingest

INGEST_ATOL = {"xla": 0.0, "pallas": 2e-6}  # as tests/test_torch_fusion.py


def _ingest_operands(seed, b, n_q, n_kv, hd):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, 1, (n_q + 2 * n_kv) * hd)).astype(np.float32)
    cos = rng.standard_normal((b, 1, hd // 2)).astype(np.float32)
    sin = rng.standard_normal((b, 1, hd // 2)).astype(np.float32)
    return [torch.from_numpy(a) for a in (qkv, cos, sin)]


@pytest.mark.parametrize("slot", [0, 17, 63])
def test_ingest_plain_with_a_slot_tensor_matches_pallas_dense(slot):
    b, n_q, n_kv, hd, max_seq = 3, 4, 2, 16, 64
    qkv, cos, sin = _ingest_operands(3, b, n_q, n_kv, hd)
    base = np.random.default_rng(4).standard_normal((b, n_kv, max_seq, hd)).astype(np.float32)
    jq, jk, jv = jax_ingest(
        *(jnp.asarray(t.numpy()) for t in (qkv, cos, sin)), jnp.int32(slot), jnp.asarray(base),
        jnp.asarray(base + 1.0), n_q=n_q, n_kv=n_kv, impl="pallas", interpret=True,
    )
    k, v = torch.from_numpy(base.copy()), torch.from_numpy(base + 1.0)
    q = fused_qkv_ingest_plain(qkv, cos, sin, torch.tensor(slot), k, v, n_q=n_q, n_kv=n_kv)
    tol = dict(atol=INGEST_ATOL["pallas"], rtol=0)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), **tol)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **tol)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize(
    "tables,slot",
    [([[3, 5, -1], [6, 2, -1], [-1, -1, -1]], 11), ([[3, 5, -1], [6, 2, -1], [0, 1, 4]], 2),
     ([[1], [4], [0]], 9)],
    ids=["scattered-unmapped", "first-page", "past-the-table"],
)
def test_ingest_plain_with_a_slot_tensor_matches_pallas_paged(tables, slot):
    b, n_q, n_kv, hd, ps, n_pages = 3, 4, 2, 16, 8, 7
    qkv, cos, sin = _ingest_operands(5, b, n_q, n_kv, hd)
    pool = np.random.default_rng(6).standard_normal((n_pages, n_kv, ps, hd)).astype(np.float32)
    tab = np.asarray(tables, np.int32)
    jq, jk, jv = jax_ingest(
        *(jnp.asarray(t.numpy()) for t in (qkv, cos, sin)), jnp.int32(slot), jnp.asarray(pool),
        jnp.asarray(pool + 1.0), n_q=n_q, n_kv=n_kv, block_tables=jnp.asarray(tab),
        impl="pallas", interpret=True,
    )
    sink = np.zeros((1, n_kv, ps, hd), np.float32)
    k = torch.from_numpy(np.concatenate([pool, sink]))
    v = torch.from_numpy(np.concatenate([pool + 1.0, sink]))
    q = fused_qkv_ingest_plain(qkv, cos, sin, torch.tensor(slot), k, v, n_q=n_q, n_kv=n_kv,
                               block_tables=torch.from_numpy(tab))
    tol = dict(atol=INGEST_ATOL["pallas"], rtol=0)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), **tol)
    np.testing.assert_allclose(k.numpy()[:-1], np.asarray(jk), **tol)
    np.testing.assert_array_equal(v.numpy()[:-1], np.asarray(jv))


def test_dense_kv_storage_is_kept_across_epochs():
    """The dense backend hands every epoch the first lanes of one cache
    (each layer's lanes contiguous, zeroed), growing it, and dropping its
    chunks, only when an epoch needs more lanes."""
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    be = LocalBatchBackend(cfg, params, max_seq_len=64, cache_dtype=torch.float32, device="cpu")
    kv4 = be.init_kv(4)
    kv4.k.fill_(1.0)
    be._chunks["probe"] = object()
    kv2 = be.init_kv(2)
    assert kv2.k.data_ptr() == kv4.k.data_ptr() and kv2.batch_size == 2
    assert kv2.k[0].is_contiguous() and not kv2.k.any() and "probe" in be._chunks
    kv8 = be.init_kv(8)
    assert kv8.batch_size == 8 and not be._chunks
    assert isinstance(kv8, KVCache)
    pb = PagedLocalBackend(cfg, params, max_seq_len=64, cache_dtype=torch.float32, page_size=16,
                           device="cpu")
    pool = pb.init_kv(2)
    pool.k.fill_(1.0)
    again = pb.init_kv(4)
    assert isinstance(again, PagedKVCache) and again.k.data_ptr() == pool.k.data_ptr()
    assert not again.k.any()


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_a_chunk_loads_its_slot_after_the_buffer_moved(jax_model, mode):
    """Each chunk copies its slot into the buffer, whatever the buffer held:
    the body run once outside ``run`` (as a profile of it does) moves the
    slot, and the next chunk still equals the eager loop at its own slot."""
    cfg = _config("none")
    be, kv, c, slot = _engine(mode, cfg, _port_params(jax_model, "bf16"))
    if mode == "paged":
        for lane in range(len(PROMPTS)):
            be.allocator.map_range(lane, slot, slot + 3 * CHUNK)
    ref_kv = _clone_kv(kv)
    tok, keys, ring, ring_idx = (c[k].clone() for k in ("tok", "keys", "ring", "ring_idx"))
    refs = [tok.clone(), keys.clone(), ring.clone(), ring_idx.clone()]
    for i in range(2):
        with torch.inference_mode():
            ids, kv, keys, ring, ring_idx = be.decode(
                kv, tok, slot, c["pads"], keys, ring, ring_idx, CHUNK, GREEDY)
            tok, keys, ring, ring_idx = ids[:, -1].clone(), keys.clone(), ring.clone(), \
                ring_idx.clone()
            if mode == "paged":
                want, ref_kv, *carries = B.paged_decode_chunk(
                    be.params, ref_kv, refs[0], slot, c["pads"], torch.as_tensor(be._host_tables()),
                    *refs[1:], cfg, CHUNK, GREEDY, be.rope)
            else:
                want, ref_kv, *carries = B.decode_chunk(
                    be.params, ref_kv, refs[0], slot, c["pads"], *refs[1:], cfg, CHUNK, GREEDY,
                    be.rope)
            refs = [want[:, -1].clone(), *carries]
            assert torch.equal(ids, want), (i, ids, want)
            if i == 0:
                (chunk,) = be._chunks.values()
                chunk.body()  # writes [slot + CHUNK, slot + 2 CHUNK), which chunk 2 writes again
                assert int(chunk.slot) == slot + 2 * CHUNK
        slot += CHUNK
    _assert_kv_equal(kv, ref_kv)


def test_ticket_buffers_outlive_their_growth(monkeypatch):
    """A ticket buffer, once handed out, stays allocated when a larger one
    takes its place (a captured graph may hold its address); growth at
    least doubles; each owner has its own."""
    import gc
    import weakref

    from cake_tpu_torch.ops import tickets

    monkeypatch.setattr(tickets, "_held", {})
    cpu = torch.device("cpu")
    first = tickets.tickets("k", cpu, 6)
    assert first.numel() == 6 and first.dtype == torch.int32 and not first.any()
    assert tickets.tickets("k", cpu, 4) is first
    kept = weakref.ref(first)
    grown = tickets.tickets("k", cpu, 7)
    assert grown.numel() == 12 and not grown.any()
    del first
    gc.collect()
    assert kept() is not None
    assert tickets.tickets("k", cpu, 12) is grown and tickets.tickets("k", cpu, 3) is grown
    assert tickets.tickets("k", cpu, 30).numel() == 30
    assert tickets.tickets("other", cpu, 1).numel() == 1
    assert [t.numel() for t in tickets._held[("k", cpu)]] == [6, 12, 30]
