"""The port's threefry keys and draws (``ops/threefry.py``) against jax.

The JAX package samples from ``jax.random`` threefry keys in the
partitionable layout. Here, on the CPU, the port's plain functions (the
twins of the noise kernel, ``ops/csrc/threefry.cu``) are held to jax:

  * threefry2x32-20 on three known-answer vectors, ``prng_key`` over seeds
    past int32 and negative, ``split`` of one key and of ``[b, 2]`` keys
    (``vmap(split)``): bitwise;
  * bits and uniforms of a shared key (counted over the whole draw) and of
    per-row keys (counted over each row), at Llama-3's vocabulary and at a
    small shape: bitwise; the gumbel plane within 2e-6 absolute (XLA's and
    torch's ``log`` round differently in the last bit), finite everywhere;
  * ``sample`` and ``sample_per_row`` ids equal to the JAX package's over
    seeds 0-19, with temperature, top-k, top-p and the repeat penalty;
  * the constants ``chip_smoke.py`` checks the kernel against on the card.

Then whole streams on a tiny random-weight model: the generator's seeded
sampled stream (per step and in chunks of 4) equals the JAX generator's,
and the dense and paged engines' per-row sampled streams, with joins, under
fusion ``none`` and ``ingest,tail``, equal the JAX engine's (its attention
on the Pallas kernels in interpret mode), token for token.
"""

import dataclasses
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jax_prng

from cake_tpu.io.safetensors_io import load_params as jax_load_params
from cake_tpu.io.safetensors_io import save_tiny_checkpoint as jax_save_tiny_checkpoint
from cake_tpu.models.llama import model as JM
from cake_tpu.models.llama.chat import Message as JaxMessage
from cake_tpu.models.llama.config import LlamaConfig as JaxConfig
from cake_tpu.models.llama.generator import LlamaGenerator as JaxGenerator
from cake_tpu.models.llama.generator import SamplingConfig as JaxSampling
from cake_tpu.models.llama.tokenizer import load_tokenizer as jax_load_tokenizer
from cake_tpu.ops import sampling as jsampling
from cake_tpu.runtime.serving import BatchEngine as JaxEngine
from cake_tpu.runtime.serving import ServeConfig as JaxServe
from cake_tpu_torch.io.safetensors_io import load_params
from cake_tpu_torch.models.llama.chat import Message
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import LlamaGenerator, SamplingConfig
from cake_tpu_torch.models.llama.tokenizer import load_tokenizer
from cake_tpu_torch.ops import sampling
from cake_tpu_torch.ops import threefry as T
from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
GUMBEL_ATOL = 2e-6  # XLA:CPU's log and torch's differ in the last bit (~1e-6 at most)
SEED = 299792458
KAT = [  # threefry2x32-20: (key, counter) -> pair
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
]


def _np(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("key,counter,want", KAT)
def test_known_answers(key, counter, want):
    got = T.threefry2x32(*(torch.tensor(v, dtype=torch.int64) for v in (*key, *counter)))
    assert tuple(int(v) for v in got) == want
    ref = jax_prng.threefry_2x32(jnp.array(key, jnp.uint32), jnp.array(counter, jnp.uint32))
    assert tuple(int(v) for v in np.asarray(ref)) == want


@pytest.mark.parametrize("seed", [0, SEED, -1, 2**31, 2**32 + 7])
def test_prng_key_is_jax_prng_key(seed):
    np.testing.assert_array_equal(T.prng_key(seed).numpy(), _np(jax.random.PRNGKey(seed)))
    many = T.prng_key([seed, 5])
    assert many.shape == (2, 2) and torch.equal(many[0], T.prng_key(seed))


@pytest.mark.parametrize("per_row", [False, True], ids=["one", "rows"])
def test_split_is_jax_split(per_row):
    seeds = [SEED, 0, 2**32 - 1, 7]
    if per_row:
        pair = jax.vmap(jax.random.split)(jnp.stack([jax.random.PRNGKey(s) for s in seeds]))
        nxt, sub = T.split(T.prng_key(seeds))
        want = (_np(pair[:, 0]), _np(pair[:, 1]))
    else:
        nxt, sub = T.split(T.prng_key(SEED))
        want = tuple(_np(jax.random.split(jax.random.PRNGKey(SEED))))
    np.testing.assert_array_equal(nxt.numpy(), want[0])
    np.testing.assert_array_equal(sub.numpy(), want[1])


def _jax_draws(keys, shape, per_row: bool):
    """jax's bits, uniforms and gumbel planes: one key over ``shape``, or a
    key a row (``vmap``) each drawing ``shape[1:]``."""
    tiny = np.finfo(np.float32).tiny
    draws = (
        lambda k, s: jax.random.bits(k, s, jnp.uint32),
        lambda k, s: jax.random.uniform(k, s, jnp.float32, minval=tiny, maxval=1.0),
        lambda k, s: jax.random.gumbel(k, s, jnp.float32),
    )
    if per_row:
        return [np.asarray(jax.vmap(lambda k, f=f: f(k, shape[1:]))(keys)) for f in draws]
    return [np.asarray(f(keys, shape)) for f in draws]


@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per_row"])
@pytest.mark.parametrize("shape", [(128256,), (3, 1000), (8, 128256)], ids=str)
def test_bits_and_uniforms_bitwise_gumbel_close(shape, per_row):
    if per_row:
        rows = shape[0] if len(shape) > 1 else 1
        shape = (rows, *shape[-1:])
        seeds = [SEED + 11 * r for r in range(rows)]
        keys, jkeys = T.prng_key(seeds), jnp.stack([jax.random.PRNGKey(s) for s in seeds])
        draw_shape = shape[1:]
    else:
        keys, jkeys, draw_shape = T.prng_key(SEED), jax.random.PRNGKey(SEED), shape
    jbits, juni, jgum = _jax_draws(jkeys, shape, per_row)
    # One threefry pass a case (the suite runs beside others): uniform and
    # gumbel are compositions over the bits, checked whole at the small shape.
    bits = T.random_bits(keys, draw_shape)
    uni = T.uniform_from_bits(bits)
    gum = -torch.log(-torch.log(uni))
    assert bits.shape == uni.shape == gum.shape == shape
    np.testing.assert_array_equal(bits.numpy(), jbits.astype(np.int64))
    np.testing.assert_array_equal(uni.numpy().view(np.int32), juni.view(np.int32))
    assert torch.isfinite(gum).all()
    np.testing.assert_allclose(gum.numpy(), jgum, atol=GUMBEL_ATOL, rtol=0)
    if math.prod(shape) <= 3000:
        assert torch.equal(T.uniform(keys, draw_shape), uni)
        assert torch.equal(T.gumbel(keys, draw_shape), gum)
        # The wrapper (the plain version on the CPU) draws the same planes.
        for kind, want in (("bits", bits), ("uniform", uni), ("gumbel", gum)):
            nxt, sub, got = T.threefry_noise(keys, draw_shape, split_keys=False, kind=kind)
            assert nxt is None and sub is keys and torch.equal(got, want)


def test_the_wrapper_splits_then_draws_with_the_subkey():
    keys = T.prng_key([3, 4, 5])
    nxt, sub, noise = T.threefry_noise(keys, (64,))
    want_nxt, want_sub = T.split(keys)
    assert torch.equal(nxt, want_nxt) and torch.equal(sub, want_sub)
    assert torch.equal(noise, T.gumbel(want_sub, (64,)))
    with pytest.raises(ValueError, match="keys must be"):
        T.threefry_noise(keys.int(), (64,))
    with pytest.raises(ValueError, match="unknown kind"):
        T.threefry_noise(keys, (64,), kind="normal")


KNOBS = [
    dict(temperature=0.8, top_k=None, top_p=None, penalty=1.0),
    dict(temperature=0.8, top_k=40, top_p=None, penalty=1.1),
    dict(temperature=1.2, top_k=None, top_p=0.9, penalty=1.3),
    dict(temperature=0.7, top_k=40, top_p=0.9, penalty=1.1),
]


@pytest.mark.parametrize("per_row", [False, True], ids=["sample", "sample_per_row"])
@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: "-".join(map(str, k.values())))
def test_sample_ids_equal_jax_categorical(knobs, per_row):
    """Seeds 0-19; random logits leave no top-two gap within the noise's
    last-bit difference."""
    rng = np.random.default_rng(9)
    logits = (rng.standard_normal((3, 2000)) * 3).astype(np.float32)
    ring = rng.integers(-1, 2000, (3, 16)).astype(np.int32)
    kw = dict(temperature=knobs["temperature"], top_k=knobs["top_k"], top_p=knobs["top_p"])
    jpen = jsampling.apply_repeat_penalty(jnp.asarray(logits), knobs["penalty"], jnp.asarray(ring))
    pen = sampling.apply_repeat_penalty(_t(logits), knobs["penalty"], _t(ring).long())
    for seed in range(20):
        if per_row:
            seeds = [seed, seed + 100, seed + 200]
            want = jsampling.sample_per_row(
                jpen, jnp.stack([jax.random.PRNGKey(s) for s in seeds]), **kw)
            got = sampling.sample_per_row(pen, T.prng_key(seeds), **kw)
        else:
            want = jsampling.sample(jpen, jax.random.PRNGKey(seed), **kw)
            got = sampling.sample(pen, T.prng_key(seed), **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"seed {seed}")


def test_the_smoke_constants_are_jax_constants():
    """The values chip_smoke.py holds the noise kernel to on the card."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert [tuple(map(tuple, k)) for k in smoke.THREEFRY_KAT] == KAT
    assert smoke.THREEFRY_SEED == SEED
    key = jax.random.PRNGKey(SEED)
    assert tuple(map(tuple, _np(jax.random.split(key)).tolist())) == smoke.SPLIT_OF_SEED
    zeros = jnp.zeros((2, smoke.VOCAB), jnp.float32)
    assert tuple(np.asarray(jax.random.categorical(key, zeros)).tolist()) == \
        smoke.CATEGORICAL_OF_SEED


# ------------------------------------------------------------- the streams

PROMPT = "a prompt long enough to span several prefill chunks of the tiny model"
GEN_SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.9, repeat_penalty=1.1, repeat_last_n=16,
                   seed=SEED)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = JaxConfig.tiny(num_hidden_layers=2)
    params = JM.init_params(cfg, jax.random.PRNGKey(31), jnp.float32)
    path = tmp_path_factory.mktemp("tiny_threefry")
    jax_save_tiny_checkpoint(path, params, cfg)
    return path


@pytest.mark.parametrize("chunk", [1, 4])
def test_generator_sampled_stream_equals_the_jax_generator(ckpt, chunk):
    jgen = JaxGenerator.load(ckpt, dtype=jnp.float32, max_seq_len=256,
                             sampling=JaxSampling(**GEN_SAMPLED), attention_impl="pallas",
                             decode_chunk_size=chunk)
    jgen.add_message(JaxMessage.user(PROMPT))
    jgen.generate(14)
    pgen = LlamaGenerator.load(ckpt, dtype=torch.float32, max_seq_len=256,
                               sampling=SamplingConfig(**GEN_SAMPLED), device="cpu",
                               decode_chunk_size=chunk)
    pgen.add_message(Message.user(PROMPT))
    pgen.generate(14)
    assert pgen.generated_token_ids == jgen.generated_token_ids
    assert len(pgen.generated_token_ids) > chunk  # past the per-step first token
    # The dialog's key advanced as the reference's: one split a sampled token.
    np.testing.assert_array_equal(pgen._key.numpy(), _np(jgen._key))


ENGINE_SAMPLED = dict(temperature=0.8, top_k=40, repeat_penalty=1.1, repeat_last_n=16)
ENGINE_MODES = {"dense": {}, "paged": {"kv_mode": "paged", "page_size": 16}}
SERVE = dict(max_batch=4, decode_chunk_size=4, admission_window=0.05)
# (user turn, max_tokens, seed): the first two open the epoch, the last two
# join it at a chunk boundary.
ROWS = [("Tell me about cakes.", 24, 7), ("What is the capital of France?", 24, 2**32 + 3),
        ("And about pies?", 10, 11), ("Name a colour.", 10, -5)]


def _rows(submit, message_cls, sampling_cls):
    handles = [submit([message_cls.user(u)], n, sampling_cls(seed=s, **ENGINE_SAMPLED))
               for u, n, s in ROWS[:2]]
    first = handles[0].tokens()
    head = [next(first).id]
    handles += [submit([message_cls.user(u)], n, sampling_cls(seed=s, **ENGINE_SAMPLED))
                for u, n, s in ROWS[2:]]
    return [head + [t.id for t in first]] + [[t.id for t in h.tokens()] for h in handles[1:]]


@pytest.fixture(scope="module")
def jax_engine_streams(ckpt):
    cfg = dataclasses.replace(JaxConfig.from_model_dir(ckpt), attention_impl="pallas")
    params = jax_load_params(ckpt, cfg, jnp.float32)
    out = {}
    for mode, kw in ENGINE_MODES.items():
        eng = JaxEngine(cfg, params, jax_load_tokenizer(ckpt), max_seq_len=256,
                        cache_dtype=jnp.float32, serve=JaxServe(**SERVE, **kw))
        eng.start()
        try:
            out[mode] = _rows(eng.submit, JaxMessage, JaxSampling)
            out[mode, "joins"] = eng.stats["joins"]
        finally:
            eng.stop()
    return out


@pytest.mark.parametrize("fusion", ["none", "ingest,tail"])
@pytest.mark.parametrize("mode", list(ENGINE_MODES))
def test_engine_sampled_rows_equal_the_jax_engine(ckpt, jax_engine_streams, mode, fusion):
    cfg = LlamaConfig.from_model_dir(ckpt)
    eng = BatchEngine(cfg, load_params(ckpt, cfg, torch.float32, "cpu"), load_tokenizer(ckpt),
                      max_seq_len=256, cache_dtype=torch.float32,
                      serve=ServeConfig(fusion_impl=fusion, **SERVE, **ENGINE_MODES[mode]),
                      device="cpu")
    eng.start()
    try:
        got = _rows(eng.submit, Message, SamplingConfig)
        joins = eng.stats["joins"]
    finally:
        eng.stop()
    assert jax_engine_streams[mode, "joins"] >= 1 and joins >= 1  # the last rows joined
    assert got == jax_engine_streams[mode]
    assert all(len(ids) > 1 for ids in got)
