"""The rolling window cache of the port (models/llama/cache.py
``write_layer_rolling`` / ``rolling_kv_positions``, the kernels' ring
plain versions, ``LocalForwardStep(rolling_budget=)``, the CLI's rule) held
to the JAX package's, on the CPU.

``tests/test_rolling_cache.py`` pins the reference: the ring holds window +
chunk budget slots, position p in slot p % L, and the rolling layout is
invisible in the tokens. Each of its seven tests runs here on the port with
the JAX ``LocalForwardStep(rolling_budget=)`` beside it over the same
weights (2-3 layers, hidden 64, f32): the same activation and ring length,
greedy ids equal to the JAX package's and to the port's full cache across
several wraps with logits within 1e-4 (f32; the two packages reduce in
other orders), fused chunks equal per-step decoding, oversized chunks
refused, prefix reuse off, and a dense model left alone. Below them the
ring's pieces: the write and the slot positions bitwise against the
reference's, and the kernels' ring plain versions against the reference's
rolling attention (``gqa_attention_hm`` over ``rolling_kv_positions``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)
from cake_tpu.models.llama import cache as JC
from cake_tpu.models.llama import model as JM
from cake_tpu.models.llama.chat import Message as JaxMessage
from cake_tpu.models.llama.config import LlamaConfig as JaxConfig
from cake_tpu.models.llama.generator import LlamaGenerator as JaxGenerator
from cake_tpu.models.llama.generator import LocalForwardStep as JaxStep
from cake_tpu.models.llama.generator import SamplingConfig as JaxSampling
from cake_tpu.models.llama.tokenizer import ByteTokenizer as JaxByteTokenizer
from cake_tpu.ops.attention import gqa_attention_hm as jax_gqa_hm
from cake_tpu_torch import cli
from cake_tpu_torch.models.llama import cache as PC
from cake_tpu_torch.models.llama import model as M
from cake_tpu_torch.models.llama.chat import Message
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import LlamaGenerator, LocalForwardStep, SamplingConfig
from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer
from cake_tpu_torch.ops.chunk_prefill import chunk_prefill_attention
from cake_tpu_torch.ops.decode_attention import decode_attention

GREEDY = dict(temperature=0.0, repeat_penalty=1.0)
TOL = 1e-4  # f32 logits, port against the JAX package (other reduction orders)


def configs(**kw):
    kw.setdefault("model_type", "mistral")
    kw.setdefault("sliding_window", 8)
    kw.setdefault("num_hidden_layers", 3)
    return LlamaConfig.tiny(**kw), JaxConfig.tiny(**kw)


def weights(jcfg, seed: int):
    """The JAX package's init and the port's copy of it."""
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    return M.params_from_jax(jax.tree.map(np.asarray, jparams)), jparams


def steps(cfg, jcfg, seed: int, max_seq: int = 256, **kw):
    """(port step, JAX step) over the same weights."""
    params, jparams = weights(jcfg, seed)
    return (LocalForwardStep(cfg, params, max_seq_len=max_seq, cache_dtype=torch.float32,
                             device="cpu", **kw),
            JaxStep(jcfg, jparams, max_seq_len=max_seq, cache_dtype=jnp.float32, **kw))


def drive_chunked(step, prompt_ids, n_steps, chunk=16):
    """tests/test_rolling_cache.drive_chunked: fixed prefill chunks, then
    greedy decoding; returns (ids, the logits of every decode step)."""
    pos, ids, logits, seen = 0, list(prompt_ids), None, []
    while pos < len(ids):
        part = ids[pos : pos + chunk]
        buf = np.zeros((1, chunk), np.int64)
        buf[0, : len(part)] = part
        logits = np.asarray(step(buf, pos, len(part)), np.float32)
        pos += len(part)
    out = []
    for _ in range(n_steps):
        seen.append(logits)
        nxt = int(np.argmax(logits[0]))
        out.append(nxt)
        logits = np.asarray(step(np.asarray([[nxt]], np.int64), pos, 1), np.float32)
        pos += 1
    return out, np.stack(seen)


def test_rolling_activates_and_shrinks_cache():
    cfg, jcfg = configs()
    for make in (lambda **kw: steps(cfg, jcfg, 0, **kw),):
        dense, jdense = make()
        roll, jroll = make(rolling_budget=16)
        for d, r in ((dense, roll), (jdense, jroll)):
            assert not d.rolling and r.rolling
            assert d._kv.max_seq_len == 256
            assert r._kv.max_seq_len == 128  # round_up(8 + 16) to the 128 tile
            assert r.max_seq_len == 256  # the LOGICAL bound is unchanged
    assert roll._kv.k.shape == (3, 1, 2, 128, 16)


def test_rolling_matches_dense_and_jax_across_wraparound():
    """Prompt 40 + 120 generated >> the ring's 128 slots: the port's rolling
    ids equal its full cache's and the JAX package's rolling ids, and every
    decode step's logits the JAX package's within TOL."""
    cfg, jcfg = configs(num_hidden_layers=2)
    rng = np.random.default_rng(0)
    prompt = [int(t) for t in rng.integers(0, 256, 40)]
    dense, _ = steps(cfg, jcfg, 1)
    roll, jroll = steps(cfg, jcfg, 1, rolling_budget=16)
    want, want_logits = drive_chunked(dense, prompt, 120)
    got, logits = drive_chunked(roll, prompt, 120)
    jgot, jlogits = drive_chunked(jroll, prompt, 120)
    assert got == want == jgot
    np.testing.assert_allclose(logits, jlogits, atol=TOL, rtol=0)
    np.testing.assert_allclose(logits, want_logits, atol=TOL, rtol=0)


def test_rolling_matches_transformers(tmp_path):
    """External oracle: the port's rolling ids == HF transformers on a
    Mistral checkpoint with a window far smaller than the prompt, and ==
    the JAX package's rolling ids from the same checkpoint."""
    transformers = pytest.importorskip("transformers")
    from cake_tpu.io.safetensors_io import load_params as jax_load_params
    from cake_tpu_torch.io.safetensors_io import load_params

    hf_cfg = transformers.MistralConfig(
        hidden_size=64, intermediate_size=128, vocab_size=512,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        rope_theta=10000.0, max_position_embeddings=256, rms_norm_eps=1e-5,
        tie_word_embeddings=False, bos_token_id=256, eos_token_id=260,
        sliding_window=8, attn_implementation="eager",
    )
    torch.manual_seed(9)
    hf = transformers.MistralForCausalLM(hf_cfg).eval().to(torch.float32)
    hf.save_pretrained(tmp_path, safe_serialization=True)
    rng = np.random.default_rng(3)
    prompt = [256] + [int(t) for t in rng.integers(0, 512, 39)]
    ids = torch.tensor([prompt], dtype=torch.long)
    want = []
    with torch.no_grad():
        for _ in range(20):
            nxt = int(torch.argmax(hf(ids).logits[0, -1]))
            want.append(nxt)
            ids = torch.cat([ids, torch.tensor([[nxt]])], dim=1)

    cfg = LlamaConfig.from_model_dir(tmp_path)
    jcfg = JaxConfig.from_model_dir(tmp_path)
    roll = LocalForwardStep(cfg, load_params(tmp_path, cfg, torch.float32), max_seq_len=256,
                            cache_dtype=torch.float32, device="cpu", rolling_budget=16)
    jroll = JaxStep(jcfg, jax_load_params(tmp_path, jcfg, jnp.float32), max_seq_len=256,
                    cache_dtype=jnp.float32, rolling_budget=16)
    assert roll.rolling and jroll.rolling
    assert drive_chunked(roll, prompt, 20)[0] == want == drive_chunked(jroll, prompt, 20)[0]


@functools.lru_cache(maxsize=None)
def rolling_generation(port: bool, size: int) -> tuple:
    """150 greedy ids (past the ring's 128 slots) of the port's or the JAX
    package's generator over the rolling step, ``size``-token decode."""
    cfg, jcfg = configs(num_hidden_layers=2)
    step, jstep = steps(cfg, jcfg, 2, rolling_budget=16)
    if port:
        gen = LlamaGenerator(cfg, step, ByteTokenizer(), SamplingConfig(**GREEDY),
                             decode_chunk_size=size, prefill_chunk=16)
        gen.add_message(Message.user("rolling cache fused decode oracle"))
    else:
        gen = JaxGenerator(jcfg, jstep, JaxByteTokenizer(), JaxSampling(**GREEDY),
                           decode_chunk_size=size, prefill_chunk=16)
        gen.add_message(JaxMessage.user("rolling cache fused decode oracle"))
    gen.generate(150)
    return tuple(gen.generated_token_ids)


@pytest.mark.parametrize("decode_chunk", [1, 6])
def test_rolling_fused_decode_matches_stepwise_and_jax(decode_chunk):
    """The generator over the rolling step: fused chunks (the DecodeChunk
    loop, each step's ring slot from the device position) give the per-step
    ids, and the JAX generator's."""
    got = rolling_generation(True, decode_chunk)
    assert len(got) == 150
    assert got == rolling_generation(True, 1) == rolling_generation(False, decode_chunk)


def test_rolling_rejects_oversized_chunk():
    cfg, jcfg = configs()
    roll, jroll = steps(cfg, jcfg, 3, max_seq=512, rolling_budget=16)
    # room = 128 - 8 = 120; a 121-token chunk could evict live-window keys.
    for step in (roll, jroll):
        with pytest.raises(ValueError, match="rolling"):
            step(np.zeros((1, 121), np.int64), 0, 121)
    roll(np.zeros((1, 120), np.int64), 0, 120)  # the room itself is taken


def test_rolling_disables_prefix_reuse():
    """A ring cannot carry a KV prefix across reset(): turn 2 re-prefills
    and gives turn 1's ids, as the JAX generator does."""
    cfg, jcfg = configs(num_hidden_layers=2)
    step, jstep = steps(cfg, jcfg, 4, rolling_budget=16)
    gens = [LlamaGenerator(cfg, step, ByteTokenizer(), SamplingConfig(**GREEDY),
                           prefill_chunk=16, prefix_cache=True),
            JaxGenerator(jcfg, jstep, JaxByteTokenizer(), JaxSampling(**GREEDY),
                         prefill_chunk=16, prefix_cache=True)]
    out = []
    for gen, msg in zip(gens, (Message, JaxMessage)):
        gen.add_message(msg.user("first turn with some words"))
        gen.generate(12)
        first = list(gen.generated_token_ids)
        gen.reset()
        assert gen._reusable == []
        gen.add_message(msg.user("first turn with some words"))
        gen.generate(12)
        assert list(gen.generated_token_ids) == first
        assert gen.last_prefill_tokens == len(gen._tokens) - len(first)  # nothing reused
        out.append(first)
    assert out[0] == out[1]


def test_rolling_noop_for_dense_and_alternating_models():
    """rolling_budget on a full-causal model, or on Gemma-2's alternating
    windows, is ignored in both packages."""
    for kw in (dict(model_type="llama", sliding_window=None),
               dict(model_type="gemma2", sliding_window=8, alt_sliding_window=True)):
        cfg, jcfg = configs(num_hidden_layers=2, **kw)
        step, jstep = steps(cfg, jcfg, 5, rolling_budget=16)
        assert not step.rolling and not jstep.rolling
        assert step._kv.max_seq_len == jstep._kv.max_seq_len == 256


# ------------------------------------------------------------ the pieces


@pytest.mark.parametrize("pos,valid,chunk", [(0, 16, 16), (120, 16, 16), (250, 5, 16),
                                             (517, 1, 1), (383, 9, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_write_layer_rolling_bitwise(pos, valid, chunk, dtype):
    """Slots (pos + j) % L for j < valid, the padded tail dropped, each
    slot's position reconstructed: bitwise the reference's, with pos a host
    int and a 0-d device tensor (a decode step)."""
    rng = np.random.default_rng(pos)
    b, n_kv, L, hd = 2, 2, 128, 16
    cache = rng.standard_normal((b, n_kv, L, hd)).astype(np.float32)
    new = rng.standard_normal((2, b, chunk, n_kv, hd)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    jk, jv = JC.write_layer_rolling(jnp.asarray(cache, jdt), jnp.asarray(cache, jdt),
                                    jnp.asarray(new[0], jdt), jnp.asarray(new[1], jdt),
                                    jnp.int32(pos), jnp.int32(valid))
    for p in (pos, torch.tensor(pos)) if chunk == 1 else (pos,):
        k = torch.tensor(cache).to(tdt)
        v = k.clone()
        PC.write_layer_rolling(k, v, torch.tensor(new[0]).to(tdt),
                               torch.tensor(new[1]).to(tdt), p, valid)
        assert torch.equal(k.float(), torch.tensor(np.asarray(jk.astype(jnp.float32))))
        assert torch.equal(v.float(), torch.tensor(np.asarray(jv.astype(jnp.float32))))
    got = PC.rolling_kv_positions(L, pos, valid)
    want = np.asarray(JC.rolling_kv_positions(L, jnp.int32(pos), jnp.int32(valid)))
    assert got.tolist() == want.tolist()
    assert PC.ROLLING_DEAD == int(JC.ROLLING_DEAD)


def ring_case(rng, b, n_q, n_kv, hd, L, newest):
    """A ring [b, n_kv, L, hd] and its reference slot positions for rows whose
    newest written position is ``newest`` [b]."""
    k = rng.standard_normal((b, n_kv, L, hd)).astype(np.float32)
    v = rng.standard_normal((b, n_kv, L, hd)).astype(np.float32)
    kpos = np.stack([np.asarray(JC.rolling_kv_positions(L, jnp.int32(p), jnp.int32(1)))
                     for p in newest])
    return k, v, kpos


@pytest.mark.parametrize("window,softcap", [(8, None), (100, None), (64, 30.0)])
def test_decode_ring_plain_matches_reference(window, softcap):
    """decode_attention(ring_limit=) on the CPU: the reference's rolling
    decode attention over the ring, rows past one and several wraps."""
    rng = np.random.default_rng(window)
    b, n_q, n_kv, hd, L = 3, 4, 2, 16, 128
    lengths = np.array([5, 300, 1031], np.int32)
    k, v, kpos = ring_case(rng, b, n_q, n_kv, hd, L, lengths - 1)
    q = rng.standard_normal((b, 1, n_q, hd)).astype(np.float32)
    want = jax_gqa_hm(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(lengths[:, None] - 1), jnp.asarray(kpos), window=window,
                      softcap=softcap)
    got = decode_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                           torch.tensor(lengths), window=window, softcap=softcap,
                           ring_limit=2048)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("q_start,chunk,window", [(0, 16, 8), (200, 16, 8), (500, 24, 100),
                                                  (130, 8, 120)])
def test_chunk_ring_plain_matches_reference(q_start, chunk, window):
    """chunk_prefill_attention(ring_limit=) on the CPU: a continuation chunk
    over the ring whose keys straddle the wrap, against the reference."""
    rng = np.random.default_rng(q_start + chunk)
    b, n_q, n_kv, hd, L = 2, 4, 2, 16, 128
    end = q_start + chunk
    k, v, kpos = ring_case(rng, b, n_q, n_kv, hd, L, [end - 1] * b)
    q = rng.standard_normal((b, chunk, n_q, hd)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(q_start, end)[None], (b, chunk))
    want = jax_gqa_hm(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
                      jnp.asarray(kpos), window=window)
    got = chunk_prefill_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                  torch.full((b,), q_start, dtype=torch.int32),
                                  torch.full((b,), end, dtype=torch.int32), window=window,
                                  ring_limit=1024)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_ring_refuses_what_its_kernels_cannot_take():
    """A ring needs a multiple of 128 slots, a logical bound past it and a
    window always on that fits the ring with the chunk."""
    q = torch.zeros(1, 1, 4, 16)
    kv = torch.zeros(1, 2, 128, 16)
    lengths = torch.tensor([10], dtype=torch.int32)
    for kw in (dict(window=None, ring_limit=256), dict(window=8, ring_limit=64),
               dict(window=129, ring_limit=256), dict(window=8, window_flag=True,
                                                       ring_limit=256)):
        with pytest.raises(ValueError, match="ring"):
            decode_attention(q, kv, kv, lengths, **kw)
    with pytest.raises(ValueError, match="ring"):
        decode_attention(q, torch.zeros(1, 2, 96, 16), torch.zeros(1, 2, 96, 16), lengths,
                         window=8, ring_limit=256)
    with pytest.raises(ValueError, match="ring"):  # window + chunk - 1 > L
        chunk_prefill_attention(torch.zeros(1, 32, 4, 16), kv, kv, torch.tensor([0]),
                                torch.tensor([32]), window=100, ring_limit=256)


def test_cli_rolling_rule(tmp_path):
    """The reference's activation rule: one sliding window and
    --prefill-chunk; the budget is the larger of the two chunk sizes."""
    parser = cli.build_parser()
    mistral, _ = configs()
    gemma2, _ = configs(model_type="gemma2", alt_sliding_window=True)
    llama = dataclasses.replace(mistral, sliding_window=None)
    args = parser.parse_args(["--model", "m", "--prefill-chunk", "16", "--decode-chunk", "24"])
    assert cli.rolling_budget(mistral, args) == 24
    assert cli.rolling_budget(gemma2, args) is None
    assert cli.rolling_budget(llama, args) is None
    assert cli.rolling_budget(mistral, parser.parse_args(["--model", "m"])) is None


def test_cli_prompt_runs_the_rolling_cache(tmp_path, capsys, monkeypatch):
    """A Mistral checkpoint with --prefill-chunk through the CLI builds the
    rolling step and prints the JAX package's greedy text."""
    from cake_tpu.io.safetensors_io import save_tiny_checkpoint as jax_save

    _, jcfg = configs(num_hidden_layers=2)
    jax_save(tmp_path, JM.init_params(jcfg, jax.random.PRNGKey(6), jnp.float32), jcfg)
    built = []
    real_init = LocalForwardStep.__init__

    def spy(self, *a, **kw):
        real_init(self, *a, **kw)
        built.append(self)

    monkeypatch.setattr(LocalForwardStep, "__init__", spy)
    argv = ["--model", str(tmp_path), "--prompt", "a prompt that wraps the ring", "-n", "20",
            "--dtype", "f32", "--device", "cpu", "--prefill-chunk", "16", "--temperature", "0",
            "--repeat-penalty", "1.0", "--max-seq-len", "256"]
    assert cli.main(argv) == 0
    text = capsys.readouterr().out.strip()
    assert built and built[0].rolling and built[0]._kv.max_seq_len == 128
    jgen = JaxGenerator.load(tmp_path, dtype=jnp.float32, max_seq_len=256,
                             sampling=JaxSampling(**GREEDY), prefill_chunk=16)
    jgen.add_message(JaxMessage.user("a prompt that wraps the ring"))
    assert text == jgen.generate(20).strip()
