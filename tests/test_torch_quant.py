"""Weight-only quantization in the port (``ops/quant.py``, ``ops/int4_matmul.py``)
against the JAX package's, on the CPU.

Inputs are made from a seed with numpy and handed to both packages.
Quantization itself is held to the JAX package's bits: int8 and int4
weights, scales, the nibble unpack and the dequantized weights are equal,
over stacked layer axes and the tiny widths' group sizes. The port's int4
product (``int4_matmul_plain``, what ``qmat`` runs on the CPU) is the
arithmetic of the JAX package's Pallas kernel, which runs here in interpret
mode: f32 within 1e-5 (summation order), bf16 within one bf16 rounding step.
On the CPU the JAX package's own ``qmat`` takes the XLA ``_qmat4`` (the
scale after the product): the port stays within that test's 2e-3.

For whole-model comparisons the JAX side is made to run its Pallas int4
kernel (interpret mode) at every int4 product, the route it takes on a TPU,
by patching its ``_int4_kernel_ok`` for the test (``jax_int4_kernel``; the
jit caches are cleared before and after). Then: tiny-model logits (int8,
int4) within 1e-4, greedy streams of the generator (per step, chunked
prefill, multi-token decode) and of both batch engines equal to the JAX
package's, quantized checkpoints written by ``cake_tpu/io/quantizer.py``
loading to the leaves of the port's own ``quantize_params``, the port's own
quantized checkpoints round-tripping, the CLI's ``--quantize`` and the
``fused_norm_matmul`` route for a quantized weight.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cake_tpu.ops.quant as JQ
from cake_tpu.io.quantizer import quantize_checkpoint
from cake_tpu.io.safetensors_io import load_params as jax_load_params
from cake_tpu.io.safetensors_io import save_tiny_checkpoint as jax_save_tiny_checkpoint
from cake_tpu.models.llama import model as JM
from cake_tpu.models.llama.cache import init_cache as jax_init_cache
from cake_tpu.models.llama.chat import Message as JaxMessage
from cake_tpu.models.llama.config import LlamaConfig as JaxConfig
from cake_tpu.models.llama.generator import LlamaGenerator as JaxGenerator
from cake_tpu.models.llama.generator import SamplingConfig as JaxSampling
from cake_tpu.models.llama.tokenizer import load_tokenizer as jax_load_tokenizer
from cake_tpu.ops.fuse import fuse_params as jax_fuse_params
from cake_tpu.ops.pallas.int4_matmul import int4_matmul as jax_int4_matmul
from cake_tpu.runtime.serving import BatchEngine as JaxEngine
from cake_tpu.runtime.serving import ServeConfig as JaxServe
from cake_tpu_torch.io.safetensors_io import load_params, save_tiny_checkpoint
from cake_tpu_torch.models.llama import model as M
from cake_tpu_torch.models.llama.cache import init_cache
from cake_tpu_torch.models.llama.chat import Message
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import LlamaGenerator, SamplingConfig
from cake_tpu_torch.models.llama.tokenizer import load_tokenizer
from cake_tpu_torch.ops import int4_matmul as I4
from cake_tpu_torch.ops import quant as Q
from cake_tpu_torch.ops.fuse import fuse_params
from cake_tpu_torch.ops.fused_norm_matmul import fused_norm_matmul
from cake_tpu_torch.ops.norm import rms_norm
from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)

GREEDY = dict(temperature=0.0, repeat_penalty=1.0)
PROMPT = "a prompt long enough to span several prefill chunks of the tiny model"


@pytest.fixture
def jax_int4_kernel(monkeypatch):
    """The JAX package's qmat on its Pallas int4 kernel (interpret mode on
    the CPU) for every 2-D int4 weight, as on a TPU."""
    monkeypatch.setattr(JQ, "_int4_kernel_ok", lambda x, w: w.w.ndim == 2)
    jax.clear_caches()
    yield
    monkeypatch.undo()
    jax.clear_caches()


def _np_weights(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np_linear(seed, in_dim, out):
    """A linear weight at a model's scale (N(0, 1/in)): outputs near 1."""
    return _np_weights(seed, in_dim, out) * np.float32(in_dim**-0.5)


def _bf16_step(ref: np.ndarray) -> float:
    top = float(np.abs(ref).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


# ------------------------------------------------- quantization, bitwise


SHAPES = [(64, 128), (128, 64), (96, 48), (512, 256), (3, 64, 128), (2, 3, 128, 96)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_quantization_is_bitwise_the_jax_package(shape, dtype):
    w = _np_weights(sum(shape), *shape)
    jw = jnp.asarray(w, getattr(jnp, dtype))
    pw = torch.from_numpy(w).to(getattr(torch, dtype))
    for jfn, pfn in ((JQ.quantize_weight, Q.quantize_weight),
                     (JQ.quantize4_weight, Q.quantize4_weight)):
        jq, pq = jfn(jw), pfn(pw)
        np.testing.assert_array_equal(pq.w.numpy(), np.asarray(jq.w))
        np.testing.assert_array_equal(pq.scale.numpy(), np.asarray(jq.scale))
        assert pq.w.dtype == torch.int8 and pq.scale.dtype == torch.float32
        np.testing.assert_array_equal(
            Q.dequantize_weight(pq).numpy(), np.asarray(JQ.dequantize_weight(jq)))


@pytest.mark.parametrize("in_dim", [2, 6, 64, 96, 128, 160, 512, 4096, 14336])
def test_group_size_matches_the_jax_package(in_dim):
    assert Q._group_size_for(in_dim, 128) == JQ._group_size_for(in_dim, 128)


def test_unpack4_sign_extends_every_byte_like_the_jax_package():
    packed = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    jlo, jhi = JQ.unpack4(jnp.asarray(packed))
    plo, phi = I4.unpack4(torch.from_numpy(packed))
    np.testing.assert_array_equal(plo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(phi.numpy(), np.asarray(jhi))
    assert plo.min() == phi.min() == -8 and plo.max() == phi.max() == 7


def test_quantize_params_layer_by_layer_equals_the_whole_stack():
    cfg = LlamaConfig.tiny(num_hidden_layers=3, tie_word_embeddings=False)
    params = M.init_params(cfg, torch.Generator().manual_seed(1), torch.float32)
    for mode in ("int8", "int4"):
        q = Q.quantize_params(params, mode)
        assert Q.tree_quantization(q) == mode
        assert Q.tree_quantization(params) is None
        for key, leaf in q["layers"].items():
            if key not in Q._QUANT_LAYER_KEYS:
                assert leaf is params["layers"][key]
                continue
            for i in range(cfg.num_hidden_layers):
                one = Q._quantize_one(params["layers"][key][i], mode)
                assert torch.equal(leaf[i].w, one.w) and torch.equal(leaf[i].scale, one.scale)
        with pytest.raises(ValueError, match="already quantized"):
            Q.quantize_params(q, mode)
    with pytest.raises(ValueError, match="unknown quantize mode"):
        Q.quantize_params(params, "int2")


def test_quantized_bytes_and_weight_out_dim():
    w = torch.from_numpy(_np_weights(3, 2, 256, 96))
    q4, q8 = Q.quantize4_weight(w), Q.quantize_weight(w)
    groups = 256 // Q._group_size_for(256, Q.DEFAULT_GROUP_SIZE)  # 4 groups of 64 rows
    assert Q.quantized_bytes({"a": q4}) == 2 * 128 * 96 + 2 * groups * 96 * 4
    assert Q.quantized_bytes({"a": q8, "b": w}) == 2 * 256 * 96 + 2 * 96 * 4 + w.numel() * 4
    assert Q.weight_out_dim(q4) == Q.weight_out_dim(q8) == Q.weight_out_dim(w) == 96
    assert q4.in_dim == 256 and q4[1].w.shape == (128, 96) and q4[1].scale.shape == (groups, 96)


# ------------------------------------------------- the int4 product


# The shapes of the JAX package's int4 kernel tests (tests/test_quant.py):
# ragged rows, several K blocks, groups below the K block, row tiles.
PRODUCT_CASES = [(1, 512, 256, 128), (3, 256, 128, 32), (9, 1024, 384, 128), (300, 256, 128, 128),
                 (4, 64, 128, 16), (2, 96, 48, 24)]


@pytest.mark.parametrize("rows,in_dim,out,gs", PRODUCT_CASES)
def test_int4_plain_matches_the_pallas_kernel_f32(rows, in_dim, out, gs):
    x = _np_weights(rows + 1, rows, in_dim)
    q = JQ.quantize4_weight(jnp.asarray(_np_linear(in_dim, in_dim, out)), group_size=gs)
    want = np.asarray(jax_int4_matmul(jnp.asarray(x), q.w, q.scale, interpret=True))
    got = I4.int4_matmul_plain(torch.from_numpy(x), torch.from_numpy(np.array(q.w)),
                               torch.from_numpy(np.array(q.scale)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rows,in_dim,out,gs", PRODUCT_CASES[:4])
def test_int4_plain_matches_the_pallas_kernel_bf16(rows, in_dim, out, gs):
    """Both round each scaled weight to bf16 and sum in f32: another
    summation order may round an output one bf16 step the other way."""
    x = _np_weights(rows + 2, rows, in_dim)
    q = JQ.quantize4_weight(jnp.asarray(_np_linear(in_dim + 1, in_dim, out)), group_size=gs)
    want = np.asarray(
        jax_int4_matmul(jnp.asarray(x, jnp.bfloat16), q.w, q.scale, interpret=True), np.float32)
    got = I4.int4_matmul_plain(torch.from_numpy(x).to(torch.bfloat16),
                               torch.from_numpy(np.array(q.w)),
                               torch.from_numpy(np.array(q.scale)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=_bf16_step(want), rtol=0)


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qmat_matches_the_jax_qmat(mode, dtype):
    """The JAX qmat on the CPU: int8 the same formula, int4 its XLA _qmat4
    (exact nibbles, the scale after the product): within 2e-3 in f32, as
    the JAX package holds its kernel to it; in bf16 within the one-step
    rounding of the larger outputs."""
    x = _np_weights(5, 2, 3, 256)
    w = _np_linear(6, 256, 192)
    quant = {"int8": (JQ.quantize_weight, Q.quantize_weight),
             "int4": (JQ.quantize4_weight, Q.quantize4_weight)}[mode]
    jw, pw = quant[0](jnp.asarray(w)), quant[1](torch.from_numpy(w))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(JQ.qmat(jx, jw), np.float32)
    got = Q.qmat(torch.from_numpy(x).to(getattr(torch, dtype)), pw)
    assert got.shape == (2, 3, 192) and got.dtype == getattr(torch, dtype)
    tol = 2e-3 if dtype == "float32" else 4 * _bf16_step(want)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=2e-3)


def test_qmat_int4_goes_through_the_wrapper_once_per_call():
    w = Q.quantize4_weight(torch.from_numpy(_np_weights(7, 128, 64)))
    before = (I4.int4_matmul_plain.launches, I4.int4_matmul.launches)
    out = Q.qmat(torch.from_numpy(_np_weights(8, 2, 5, 128)), w)
    assert out.shape == (2, 5, 64)
    assert (I4.int4_matmul_plain.launches, I4.int4_matmul.launches) == (before[0] + 1, before[1])


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_fuse_of_quantized_equals_quantize_of_fused(mode):
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    params = M.init_params(cfg, torch.Generator().manual_seed(2), torch.float32)
    a = fuse_params(Q.quantize_params(params, mode))["layers"]
    b = Q.quantize_params(fuse_params(params), mode)["layers"]
    for key in ("wqkv", "w_gu"):
        assert type(a[key]) is type(b[key])
        assert torch.equal(a[key].w, b[key].w) and torch.equal(a[key].scale, b[key].scale)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_params_from_jax_takes_quantized_leaves(mode):
    cfg = JaxConfig.tiny(num_hidden_layers=2, tie_word_embeddings=False)
    tree = JQ.quantize_params(JM.init_params(cfg, jax.random.PRNGKey(3), jnp.float32), mode)
    port = M.params_from_jax(jax.tree.map(np.asarray, tree))
    cls = Q.Quant4Weight if mode == "int4" else Q.QuantWeight
    for key, leaf in tree["layers"].items():
        got = port["layers"][key]
        if isinstance(leaf, (JQ.QuantWeight, JQ.Quant4Weight)):
            assert type(got) is cls
            np.testing.assert_array_equal(got.w.numpy(), np.asarray(leaf.w))
            np.testing.assert_array_equal(got.scale.numpy(), np.asarray(leaf.scale))
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    assert type(port["lm_head"]) is cls
    assert Q.tree_quantization(port) == mode
    assert M.count_params(port) == JM.count_params(tree)


# ------------------------------------------------- the model


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("family", ["llama", "qwen2"])
def test_forward_logits_match_jax(jax_int4_kernel, mode, family):
    kw = dict(num_hidden_layers=2, tie_word_embeddings=False)
    if family == "qwen2":
        kw.update(model_type="qwen2", attention_bias=True)
    jcfg = JaxConfig.tiny(attention_impl="pallas", **kw)
    pcfg = LlamaConfig.tiny(**kw)
    tree = jax_fuse_params(
        JQ.quantize_params(JM.init_params(jcfg, jax.random.PRNGKey(5), jnp.float32), mode))
    params = M.params_from_jax(jax.tree.map(np.asarray, tree))
    rng = np.random.default_rng(9)
    first = rng.integers(0, pcfg.vocab_size, (1, 8)).astype(np.int32)
    cont = rng.integers(0, pcfg.vocab_size, (1, 6)).astype(np.int32)
    hd, n_kv, n = pcfg.head_dim, pcfg.num_key_value_heads, pcfg.num_hidden_layers
    jkv = jax_init_cache(n, 1, 64, n_kv, hd, jnp.float32)
    pkv = init_cache(n, 1, 64, n_kv, hd, torch.float32)
    feed = [(first, 0, 8, False), (cont, 8, 6, True)]
    pos = 14
    for i in range(len(feed) + 3):
        if i < len(feed):
            toks, p, seq_len, cached = feed[i]
        else:
            toks, p, seq_len, cached = nxt, pos, 1, False
            pos += 1
        jl, jkv = JM.forward(tree, jnp.asarray(toks), jkv, jnp.int32(p), jnp.int32(seq_len),
                             jcfg, cached_prefill=cached)
        pl, pkv = M.forward(params, torch.from_numpy(np.array(toks)), pkv, p, seq_len, pcfg,
                            cached_prefill=cached)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
        nxt = pl.argmax(-1).numpy().astype(np.int32)[:, None]
        np.testing.assert_array_equal(nxt, np.asarray(jnp.argmax(jl, -1))[:, None])


def test_fused_norm_matmul_routes_a_quantized_weight_to_qmat():
    x = torch.from_numpy(_np_weights(10, 2, 3, 128))
    nw = torch.from_numpy(_np_weights(11, 128))
    for quantize in (Q.quantize_weight, Q.quantize4_weight):
        w = quantize(torch.from_numpy(_np_weights(12, 128, 64)))
        before = (fused_norm_matmul.quantized, fused_norm_matmul.launches,
                  fused_norm_matmul.unfused)
        got = fused_norm_matmul(x, nw, w, eps=1e-5, offset=True)
        assert torch.equal(got, Q.qmat(rms_norm(x, nw, 1e-5, True), w))
        assert (fused_norm_matmul.quantized, fused_norm_matmul.launches,
                fused_norm_matmul.unfused) == (before[0] + 1, before[1], before[2])


# ------------------------------------------------- generator and checkpoints


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = JaxConfig.tiny(num_hidden_layers=3, tie_word_embeddings=False)
    path = tmp_path_factory.mktemp("tiny_quant")
    jax_save_tiny_checkpoint(path, JM.init_params(cfg, jax.random.PRNGKey(6), jnp.float32), cfg)
    return path


def _port_stream(path, mode, **kw):
    gen = LlamaGenerator.load(path, dtype=torch.float32, max_seq_len=256, device="cpu",
                              sampling=SamplingConfig(**GREEDY), quantize=mode, **kw)
    gen.add_message(Message.user(PROMPT))
    gen.generate(16)
    return gen


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_greedy_streams_match_jax(jax_int4_kernel, ckpt, mode):
    """The JAX generator (per step) and the port's per step, with chunked
    prefill and with multi-token decode: one stream."""
    jgen = JaxGenerator.load(ckpt, dtype=jnp.float32, max_seq_len=256,
                             sampling=JaxSampling(**GREEDY), attention_impl="pallas",
                             quantize=mode)
    jgen.add_message(JaxMessage.user(PROMPT))
    jgen.generate(16)
    want = jgen.generated_token_ids
    assert len(want) == 16
    for kw in ({}, {"prefill_chunk": 16}, {"prefill_chunk": 16, "decode_chunk_size": 4}):
        gen = _port_stream(ckpt, mode, **kw)
        assert gen.generated_token_ids == want, kw
    assert Q.tree_quantization(gen.step.params) == mode


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_offline_quantized_checkpoint_loads_bitwise(tmp_path, ckpt, mode):
    """A checkpoint from the JAX package's offline quantizer loads into the
    leaves of the port's own quantize_params over the source, and generates
    the stream of runtime quantization with no flag."""
    dst = quantize_checkpoint(ckpt, tmp_path / "q", mode, dtype=jnp.float32)
    cfg = LlamaConfig.from_model_dir(dst)
    loaded = load_params(dst, cfg, torch.float32)
    want = Q.quantize_params(load_params(ckpt, cfg, torch.float32), mode)
    assert Q.tree_quantization(loaded) == mode
    for key, leaf in want["layers"].items():
        got = loaded["layers"][key]
        if isinstance(leaf, Q.QUANT_TYPES):
            assert type(got) is type(leaf)
            assert torch.equal(got.w, leaf.w) and torch.equal(got.scale, leaf.scale), key
        else:
            assert torch.equal(got, leaf), key
    assert torch.equal(loaded["lm_head"].w, want["lm_head"].w)
    assert torch.equal(loaded["embed"], want["embed"])
    offline = _port_stream(dst, None)
    assert offline.generated_token_ids == _port_stream(ckpt, mode).generated_token_ids


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_port_quantized_checkpoint_roundtrips(tmp_path, mode):
    cfg = LlamaConfig.tiny(num_hidden_layers=2, tie_word_embeddings=False)
    params = M.init_params(cfg, torch.Generator().manual_seed(4), torch.float32)
    q = Q.quantize_params(params, mode)
    save_tiny_checkpoint(tmp_path, q, cfg, dtype=torch.bfloat16)
    loaded = load_params(tmp_path, cfg, torch.bfloat16)
    want = fuse_params(q)
    for key in ("wqkv", "wo", "w_gu", "w_down"):
        assert torch.equal(loaded["layers"][key].w, want["layers"][key].w)
        assert torch.equal(loaded["layers"][key].scale, want["layers"][key].scale)
    assert torch.equal(loaded["lm_head"].w, want["lm_head"].w)
    # The JAX package reads the port's quantized checkpoint as its own.
    jtree = jax_load_params(tmp_path, JaxConfig.from_model_dir(tmp_path), jnp.bfloat16)
    assert JQ.tree_quantization(jtree) == mode
    np.testing.assert_array_equal(np.asarray(jtree["layers"]["w_down"].w),
                                  want["layers"]["w_down"].w.numpy())


# ------------------------------------------------- the batch engines


ENGINE_SERVE = dict(max_batch=4, decode_chunk_size=4, admission_window=0.05)
ENGINE_MODES = {"dense": {}, "paged": {"kv_mode": "paged", "page_size": 16}}
ENGINE_TURNS = ["Tell me about cakes.", "What is the capital of France?", "Name a colour."]


def _wave(submit, message_cls, sampling):
    handles = [submit([message_cls.user(t)], 12, sampling) for t in ENGINE_TURNS]
    return [[t.id for t in h.tokens()] for h in handles]


@pytest.mark.parametrize("kv_mode", list(ENGINE_MODES))
def test_int4_engine_streams_match_the_jax_engine(jax_int4_kernel, ckpt, kv_mode):
    jcfg = JaxConfig.from_model_dir(ckpt)
    jparams = JQ.quantize_params(jax_load_params(ckpt, jcfg, jnp.float32), "int4")
    jeng = JaxEngine(jcfg, jparams, jax_load_tokenizer(ckpt), max_seq_len=256,
                     cache_dtype=jnp.float32, serve=JaxServe(**ENGINE_SERVE, **ENGINE_MODES[kv_mode]))
    jeng.start()
    try:
        want = _wave(jeng.submit, JaxMessage, JaxSampling(**GREEDY))
    finally:
        jeng.stop()
    cfg = LlamaConfig.from_model_dir(ckpt)
    params = Q.quantize_params(load_params(ckpt, cfg, torch.float32), "int4")
    before = I4.int4_matmul_plain.launches
    eng = BatchEngine(cfg, params, load_tokenizer(ckpt), max_seq_len=256,
                      cache_dtype=torch.float32, device="cpu",
                      serve=ServeConfig(**ENGINE_SERVE, **ENGINE_MODES[kv_mode]))
    eng.start()
    try:
        got = _wave(eng.submit, Message, SamplingConfig(**GREEDY))
    finally:
        eng.stop()
    assert got == want
    assert all(len(ids) == 12 for ids in got)
    assert I4.int4_matmul_plain.launches > before


def test_int4_engine_with_every_fusion_equals_unfused(ckpt):
    """Over int4 weights the "norm" sites run qmat(rms_norm(...)), so every
    fusion keeps the unfused streams on the CPU."""
    cfg = LlamaConfig.from_model_dir(ckpt)
    params = Q.quantize_params(load_params(ckpt, cfg, torch.float32), "int4")
    streams = {}
    for spec in ("none", "all"):
        before = fused_norm_matmul.quantized
        eng = BatchEngine(cfg, params, load_tokenizer(ckpt), max_seq_len=256,
                          cache_dtype=torch.float32, device="cpu",
                          serve=ServeConfig(**ENGINE_SERVE, **ENGINE_MODES["paged"],
                                            fusion_impl=spec))
        eng.start()
        try:
            streams[spec] = _wave(eng.submit, Message, SamplingConfig(**GREEDY))
        finally:
            eng.stop()
        assert (fused_norm_matmul.quantized > before) == (spec == "all")
    assert streams["all"] == streams["none"]


# ------------------------------------------------- the CLI


def test_cli_parses_quantize():
    from cake_tpu_torch.cli import build_parser

    p = build_parser()
    assert p.parse_args(["--model", "m"]).quantize is None
    assert p.parse_args(["--model", "m", "--quantize", "int4"]).quantize == "int4"
    with pytest.raises(SystemExit):
        p.parse_args(["--model", "m", "--quantize", "int2"])


def test_generator_load_refuses_an_unknown_mode(ckpt):
    with pytest.raises(ValueError, match="unknown quantize mode"):
        LlamaGenerator.load(ckpt, dtype=torch.float32, device="cpu", quantize="fp4")


def test_cli_quantized_prompt_on_the_cpu(ckpt):
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-m", "cake_tpu_torch.cli", "--model", str(ckpt), "--prompt", "hi",
         "-n", "6", "--device", "cpu", "--dtype", "f32", "--quantize", "int4",
         "--temperature", "0", "--repeat-penalty", "1.0"],
        cwd=repo, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    gen = LlamaGenerator.load(ckpt, dtype=torch.float32, device="cpu", quantize="int4",
                              sampling=SamplingConfig(**GREEDY))
    gen.add_message(Message.user("hi"))
    assert proc.stdout == gen.generate(6) + "\n"
