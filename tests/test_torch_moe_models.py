"""Whole sparse-MoE and Phi-3 models of the port against the JAX package's
and against transformers, on the CPU.

Each family's checkpoint is written by transformers' ``save_pretrained``
from a local config (Mixtral; Qwen2-MoE with its shared expert and
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)
``norm_topk_prob=False``; Qwen3-MoE with q/k norm; Phi-3 with and without
``sliding_window``), random weights from a seed, f32, never downloaded.
Then:

  * the port's loader gives the JAX loader's tree, fused, leaf for leaf and
    bitwise (Phi-3's ``qkv_proj``/``gate_up_proj`` against the JAX split);
    layer-range loads equal slices of the whole;
  * prefill logits within 1e-4 max-abs of the JAX package's forward, through
    a continuation chunk and decode steps (the grouped dispatch on chunks of
    8 or more tokens, the dense combine below);
  * greedy tokens equal the JAX generator's (its Pallas kernels in
    interpret mode, chunked prefill) and transformers'.

The MoE save path of the port (``save_tiny_checkpoint``) writes what both
loaders read back, and Phi-3 configs write the fused tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from cake_tpu.io.safetensors_io import load_params as jax_load_params  # noqa: E402
from cake_tpu.models.llama import model as JM  # noqa: E402
from cake_tpu.models.llama.cache import init_cache as jax_init_cache  # noqa: E402
from cake_tpu.models.llama.chat import Message as JaxMessage  # noqa: E402
from cake_tpu.models.llama.config import LlamaConfig as JaxConfig  # noqa: E402
from cake_tpu.models.llama.generator import LlamaGenerator as JaxGenerator  # noqa: E402
from cake_tpu.models.llama.generator import SamplingConfig as JaxSampling  # noqa: E402
from cake_tpu_torch.io.safetensors_io import load_params, save_tiny_checkpoint  # noqa: E402
from cake_tpu_torch.models.llama import model as M  # noqa: E402
from cake_tpu_torch.models.llama.cache import init_cache  # noqa: E402
from cake_tpu_torch.models.llama.chat import Message  # noqa: E402
from cake_tpu_torch.models.llama.config import LlamaConfig  # noqa: E402
from cake_tpu_torch.models.llama.generator import LlamaGenerator, SamplingConfig  # noqa: E402
from cake_tpu_torch.ops.fuse import fuse_params  # noqa: E402
from cake_tpu_torch.ops.quant import QUANT_TYPES, quantize_params  # noqa: E402

GREEDY = dict(temperature=0.0, repeat_penalty=1.0)
COMMON = dict(hidden_size=64, vocab_size=512, num_hidden_layers=3, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=256, rms_norm_eps=1e-5,
              tie_word_embeddings=False, bos_token_id=256, eos_token_id=260,
              attn_implementation="eager")
PROMPT_IDS = [256, 7, 301, 42, 42, 9, 123, 77, 5, 18, 460, 33]


def _hf_model(family, seed):
    if family == "mixtral":
        cfg = transformers.MixtralConfig(intermediate_size=96, num_local_experts=4,
                                         num_experts_per_tok=2, rope_theta=10000.0,
                                         sliding_window=None, **COMMON)
        cls = transformers.MixtralForCausalLM
    elif family == "qwen2_moe":
        cfg = transformers.Qwen2MoeConfig(
            intermediate_size=96, moe_intermediate_size=80, shared_expert_intermediate_size=112,
            num_experts=4, num_experts_per_tok=2, norm_topk_prob=False, rope_theta=10000.0,
            use_sliding_window=False, decoder_sparse_step=1, mlp_only_layers=[], **COMMON)
        cls = transformers.Qwen2MoeForCausalLM
    elif family == "qwen3_moe":
        cfg = transformers.Qwen3MoeConfig(
            intermediate_size=128, moe_intermediate_size=48, head_dim=16, num_experts=8,
            num_experts_per_tok=4, norm_topk_prob=True, decoder_sparse_step=1,
            rope_theta=1000000.0, attention_bias=False, **COMMON)
        cls = transformers.Qwen3MoeForCausalLM
    else:
        cfg = transformers.Phi3Config(
            intermediate_size=128, rope_theta=10000.0, pad_token_id=0,
            sliding_window=8 if family == "phi3_window" else None, **COMMON)
        cls = transformers.Phi3ForCausalLM
    torch.manual_seed(seed)
    return cls(cfg).eval().to(torch.float32)


FAMILIES = ["mixtral", "qwen2_moe", "qwen3_moe", "phi3", "phi3_window"]


@pytest.fixture(scope="module", params=FAMILIES)
def family_ckpt(request, tmp_path_factory):
    family = request.param
    model = _hf_model(family, FAMILIES.index(family))
    path = tmp_path_factory.mktemp(family)
    model.save_pretrained(path, safe_serialization=True)
    return family, path, model


def _configs(path):
    return JaxConfig.from_model_dir(path), LlamaConfig.from_model_dir(path)


def _assert_trees_equal(port, ref, where=""):
    assert set(port) == set(ref), (where, sorted(port), sorted(ref))
    for key, r in ref.items():
        p = port[key]
        if isinstance(r, dict):
            _assert_trees_equal(p, r, key)
        elif isinstance(p, QUANT_TYPES):
            np.testing.assert_array_equal(p.w.numpy(), np.asarray(r.w), err_msg=key)
            np.testing.assert_array_equal(p.scale.numpy(), np.asarray(r.scale), err_msg=key)
        else:
            assert p.dtype == torch.float32, key
            np.testing.assert_array_equal(p.numpy(), np.asarray(r), err_msg=f"{where}/{key}")


def test_loader_matches_the_jax_loader(family_ckpt):
    family, path, _ = family_ckpt
    jcfg, pcfg = _configs(path)
    ref = jax_load_params(path, jcfg, jnp.float32)
    port = load_params(path, pcfg, torch.float32)
    _assert_trees_equal(port, fuse_params(M.params_from_jax(jax.tree.map(np.asarray, ref))))
    layers = port["layers"]
    if family.startswith("phi3"):
        # The fused tensors as loaded against the JAX package's split.
        hd, n_q, n_kv = pcfg.head_dim, pcfg.num_attention_heads, pcfg.num_key_value_heads
        qw, kw = n_q * hd, n_kv * hd
        for name, cols in (("wq", slice(0, qw)), ("wk", slice(qw, qw + kw)),
                           ("wv", slice(qw + kw, None))):
            np.testing.assert_array_equal(layers["wqkv"][..., cols].numpy(),
                                          np.asarray(ref["layers"][name]))
        inter = pcfg.intermediate_size
        np.testing.assert_array_equal(layers["w_gu"][..., :inter].numpy(),
                                      np.asarray(ref["layers"]["w_gate"]))
        np.testing.assert_array_equal(layers["w_gu"][..., inter:].numpy(),
                                      np.asarray(ref["layers"]["w_up"]))
    else:
        assert layers["w_gate"].shape[1] == pcfg.num_local_experts
        assert ("sh_gu" in layers) == (family == "qwen2_moe")


def test_layer_range_loads_equal_slices(family_ckpt):
    _, path, _ = family_ckpt
    jcfg, pcfg = _configs(path)
    whole = load_params(path, pcfg, torch.float32)
    part = load_params(path, pcfg, torch.float32, layer_range=(1, 3), head=False)
    assert set(part) == {"layers"}
    _assert_trees_equal(part["layers"], {k: v[1:3] for k, v in whole["layers"].items()})
    jpart = jax_load_params(path, jcfg, jnp.float32, layer_range=(1, 3))
    _assert_trees_equal(
        part["layers"], fuse_params(M.params_from_jax(jax.tree.map(np.asarray, jpart)))["layers"])


def test_forward_logits_match_jax(family_ckpt):
    _, path, _ = family_ckpt
    jcfg, pcfg = _configs(path)
    tree = jax.tree.map(np.asarray, jax_load_params(path, jcfg, jnp.float32))
    params = load_params(path, pcfg, torch.float32)
    n, n_kv, hd = pcfg.num_hidden_layers, pcfg.num_key_value_heads, pcfg.head_dim
    jkv = jax_init_cache(n, 1, 64, n_kv, hd, jnp.float32)
    pkv = init_cache(n, 1, 64, n_kv, hd, torch.float32)
    first = np.asarray([PROMPT_IDS], np.int32)  # 12 tokens: the grouped dispatch
    cont = np.asarray([[3, 99, 150, 4, 8]], np.int32)  # 5: the dense combine
    steps = [(first, 0, 12, False), (cont, 12, 5, True)]
    nxt, pos = None, 17
    for i in range(len(steps) + 3):
        if i < len(steps):
            toks, p, seq_len, cached = steps[i]
        else:
            toks, p, seq_len, cached = nxt, pos, 1, False
            pos += 1
        jl, jkv = JM.forward(tree, jnp.asarray(toks), jkv, jnp.int32(p), jnp.int32(seq_len),
                             jcfg, cached_prefill=cached)
        pl, pkv = M.forward(params, torch.from_numpy(toks), pkv, p, seq_len, pcfg,
                            cached_prefill=cached)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
        nxt = pl.argmax(-1).numpy().astype(np.int32)[:, None]
        np.testing.assert_array_equal(nxt[:, 0], np.asarray(jnp.argmax(jl, -1)))


def _hf_greedy(model, prompt_ids, n_steps):
    ids = torch.tensor([prompt_ids], dtype=torch.long)
    out = []
    with torch.no_grad():
        for _ in range(n_steps):
            nxt = int(torch.argmax(model(ids).logits[0, -1]))
            out.append(nxt)
            ids = torch.cat([ids, torch.tensor([[nxt]])], dim=1)
    return out


def _port_greedy(params, cfg, prompt_ids, n_steps):
    kv = init_cache(cfg.num_hidden_layers, 1, 64, cfg.num_key_value_heads, cfg.head_dim,
                    torch.float32)
    logits, kv = M.forward(params, torch.tensor([prompt_ids]), kv, 0, len(prompt_ids), cfg)
    out, pos = [], len(prompt_ids)
    for _ in range(n_steps):
        nxt = int(logits[0].argmax())
        out.append(nxt)
        logits, kv = M.forward(params, torch.tensor([[nxt]]), kv, pos, 1, cfg)
        pos += 1
    return out


def test_greedy_tokens_match_transformers(family_ckpt):
    _, path, hf = family_ckpt
    _, pcfg = _configs(path)
    params = load_params(path, pcfg, torch.float32)
    assert _port_greedy(params, pcfg, PROMPT_IDS, 12) == _hf_greedy(hf, PROMPT_IDS, 12)


@pytest.mark.parametrize("prefill_chunk", [None, 8])
def test_greedy_generator_matches_the_jax_generator(family_ckpt, prefill_chunk):
    _, path, _ = family_ckpt
    jgen = JaxGenerator.load(path, dtype=jnp.float32, max_seq_len=192,
                             sampling=JaxSampling(**GREEDY), attention_impl="pallas",
                             prefill_chunk=prefill_chunk)
    jgen.add_message(JaxMessage.user("sparse experts route each token"))
    jtext = jgen.generate(10)
    pgen = LlamaGenerator.load(path, dtype=torch.float32, max_seq_len=192,
                               sampling=SamplingConfig(**GREEDY), device="cpu",
                               prefill_chunk=prefill_chunk)
    pgen.add_message(Message.user("sparse experts route each token"))
    ptext = pgen.generate(10)
    assert pgen.generated_token_ids == jgen.generated_token_ids
    assert len(pgen.generated_token_ids) > 0 and ptext == jtext


MOE_TINY = {
    "mixtral": dict(model_type="mixtral", num_local_experts=4, num_experts_per_tok=2),
    "qwen2_moe": dict(model_type="qwen2_moe", num_local_experts=4, num_experts_per_tok=2,
                      norm_topk_prob=False, moe_intermediate_size=48,
                      shared_expert_intermediate_size=80, attention_bias=True),
    "qwen3_moe": dict(model_type="qwen3_moe", num_local_experts=8, num_experts_per_tok=4,
                      moe_intermediate_size=48, qk_norm=True, head_dim_override=32),
    "phi3": dict(model_type="phi3", sliding_window=24),
}


@pytest.mark.parametrize("quantize", [None, "int8", "int4"])
@pytest.mark.parametrize("family", sorted(MOE_TINY))
def test_port_checkpoint_round_trip(tmp_path, family, quantize):
    """save_tiny_checkpoint writes a MoE tree under its family's names (a
    Phi-3 tree as its fused tensors), plain or quantized: the port reads it
    back bitwise, and the JAX loader reads the same tensors."""
    cfg = LlamaConfig.tiny(num_hidden_layers=2, **MOE_TINY[family])
    params = M.init_params(cfg, torch.Generator().manual_seed(3), torch.float32)
    if quantize:
        params = quantize_params(params, quantize)
    save_tiny_checkpoint(tmp_path, params, cfg)
    back = load_params(tmp_path, LlamaConfig.from_model_dir(tmp_path), torch.float32)
    _assert_trees_equal(back, fuse_params(params))
    if quantize is None:
        jcfg = JaxConfig.from_model_dir(tmp_path)
        jtree = jax.tree.map(np.asarray, jax_load_params(tmp_path, jcfg, jnp.float32))
        _assert_trees_equal(back, fuse_params(M.params_from_jax(jtree)))


def test_loader_refuses_a_phi3_width_the_config_does_not_have(tmp_path):
    cfg = LlamaConfig.tiny(num_hidden_layers=2, model_type="phi3")
    save_tiny_checkpoint(tmp_path, M.init_params(cfg, torch.Generator().manual_seed(0),
                                                 torch.float32), cfg)
    import dataclasses
    wrong = dataclasses.replace(cfg, num_key_value_heads=cfg.num_key_value_heads // 2)
    with pytest.raises(ValueError, match="fused qkv width"):
        load_params(tmp_path, wrong, torch.float32)
