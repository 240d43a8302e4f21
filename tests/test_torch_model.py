"""The port's model against the JAX package's, on tiny random-weight models.

One JAX ``init_params`` tree (numpy leaves) feeds both packages through
``params_from_jax``. The JAX side runs its Pallas attention kernels in
interpret mode (``attention_impl="pallas"`` on the CPU backend); the port runs
the plain versions of its kernels (CPU tensors). Logits are compared with
max-abs 1e-3 after a position-0 prefill, a cached-prefill continuation chunk
and decode steps, for the Llama, Qwen2 (QKV bias), Qwen3 (q/k norm) and
Gemma-2 (soft-caps, alternating window) tiny configs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models.llama import model as JM
from cake_tpu.models.llama.cache import init_cache as jax_init_cache
from cake_tpu.models.llama.config import LlamaConfig as JaxConfig
from cake_tpu_torch.models.llama import model as M
from cake_tpu_torch.models.llama.cache import init_cache
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.ops.fuse import fuse_params
from cake_tpu_torch.ops.moe import moe_swiglu

LOGITS_ATOL = 1e-3

FAMILIES = {
    "llama": dict(rope_scaling=None),
    "qwen2": dict(model_type="qwen2", attention_bias=True),
    "qwen3": dict(model_type="qwen3", qk_norm=True, head_dim_override=32),
    "gemma2": dict(
        model_type="gemma2", sliding_window=16, alt_sliding_window=True,
        attn_logit_softcap=30.0, final_logit_softcap=20.0, query_pre_attn_scalar=144,
        post_block_norms=True, hidden_activation="gelu_tanh", rmsnorm_offset=True,
        embedding_scale=8.0, tie_word_embeddings=True,
    ),
}


def _jax_tree(cfg, seed):
    params = JM.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32)
    return jax.tree.map(np.asarray, params)


def _configs(family):
    kw = dict(num_hidden_layers=2, **FAMILIES[family])
    return JaxConfig.tiny(attention_impl="pallas", **kw), LlamaConfig.tiny(**kw)


def test_params_from_jax_keeps_every_leaf():
    jcfg, _ = _configs("gemma2")
    tree = _jax_tree(jcfg, 0)
    port = M.params_from_jax(tree)
    assert set(port) == set(tree) and set(port["layers"]) == set(tree["layers"])
    for key, leaf in tree["layers"].items():
        assert port["layers"][key].shape == leaf.shape
        np.testing.assert_array_equal(port["layers"][key].numpy(), leaf)
    np.testing.assert_array_equal(port["embed"].numpy(), tree["embed"])


def test_params_from_jax_reads_bf16_leaves():
    tree = {"w": np.asarray(jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3))}
    out = M.params_from_jax(tree)["w"]
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), np.arange(6).reshape(2, 3))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_logits_match_jax(family):
    jcfg, pcfg = _configs(family)
    tree = _jax_tree(jcfg, 1)
    params = fuse_params(M.params_from_jax(tree))
    rng = np.random.default_rng(7)
    first = rng.integers(0, pcfg.vocab_size, (1, 8)).astype(np.int32)
    cont = rng.integers(0, pcfg.vocab_size, (1, 6)).astype(np.int32)
    hd, n_kv, n = pcfg.head_dim, pcfg.num_key_value_heads, pcfg.num_hidden_layers

    jkv = jax_init_cache(n, 1, 64, n_kv, hd, jnp.float32)
    pkv = init_cache(n, 1, 64, n_kv, hd, torch.float32)
    steps = [(first, 0, 8, False), (cont, 8, 6, True)]
    tokens_j, tokens_p = None, None
    pos = 14
    for i in range(len(steps) + 3):
        if i < len(steps):
            toks, p, seq_len, cached = steps[i]
        else:
            toks, p, seq_len, cached = tokens_p, pos, 1, False
            pos += 1
        jl, jkv = JM.forward(
            tree, jnp.asarray(toks), jkv, jnp.int32(p), jnp.int32(seq_len), jcfg,
            cached_prefill=cached,
        )
        pl, pkv = M.forward(
            params, torch.from_numpy(np.array(toks)), pkv, p, seq_len, pcfg,
            cached_prefill=cached,
        )
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGITS_ATOL, rtol=0)
        tokens_j = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        tokens_p = pl.argmax(-1).numpy().astype(np.int32)[:, None]
        np.testing.assert_array_equal(tokens_p, tokens_j)
    # Both caches hold the same K/V for every written slot.
    np.testing.assert_allclose(
        pkv.k[:, :, :, :pos].numpy(), np.asarray(jkv.k)[:, :, :, :pos], atol=1e-4, rtol=0
    )


def test_unported_paths_raise_naming_the_roadmap():
    """Tensor-parallel MoE is not ported; MoE models themselves are
    (tests/test_torch_moe*.py). The rolling window cache is ported
    (tests/test_torch_rolling.py) and refuses a model without a window."""
    cfg = LlamaConfig.tiny(num_local_experts=4)
    moe_params = M.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    assert moe_params["layers"]["router"].shape == (cfg.num_hidden_layers, cfg.hidden_size, 4)
    lp = {k: v[0] for k, v in moe_params["layers"].items()}
    x = torch.zeros(1, 8, cfg.hidden_size)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        moe_swiglu(x, lp["router"], lp["w_gate"], lp["w_up"], lp["w_down"], 2, tp_axis="tp")
    dense = dataclasses.replace(cfg, num_local_experts=0)
    params = M.init_params(dense, torch.Generator().manual_seed(0), torch.float32)
    kv = init_cache(dense.num_hidden_layers, 1, 32, dense.num_key_value_heads, dense.head_dim,
                    torch.float32)
    with pytest.raises(ValueError, match="rolling"):
        M.forward(params, torch.zeros((1, 1), dtype=torch.long), kv, 0, 1, dense, rolling=True,
                  rope_len=64)


def test_init_params_is_seeded_and_shaped_like_jax():
    cfg = LlamaConfig.tiny(num_hidden_layers=2, attention_bias=True)
    a = M.init_params(cfg, torch.Generator().manual_seed(3), torch.float32)
    b = M.init_params(cfg, torch.Generator().manual_seed(3), torch.float32)
    jtree = _jax_tree(JaxConfig.tiny(num_hidden_layers=2, attention_bias=True), 0)
    assert set(a["layers"]) == set(jtree["layers"])
    for key, leaf in jtree["layers"].items():
        assert tuple(a["layers"][key].shape) == leaf.shape
        torch.testing.assert_close(a["layers"][key], b["layers"][key], rtol=0, atol=0)
    assert M.count_params(a) == sum(x.size for x in jax.tree.leaves(jtree))
