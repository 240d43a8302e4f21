"""Llama-family decoder as plain functions over a dict of tensors.

Port of ``cake_tpu/models/llama/model.py``: Llama, Qwen2 (QKV bias), Qwen3
(q/k RMSNorm), Mistral (window, decoupled head_dim), Phi-3, the Gemma family
(scaled embeddings, (1+w) norms, GeGLU, score scale and soft-caps, per-layer
window flags, Gemma-3's dual rope) and the sparse-MoE families (Mixtral,
Qwen2-MoE with its gated shared expert, Qwen3-MoE; ops/moe.py). A
single-window model may run over the rolling window cache
(models/llama/cache.py): ``rolling`` writes each chunk into the ring and
attends through the kernels' ring instantiations, ``rope_len`` giving the
logical bound of positions.

The param tree keeps the JAX package's layout so the two can be compared
leaf for leaf: linear weights are [in, out] and applied as ``x @ w``, and
per-layer weights are stacked along a leading layer axis. Where the JAX
package scans the stack with ``lax.scan``, the port walks it with a Python
loop over per-layer views.

Attention dispatch is by the tensors' device: the wrappers in ops/ launch
the CUDA kernels for CUDA tensors and run their plain versions for CPU
tensors. The KV cache is written in place (models/llama/cache.py).

The "norm" decode fusion (``LlamaConfig.fusion_impl``, ops/fuse.py) folds
RMSNorm into the projection it feeds at three sites: the input norm ->
``wqkv`` (``block_qkv_flat``), the post-attention norm -> ``w_gu``
(``block_finish``; never for a router layer) and the final norm ->
``lm_head`` (``head_forward``, unless the embeddings are tied). A
``fusion`` argument, resolved once per dispatch (``resolve_fusion``), is
handed down to every site; None resolves it from the config.

Every projection goes through ``ops/quant.qmat``, so a weight-only
quantized tree (``ops/quant.quantize_params``, int8 or int4) runs the same
code: the int8 product in PyTorch, every int4 product through the int4
kernel (``ops/int4_matmul.py``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from cake_tpu_torch.models.llama.cache import SEQ_MULTIPLE, KVCache, write_layer, write_layer_rolling
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.ops.chunk_prefill import chunk_prefill_attention
from cake_tpu_torch.ops.decode_attention import decode_attention
from cake_tpu_torch.ops.flash_attention import flash_attention
from cake_tpu_torch.ops.fuse import resolve_fusion
from cake_tpu_torch.ops.fused_norm_matmul import fused_norm_matmul
from cake_tpu_torch.ops.mlp import swiglu, swiglu_gu, swiglu_gu_from
from cake_tpu_torch.ops.moe import moe_swiglu
from cake_tpu_torch.ops.norm import rms_norm
from cake_tpu_torch.ops.quant import QUANT_TYPES, Quant4Weight, QuantWeight, qmat
from cake_tpu_torch.ops.rope import apply_rope, model_rope_tables

Params = dict[str, Any]

def init_params(
    config: LlamaConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cpu",
) -> Params:
    """Random params drawn from ``generator`` (which must live on ``device``),
    N(0, fan_in**-0.5) like the JAX package's init; norms start at identity.
    MoE configs get the router [n, h, E], the expert stacks [n, E, in, out]
    and, for Qwen2-MoE, the shared expert and its gate [n, h, 1]."""
    h, inter, v = config.hidden_size, config.intermediate_size, config.vocab_size
    hd, n_q, n_kv = config.head_dim, config.num_attention_heads, config.num_key_value_heads
    n = config.num_hidden_layers

    def w(*shape):
        fan_in = shape[-2] if len(shape) > 1 else shape[-1]
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.normal_(0.0, fan_in**-0.5, generator=generator)

    def norm(*shape):
        fill = 0.0 if config.rmsnorm_offset else 1.0
        return torch.full(shape, fill, dtype=dtype, device=device)

    # Attention first, then the MLP: the order the dense trees' seeds draw in.
    layers = {
        "wq": w(n, h, n_q * hd),
        "wk": w(n, h, n_kv * hd),
        "wv": w(n, h, n_kv * hd),
        "wo": w(n, n_q * hd, h),
    }
    n_e = config.num_local_experts
    if n_e:
        e_inter = config.moe_intermediate_size or inter
        layers.update(router=w(n, h, n_e), w_gate=w(n, n_e, h, e_inter),
                      w_up=w(n, n_e, h, e_inter), w_down=w(n, n_e, e_inter, h))
        s_i = config.shared_expert_intermediate_size
        if s_i:
            layers.update(sh_gate=w(n, h, s_i), sh_up=w(n, h, s_i), sh_down=w(n, s_i, h),
                          se_gate=w(n, h, 1))
    else:
        layers.update(w_gate=w(n, h, inter), w_up=w(n, h, inter), w_down=w(n, inter, h))
    layers.update(ln_attn=norm(n, h), ln_mlp=norm(n, h))
    if config.post_block_norms:
        layers["ln_post_attn"] = norm(n, h)
        layers["ln_post_mlp"] = norm(n, h)
    if config.qk_norm:
        layers["q_norm"] = norm(n, hd)
        layers["k_norm"] = norm(n, hd)
    if config.sliding_pattern is not None:
        layers["win_flag"] = torch.tensor(config.sliding_pattern, device=device)
    if config.rope_local_base_freq is not None:
        if config.sliding_pattern is None:
            raise ValueError("rope_local_base_freq needs sliding_pattern")
        layers["rope_sel"] = torch.tensor(
            config.sliding_pattern, dtype=torch.int32, device=device
        )
    if config.alt_sliding_window:
        layers["win_flag"] = (torch.arange(n, device=device) % 2) == 0
    if config.attention_bias:
        layers["bq"] = w(n, 1, n_q * hd)[:, 0]
        layers["bk"] = w(n, 1, n_kv * hd)[:, 0]
        layers["bv"] = w(n, 1, n_kv * hd)[:, 0]
    return {
        "embed": w(v, h),
        "layers": layers,
        "ln_f": norm(h),
        "lm_head": w(h, v),
    }


def _to_torch(leaf, device) -> torch.Tensor:
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":  # ml_dtypes: no numpy-native bf16
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


_JAX_QUANT_LEAVES = {"QuantWeight": QuantWeight, "Quant4Weight": Quant4Weight}


def params_from_jax(tree: Params, device: torch.device | str = "cpu") -> Params:
    """The port's param tree from a JAX package param tree whose leaves are
    numpy arrays (or anything ``np.asarray`` takes). Layouts are the same
    ([in, out] linear weights, stacked layers), so this only moves data. A
    quantized leaf of the JAX package (a ``QuantWeight``/``Quant4Weight``
    NamedTuple of two arrays) becomes the port's leaf of the same name."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    leaf_cls = _JAX_QUANT_LEAVES.get(type(tree).__name__)
    if leaf_cls is not None and hasattr(tree, "_fields"):
        return leaf_cls(_to_torch(tree.w, device), _to_torch(tree.scale, device))
    return _to_torch(tree, device)


def embed_tokens(tree: Params, tokens: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    """Embedding lookup; Gemma scales by sqrt(hidden), the factor cast to the
    embedding dtype first."""
    x = tree["embed"][tokens.long()]
    if config.embedding_scale is not None:
        x = x * torch.tensor(config.embedding_scale, dtype=x.dtype, device=x.device)
    return x


def is_cached_prefill(pos: int, width: int) -> bool:
    """A multi-token chunk at a nonzero offset attends the cache prefix."""
    return pos > 0 and width > 1


def block_qkv_flat(lp, x, config: LlamaConfig, fusion=None):
    """rms_1 -> the fused QKV projection (+bias), UNSPLIT: [b, chunk,
    (n_q + 2 n_kv) hd]. With "norm" the input norm folds into the
    projection (ops/fused_norm_matmul.py)."""
    fusion = resolve_fusion(config) if fusion is None else fusion
    if "norm" in fusion:
        qkv = fused_norm_matmul(
            x, lp["ln_attn"], lp["wqkv"], eps=config.rms_norm_eps, offset=config.rmsnorm_offset
        )
    else:
        qkv = qmat(rms_norm(x, lp["ln_attn"], config.rms_norm_eps, config.rmsnorm_offset),
                   lp["wqkv"])
    if "bqkv" in lp:
        qkv = qkv + lp["bqkv"].to(qkv.dtype)
    return qkv


def block_qkv(lp, x, cos, sin, positions, config: LlamaConfig, fusion=None):
    """rms_1 -> QKV projection (+bias) -> q/k norm -> RoPE on q/k."""
    b, chunk, _ = x.shape
    hd = config.head_dim
    n_q, n_kv = config.num_attention_heads, config.num_key_value_heads
    if "rope_sel" in lp:  # Gemma-3: plane 0 global rope, plane 1 local
        cos, sin = cos[lp["rope_sel"]], sin[lp["rope_sel"]]
    if "wqkv" in lp:
        qkv = block_qkv_flat(lp, x, config, fusion)
        qw, kw = n_q * hd, n_kv * hd
        q, k, v = qkv[..., :qw], qkv[..., qw : qw + kw], qkv[..., qw + kw :]
    else:
        h = rms_norm(x, lp["ln_attn"], config.rms_norm_eps, config.rmsnorm_offset)
        q, k, v = qmat(h, lp["wq"]), qmat(h, lp["wk"]), qmat(h, lp["wv"])
        if "bq" in lp:
            q = q + lp["bq"].to(q.dtype)
            k = k + lp["bk"].to(k.dtype)
            v = v + lp["bv"].to(v.dtype)
    q = q.reshape(b, chunk, n_q, hd)
    k = k.reshape(b, chunk, n_kv, hd)
    v = v.reshape(b, chunk, n_kv, hd)
    if "q_norm" in lp:
        q = rms_norm(q, lp["q_norm"], config.rms_norm_eps, config.rmsnorm_offset)
        k = rms_norm(k, lp["k_norm"], config.rms_norm_eps, config.rmsnorm_offset)
    return apply_rope(q, cos, sin, positions), apply_rope(k, cos, sin, positions), v


def block_finish(lp, x, attn, config: LlamaConfig, fusion=None):
    """Out-projection + residual, rms_2 -> gated MLP + residual. With
    "norm" and the fused ``w_gu``, rms_2 folds into the gate|up product. A
    layer with a "router" runs the routed experts (ops/moe.py) plus, for
    Qwen2-MoE, the shared expert scaled by its sigmoid gate; the "norm"
    fusion never fires there (the router and the experts read rms_2's
    output)."""
    fusion = resolve_fusion(config) if fusion is None else fusion
    b, chunk, _ = x.shape
    off = config.rmsnorm_offset
    o = qmat(attn.reshape(b, chunk, -1), lp["wo"]).to(x.dtype)
    if "ln_post_attn" in lp:
        o = rms_norm(o, lp["ln_post_attn"], config.rms_norm_eps, off)
    x = x + o
    if "router" in lp:
        h = rms_norm(x, lp["ln_mlp"], config.rms_norm_eps, off)
        mlp = moe_swiglu(
            h, lp["router"], lp["w_gate"], lp["w_up"], lp["w_down"],
            config.num_experts_per_tok, norm_topk=config.norm_topk_prob,
        ).to(x.dtype)
        if "sh_gu" in lp or "sh_gate" in lp:
            if "sh_gu" in lp:
                shared = swiglu_gu(h, lp["sh_gu"], lp["sh_down"])
            else:
                shared = swiglu(h, lp["sh_gate"], lp["sh_up"], lp["sh_down"])
            gate = torch.sigmoid(qmat(h, lp["se_gate"]))
            mlp = mlp + (shared * gate).to(x.dtype)
    elif "w_gu" in lp:
        if "norm" in fusion:
            gu = fused_norm_matmul(x, lp["ln_mlp"], lp["w_gu"], eps=config.rms_norm_eps, offset=off)
        else:
            gu = qmat(rms_norm(x, lp["ln_mlp"], config.rms_norm_eps, off), lp["w_gu"])
        mlp = swiglu_gu_from(gu, lp["w_down"], config.hidden_activation)
    else:
        h = rms_norm(x, lp["ln_mlp"], config.rms_norm_eps, off)
        mlp = swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"], config.hidden_activation)
    mlp = mlp.to(x.dtype)
    if "ln_post_mlp" in lp:
        mlp = rms_norm(mlp, lp["ln_post_mlp"], config.rms_norm_eps, off)
    return x + mlp


def attention_rows(b: int, pos, chunk: int, device) -> dict[str, torch.Tensor]:
    """Per-row int32 bounds the attention kernels take, built once per step:
    decode lengths (pos + 1) or the continuation's q_starts and lengths.
    A decode ``pos`` may be a 0-d device tensor: the lengths then derive
    from it on the device."""
    if chunk == 1:
        if isinstance(pos, torch.Tensor):
            return {"lengths": (pos.expand(b) + 1).to(torch.int32)}
        return {"lengths": torch.full((b,), pos + 1, dtype=torch.int32, device=device)}
    q_starts = torch.full((b,), pos, dtype=torch.int32, device=device)
    return {"q_starts": q_starts, "lengths": q_starts + chunk}


def block_forward(
    lp, x, k_cache, v_cache, cos, sin, positions, pos, config: LlamaConfig,
    cached_prefill: bool = False, rolling: bool = False, rows=None, fusion=None,
    valid_len: int | None = None, ring_limit: int | None = None,
):
    """One decoder block over a token chunk; writes this chunk's K/V into the
    layer's cache in place. ``pos``: a host int, or for a one-token step a
    0-d int64 device tensor (``blocks_forward``). Returns (x_out, k_cache,
    v_cache).

    ``rolling``: the cache is a ring of L slots (models/llama/cache.py;
    needs ``config.sliding_window``): the chunk's first ``valid_len`` tokens
    are written at slots (pos + j) % L and the padded tail is dropped, then
    continuation chunks and decode steps attend through the kernels' ring
    instantiations up to ``ring_limit``, the logical bound of positions; a
    position-0 chunk attends within itself, as on the full cache. The
    reference computes the rolling path's attention as ``gqa_attention_hm``
    over ``rolling_kv_positions``, the ring kernels' plain version."""
    if fusion is None:
        fusion = resolve_fusion(config)
    b, chunk, _ = x.shape
    q, k, v = block_qkv(lp, x, cos, sin, positions, config, fusion)
    ring = {}  # the attention calls' ring argument (none over the full cache)
    if rolling:
        if config.sliding_window is None or ring_limit is None:
            raise ValueError("the rolling cache needs a sliding-window model and ring_limit")
        write_layer_rolling(k_cache, v_cache, k, v, pos, chunk if valid_len is None else valid_len)
        ring = {"ring_limit": ring_limit}
    else:
        write_layer(k_cache, v_cache, k, v, pos)
    if rows is None:
        rows = attention_rows(b, pos, chunk, x.device)
    kw = dict(
        window=config.sliding_window,
        window_flag=lp.get("win_flag"),
        scale=config.attn_scale,
        softcap=config.attn_logit_softcap,
    )
    if chunk > 1 and cached_prefill:
        # Continuation chunk: attend the live cache prefix, which already
        # holds this chunk's keys.
        attn = chunk_prefill_attention(
            q, k_cache, v_cache, rows["q_starts"], rows["lengths"], **kw, **ring
        )
    elif chunk > 1:
        # Prefill from offset 0: the chunk attends only within itself.
        attn = flash_attention(q, k, v, **kw)
    else:
        attn = decode_attention(q, k_cache, v_cache, rows["lengths"], None, **kw, **ring)
    return block_finish(lp, x, attn, config, fusion), k_cache, v_cache


def blocks_forward(
    layers: Params, x, kv: KVCache, cos, sin, pos, config: LlamaConfig,
    cached_prefill: bool = False, fusion=None, rolling: bool = False,
    valid_len: int | None = None, ring_limit: int | None = None,
):
    """Run the stacked layers in order (the JAX package's ``lax.scan``).

    ``pos`` is a host int (prefill, per-step decode) or, for a one-token
    decode step, a 0-d int64 tensor on the device (the captured decode chunk
    of models/llama/fused.py): the positions, the rope rows, the lengths and
    the cache writes then all derive from it on the device, so the step
    reads nothing back and bakes no position into a captured graph.
    ``rolling``, ``valid_len`` and ``ring_limit`` select the rolling window
    cache (``block_forward``); the rope rows stay at the absolute
    positions."""
    if fusion is None:
        fusion = resolve_fusion(config)
    b, chunk, _ = x.shape
    positions = pos + torch.arange(chunk, device=x.device)[None, :].expand(b, chunk)
    # Positions are layer-invariant: gather the rope rows once per step.
    if cos.dim() == 3:
        cos, sin = cos[:, positions], sin[:, positions]
    else:
        cos, sin = cos[positions], sin[positions]
    rows = attention_rows(b, pos, chunk, x.device)
    for i in range(kv.n_layers):
        lp = {name: w[i] for name, w in layers.items()}
        x, _, _ = block_forward(
            lp, x, kv.k[i], kv.v[i], cos, sin, positions, pos, config,
            cached_prefill=cached_prefill, rows=rows, fusion=fusion, rolling=rolling,
            valid_len=valid_len, ring_limit=ring_limit,
        )
    return x, kv


def _final_softcap(logits, config: LlamaConfig):
    cap = config.final_logit_softcap
    return logits if cap is None else cap * torch.tanh(logits / cap)


def head_forward(params: Params, x, seq_len: int, config: LlamaConfig, fusion=None):
    """Final norm + LM head at the last valid position -> [b, vocab] f32.
    With "norm" the final norm folds into the lm_head product; tied
    embeddings keep the unfused path (the transposed embedding is not the
    kernel's [in, out] layout)."""
    fusion = resolve_fusion(config) if fusion is None else fusion
    x_last = x[:, seq_len - 1]
    if "norm" in fusion and not config.tie_word_embeddings:
        logits = fused_norm_matmul(
            x_last[:, None], params["ln_f"], params["lm_head"], eps=config.rms_norm_eps,
            offset=config.rmsnorm_offset,
        )[:, 0]
        return _final_softcap(logits.float(), config)
    x_last = rms_norm(x_last, params["ln_f"], config.rms_norm_eps, config.rmsnorm_offset)
    lm_head = params["embed"].T if config.tie_word_embeddings else params["lm_head"]
    return _final_softcap(qmat(x_last, lm_head).float(), config)


def forward(
    params: Params, tokens, kv: KVCache, pos, seq_len: int, config: LlamaConfig,
    cached_prefill: bool = False, rolling: bool = False, rope=None,
    rope_len: int | None = None,
):
    """embed -> blocks -> ln_f -> lm_head at position seq_len - 1.

    Args:
      tokens: [b, chunk] int (the chunk may be padded past seq_len).
      kv: full-depth cache, updated in place.
      pos: offset of tokens[:, 0], a host int or, for a one-token step, a
        0-d int64 device tensor (``blocks_forward``); seq_len: count of
        valid tokens.
      cached_prefill: chunk > 1 at pos > 0 attends the cache prefix.
      rolling: kv is a rolling ring smaller than the logical bound of
        positions (a single-window model, models/llama/cache.py).
      rope: precomputed (cos, sin) tables (default: built for ``rope_len``,
        else kv's length).
      rope_len: the logical bound of positions, REQUIRED when rolling:
        positions run past the ring's length, which would otherwise size the
        rope table, and the ring kernels take it (rounded up to
        SEQ_MULTIPLE, the full cache's length) as their limit.

    Returns (logits [b, vocab] f32, kv).
    """
    if rolling and rope_len is None:
        raise ValueError("forward: the rolling cache needs rope_len, the logical bound")
    if rope is None:
        rope = model_rope_tables(config, rope_len or kv.max_seq_len, tokens.device)
    cos, sin = rope
    fusion = resolve_fusion(config)
    x = embed_tokens(params, tokens, config)
    ring_limit = -(-rope_len // SEQ_MULTIPLE) * SEQ_MULTIPLE if rolling else None
    x, kv = blocks_forward(
        params["layers"], x, kv, cos, sin, pos, config, cached_prefill=cached_prefill,
        fusion=fusion, rolling=rolling, valid_len=seq_len, ring_limit=ring_limit,
    )
    return head_forward(params, x, seq_len, config, fusion), kv


def count_params(params: Params) -> int:
    """Elements of every tensor in the tree (a quantized leaf: its integer
    weight and its scales, as the JAX package counts its two leaves)."""
    total = 0
    for leaf in params.values():
        if isinstance(leaf, dict):
            total += count_params(leaf)
        elif isinstance(leaf, QUANT_TYPES):
            total += leaf.w.numel() + leaf.scale.numel()
        else:
            total += leaf.numel()
    return total
