"""Llama model configuration (the port's own copy of
``cake_tpu/models/llama/config.py``, minus its kernel-selection switches:
the port picks a kernel or its plain version by the tensors' device).

Parses the HuggingFace ``config.json`` schema, covering the same field subset the
reference framework reads (reference: cake-core/src/models/llama3/config.rs:13-26,
45-58) plus the fields needed for Llama 3.1+ rope scaling.

Unlike the reference (which hard-caps MAX_SEQ_LEN at 4096, config.rs:6), the max
sequence length here is a runtime choice: ``max_position_embeddings`` from the
checkpoint is the default ceiling, and callers size their KV caches explicitly.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Llama 3.1-style rope frequency scaling (absent => plain RoPE)."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192
    rope_type: str = "llama3"


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Architecture hyperparameters for a Llama-family decoder-only model.

    "Family" is wider than the reference's Llama-3-only scope: the same
    decoder core (RMSNorm -> GQA+RoPE -> gated MLP) runs Llama 3.x, Qwen2/2.5
    (QKV bias), Mistral (sliding window, explicit head_dim), Mixtral and
    Qwen2-MoE (sparse MoE), Gemma and Gemma-2 (GeGLU, (1+w) norms, embedding
    scale, soft-caps, alternating window), and Phi-3 (fused checkpoint
    tensors), dispatched by HF ``model_type`` — each pinned against
    transformers (tests/test_model_families.py, test_moe.py, test_gemma.py).
    """

    hidden_size: int = 4096
    intermediate_size: int = 14336
    vocab_size: int = 128256
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    max_position_embeddings: int = 8192
    bos_token_id: int = 128000
    eos_token_ids: tuple[int, ...] = (128001, 128009)
    tie_word_embeddings: bool = False
    rope_scaling: RopeScaling | None = None
    # HF model_type: "llama", "qwen2", or "mistral" — selects the chat
    # template (chat.py) and defaults; the decoder core is shared.
    model_type: str = "llama"
    # Qwen2: q/k/v projections carry a bias (o_proj does not).
    attention_bias: bool = False
    # Mistral: keys/values further than this behind the query are masked.
    # None = full causal. The preallocated cache still stores the whole
    # sequence (no rolling buffer); the window is enforced by masking.
    sliding_window: int | None = None
    # Mistral-Nemo style: head_dim decoupled from hidden_size // heads.
    head_dim_override: int | None = None
    # Qwen3 / Gemma-3: per-head RMSNorm on q and k after projection, before
    # RoPE (head_dim-wide weights q_norm/k_norm in every layer; Gemma-3's
    # use the (1+w) offset convention via rmsnorm_offset).
    qk_norm: bool = False
    # Gemma-3 dual rope: sliding layers rope at this theta (unscaled), full
    # layers at rope_theta (+ rope_scaling). None = single rope.
    rope_local_base_freq: float | None = None
    # Per-layer sliding flags (Gemma-3 layer_types 5:1 pattern). None = the
    # family default (gemma2's even/odd comes from alt_sliding_window).
    sliding_pattern: tuple[bool, ...] | None = None
    # Sparse MoE (Mixtral / Qwen2-MoE): 0 = dense MLP; > 0 = number of
    # experts, with num_experts_per_tok of them combined per token
    # (ops/moe.py).
    num_local_experts: int = 0
    num_experts_per_tok: int = 2
    # Renormalize the top-k routing probabilities to sum 1 (Mixtral always
    # does; Qwen2-MoE ships norm_topk_prob, usually false).
    norm_topk_prob: bool = True
    # Qwen2-MoE: experts use their own intermediate size (None = the dense
    # intermediate_size, as in Mixtral) and an always-on shared expert with
    # a learned sigmoid gate.
    moe_intermediate_size: int | None = None
    shared_expert_intermediate_size: int | None = None
    # Gemma family knobs. hidden_activation: the MLP gate activation ("silu"
    # = SwiGLU everywhere else, "gelu_tanh" = Gemma's GeGLU). rmsnorm_offset:
    # norm weights stored zero-centered, applied as (1 + w).
    # embedding_scale: embeddings multiplied by sqrt(hidden) after lookup.
    hidden_activation: str = "silu"
    rmsnorm_offset: bool = False
    embedding_scale: float | None = None
    # Gemma-2 extras: tanh soft-capping of attention scores / final logits,
    # an attention scale decoupled from head_dim (query_pre_attn_scalar),
    # post-attention/post-MLP norms, and the alternating local/global window
    # pattern (even layers sliding, odd global).
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    query_pre_attn_scalar: int | None = None
    post_block_norms: bool = False
    alt_sliding_window: bool = False
    # Decode op fusion (ops/fuse.py parse_fusion_spec): "none", "all", or a
    # comma list from {norm, ingest, tail}. A runtime knob, never an HF field.
    fusion_impl: str = "none"
    # Chat-template override (--chat-template; not an HF field). None = pick
    # by model_type. Needed for Llama-2-chat checkpoints, whose config.json
    # is indistinguishable from base Llama (chat.DIALOG_ENCODERS keys).
    chat_template: str | None = None

    @property
    def dialog_template(self) -> str:
        return self.chat_template or self.model_type

    @property
    def attn_scale(self) -> float | None:
        """Score scale override (None = head_dim**-0.5): THE one mapping of
        Gemma-2's query_pre_attn_scalar, shared by every execution backend."""
        if self.query_pre_attn_scalar is None:
            return None
        return float(self.query_pre_attn_scalar) ** -0.5

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_size // self.num_attention_heads

    @property
    def num_query_groups(self) -> int:
        """Query heads per KV head (GQA group size)."""
        return self.num_attention_heads // self.num_key_value_heads

    def __post_init__(self) -> None:
        if self.head_dim_override is None and (
            self.hidden_size % self.num_attention_heads
        ):
            raise ValueError(
                f"hidden_size {self.hidden_size} not divisible by "
                f"num_attention_heads {self.num_attention_heads} "
                "(set head_dim explicitly in config.json to decouple them)"
            )
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError(
                f"num_attention_heads {self.num_attention_heads} not divisible by "
                f"num_key_value_heads {self.num_key_value_heads}"
            )

    @classmethod
    def from_hf_dict(cls, d: dict[str, Any]) -> "LlamaConfig":
        """Build from a parsed HF ``config.json`` dict.

        Mirrors the normalization in the reference's ``LlamaConfig::into_config``
        (config.rs:45-58): missing ``num_key_value_heads`` falls back to MHA, rope
        theta defaults, and eos may be a scalar or a list.
        """
        eos = d.get("eos_token_id", 128001)
        if isinstance(eos, int):
            eos_ids: tuple[int, ...] = (eos,)
        else:
            eos_ids = tuple(int(e) for e in eos)
        heads = int(d.get("num_attention_heads", 32))
        rs = None
        raw_rs = d.get("rope_scaling")
        if raw_rs and raw_rs.get("rope_type", raw_rs.get("type")) == "linear":
            # Plain linear frequency scaling (Gemma-3 global rope).
            rs = RopeScaling(
                factor=float(raw_rs.get("factor", 8.0)), rope_type="linear"
            )
        if raw_rs and raw_rs.get("rope_type", raw_rs.get("type")) == "llama3":
            rs = RopeScaling(
                factor=float(raw_rs.get("factor", 8.0)),
                low_freq_factor=float(raw_rs.get("low_freq_factor", 1.0)),
                high_freq_factor=float(raw_rs.get("high_freq_factor", 4.0)),
                original_max_position_embeddings=int(
                    raw_rs.get("original_max_position_embeddings", 8192)
                ),
            )
        model_type = str(d.get("model_type", "llama"))
        if model_type not in (
            "llama", "qwen2", "mistral", "mixtral", "qwen2_moe",
            "gemma", "gemma2", "phi3", "qwen3", "qwen3_moe", "gemma3_text",
        ):
            if model_type == "gemma3":
                raise ValueError(
                    "model_type 'gemma3' is the MULTIMODAL wrapper config; "
                    "use a text-only checkpoint (model_type 'gemma3_text') — "
                    "its fields live under the wrapper's text_config"
                )
            raise ValueError(
                f"unsupported model_type {model_type!r} (supported: llama, "
                "qwen2, mistral, mixtral, qwen2_moe, gemma, gemma2, phi3, "
                "qwen3, qwen3_moe, gemma3_text)"
            )
        if model_type == "phi3" and d.get("rope_scaling"):
            # Phi-3 128k variants use longrope (per-dim su-scaled factors);
            # only the base-rope variants (4k/8k) are supported.
            raise ValueError(
                "phi3 rope_scaling (longrope) is not supported; use a "
                "base-context Phi-3 checkpoint"
            )
        if model_type in ("qwen2_moe", "qwen3_moe"):
            # Layers can individually opt out of MoE via these knobs; only
            # the uniform all-sparse shape (every shipped Qwen-MoE model)
            # is supported — mixed dense/sparse stacks are an explicit error.
            if int(d.get("decoder_sparse_step", 1)) != 1 or d.get(
                "mlp_only_layers"
            ):
                raise ValueError(
                    f"{model_type} with decoder_sparse_step != 1 or "
                    "mlp_only_layers needs per-layer dense/sparse mixing, "
                    "which this framework does not support"
                )
        n_layers = int(d.get("num_hidden_layers", 32))
        sliding_pattern = None
        if model_type == "gemma3_text":
            lt = d.get("layer_types")
            if lt is None:
                # Real checkpoints often ship only sliding_window_pattern
                # (default 6): every pattern-th layer is full attention.
                # Built over n_layers so the pattern length always matches
                # the actual stack depth.
                swp = int(d.get("sliding_window_pattern", 6))
                lt = [
                    "full_attention"
                    if swp > 0 and (i + 1) % swp == 0
                    else "sliding_attention"
                    for i in range(n_layers)
                ]
            sliding_pattern = tuple(t == "sliding_attention" for t in lt)
        head_dim = d.get("head_dim")
        if head_dim is None and model_type in ("qwen3", "qwen3_moe", "gemma3_text"):
            # HF class defaults regardless of hidden_size/heads (the
            # honor-the-class-default rule): Qwen3 128, Gemma3 256.
            head_dim = 256 if model_type == "gemma3_text" else 128
        hidden = int(d.get("hidden_size", 4096))
        if head_dim is not None and int(head_dim) * heads == hidden:
            head_dim = None  # redundant with the derived value
        sw = d.get("sliding_window")
        # Qwen2 ships sliding_window in config.json but gates it off with
        # use_sliding_window (default false) — honor the gate. When on,
        # transformers applies the window only to layers >= max_window_layers;
        # the common shipped shape (max_window_layers == num_hidden_layers)
        # means NO layer is windowed. Per-layer windows aren't supported here,
        # so the mixed shape is an explicit error rather than wrong numerics.
        if model_type in ("qwen2", "qwen2_moe", "qwen3", "qwen3_moe"):
            if not d.get("use_sliding_window", False):
                sw = None
            else:
                mwl = int(d.get("max_window_layers", n_layers))
                if mwl >= n_layers:
                    sw = None  # threshold never reached: full causal everywhere
                elif mwl > 0:
                    raise ValueError(
                        f"qwen2 max_window_layers={mwl} < num_hidden_layers="
                        f"{n_layers} needs per-layer sliding windows, which "
                        "this framework does not support"
                    )
        if model_type == "gemma3_text" and sw is None:
            sw = 4096  # HF Gemma3TextConfig class default
        # Explicit null is treated like absence (HF default 5632), but an
        # explicit 0 means "shared expert disabled" and must survive parsing
        # (model.py gates the shared-expert weights on truthiness).
        se_size = d.get("shared_expert_intermediate_size", 5632)
        se_size = 5632 if se_size is None else int(se_size)
        return cls(
            hidden_size=hidden,
            intermediate_size=int(d.get("intermediate_size", 14336)),
            vocab_size=int(d.get("vocab_size", 128256)),
            num_hidden_layers=int(d.get("num_hidden_layers", 32)),
            num_attention_heads=heads,
            num_key_value_heads=int(d.get("num_key_value_heads", heads)),
            rms_norm_eps=float(d.get("rms_norm_eps", 1e-5)),
            rope_theta=float(d.get("rope_theta", 10000.0)),
            max_position_embeddings=int(d.get("max_position_embeddings", 8192)),
            bos_token_id=int(d.get("bos_token_id", 128000)),
            eos_token_ids=eos_ids,
            tie_word_embeddings=bool(
                # Gemma ties embeddings BY DEFAULT, so its config.json omits
                # the field (it matches the HF base default of True).
                d.get(
                    "tie_word_embeddings",
                    model_type in ("gemma", "gemma2", "gemma3_text"),
                )
            ),
            rope_scaling=rs,
            model_type=model_type,
            attention_bias=bool(
                d.get("attention_bias", model_type in ("qwen2", "qwen2_moe"))
            ),
            sliding_window=None if sw is None else int(sw),
            head_dim_override=None if head_dim is None else int(head_dim),
            num_local_experts=(
                int(d.get("num_local_experts", 8))
                if model_type == "mixtral"
                else int(d.get("num_experts", 60))
                if model_type == "qwen2_moe"
                else int(d.get("num_experts", 128))
                if model_type == "qwen3_moe"
                else 0
            ),
            num_experts_per_tok=int(
                # HF defaults differ by family: Mixtral 2, Qwen2-MoE 4,
                # Qwen3-MoE 8.
                d.get(
                    "num_experts_per_tok",
                    {"qwen2_moe": 4, "qwen3_moe": 8}.get(model_type, 2),
                )
            ),
            norm_topk_prob=bool(
                # HF class defaults: Mixtral always renormalizes; BOTH Qwen
                # MoE configs default False (shipped Qwen3-MoE checkpoints
                # set True explicitly — honor the field, not the brand).
                d.get(
                    "norm_topk_prob",
                    model_type not in ("qwen2_moe", "qwen3_moe"),
                )
            ),
            moe_intermediate_size=(
                int(d["moe_intermediate_size"])
                if model_type in ("qwen2_moe", "qwen3_moe")
                and "moe_intermediate_size" in d
                else None
            ),
            qk_norm=model_type in ("qwen3", "qwen3_moe", "gemma3_text"),
            rope_local_base_freq=(
                float(d.get("rope_local_base_freq", 10000.0))
                if model_type == "gemma3_text"
                else None
            ),
            sliding_pattern=sliding_pattern,
            shared_expert_intermediate_size=(
                se_size if model_type == "qwen2_moe" else None
            ),
            hidden_activation=(
                "gelu_tanh"
                if model_type in ("gemma", "gemma2", "gemma3_text")
                else "silu"
            ),
            rmsnorm_offset=model_type in ("gemma", "gemma2", "gemma3_text"),
            embedding_scale=(
                float(hidden) ** 0.5
                if model_type in ("gemma", "gemma2", "gemma3_text")
                else None
            ),
            attn_logit_softcap=(
                float(d["attn_logit_softcapping"])
                if model_type == "gemma2"
                and d.get("attn_logit_softcapping") is not None
                else None
            ),
            final_logit_softcap=(
                float(d["final_logit_softcapping"])
                if model_type == "gemma2"
                and d.get("final_logit_softcapping") is not None
                else None
            ),
            query_pre_attn_scalar=(
                int(d.get("query_pre_attn_scalar") or 256)
                if model_type in ("gemma2", "gemma3_text")
                else None
            ),
            post_block_norms=model_type in ("gemma2", "gemma3_text"),
            alt_sliding_window=model_type == "gemma2",
        )

    @classmethod
    def from_model_dir(cls, model_dir: str | Path) -> "LlamaConfig":
        """Load ``config.json`` from a model directory (config.rs:28-42)."""
        path = Path(model_dir) / "config.json"
        with open(path) as f:
            config = cls.from_hf_dict(json.load(f))
        # Real instruct checkpoints carry their FULL stop-token list in
        # generation_config.json (Llama-3-Instruct: [128001, 128008, 128009]
        # there, while config.json says just 128001 — without the merge,
        # generation would run through <|eot_id|> instead of stopping, the
        # behavior transformers gets from GenerationConfig). Union, config
        # ids first. The reference reads config.json only (config.rs:13-26)
        # and so inherits exactly this bug on instruct checkpoints.
        gen_path = Path(model_dir) / "generation_config.json"
        if gen_path.exists():
            with open(gen_path) as f:
                gen_eos = json.load(f).get("eos_token_id")
            if gen_eos is not None:
                if isinstance(gen_eos, int):
                    gen_eos = [gen_eos]
                merged = list(config.eos_token_ids)
                merged += [int(e) for e in gen_eos if int(e) not in merged]
                config = dataclasses.replace(
                    config, eos_token_ids=tuple(merged)
                )
        return config

    @classmethod
    def tiny(cls, **overrides: Any) -> "LlamaConfig":
        """A minuscule config for tests (random weights, CPU-friendly)."""
        kw: dict[str, Any] = dict(
            hidden_size=64,
            intermediate_size=128,
            vocab_size=512,
            num_hidden_layers=4,
            num_attention_heads=4,
            num_key_value_heads=2,
            rms_norm_eps=1e-5,
            rope_theta=10000.0,
            max_position_embeddings=256,
            # Special ids match tokenizer.ByteTokenizer (256 = begin_of_text,
            # 259 = eot, 260 = end_of_text).
            bos_token_id=256,
            eos_token_ids=(259, 260),
        )
        kw.update(overrides)
        return cls(**kw)

    def to_hf_dict(self) -> dict[str, Any]:
        arch = {
            "llama": "LlamaForCausalLM",
            "qwen2": "Qwen2ForCausalLM",
            "mistral": "MistralForCausalLM",
            "mixtral": "MixtralForCausalLM",
            "qwen2_moe": "Qwen2MoeForCausalLM",
            "gemma": "GemmaForCausalLM",
            "gemma2": "Gemma2ForCausalLM",
            "gemma3_text": "Gemma3ForCausalLM",
            "phi3": "Phi3ForCausalLM",
            "qwen3": "Qwen3ForCausalLM",
            "qwen3_moe": "Qwen3MoeForCausalLM",
        }[self.model_type]
        d: dict[str, Any] = {
            "architectures": [arch],
            "model_type": self.model_type,
            "hidden_size": self.hidden_size,
            "intermediate_size": self.intermediate_size,
            "vocab_size": self.vocab_size,
            "num_hidden_layers": self.num_hidden_layers,
            "num_attention_heads": self.num_attention_heads,
            "num_key_value_heads": self.num_key_value_heads,
            "rms_norm_eps": self.rms_norm_eps,
            "rope_theta": self.rope_theta,
            "max_position_embeddings": self.max_position_embeddings,
            "bos_token_id": self.bos_token_id,
            "eos_token_id": list(self.eos_token_ids)
            if len(self.eos_token_ids) > 1
            else self.eos_token_ids[0],
            "tie_word_embeddings": self.tie_word_embeddings,
        }
        # Emitted unconditionally: from_hf_dict defaults attention_bias by
        # family (True for qwen2), so omitting a False would flip on reload.
        d["attention_bias"] = self.attention_bias
        if self.sliding_window is not None:
            d["sliding_window"] = self.sliding_window
            if self.model_type in ("qwen2", "qwen2_moe", "qwen3", "qwen3_moe"):
                d["use_sliding_window"] = True
                # All layers windowed; without this, from_hf_dict's default
                # (max_window_layers = num_hidden_layers) gates the window off.
                d["max_window_layers"] = 0
        if self.head_dim_override is not None:
            d["head_dim"] = self.head_dim_override
        if self.num_local_experts:
            if self.model_type in ("qwen2_moe", "qwen3_moe"):
                d["num_experts"] = self.num_local_experts
                d["norm_topk_prob"] = self.norm_topk_prob
                if self.moe_intermediate_size is not None:
                    d["moe_intermediate_size"] = self.moe_intermediate_size
                if self.shared_expert_intermediate_size is not None:
                    d["shared_expert_intermediate_size"] = (
                        self.shared_expert_intermediate_size
                    )
            else:
                d["num_local_experts"] = self.num_local_experts
            d["num_experts_per_tok"] = self.num_experts_per_tok
        if self.model_type in ("gemma", "gemma2"):
            d["hidden_activation"] = "gelu_pytorch_tanh"
            d["head_dim"] = self.head_dim
        if self.model_type == "gemma2":
            d["attn_logit_softcapping"] = self.attn_logit_softcap
            d["final_logit_softcapping"] = self.final_logit_softcap
            d["query_pre_attn_scalar"] = self.query_pre_attn_scalar
        if self.model_type == "gemma3_text":
            d["rope_local_base_freq"] = self.rope_local_base_freq
            d["query_pre_attn_scalar"] = self.query_pre_attn_scalar
            d["head_dim"] = self.head_dim
            if self.sliding_pattern is not None:
                d["layer_types"] = [
                    "sliding_attention" if f else "full_attention"
                    for f in self.sliding_pattern
                ]
        if self.rope_scaling is not None and self.rope_scaling.rope_type == "linear":
            d["rope_scaling"] = {
                "rope_type": "linear",
                "factor": self.rope_scaling.factor,
            }
        elif self.rope_scaling is not None:
            d["rope_scaling"] = {
                "rope_type": "llama3",
                "factor": self.rope_scaling.factor,
                "low_freq_factor": self.rope_scaling.low_freq_factor,
                "high_freq_factor": self.rope_scaling.high_freq_factor,
                "original_max_position_embeddings": (
                    self.rope_scaling.original_max_position_embeddings
                ),
            }
        return d
