"""Rotary position embeddings (port of ``cake_tpu/ops/rope.py``).

HuggingFace rotate-half layout, tables computed once in f32 (with Llama-3.1
"llama3" or plain "linear" frequency scaling), rows gathered by position.
"""

from __future__ import annotations

import numpy as np
import torch

from cake_tpu_torch.models.llama.config import RopeScaling


def rope_frequencies(
    head_dim: int, theta: float, scaling: RopeScaling | None = None
) -> np.ndarray:
    """Inverse frequencies [head_dim // 2] in f32, optionally rescaled."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    if scaling is not None and scaling.rope_type == "linear":
        return (inv_freq / scaling.factor).astype(np.float32)
    if scaling is not None:
        low_wavelen = scaling.original_max_position_embeddings / scaling.low_freq_factor
        high_wavelen = scaling.original_max_position_embeddings / scaling.high_freq_factor
        wavelen = 2.0 * np.pi / inv_freq
        scaled = np.where(wavelen > low_wavelen, inv_freq / scaling.factor, inv_freq)
        smooth = (
            scaling.original_max_position_embeddings / wavelen - scaling.low_freq_factor
        ) / (scaling.high_freq_factor - scaling.low_freq_factor)
        mid = (1.0 - smooth) * inv_freq / scaling.factor + smooth * inv_freq
        is_mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
        inv_freq = np.where(is_mid, mid, scaled)
    return inv_freq.astype(np.float32)


def rope_table(
    head_dim: int,
    max_seq_len: int,
    theta: float,
    scaling: RopeScaling | None = None,
    device: torch.device | str = "cpu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each [max_seq_len, head_dim // 2] f32."""
    inv_freq = rope_frequencies(head_dim, theta, scaling)
    t = np.arange(max_seq_len, dtype=np.float32)
    freqs = np.outer(t, inv_freq)
    return (
        torch.from_numpy(np.cos(freqs)).to(device),
        torch.from_numpy(np.sin(freqs)).to(device),
    )


def model_rope_tables(config, max_seq_len: int, device: torch.device | str = "cpu"):
    """Plain [max_seq, hd/2] tables, or for dual-rope families (Gemma-3)
    stacked [2, max_seq, hd/2] tables: plane 0 global, plane 1 local."""
    if getattr(config, "rope_local_base_freq", None) is None:
        return rope_table(
            config.head_dim, max_seq_len, config.rope_theta, config.rope_scaling, device
        )
    cos_g, sin_g = rope_table(
        config.head_dim, max_seq_len, config.rope_theta, config.rope_scaling, device
    )
    cos_l, sin_l = rope_table(
        config.head_dim, max_seq_len, config.rope_local_base_freq, None, device
    )
    return torch.stack([cos_g, cos_l]), torch.stack([sin_g, sin_l])


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, positions: torch.Tensor | None
) -> torch.Tensor:
    """Rotate q or k.

    Args:
      x: [b, s, heads, hd]
      cos/sin: [max_seq, hd/2] tables, or pre-gathered [b, s, hd/2] rows
        (``positions`` then ignored).
      positions: [b, s] absolute positions.
    """
    dtype = x.dtype
    if cos.dim() == 3:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    else:
        c, s = cos[positions][:, :, None, :], sin[positions][:, :, None, :]
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat((x1 * c - x2 * s, x2 * c + x1 * s), dim=-1).to(dtype)
