"""Causal attention for the position-0 prefill, through the chunk kernel.

Port of ``cake_tpu/ops/pallas/flash_attention.py``, which has no kernel of
its own: the offset-0 prefill is the chunked-prefill kernel
(ops/chunk_prefill.py) with ``q_starts = 0`` and ``lengths = q_len`` over the
fresh K/V. The TPU wrapper moves K/V to the head-major cache layout and pads
it to a block; the CUDA kernel reads the seq-major projections through
their strides instead, so nothing is copied. Launches count on
``chunk_prefill_attention.launches``.
"""

from __future__ import annotations

import torch

from cake_tpu_torch.ops.attention import gqa_attention
from cake_tpu_torch.ops.chunk_prefill import launch_chunk_kernel
from cake_tpu_torch.ops.launches import count


def flash_attention_plain(
    q, k, v, window_flag=None, *, window=None, scale=None, softcap=None
):
    """Plain PyTorch version: causal GQA of the chunk over itself."""
    count(flash_attention_plain)
    b, q_len = q.shape[:2]
    pos = torch.arange(q_len, device=q.device, dtype=torch.int32)[None].expand(b, -1)
    return gqa_attention(
        q, k, v, pos, pos,
        window=window, window_flag=window_flag, scale=scale, softcap=softcap,
    )


flash_attention_plain.launches = 0


def flash_attention(q, k, v, window_flag=None, *, window=None, scale=None, softcap=None):
    """Causal self-attention over a fresh chunk starting at position 0.

    Args:
      q: [b, q_len, n_q, hd]; k/v: [b, q_len, n_kv, hd] (seq-major).
      window_flag / window / scale / softcap: as chunk_prefill_attention.

    Returns [b, q_len, n_q, hd] in q's dtype.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, window_flag, window=window, scale=scale, softcap=softcap
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, q_len = q.shape[:2]
    if k.dim() != 4 or k.shape[1] != q_len:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    return launch_chunk_kernel(
        q, k, v, "bshd", None, torch.full((b,), q_len, dtype=torch.int32, device=q.device),
        None, window_flag, window=window, scale=scale, softcap=softcap,
    )
