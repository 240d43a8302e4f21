"""Grouped-query attention in plain PyTorch.

Port of ``cake_tpu/ops/attention.py``: GQA without a ``repeat_kv`` copy (the
query heads of a group are reshaped onto their KV head), f32 scores, softmax
with all-masked rows guarded to exact zeros, and ``p @ v`` in the value
dtype. ``gqa_attention_hm`` reads the cache's head-major layout,
``gqa_attention`` takes fresh seq-major K/V.

These are the plain versions of the two attention kernels
(ops/decode_attention.py, ops/chunk_prefill.py): the wrappers run them for
CPU tensors, and the tests and ``chip_smoke.py`` hold the kernels against
them.
"""

from __future__ import annotations

import torch


def widen_qkv(q, k, v):
    """Mixed cache/activation precision: compute in the WIDER dtype (a
    narrow cache is cast up on read; a wider cache upgrades the query)."""
    if k.dtype == q.dtype:
        return q, k, v
    wide = k.dtype if k.element_size() > q.element_size() else q.dtype
    return q.to(wide), k.to(wide), v.to(wide)


def masked_gqa_attention_hm(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    scale: float | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """The one softmax body: q [b, q_len, n_q, hd], K/V head-major
    [b, n_kv, kv_len, hd], ``mask`` [b, q_len, kv_len] bool (True = attend).
    Returns [b, q_len, n_q, hd] in q's dtype."""
    b, q_len, n_q, hd = q.shape
    n_kv = k.shape[1]
    group = n_q // n_kv
    if scale is None:
        scale = hd**-0.5
    out_dtype = q.dtype
    q, k, v = widen_qkv(q, k, v)
    qg = q.reshape(b, q_len, n_kv, group, hd).float()
    # [b, n_kv, group, q_len, kv_len], f32 like the reference's upcast.
    scores = torch.einsum("bqkgh,bksh->bkgqs", qg, k.float()) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    scores = scores.masked_fill(~mask[:, None, None, :, :], float("-inf"))
    row_max = scores.amax(dim=-1, keepdim=True)
    row_max = torch.where(torch.isfinite(row_max), row_max, torch.zeros_like(row_max))
    weights = torch.exp(scores - row_max)
    denom = weights.sum(dim=-1, keepdim=True)
    weights = weights / torch.where(denom > 0, denom, torch.ones_like(denom))
    out = torch.einsum("bkgqs,bksh->bqkgh", weights.to(v.dtype), v)
    return out.reshape(b, q_len, n_q, hd).to(out_dtype)


def causal_mask(
    q_positions: torch.Tensor,
    k_positions: torch.Tensor,
    window: int | None = None,
    window_flag=None,
) -> torch.Tensor:
    """[b, q_len, kv_len] causal (and optionally windowed) mask from absolute
    positions; ``window_flag`` (bool or 0-dim bool tensor) gates the window."""
    mask = k_positions[:, None, :] <= q_positions[:, :, None]
    if window is not None:
        # HF convention: position p attends to [p - window + 1, p].
        in_window = k_positions[:, None, :] > q_positions[:, :, None] - window
        if window_flag is not None:
            in_window = in_window | ~torch.as_tensor(
                window_flag, dtype=torch.bool, device=in_window.device
            )
        mask = mask & in_window
    return mask


ROLLING_DEAD = 2**30  # sentinel position of a slot never written (masked out)


def rolling_kv_positions(cache_len: int, pos, valid_len) -> torch.Tensor:
    """Absolute position of each ring slot, int64: [cache_len] for a scalar
    ``pos``, [b, cache_len] for a [b] tensor of them.

    Slot s holds the unique position q = s (mod cache_len) in
    (p_max - cache_len, p_max], where p_max = pos + valid_len - 1 is the
    newest position just written. Slots never written (q < 0) get
    ROLLING_DEAD so the causal mask excludes them."""
    p_max = torch.as_tensor(pos, dtype=torch.int64) + valid_len - 1
    s = torch.arange(cache_len, dtype=torch.int64, device=p_max.device)
    p = p_max[..., None]
    q = p - ((p - s) % cache_len)
    return torch.where(q >= 0, q, torch.full_like(q, ROLLING_DEAD))


def gqa_attention_hm(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    k_positions: torch.Tensor,
    window: int | None = None,
    window_flag=None,
    scale: float | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """Causal GQA with K/V head-major [b, n_kv, kv_len, hd] (the cache
    layout); positions are [b, q_len] / [b, kv_len] int."""
    mask = causal_mask(q_positions, k_positions, window, window_flag)
    return masked_gqa_attention_hm(q, k, v, mask, scale, softcap)


def gqa_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    k_positions: torch.Tensor,
    window: int | None = None,
    window_flag=None,
    scale: float | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """``gqa_attention_hm`` for fresh seq-major K/V [b, kv_len, n_kv, hd]."""
    return gqa_attention_hm(
        q, k.transpose(1, 2), v.transpose(1, 2), q_positions, k_positions,
        window=window, window_flag=window_flag, scale=scale, softcap=softcap,
    )
