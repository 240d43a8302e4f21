"""Decode attention: one query position per row over the dense KV cache.

Replaces the Pallas TPU kernel ``cake_tpu/ops/pallas/decode_attention.py``
(``decode_attention``) with a CUDA kernel written for Hopper,
``ops/csrc/decode_attention.cu``.

What bounds it on the H100: device-memory bytes. Every live K/V row of the
cache is read once and serves the ``group`` query heads of its KV head
(4 for Llama-3-8B), about one FLOP per byte read.

What the design does about it: one thread block per (KV head, row) holds all
query heads of the group, so each K/V byte is read exactly once; the block
walks only the live slots ``[start, length)`` (the window folds into
``start``), so pruning is the loop bound and dead slots are never read; eight
warps stream the keys with coalesced vector loads, 8 keys per warp step, and
merge their partial softmax states once at the end; the group size is a
compile-time parameter, so the per-step warp reductions have no branches.
At batch 1 with 8 KV heads the grid is only 8 blocks on 132 SMs, so the
kernel is bound by load latency, not bandwidth; splitting the key range
over more blocks (flash-decoding) is later work.

For a tensor on the CPU the wrapper runs :func:`decode_attention_plain`
(the tests' path); for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from cake_tpu_torch.ops import _build
from cake_tpu_torch.ops.attention import masked_gqa_attention_hm

_KERNEL_DTYPES = (torch.float32, torch.float16, torch.bfloat16)
_HEAD_DIMS = (64, 128, 256)
_MAX_GROUP = 8


def fold_window(starts, lengths, window, window_flag):
    """The decode query sits at position length-1, so a window admits keys
    at positions >= length - window: fold that into the pruning start
    (gated per call by ``window_flag``)."""
    if window is None:
        return starts
    w_start = torch.maximum(starts, lengths - window)
    if window_flag is None:
        return w_start
    flag = torch.as_tensor(window_flag, dtype=torch.bool, device=starts.device)
    return torch.where(flag, w_start, starts)


def row_bounds(q, lengths, starts, window, window_flag):
    """[b] int32 (lengths, starts) on q's device, the window folded into
    starts. A no-op on tensors the caller already built once per dispatch."""
    b = q.shape[0]
    dev = q.device
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev).reshape(b)
    if starts is None:
        starts = torch.zeros(b, dtype=torch.int32, device=dev)
    else:
        starts = torch.as_tensor(starts, dtype=torch.int32, device=dev).reshape(b)
    return lengths, fold_window(starts, lengths, window, window_flag)


def decode_masked(q, k, v, lengths, starts, window_flag, *, window, scale, softcap):
    """The plain decode arithmetic over a dense head-major view
    [b, n_kv, kv_len, hd]: masked softmax, keys in ``[start, length)`` only
    (the window folded into ``start``). Shared with the paged plain version,
    which gathers its pages into that view first."""
    if q.shape[1] != 1:
        raise ValueError(f"decode attention takes one position, got q_len={q.shape[1]}")
    lengths, starts = row_bounds(q, lengths, starts, window, window_flag)
    kpos = torch.arange(k.shape[2], device=q.device, dtype=torch.int32)
    live = (kpos[None, :] >= starts[:, None]) & (kpos[None, :] < lengths[:, None])
    return masked_gqa_attention_hm(q, k, v, live[:, None, :], scale=scale, softcap=softcap)


def decode_attention_plain(
    q, k_cache, v_cache, lengths, starts=None, window_flag=None, *,
    window=None, scale=None, softcap=None,
):
    """Plain PyTorch version: masked softmax over the whole cache, keys in
    ``[start, length)`` only (the window folded into ``start``)."""
    decode_attention_plain.launches += 1
    return decode_masked(
        q, k_cache, v_cache, lengths, starts, window_flag,
        window=window, scale=scale, softcap=softcap,
    )


decode_attention_plain.launches = 0


def decode_attention(
    q, k_cache, v_cache, lengths, starts=None, window_flag=None, *,
    window=None, scale=None, softcap=None,
):
    """Single-position GQA attention against the cache.

    Args:
      q: [b, 1, n_q, hd]; k_cache/v_cache: [b, n_kv, max_seq, hd] head-major.
      lengths: [b] int32 live prefix per row (the current token is written).
      starts: optional [b] int32 first live slot per row (None = 0); every
        row needs starts < lengths.
      window_flag: optional bool / 0-dim bool tensor gating ``window``.
      window: sliding window (folded into ``starts``); scale: score scale
        (None = hd**-0.5); softcap: tanh soft-cap of the scores.

    Returns [b, 1, n_q, hd] in q's dtype.
    """
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k_cache, v_cache, lengths, starts, window_flag,
            window=window, scale=scale, softcap=softcap,
        )
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    b, q_len, n_q, hd = q.shape
    if q_len != 1:
        raise ValueError(f"decode_attention takes one position, got q_len={q_len}")
    if k_cache.dtype == torch.float8_e4m3fn or v_cache.dtype == torch.float8_e4m3fn:
        raise NotImplementedError(
            "decode_attention: f8 KV caches are not ported yet (ROADMAP.md)"
        )
    if q.dtype not in _KERNEL_DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(
            f"decode_attention: q/k/v dtypes {q.dtype}/{k_cache.dtype}/"
            f"{v_cache.dtype} must match and be one of {_KERNEL_DTYPES}"
        )
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: cache shapes {k_cache.shape} / {v_cache.shape}")
    kb, n_kv, max_seq, khd = k_cache.shape
    if kb != b or khd != hd or hd not in _HEAD_DIMS or n_q % n_kv:
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)} does not fit cache {tuple(k_cache.shape)} "
            f"(head_dim must be one of {_HEAD_DIMS})"
        )
    if n_q // n_kv > _MAX_GROUP:
        raise ValueError(f"decode_attention: GQA group {n_q // n_kv} > {_MAX_GROUP}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"decode_attention: {name} must be contiguous and 16-byte aligned on {q.device}"
            )
    lengths, starts = row_bounds(q, lengths, starts, window, window_flag)
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.library()
    err = lib.cake_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        lengths.data_ptr(), starts.data_ptr(),
        b, n_kv, n_q // n_kv, max_seq, hd,
        _build.DTYPE_CODES[str(q.dtype).removeprefix("torch.")],
        float(hd**-0.5 if scale is None else scale),
        float(softcap or 0.0),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
