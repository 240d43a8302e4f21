"""Chunked-prefill attention: a chunk of queries over the live KV prefix.

Replaces the Pallas TPU kernel ``cake_tpu/ops/pallas/chunk_prefill.py``
(``chunk_prefill_attention``) with a CUDA kernel written for Hopper,
``ops/csrc/chunk_prefill.cu``. The position-0 prefill reaches the same
kernel through ``ops/flash_attention.py``.

What bounds it on the H100: at the main path's chunk sizes (hundreds to
thousands of queries over a prefix of the same order) the products, about
4*head_dim FLOPs per (query, key) pair, outweigh the bytes: the tensor
cores' rate bounds it.

What the design does about it (``ops/csrc/chunk_prefill.cuh``): for f16/bf16
one block per (64 (query, head) rows of a KV head's GQA group, row) keeps
its Q rows and a 64-key K/V tile in shared memory, reads each K/V tile once
for the whole group, and runs S = Q K^T and P V on mma.sync m16n8k16 with
f32 accumulation, the softmax state in f32 registers; f32 inputs take the
same loop on the CUDA cores. The key loop starts at the first key any row
of the block needs (``k_starts``, the window) and stops at the last (the
causal end, ``lengths``), so masked-out blocks cost nothing, as the
reference's block pruning; its tiles sit at multiples of 64 in key
position, so a query's bits do not depend on the block that holds it. An f8
cache reaches shared memory narrow (cp.async, half the bytes) and each tile
is widened there, exactly, into the layout the products read; the products
stay in q's dtype, as the reference widens f8 before its dots.

A rolling window cache (models/llama/cache.py: a ring of L slots,
position p in slot p % L) is read through the ring instantiations of the
same body (``csrc/ring_chunk_attention*.cu``, ``RingLayout``) when the call
gives ``ring_limit``, the logical bound of positions: a 64-key tile of
logical positions is contiguous in the ring (L is a multiple of 128) and
the loop bounds are the dense kernel's, so a ring call gives the full
cache's bits on the same keys. Its plain version is
:func:`chunk_ring_plain`, the reference's ``gqa_attention_hm`` over
``rolling_kv_positions``. Ring launches also count in
``chunk_prefill_attention.ring``.

For a tensor on the CPU the wrapper runs :func:`chunk_prefill_attention_plain`;
for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from cake_tpu_torch.ops import _build
from cake_tpu_torch.ops.attention import causal_mask, masked_gqa_attention_hm
from cake_tpu_torch.ops.decode_attention import HEAD_DIM_TODO, HEAD_DIMS, check_ring, ring_mask
from cake_tpu_torch.ops.kv_dtype import F8, attention_dtype
from cake_tpu_torch.ops.launches import count



def as_rows(x, b, device, default=0):
    if x is None:
        return torch.full((b,), default, dtype=torch.int32, device=device)
    return torch.as_tensor(x, dtype=torch.int32, device=device).reshape(b)


def chunk_masked(q, k, v, q_starts, lengths, window_flag, k_starts, *, window, scale, softcap):
    """The plain chunk arithmetic over a dense head-major view
    [b, n_kv, kv_len, hd]: row r's query i at position q_starts[r] + i sees
    slots j with k_starts[r] <= j <= its position and j < lengths[r] (and
    inside the window when gated on). Shared with the paged plain version,
    which gathers its pages into that view first."""
    b, chunk = q.shape[:2]
    dev = q.device
    q_starts = as_rows(q_starts, b, dev)
    lengths = as_rows(lengths, b, dev)
    k_starts = as_rows(k_starts, b, dev)
    qpos = q_starts[:, None] + torch.arange(chunk, device=dev, dtype=torch.int32)[None]
    kpos = torch.arange(k.shape[2], device=dev, dtype=torch.int32)[None].expand(b, -1)
    mask = causal_mask(qpos, kpos, window, window_flag)
    live = (kpos >= k_starts[:, None]) & (kpos < lengths[:, None])
    return masked_gqa_attention_hm(
        q, k, v, mask & live[:, None, :], scale=scale, softcap=softcap
    )


def chunk_prefill_attention_plain(
    q, k_cache, v_cache, q_starts, lengths, window_flag=None, k_starts=None, *,
    window=None, scale=None, softcap=None,
):
    """Plain PyTorch version over the whole cache (``chunk_masked``)."""
    count(chunk_prefill_attention_plain)
    return chunk_masked(
        q, k_cache, v_cache, q_starts, lengths, window_flag, k_starts,
        window=window, scale=scale, softcap=softcap,
    )


chunk_prefill_attention_plain.launches = 0


def chunk_ring_plain(
    q, k_cache, v_cache, q_starts, lengths, window_flag=None, k_starts=None, *,
    window=None, scale=None, softcap=None,
):
    """Plain PyTorch version over a ring [b, n_kv, L, hd] whose newest
    written position is lengths - 1: the reference's rolling attention
    (``gqa_attention_hm`` over ``rolling_kv_positions``)."""
    count(chunk_ring_plain)
    b, chunk = q.shape[:2]
    dev = q.device
    q_starts = as_rows(q_starts, b, dev)
    qpos = q_starts[:, None] + torch.arange(chunk, device=dev, dtype=torch.int32)[None]
    mask = ring_mask(qpos, as_rows(lengths, b, dev), as_rows(k_starts, b, dev),
                     k_cache.shape[2], window, window_flag)
    return masked_gqa_attention_hm(q, k_cache, v_cache, mask, scale=scale, softcap=softcap)


chunk_ring_plain.launches = 0


def _check_operand(name, t, dtype, device):
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"chunk_prefill_attention: {name} must be {dtype} on {device}")
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
        (s * t.element_size()) % 16 for s in t.stride()[:-1]
    ):
        raise ValueError(
            f"chunk_prefill_attention: {name} needs a contiguous head_dim axis and "
            f"16-byte aligned rows (strides {t.stride()})"
        )


def launch_chunk_kernel(
    q, k, v, k_layout, q_starts, lengths, k_starts, window_flag, *,
    window, scale, softcap, ring_limit=None,
):
    """Launch the CUDA kernel. ``k_layout`` names the K/V axes: "bhsd" for
    the head-major cache, "bshd" for fresh seq-major projections (read
    through strides, never copied). ``ring_limit``: the cache is a
    contiguous rolling ring [b, n_kv, L, hd] (the module docstring)."""
    b, chunk, n_q, hd = q.shape
    if k_layout == "bhsd":
        _, n_kv, kv_len, _ = k.shape
        ksb, ksh, kss = k.stride(0), k.stride(1), k.stride(2)
        vsb, vsh, vss = v.stride(0), v.stride(1), v.stride(2)
    else:
        _, kv_len, n_kv, _ = k.shape
        ksb, kss, ksh = k.stride(0), k.stride(1), k.stride(2)
        vsb, vss, vsh = v.stride(0), v.stride(1), v.stride(2)
    wide = attention_dtype("chunk_prefill_attention", q.dtype, k.dtype, v.dtype)
    if wide != q.dtype:  # a wider cache: the query upcast exactly, the output cast back
        return launch_chunk_kernel(
            q.to(wide), k, v, k_layout, q_starts, lengths, k_starts, window_flag,
            window=window, scale=scale, softcap=softcap, ring_limit=ring_limit,
        ).to(q.dtype)
    if hd not in HEAD_DIMS or k.shape[-1] != hd or n_q % n_kv or k.shape != v.shape:
        raise ValueError(
            f"chunk_prefill_attention: q {tuple(q.shape)} does not fit k/v "
            f"{tuple(k.shape)}/{tuple(v.shape)} (head_dim must be one of {HEAD_DIMS}; "
            f"{HEAD_DIM_TODO})"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.dtype if name == "q" else k.dtype, q.device)
    out = torch.empty((b, chunk, n_q, hd), dtype=q.dtype, device=q.device)
    if b == 0 or chunk == 0:
        return out
    dev = q.device
    q_starts = as_rows(q_starts, b, dev)
    lengths = as_rows(lengths, b, dev)
    k_starts = as_rows(k_starts, b, dev)
    flag = None
    if window is not None and window_flag is not None:
        flag = torch.as_tensor(window_flag, device=dev).to(torch.int32).reshape(1)
    strides = (ctypes.c_longlong * 12)(
        q.stride(0), q.stride(1), q.stride(2),
        ksb, ksh, kss, vsb, vsh, vss,
        out.stride(0), out.stride(1), out.stride(2),
    )
    lib = _build.library()
    if ring_limit is not None:
        if not (k.is_contiguous() and v.is_contiguous()):
            raise ValueError("chunk_prefill_attention: a ring cache must be contiguous")
        err = lib.cake_ring_chunk_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q_starts.data_ptr(), lengths.data_ptr(), k_starts.data_ptr(),
            None if flag is None else flag.data_ptr(),
            b, chunk, n_q, n_kv, kv_len, ring_limit, hd,
            _build.dtype_code(q.dtype), _build.dtype_code(k.dtype),
            q.stride(0), q.stride(1), q.stride(2), out.stride(0), out.stride(1), out.stride(2),
            int(window or 0), float(hd**-0.5 if scale is None else scale), float(softcap or 0.0),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
        _build.check(err, "chunk_prefill_attention")
        count(chunk_prefill_attention)
        count(chunk_prefill_attention, "ring")
        if k.dtype == F8:
            count(chunk_prefill_attention, "f8")
        return out
    err = lib.cake_chunk_prefill_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q_starts.data_ptr(), lengths.data_ptr(), k_starts.data_ptr(),
        None if flag is None else flag.data_ptr(),
        b, chunk, n_q, n_kv, kv_len, hd,
        _build.dtype_code(q.dtype), _build.dtype_code(k.dtype),
        strides,
        int(window or 0),
        float(hd**-0.5 if scale is None else scale),
        float(softcap or 0.0),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _build.check(err, "chunk_prefill_attention")
    count(chunk_prefill_attention)
    if k.dtype == F8:
        count(chunk_prefill_attention, "f8")
    return out


def chunk_prefill_attention(
    q, k_cache, v_cache, q_starts, lengths, window_flag=None, k_starts=None, *,
    window=None, scale=None, softcap=None, ring_limit=None,
):
    """Chunk-of-queries GQA attention against the live cache prefix.

    Args:
      q: [b, chunk, n_q, hd]; row r's token i sits at q_starts[r] + i.
      k_cache/v_cache: [b, n_kv, max_seq, hd] head-major, the chunk's own
        keys already written; of q's dtype, f8 or wider than q
        (``ops/kv_dtype.attention_dtype``).
      q_starts, lengths: [b] int32; lengths >= q_starts + valid chunk.
      window_flag: optional bool / 0-dim bool tensor gating ``window``.
      k_starts: optional [b] int32 first live key slot (left-padded rows).
      window/scale/softcap: attention knobs (see decode_attention).
      ring_limit: None for the dense cache; for a rolling ring of L =
        max_seq slots whose newest written position is lengths - 1, the
        logical bound of positions. The window must be on, and the window
        plus the chunk fit the ring.

    Returns [b, chunk, n_q, hd] in q's dtype.
    """
    if ring_limit is not None:
        check_ring("chunk_prefill_attention", k_cache.shape[2], ring_limit, window, window_flag,
                   q.shape[1])
        if q.device.type == "cpu":
            return chunk_ring_plain(
                q, k_cache, v_cache, q_starts, lengths, window_flag, k_starts,
                window=window, scale=scale, softcap=softcap,
            )
    if q.device.type == "cpu":
        return chunk_prefill_attention_plain(
            q, k_cache, v_cache, q_starts, lengths, window_flag, k_starts,
            window=window, scale=scale, softcap=softcap,
        )
    if q.device.type != "cuda":
        raise ValueError(f"chunk_prefill_attention: unsupported device {q.device}")
    if k_cache.dim() != 4 or q.dim() != 4:
        raise ValueError("chunk_prefill_attention: q and the cache must be 4-D")
    return launch_chunk_kernel(
        q, k_cache, v_cache, "bhsd", q_starts, lengths, k_starts, window_flag,
        window=window, scale=scale, softcap=softcap, ring_limit=ring_limit,
    )


chunk_prefill_attention.launches = 0
chunk_prefill_attention.f8 = 0  # launches over an f8 cache
chunk_prefill_attention.ring = 0  # launches over a rolling ring (ring_limit)
