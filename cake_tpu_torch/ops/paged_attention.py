"""Paged decode attention: one query per row over the page-pool KV cache.

Replaces the Pallas TPU kernel ``cake_tpu/ops/pallas/paged_attention.py``
(``paged_decode_attention``) with a CUDA kernel written for Hopper,
``ops/csrc/paged_decode_attention.cu``.

What bounds it on the H100: device-memory bytes, as the dense decode kernel
(ops/decode_attention.py): each live K/V row is read once and serves the
``group`` query heads of its KV head, about one FLOP per byte read.

What the design does about it: the kernel is the dense decode kernel's body
(``ops/csrc/decode_attention.cuh``, flash-decoding: key splits of
``decode_attention.SPLIT`` positions over the whole card, an ordered combine)
with one change, how a key slot becomes an address: ``page = tables[row,
j // page_size]`` (an unmapped entry, < 0, reads page 0) at offset
``j % page_size``. The split size divides 128 and the kernel takes page sizes
that are multiples of 128, so a split lies inside one page: a block looks
its page up once and reads the split's keys from one base. Only the splits
of ``[start, length)`` are walked, so dead pages cost nothing (the TPU
kernel's clamp of the logical page into the live range), and splits and key
slots go to blocks and warps exactly as in the dense kernel: on the same
keys the paged kernel gives the dense kernel's bits. The grid comes from
the pool's shapes (``decode_attention.plan`` over ``n_p * page_size``
slots), never from ``lengths``. The window folds into ``start`` as in the
JAX package's ``_apply_window`` (``ops/decode_attention.fold_window``, the
same rule).

For a tensor on the CPU the wrapper runs :func:`paged_decode_attention_plain`
(the tests' path); for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from cake_tpu_torch.models.llama.paged_cache import gather_pages
from cake_tpu_torch.ops import _build
from cake_tpu_torch.ops.decode_attention import decode_masked, row_bounds, split_launch
from cake_tpu_torch.ops.kv_dtype import F8, attention_dtype
from cake_tpu_torch.ops.launches import count
from cake_tpu_torch.ops.paged_prefill import check_paged_operands


def paged_decode_attention_plain(
    q, k_pages, v_pages, lengths, block_tables, starts=None, window_flag=None, *,
    window=None, scale=None, softcap=None,
):
    """Plain PyTorch version (the JAX package's ``paged_decode_attention_xla``):
    gather each row's pages into the dense head-major view, then the dense
    plain decode arithmetic, so it is bitwise the dense plain path on equal
    keys and equal widths."""
    count(paged_decode_attention_plain)
    return decode_masked(
        q, gather_pages(k_pages, block_tables), gather_pages(v_pages, block_tables),
        lengths, starts, window_flag, window=window, scale=scale, softcap=softcap,
    )


paged_decode_attention_plain.launches = 0


def paged_decode_attention(
    q, k_pages, v_pages, lengths, block_tables, starts=None, window_flag=None, *,
    window=None, scale=None, softcap=None,
):
    """Single-position GQA attention against the page pool.

    Args:
      q: [b, 1, n_q, hd].
      k_pages/v_pages: one layer's pool [n_pages + 1, n_kv, page_size, hd]
        (models/llama/paged_cache.py); the kernel takes page sizes that are
        multiples of 128, and pools of q's dtype, f8 or wider than q
        (``ops/kv_dtype.attention_dtype``).
      lengths: [b] int32 live prefix per row (the current token is written).
      block_tables: [b, n_p] int32 physical page per logical page; entries
        < 0 are unmapped (legal only outside [start, length)).
      starts: optional [b] int32 first live slot (left pads); None = 0.
      window_flag / window / scale / softcap: as decode_attention.

    Returns [b, 1, n_q, hd] in q's dtype.
    """
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, lengths, block_tables, starts, window_flag,
            window=window, scale=scale, softcap=softcap,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    b, q_len, n_q, hd = q.shape
    if q_len != 1:
        raise ValueError(f"paged_decode_attention takes one position, got q_len={q_len}")
    wide = attention_dtype("paged_decode_attention", q.dtype, k_pages.dtype, v_pages.dtype)
    if wide != q.dtype:  # a wider pool: the query upcast exactly, the output cast back
        return paged_decode_attention(
            q.to(wide), k_pages, v_pages, lengths, block_tables, starts, window_flag,
            window=window, scale=scale, softcap=softcap,
        ).to(q.dtype)
    n_kv, page_size, n_p, stride = check_paged_operands(
        "paged_decode_attention", q, k_pages, v_pages, block_tables
    )
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("paged_decode_attention: q must be contiguous and 16-byte aligned")
    lengths, starts = row_bounds(q, lengths, starts, window, window_flag)
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.library()
    p, part, tickets = split_launch(q, n_kv, n_p * page_size)
    err = lib.cake_paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), out.data_ptr(),
        lengths.data_ptr(), starts.data_ptr(), block_tables.data_ptr(),
        part.data_ptr(), tickets.data_ptr(),
        b, n_kv, n_q // n_kv, p.heads, page_size, n_p, stride, hd,
        _build.dtype_code(q.dtype), _build.dtype_code(k_pages.dtype),
        float(hd**-0.5 if scale is None else scale),
        float(softcap or 0.0), p.n_split, p.z,
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _build.check(err, "paged_decode_attention")
    count(paged_decode_attention)
    if k_pages.dtype == F8:
        count(paged_decode_attention, "f8")
    return out


paged_decode_attention.launches = 0
paged_decode_attention.f8 = 0  # launches over an f8 cache
