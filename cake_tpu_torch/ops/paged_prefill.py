"""Paged chunk attention: a chunk of queries over the page-pool KV prefix.

Replaces the Pallas TPU kernel ``cake_tpu/ops/pallas/paged_prefill.py``
(``paged_chunk_attention``) with a CUDA kernel written for Hopper,
``ops/csrc/paged_chunk_attention.cu``. One kernel serves the three paged
prefill shapes: the cold prefill (``q_starts = 0``), the warm suffix prefill
over a forked prefix-cache chain (``q_starts`` = the window start) and
verify-shaped chunks (``q_starts`` = the shared slot).

What bounds it on the H100: at prefill shapes the products, about
4*head_dim FLOPs per (query, key) pair, outweigh the bytes, as for the dense
chunk kernel (ops/chunk_prefill.py); f16/bf16 run them on the tensor cores.

What the design does about it: the kernel is the dense chunk kernel's body
(``ops/csrc/chunk_prefill.cuh``): one block per (64 (query, head) rows of a
KV head's GQA group, row) reads each 64-key K/V tile once for the whole
group, and runs both products on mma.sync m16n8k16 with f32 accumulation
(f32 inputs: the CUDA cores). The key loop runs only over the tiles of
``[max(k_start, window start), min(q0 + rows, length))``, tiles placed by
key position. Each key row of a tile resolves its page through the block
table, so dead pages are never read. A query tile with no live key writes
zeros and an all-masked row comes out exactly 0 (the TPU kernel's ``_init``
and ``m_safe`` contracts); ``p`` is rounded to V's dtype before ``p@v``.

For a tensor on the CPU the wrapper runs :func:`paged_chunk_attention_plain`;
for a CUDA tensor it launches the kernel or raises. There is no quiet switch
to the plain version: a page size the kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import torch

from cake_tpu_torch.models.llama.paged_cache import gather_pages
from cake_tpu_torch.ops import _build
from cake_tpu_torch.ops.chunk_prefill import as_rows, chunk_masked
from cake_tpu_torch.ops.decode_attention import HEAD_DIM_TODO, HEAD_DIMS
from cake_tpu_torch.ops.kv_dtype import F8, attention_dtype
from cake_tpu_torch.ops.launches import count

_PAGE_MULTIPLE = 128


def paged_kernel_supported(page_size: int) -> bool:
    """Whether the paged CUDA kernels take this pool layout: a page of a
    whole number of 128 slots (two 64-key tiles of the chunk kernel)."""
    return page_size > 0 and page_size % _PAGE_MULTIPLE == 0


def check_paged_operands(name, q, k_pages, v_pages, block_tables):
    """Validate what the paged kernels take, for q already in the dtype
    they compute in (``ops/kv_dtype.attention_dtype``); returns (n_kv,
    page_size, n_p, table row stride). Raises ValueError for anything the
    kernels do not take."""
    hd = q.shape[-1]
    n_q = q.shape[2]
    if attention_dtype(name, q.dtype, k_pages.dtype, v_pages.dtype) != q.dtype:
        raise ValueError(f"{name}: q must come in the dtype the kernel computes in")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"{name}: pool shapes {tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    _, n_kv, page_size, khd = k_pages.shape
    if khd != hd or hd not in HEAD_DIMS or n_q % n_kv:
        raise ValueError(
            f"{name}: q {tuple(q.shape)} does not fit pool {tuple(k_pages.shape)} "
            f"(head_dim must be one of {HEAD_DIMS}; {HEAD_DIM_TODO})"
        )
    if not paged_kernel_supported(page_size):
        raise ValueError(
            f"{name}: page_size {page_size} is not a multiple of {_PAGE_MULTIPLE}"
        )
    for tname, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be contiguous and 16-byte aligned on {q.device}")
    if (
        block_tables.dtype != torch.int32
        or block_tables.device != q.device
        or block_tables.dim() != 2
        or block_tables.shape[0] != q.shape[0]
        or block_tables.shape[1] < 1
        or block_tables.stride(1) != 1
    ):
        raise ValueError(
            f"{name}: block_tables must be [b, n_p >= 1] int32 on {q.device} with "
            f"contiguous rows, got {tuple(block_tables.shape)} {block_tables.dtype}"
        )
    return n_kv, page_size, block_tables.shape[1], block_tables.stride(0)


def paged_chunk_attention_plain(
    q, k_pages, v_pages, q_starts, lengths, k_starts, block_tables, window_flag=None, *,
    window=None, scale=None, softcap=None,
):
    """Plain PyTorch version (the JAX package's ``paged_chunk_attention_xla``):
    gather each row's pages into the dense head-major view, then the dense
    plain chunk arithmetic, so it is bitwise the dense plain path on equal
    keys and equal widths."""
    count(paged_chunk_attention_plain)
    return chunk_masked(
        q, gather_pages(k_pages, block_tables), gather_pages(v_pages, block_tables),
        q_starts, lengths, window_flag, k_starts,
        window=window, scale=scale, softcap=softcap,
    )


paged_chunk_attention_plain.launches = 0


def paged_chunk_attention(
    q, k_pages, v_pages, q_starts, lengths, k_starts, block_tables, window_flag=None, *,
    window=None, scale=None, softcap=None,
):
    """Chunk-of-queries GQA attention against the page pool.

    Args:
      q: [b, chunk, n_q, hd]; row r's token i sits at slot q_starts[r] + i,
        the chunk's own keys already written through the block table.
      k_pages/v_pages: one layer's pool [n_pages + 1, n_kv, page_size, hd],
        of q's dtype, f8 or wider than q (``ops/kv_dtype.attention_dtype``).
      q_starts, lengths, k_starts: [b] int32 (first query slot, live prefix,
        first live key slot).
      block_tables: [b, n_p] int32; entries < 0 are unmapped (legal only
        outside the live window). ``n_p`` bounds every read: callers slice
        the table to the epoch's capacity.
      window_flag / window / scale / softcap: as chunk_prefill_attention.

    Returns [b, chunk, n_q, hd] in q's dtype.
    """
    if q.device.type == "cpu":
        return paged_chunk_attention_plain(
            q, k_pages, v_pages, q_starts, lengths, k_starts, block_tables, window_flag,
            window=window, scale=scale, softcap=softcap,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_chunk_attention: unsupported device {q.device}")
    if q.dim() != 4:
        raise ValueError("paged_chunk_attention: q must be [b, chunk, n_q, hd]")
    wide = attention_dtype("paged_chunk_attention", q.dtype, k_pages.dtype, v_pages.dtype)
    if wide != q.dtype:  # a wider pool: the query upcast exactly, the output cast back
        return paged_chunk_attention(
            q.to(wide), k_pages, v_pages, q_starts, lengths, k_starts, block_tables, window_flag,
            window=window, scale=scale, softcap=softcap,
        ).to(q.dtype)
    n_kv, page_size, n_p, stride = check_paged_operands(
        "paged_chunk_attention", q, k_pages, v_pages, block_tables
    )
    b, chunk, n_q, hd = q.shape
    if q.stride(-1) != 1 or q.data_ptr() % 16 or any(
        (s * q.element_size()) % 16 for s in q.stride()[:-1]
    ):
        raise ValueError(
            f"paged_chunk_attention: q needs a contiguous head_dim axis and 16-byte "
            f"aligned rows (strides {q.stride()})"
        )
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
    lib = _build.library()
    err = lib.cake_paged_chunk_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), out.data_ptr(),
        q_starts.data_ptr(), lengths.data_ptr(), k_starts.data_ptr(),
        block_tables.data_ptr(), None if flag is None else flag.data_ptr(),
        b, chunk, n_q, n_kv, page_size, n_p, stride, hd,
        _build.dtype_code(q.dtype), _build.dtype_code(k_pages.dtype),
        q.stride(0), q.stride(1), q.stride(2), out.stride(0), out.stride(1), out.stride(2),
        int(window or 0),
        float(hd**-0.5 if scale is None else scale),
        float(softcap or 0.0),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _build.check(err, "paged_chunk_attention")
    count(paged_chunk_attention)
    if k_pages.dtype == F8:
        count(paged_chunk_attention, "f8")
    return out


paged_chunk_attention.launches = 0
paged_chunk_attention.f8 = 0  # launches over an f8 cache
