"""Decode attention: one query position per row over the dense KV cache.

Replaces the Pallas TPU kernel ``cake_tpu/ops/pallas/decode_attention.py``
(``decode_attention``) with a CUDA kernel written for Hopper,
``ops/csrc/decode_attention.cu``.

What bounds it on the H100: device-memory bytes. Every live K/V row of the
cache is read once and serves the ``group`` query heads of its KV head
(4 for Llama-3-8B), about one FLOP per byte read. To read at the card's rate
the keys must be spread over all 132 SMs, even at batch 1.

What the design does about it (flash-decoding, ``ops/csrc/decode_attention.cuh``):
a row's live slots ``[start, length)`` (the window folds into ``start``) are
cut at multiples of :data:`SPLIT` key positions, points that depend on
nothing but the positions, so a row's bits are the same whatever else shares
the call. :func:`plan` sizes the grid ``(n_kv * passes, b, z)`` from the
shapes alone (never from ``lengths``: no host sync, so a CUDA graph can
replay it): a GQA group of more query heads than a block takes
(:func:`max_heads`: 16 at head_dim <= 128, 8 at 256) is cut into passes
of at most that many heads, each reading the KV head's keys; the
blocks find their row's live splits on the device and stride over them, and
each split's block reads its keys once for all query heads of the group
(eight warps, coalesced vector loads, the warps merged in order; an f8
cache is loaded narrow, half the bytes, and widened in registers) and writes
an f32 partial (max, sum, acc). The last block of a (row, KV head), by an
atomic ticket, merges the partials in ascending split order. The tickets
(ops/tickets.py) are a zeroed buffer that every call leaves at zero; they
assume the calls run on one stream at a time, as the port's callers do.

The rolling window cache (models/llama/cache.py) is a ring of L slots,
position p in slot p % L. ``ring_limit`` (the logical bound of positions,
the full cache's padded length) routes a call to the ring instantiations
of the same body (``csrc/ring_decode_attention*.cu``, ``RingLayout``): L is
a multiple of SPLIT, so each split of logical positions is contiguous in
the ring, and the grid comes from ``plan()`` at ``ring_limit``, the full
cache's, so a ring call gives the full cache's bits on the same keys. Its
plain version is :func:`decode_ring_plain`, the reference's
``gqa_attention_hm`` over ``rolling_kv_positions``. Ring launches also
count in ``decode_attention.ring``.

For a tensor on the CPU the wrapper runs :func:`decode_attention_plain`
(the tests' path); for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from cake_tpu_torch.ops import _build
from cake_tpu_torch.ops.attention import causal_mask, masked_gqa_attention_hm, rolling_kv_positions
from cake_tpu_torch.ops.kv_dtype import F8, attention_dtype
from cake_tpu_torch.ops.launches import count
from cake_tpu_torch.ops.tickets import tickets

HEAD_DIMS = (64, 96, 128, 256)
HEAD_DIM_TODO = "other head dims are not ported (ROADMAP.md queue B item 2)"
# Geometry shared with csrc/decode_attention.cuh.
SPLIT = 128  # keys a split covers (DEC_SPLIT); divides 128, so a page holds whole splits
SMS = 132  # H100 SXM streaming multiprocessors
BLOCKS_PER_SM = 8  # the grid offers this many blocks an SM before blocks stride over splits


@dataclass(frozen=True)
class SplitPlan:
    """A decode launch's geometry, from the shapes alone."""

    n_split: int  # split slots a row has: ceil(limit / SPLIT)
    z: int  # the grid's third dimension: blocks a (unit, row) gets
    heads: int  # query heads a block takes; units = n_kv * ceil(group / heads)
    units: int  # (KV head, pass) pairs: the grid's first dimension
    scratch: int  # f32 partials: acc [b, units, n_split, heads, head_dim], (m, l) [.., heads, 2]


def max_heads(head_dim: int) -> int:
    """Most query heads a block takes (csrc/decode_attention.cuh
    DEC_MAX_HEADS): its register tiles of 16 heads fit at head_dim <= 128."""
    return 16 if head_dim <= 128 else 8


def plan(b: int, n_kv: int, group: int, head_dim: int, limit: int, sms: int = SMS) -> SplitPlan:
    """The grid and scratch of a decode call over ``limit`` key slots a row
    (``max_seq``, or ``n_p * page_size``): the group in as few passes as
    :func:`max_heads` allows, of equal size but the last; enough blocks to
    offer every SM BLOCKS_PER_SM of them, never more than a row has splits."""
    n_split = max(1, -(-limit // SPLIT))
    passes = -(-group // max_heads(head_dim))
    heads = -(-group // passes)
    units = n_kv * -(-group // heads)
    z = max(1, min(n_split, -(-BLOCKS_PER_SM * sms // max(1, b * units))))
    return SplitPlan(n_split, z, heads, units, b * units * n_split * heads * (head_dim + 2))


def live_splits(start: int, length: int, limit: int) -> list[tuple[int, int]]:
    """The key ranges of a row's live splits, in the order the kernel merges
    them: ``[start, length)`` clamped to ``[0, limit)``, cut at multiples of
    SPLIT."""
    start, length = max(start, 0), min(length, limit)
    return [
        (max(start, s * SPLIT), min(length, (s + 1) * SPLIT))
        for s in range(start // SPLIT, (length - 1) // SPLIT + 1)
    ] if start < length else []


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_launch(q: torch.Tensor, n_kv: int, limit: int):
    """(plan, partials scratch, tickets) of a decode call on q's card. The
    scratch comes from torch.empty (inside a CUDA graph capture, from the
    graph's pool, which every replay reuses); the tickets (b * units) from
    ops/tickets.py, which never frees a buffer a graph may hold and raises
    where one would be made during a capture."""
    b, _, n_q, hd = q.shape
    p = plan(b, n_kv, n_q // n_kv, hd, limit, _sm_count(q.device.index))
    part = torch.empty(p.scratch, dtype=torch.float32, device=q.device)
    return p, part, tickets("decode attention", q.device, b * p.units)


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
    count(decode_attention_plain)
    return decode_masked(
        q, k_cache, v_cache, lengths, starts, window_flag,
        window=window, scale=scale, softcap=softcap,
    )


decode_attention_plain.launches = 0


def ring_mask(q_pos, lengths, starts, ring: int, window, window_flag):
    """[b, q_len, L] mask over a ring of ``ring`` slots: each slot's
    position from ``rolling_kv_positions`` (the newest written position of a
    row is lengths - 1), then the causal and window mask of the reference's
    ``gqa_attention_hm`` and the left pad (``starts``)."""
    kpos = rolling_kv_positions(ring, lengths.long() - 1, 1)
    mask = causal_mask(q_pos.long(), kpos, window, window_flag)
    return mask & (kpos >= starts.long()[:, None])[:, None, :]


def check_ring(name: str, ring: int, ring_limit: int, window, window_flag, span: int) -> None:
    """What a ring call needs: L a multiple of SPLIT (a split of logical
    positions is then contiguous in the ring), a logical bound past it, and
    a window always on that fits the ring with ``span`` - 1 newer keys."""
    if ring % SPLIT or ring < SPLIT or ring_limit < ring:
        raise ValueError(f"{name}: a ring of {ring} slots needs a multiple of {SPLIT} and a "
                         f"logical bound >= it (got {ring_limit})")
    if window is None or window_flag is not None or window + span - 1 > ring:
        raise ValueError(f"{name}: a ring of {ring} slots needs a window always on of at most "
                         f"{ring - span + 1} (got window={window}, flag={window_flag})")


def decode_ring_plain(
    q, k_cache, v_cache, lengths, starts=None, window_flag=None, *,
    window=None, scale=None, softcap=None,
):
    """Plain PyTorch version over a ring [b, n_kv, L, hd]: the reference's
    rolling attention (``gqa_attention_hm`` over ``rolling_kv_positions``),
    the query at position lengths - 1."""
    count(decode_ring_plain)
    lengths, starts = row_bounds(q, lengths, starts, None, None)
    mask = ring_mask((lengths - 1)[:, None], lengths, starts, k_cache.shape[2], window,
                     window_flag)
    return masked_gqa_attention_hm(q, k_cache, v_cache, mask, scale=scale, softcap=softcap)


decode_ring_plain.launches = 0


def decode_attention(
    q, k_cache, v_cache, lengths, starts=None, window_flag=None, *,
    window=None, scale=None, softcap=None, ring_limit=None,
):
    """Single-position GQA attention against the cache.

    Args:
      q: [b, 1, n_q, hd]; k_cache/v_cache: [b, n_kv, max_seq, hd] head-major,
        of q's dtype, f8 (widened exactly, computed in q's dtype) or wider
        than q (``ops/kv_dtype.attention_dtype``).
      lengths: [b] int32 live prefix per row (the current token is written).
      starts: optional [b] int32 first live slot per row (None = 0); every
        row needs starts < lengths.
      window_flag: optional bool / 0-dim bool tensor gating ``window``.
      window: sliding window (folded into ``starts``); scale: score scale
        (None = hd**-0.5); softcap: tanh soft-cap of the scores.
      ring_limit: None for the dense cache; for a rolling ring of L =
        max_seq slots, the logical bound of positions (the module
        docstring). The window must then be on and fit the ring.

    Returns [b, 1, n_q, hd] in q's dtype.
    """
    if ring_limit is not None:
        check_ring("decode_attention", k_cache.shape[2], ring_limit, window, window_flag, 1)
        if q.device.type == "cpu":
            return decode_ring_plain(q, k_cache, v_cache, lengths, starts, window_flag,
                                     window=window, scale=scale, softcap=softcap)
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
    wide = attention_dtype("decode_attention", q.dtype, k_cache.dtype, v_cache.dtype)
    if wide != q.dtype:  # a wider cache: the query upcast exactly, the output cast back
        return decode_attention(
            q.to(wide), k_cache, v_cache, lengths, starts, window_flag,
            window=window, scale=scale, softcap=softcap, ring_limit=ring_limit,
        ).to(q.dtype)
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: cache shapes {k_cache.shape} / {v_cache.shape}")
    kb, n_kv, max_seq, khd = k_cache.shape
    if kb != b or khd != hd or n_q % n_kv:
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)} does not fit cache {tuple(k_cache.shape)}"
        )
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {hd} is not one of {HEAD_DIMS}; "
                         f"{HEAD_DIM_TODO}")
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
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    scale = float(hd**-0.5 if scale is None else scale)
    codes = _build.dtype_code(q.dtype), _build.dtype_code(k_cache.dtype)
    if ring_limit is None:
        p, part, ticket_buf = split_launch(q, n_kv, max_seq)
        err = lib.cake_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
            lengths.data_ptr(), starts.data_ptr(), part.data_ptr(), ticket_buf.data_ptr(),
            b, n_kv, n_q // n_kv, p.heads, max_seq, hd, *codes, scale,
            float(softcap or 0.0), p.n_split, p.z, stream,
        )
    else:  # max_seq is the ring's L; the grid is the logical bound's
        p, part, ticket_buf = split_launch(q, n_kv, ring_limit)
        err = lib.cake_ring_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
            lengths.data_ptr(), starts.data_ptr(), part.data_ptr(), ticket_buf.data_ptr(),
            b, n_kv, n_q // n_kv, p.heads, max_seq, ring_limit, hd, *codes, scale,
            float(softcap or 0.0), p.n_split, p.z, stream,
        )
    _build.check(err, "decode_attention")
    count(decode_attention)
    if ring_limit is not None:
        count(decode_attention, "ring")
    if k_cache.dtype == F8:
        count(decode_attention, "f8")
    return out


decode_attention.launches = 0
decode_attention.f8 = 0  # launches over an f8 cache
decode_attention.ring = 0  # launches over a rolling ring (ring_limit)
