"""Fused decode ingest: head split + RoPE on q/k + the one-slot K/V write.

Replaces the Pallas TPU kernel ``cake_tpu/ops/pallas/fused_ingest.py``
(``fused_qkv_ingest``) with a CUDA kernel written for Hopper,
``ops/csrc/fused_ingest.cu``. It serves the batch engine's decode step: one
token per row, the flat ``[b, 1, (n_q + 2 n_kv) hd]`` projection row in,
roped q out, the row's K/V written into the cache in place.

What bounds it on the H100: the latency of its trip to memory. At
Llama-3-8B a row is 12 KB of projection in, 8 KB of q out and 4 KB of K/V
written: ~24 KB a row, 0.06 us of bytes at 8 rows. A kernel that loops
over its elements waits on one load after another; the unfused step spends
~20 small ops on the same work (the head split, rope's upcast, products,
concatenation and cast on q and on k, the write plan and two scatters).

What the design does about it: each thread makes one trip to memory.
:func:`plan` splits a row from the shapes alone: a thread owns one vector
(16 bytes where ``hd/2`` allows it, narrower otherwise, never a wrong
pairing) of a q or k head's first half, the matching vector of its second
half and their cos/sin floats, or one vector of a v head. It issues every
load before its first store. A head's vectors get a power of two of threads,
so the body maps a thread to its head and vector by shifts. The write slot
is read from device memory (a 0-d int64 tensor), as the TPU kernel reads it
from a scalar-prefetch ref: a kernel argument is frozen when a CUDA graph
captures the launch, so a slot passed by value would replay the first
chunk's slot forever (models/llama/fused.py). Each thread ropes its pairs in
f32 with the plain path's rounding, every product and sum rounded on its own
(``__fmul_rn``, ``__fsub_rn``, ``__fadd_rn``; a contracted FMA would differ
in the last bit), casts back with round-to-nearest-even, and stores q, or k
at the row's cache slot; v is copied. A cache of another dtype (f8, or f32
under 16-bit activations) takes k and v as the plain path's ``narrow`` does:
k from its activation-dtype rounding (the JAX package's ingest ropes in f32,
casts back to the activations' dtype, then to the cache's), v as it comes,
f8 rounded to nearest even with NaN past +-464 (``__NV_SATFINITE`` below
464, NaN above it: the reference's ``astype``, not a saturating cast). So q
and the written K/V are the plain path's bits. The paged variant resolves the slot through the block table
like ``write_plan``: the logical page is clamped into the table before the
lookup, and an unmapped (< 0) or past-the-table entry drops the write, where
the plain path sends it to the pool's sink page. A dense slot outside the
cache drops the write too; the caller checks its bound on the host, where
the plain path's ``index_copy_`` would fail.

For tensors on the CPU the wrapper runs :func:`fused_qkv_ingest_plain`; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from cake_tpu_torch.models.llama.cache import write_layer
from cake_tpu_torch.models.llama.paged_cache import paged_write_layer
from cake_tpu_torch.ops import _build
from cake_tpu_torch.ops.kv_dtype import F8
from cake_tpu_torch.ops.launches import count
from cake_tpu_torch.ops.rope import apply_rope

_KERNEL_DTYPES = (torch.float32, torch.float16, torch.bfloat16)
THREADS = 128  # a block's threads: a row of Llama-3-8B spreads over 4 SMs


@dataclass(frozen=True)
class Plan:
    """The kernel's split of a row: ``blocks`` x ``threads`` (the grid is
    ``(blocks, b)``); a q/k thread owns ``vec_rope`` elements of a head's
    first half and the same of its second half, a v thread ``vec_v``
    elements of a v head; a q/k head takes ``2**rope_shift`` threads, a v
    head ``2**v_shift`` (the first ``hd/2 / vec_rope`` and ``hd / vec_v`` of
    them work)."""

    blocks: int
    threads: int
    vec_rope: int
    vec_v: int
    rope_shift: int
    v_shift: int


def _vector(n: int, itemsize: int) -> int:
    """The widest power-of-two vector of at most 16 bytes that divides n."""
    v = 16 // itemsize
    while n % v:
        v //= 2
    return v


def plan(b: int, n_q: int, n_kv: int, hd: int, dtype) -> Plan:
    """The grid and the threads' split from the shapes alone (never the
    slot or the table)."""
    if hd < 2 or hd % 2:
        raise ValueError(f"fused_qkv_ingest: head dim {hd} must be even")
    itemsize = torch.empty((), dtype=dtype).element_size()
    vr, vv = _vector(hd // 2, itemsize), _vector(hd, itemsize)
    rope_shift = (hd // 2 // vr - 1).bit_length()
    v_shift = (hd // vv - 1).bit_length()
    row = ((n_q + n_kv) << rope_shift) + (n_kv << v_shift)
    threads = min(THREADS, -(-row // 32) * 32)
    return Plan(-(-row // threads), threads, vr, vv, rope_shift, v_shift)


def fused_qkv_ingest_plain(qkv, cos, sin, slot, k_cache, v_cache, *, n_q: int, n_kv: int,
                           block_tables=None):
    """Plain PyTorch version: split, ``apply_rope`` on q and k, then
    ``write_layer`` (dense) or ``paged_write_layer`` (through the table;
    dropped writes land on the sink page). ``slot`` as the kernel's."""
    count(fused_qkv_ingest_plain)
    b = qkv.shape[0]
    hd = qkv.shape[-1] // (n_q + 2 * n_kv)
    qw, kw = n_q * hd, n_kv * hd
    q = qkv[..., :qw].reshape(b, 1, n_q, hd)
    k = qkv[..., qw : qw + kw].reshape(b, 1, n_kv, hd)
    v = qkv[..., qw + kw :].reshape(b, 1, n_kv, hd)
    q = apply_rope(q, cos, sin, None)
    k = apply_rope(k, cos, sin, None)
    if block_tables is None:
        write_layer(k_cache, v_cache, k, v, slot)
    else:
        paged_write_layer(k_cache, v_cache, k, v, slot, block_tables)
    return q


fused_qkv_ingest_plain.launches = 0


def fused_qkv_ingest(qkv, cos, sin, slot, k_cache, v_cache, *, n_q: int, n_kv: int,
                     block_tables=None):
    """Split heads + rope + cache write for ONE decode token per row.

    Args:
      qkv: [b, 1, (n_q + 2 n_kv) hd], the bias already added.
      cos/sin: [b, 1, hd/2] f32 rope rows gathered at each row's position.
      slot: the shared write slot: a 0-d int64 tensor on qkv's device,
        which the kernel reads when it runs (the decode step's), or a host
        int, checked here and written into a new such tensor.
      k_cache/v_cache: one layer's dense cache [b, n_kv, max_seq, hd], or
        with ``block_tables`` ([b, n_p] int32) its page pool
        [n_pages + 1, n_kv, page_size, hd]; written in place; of qkv's
        dtype, f8, or f32 under 16-bit activations.

    Returns q [b, 1, n_q, hd] roped, in qkv's dtype."""
    if qkv.device.type == "cpu":
        return fused_qkv_ingest_plain(
            qkv, cos, sin, slot, k_cache, v_cache, n_q=n_q, n_kv=n_kv, block_tables=block_tables
        )
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_qkv_ingest: unsupported device {qkv.device}")
    b, one, width = qkv.shape
    heads = n_q + 2 * n_kv
    hd = width // heads
    if one != 1 or width != heads * hd or hd % 2:
        raise ValueError(
            f"fused_qkv_ingest: qkv {tuple(qkv.shape)} is not one token of {heads} heads"
        )
    if {qkv.dtype, k_cache.dtype} == {torch.float16, torch.bfloat16}:
        raise NotImplementedError(
            f"fused_qkv_ingest: a {k_cache.dtype} cache under {qkv.dtype} activations is not "
            "ported (ROADMAP.md, queue B item 1: same-width cross-dtype caches)"
        )
    if qkv.dtype not in _KERNEL_DTYPES or v_cache.dtype != k_cache.dtype or not (
            k_cache.dtype in (qkv.dtype, F8)
            or (k_cache.dtype == torch.float32 and qkv.dtype != torch.float32)):
        raise ValueError(
            f"fused_qkv_ingest: qkv/k/v dtypes {qkv.dtype}/{k_cache.dtype}/{v_cache.dtype}: qkv "
            f"must be one of {_KERNEL_DTYPES}, the cache of its dtype, f8 or f32"
        )
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape or k_cache.shape[1] != n_kv \
            or k_cache.shape[3] != hd:
        raise ValueError(
            f"fused_qkv_ingest: cache {tuple(k_cache.shape)} / {tuple(v_cache.shape)} does not "
            f"hold {n_kv} heads of {hd}"
        )
    cos = cos.reshape(b, hd // 2)
    sin = sin.reshape(b, hd // 2)
    tables, n_p, table_stride = None, 0, 0
    if block_tables is None:
        if k_cache.shape[0] != b:
            raise ValueError(f"fused_qkv_ingest: cache batch {k_cache.shape[0]} != {b}")
        if not isinstance(slot, torch.Tensor) and not 0 <= slot < k_cache.shape[2]:
            raise ValueError(f"fused_qkv_ingest: slot {slot} outside [0, {k_cache.shape[2]})")
    else:
        if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
                or block_tables.shape[0] != b or block_tables.stride(1) != 1:
            raise ValueError(
                f"fused_qkv_ingest: block_tables must be [b, n_p] int32 with unit column "
                f"stride, got {tuple(block_tables.shape)} {block_tables.dtype}"
            )
        if not isinstance(slot, torch.Tensor) and slot < 0:
            raise ValueError(f"fused_qkv_ingest: slot {slot} < 0")
        tables, n_p, table_stride = block_tables, block_tables.shape[1], block_tables.stride(0)
    if isinstance(slot, torch.Tensor):
        if slot.dim() != 0 or slot.dtype != torch.int64:
            raise ValueError(f"fused_qkv_ingest: a slot tensor must be 0-d int64, got "
                             f"{tuple(slot.shape)} {slot.dtype}")
    else:
        slot = torch.full((), int(slot), dtype=torch.int64, device=qkv.device)
    operands = {"cos": cos, "sin": sin, "k_cache": k_cache, "v_cache": v_cache, "slot": slot}
    if tables is not None:
        operands["block_tables"] = tables
    for name, tn in operands.items():
        if tn.device != qkv.device:
            raise ValueError(f"fused_qkv_ingest: {name} is on {tn.device}, not {qkv.device}")
    if cos.dtype != torch.float32 or sin.dtype != torch.float32:
        raise ValueError("fused_qkv_ingest: cos/sin must be f32")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("fused_qkv_ingest: the cache must be contiguous (it is written in place)")
    p = plan(b, n_q, n_kv, hd, qkv.dtype)
    align = p.vec_v * k_cache.element_size()  # the v vector, the widest access to the cache
    if k_cache.data_ptr() % align or v_cache.data_ptr() % align:
        raise ValueError(
            f"fused_qkv_ingest: the cache must start at a {align}-byte aligned address")
    # The kernel's vector loads take 16-byte aligned operands: one that is
    # not is copied (a fresh tensor is aligned).
    qkv, cos, sin = (t if t.data_ptr() % 16 == 0 else t.clone()
                     for t in (qkv.contiguous(), cos.contiguous(), sin.contiguous()))
    q = torch.empty((b, 1, n_q, hd), dtype=qkv.dtype, device=qkv.device)
    if b == 0:
        return q
    err = _build.library().cake_fused_qkv_ingest(
        qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), q.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(),
        None if tables is None else tables.data_ptr(), slot.data_ptr(),
        b, n_q, n_kv, hd, k_cache.shape[2], n_p, table_stride,
        p.blocks, p.threads, p.vec_rope, p.vec_v, p.rope_shift, p.v_shift,
        _build.dtype_code(qkv.dtype), _build.dtype_code(k_cache.dtype),
        ctypes.c_void_p(torch.cuda.current_stream(qkv.device).cuda_stream),
    )
    _build.check(err, "fused_qkv_ingest")
    count(fused_qkv_ingest)
    if k_cache.dtype == F8:
        count(fused_qkv_ingest, "f8")
    return q


fused_qkv_ingest.launches = 0
fused_qkv_ingest.f8 = 0  # launches over an f8 cache
