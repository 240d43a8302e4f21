"""Paged KV cache: a shared page pool and a host-side block-table allocator
(port of ``cake_tpu/models/llama/paged_cache.py``).

Instead of one ``[max_seq]`` strip per lane (models/llama/cache.py), KV
storage is a pool of fixed-size pages shared by every lane:

  pool:        [n_layers, n_pages + 1, n_kv_heads, page_size, head_dim]
  block table: int32 [batch, max_pages_per_seq], physical page per logical
               page, UNMAPPED (-1) where the lane holds no storage

Inside a page the layout is head-major (n_kv before page_size), the dense
cache's stride order, so one page is one contiguous ``page_size * head_dim``
strip per KV head; the paged attention kernels (ops/paged_attention.py,
ops/paged_prefill.py) stream it like the dense cache.

**The sink page.** The JAX package drops a write through an unmapped entry,
past the table or below ``write_starts`` with an out-of-bounds scatter
(``mode="drop"``). Torch has no dropping scatter, and filtering the writes
on the device would need a host round trip for the count. So the pool holds
one page more than the allocator hands out, the last one: every write the
JAX package drops lands there instead. No table entry ever names it, so
nothing reads it. ``PagedKVCache.n_pages`` counts the allocatable pages.

The port writes the pool IN PLACE (the JAX package returns a new pool).
Writes narrow to the pool's dtype (``ops/kv_dtype.narrow``); an f8 pool is
written, gathered and copied through its byte view (``kv_view``), so f8
bits move unchanged.

``PageAllocator`` is host-side bookkeeping (free list, refcounts, block
tables as numpy); only the block tables cross to the device, once per
dispatch. Refcounts let a shared prompt prefix map the same physical pages
from several lanes (``fork_chain``), copy-on-write (``make_private`` +
``copy_pages``) splitting a page only before a lane writes it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cake_tpu_torch.ops.kv_dtype import kv_view, narrow
from cake_tpu_torch.utils import metrics


_G_TOTAL = "cake_kv_pages_total"
_G_FREE = "cake_kv_pages_free"
_G_SHARED = "cake_kv_pages_shared"
_C_FAIL = "cake_kv_page_alloc_failures_total"

UNMAPPED = np.int32(-1)  # block-table sentinel: no physical page mapped


class PagedKVCache(NamedTuple):
    """Page-pool KV storage for a contiguous run of layers."""

    k: torch.Tensor  # [n_layers, n_pages + 1, n_kv_heads, page_size, head_dim]
    v: torch.Tensor

    @property
    def n_layers(self) -> int:
        return self.k.shape[0]

    @property
    def n_pages(self) -> int:
        """Allocatable pages (the pool's last page is the write sink)."""
        return self.k.shape[1] - 1

    @property
    def page_size(self) -> int:
        return self.k.shape[3]


def init_paged_cache(
    n_layers: int,
    n_pages: int,
    n_kv_heads: int,
    page_size: int,
    head_dim: int,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cpu",
) -> PagedKVCache:
    """Allocate a zeroed pool of ``n_pages`` pages plus the write sink.

    Any page size works for the plain versions (CPU tests use small pages);
    the CUDA kernels take multiples of 128 and their wrappers raise on
    anything else (``ops/paged_prefill.paged_kernel_supported``)."""
    shape = (n_layers, n_pages + 1, n_kv_heads, page_size, head_dim)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


def write_plan(
    pos: int | torch.Tensor,
    chunk: int,
    block_tables: torch.Tensor,
    sink: int,
    page_size: int,
    starts: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Where a [batch, chunk] write at slot offset ``pos`` lands: (physical
    page [b, chunk], in-page offset [b, chunk]), int64 on the table's device.

    Token ``pos + j`` of row ``b`` goes to page ``block_tables[b, (pos + j)
    // page_size]`` at offset ``(pos + j) % page_size``. An unmapped entry, a
    logical page past the table, or (with ``starts``) a slot below
    ``starts[b]`` sends the write to page ``sink`` (the pool's write sink).
    Layer-invariant: built once per dispatch, used by every layer.

    ``pos`` is a host int or, on the decode step, a 0-d int64 tensor on
    the table's device: the plan is then computed from it on the device,
    nothing read back, so a captured CUDA graph writes where the tensor
    says at each replay."""
    b, n_p = block_tables.shape
    dev = block_tables.device
    slots = pos + torch.arange(chunk, device=dev, dtype=torch.int64)
    logical = (slots // page_size).expand(b, chunk)
    inside = logical < n_p
    phys = torch.gather(block_tables.long(), 1, logical.clamp(max=n_p - 1))
    keep = inside & (phys >= 0)
    if starts is not None:
        keep &= slots[None, :] >= starts.long()[:, None]
    phys = torch.where(keep, phys, sink)
    return phys, (slots % page_size).expand(b, chunk)


def write_pages(
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    plan: tuple[torch.Tensor, torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter a [b, chunk, n_kv, hd] chunk through a ``write_plan`` into one
    layer's [n_pages + 1, n_kv, page_size, hd] pool, in place."""
    phys, offs = plan
    kv_view(k_pages)[phys, :, offs] = kv_view(narrow(k_new, k_pages.dtype))
    kv_view(v_pages)[phys, :, offs] = kv_view(narrow(v_new, v_pages.dtype))
    return k_pages, v_pages


def paged_write_layer(
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pos: int | torch.Tensor,
    block_tables: torch.Tensor,
    starts: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write a [batch, chunk, n_kv, head_dim] chunk at slot offset ``pos``
    (a host int or a 0-d device tensor, as ``write_plan``) into one layer's
    pool slice through the block table, in place.

    The paged sibling of cache.write_layer: writes the JAX package drops
    (unmapped entries, logical pages past the table, and with ``starts`` the
    slots below ``starts[b]``, which a suffix prefill over a forked shared
    prefix must never scribble) land on the write sink."""
    plan = write_plan(
        pos, k_new.shape[1], block_tables, k_pages.shape[0] - 1, k_pages.shape[2], starts
    )
    return write_pages(k_pages, v_pages, k_new, v_new, plan)


def gather_pages(pages: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Dense head-major view of each row's pages: [b, n_kv, n_p * ps, hd].

    The read path of the plain attention versions: gathering a row's pages
    in logical order rebuilds the dense cache layout at every mapped slot;
    unmapped pages read zeros, which the callers' masks exclude anyway."""
    bt = block_tables.long()
    g = kv_view(pages)[bt.clamp(min=0)]  # [b, n_p, n_kv, ps, hd]
    g = torch.where((bt >= 0)[:, :, None, None, None], g, torch.zeros((), dtype=g.dtype))
    b, n_p, n_kv, ps, hd = g.shape
    return g.transpose(1, 2).reshape(b, n_kv, n_p * ps, hd).view(pages.dtype)


def copy_pages(cache: PagedKVCache, src, dst) -> PagedKVCache:
    """Copy physical pages ``src[i] -> dst[i]`` across every layer, in place.

    The device half of copy-on-write: ``PageAllocator.make_private`` picks
    the (src, dst) pairs on the host; this moves the bytes so the forked
    lane's private page starts as an exact copy of the shared one."""
    dev = cache.k.device
    src = torch.as_tensor(np.asarray(src, np.int64), device=dev)
    dst = torch.as_tensor(np.asarray(dst, np.int64), device=dev)
    for pool in (kv_view(cache.k), kv_view(cache.v)):
        pool[:, dst] = pool[:, src]
    return cache


class PageExhausted(RuntimeError):
    """The pool has no free page for a required mapping."""


class PageAllocator:
    """Host-side page bookkeeping: free list, refcounts, per-lane block tables.

    All state is numpy/Python. The serving engine consults it for admission
    (``can_admit``), maps pages as sequences grow (``map_range``), and
    returns them when streams finish (``release``). ``fork_chain`` and
    ``make_private`` implement refcounted prefix sharing with copy-on-write
    (the device-side byte copy is ``copy_pages``). The ``cake_kv_pages_*``
    gauges follow every change and ``cake_kv_page_alloc_failures_total``
    counts the refusals (utils/metrics.py), as the reference's do.
    """

    def __init__(
        self,
        n_pages: int,
        page_size: int,
        batch: int,
        max_pages_per_seq: int,
        reserve_pages: int = 1,
    ):
        if n_pages <= 0 or page_size <= 0:
            raise ValueError("n_pages and page_size must be positive")
        self.n_pages = n_pages
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self.reserve_pages = max(0, reserve_pages)
        self.refcount = np.zeros(n_pages, np.int32)
        # LIFO free list: recently-freed pages are re-used first.
        self._free: list[int] = list(range(n_pages - 1, -1, -1))
        self.block_tables = np.full((batch, max_pages_per_seq), UNMAPPED, np.int32)
        self._update_gauges()

    def _update_gauges(self) -> None:
        reg = metrics.registry
        reg.gauge(_G_TOTAL, "Physical KV pages in the pool.").set(self.pages_total)
        reg.gauge(_G_FREE, "KV pages currently on the free list.").set(self.pages_free)
        reg.gauge(_G_SHARED, "KV pages mapped by more than one lane (CoW-shared).").set(
            self.pages_shared)

    def _refused(self) -> None:
        metrics.registry.counter(_C_FAIL, "Page allocations refused for an empty free list.").inc()
        self._update_gauges()

    # ------------------------------------------------------------- accounting

    @property
    def pages_total(self) -> int:
        return self.n_pages

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_shared(self) -> int:
        return int((self.refcount > 1).sum())

    def pages_needed(self, n_tokens: int) -> int:
        return -(-max(0, n_tokens) // self.page_size)

    def can_admit(self, prompt_tokens: int) -> bool:
        """Admission rule: ceil(prompt / page_size) + reserve pages are free.
        The reserve covers the page-boundary straddle of a left-padded layout
        and gives the first decode tokens headroom."""
        return self.pages_needed(prompt_tokens) + self.reserve_pages <= self.pages_free

    def reset(self, batch: int) -> None:
        """Fresh epoch: every page free, every lane unmapped."""
        self.refcount[:] = 0
        self._free = list(range(self.n_pages - 1, -1, -1))
        self.block_tables = np.full((batch, self.max_pages_per_seq), UNMAPPED, np.int32)
        self._update_gauges()

    def release_lanes(self, batch: int) -> None:
        """Unmap every lane, KEEPING non-lane references (the prefix cache's
        chain refs) alive: the persistent-pool epoch boundary."""
        for lane in range(self.block_tables.shape[0]):
            self.release(lane)
        if batch != self.block_tables.shape[0]:
            self.block_tables = np.full((batch, self.max_pages_per_seq), UNMAPPED, np.int32)
        self._update_gauges()

    # ------------------------------------------------------------- allocation

    def lane_mapped(self, lane: int) -> bool:
        return bool((self.block_tables[lane] >= 0).any())

    def lane_pages(self, lane: int) -> int:
        """Mapped logical pages of ``lane``: the relief spilling it would
        give (the continuous scheduler's victim choice; shared pages count
        too, since the lane's reference still blocks their reuse)."""
        return int((self.block_tables[lane] >= 0).sum())

    def map_range(self, lane: int, start_slot: int, end_slot: int) -> None:
        """Map pages so slots [start_slot, end_slot) of ``lane`` have storage.

        Already-mapped logical pages are kept (growth is incremental: only
        page-boundary crossings allocate). Atomic: on exhaustion nothing is
        mapped and PageExhausted raises."""
        if end_slot <= start_slot:
            return
        first = start_slot // self.page_size
        last = -(-end_slot // self.page_size)  # exclusive
        if last > self.max_pages_per_seq:
            raise ValueError(
                f"slots [{start_slot}, {end_slot}) need logical page "
                f"{last - 1} but the table has {self.max_pages_per_seq}"
            )
        row = self.block_tables[lane]
        need = [p for p in range(first, last) if row[p] < 0]
        if len(need) > len(self._free):
            self._refused()
            raise PageExhausted(
                f"lane {lane} needs {len(need)} page(s), "
                f"{len(self._free)} free of {self.n_pages}"
            )
        for p in need:
            phys = self._free.pop()
            self.refcount[phys] = 1
            row[p] = phys
        self._update_gauges()

    def release(self, lane: int) -> None:
        """Drop every mapping of ``lane``; pages reaching refcount 0 go free."""
        row = self.block_tables[lane]
        for p in np.flatnonzero(row >= 0):
            phys = int(row[p])
            self.refcount[phys] -= 1
            if self.refcount[phys] == 0:
                self._free.append(phys)
        row[:] = UNMAPPED
        self._update_gauges()

    # ----------------------------------------------- prefix sharing (CoW)

    def retain_pages(self, pages: list[int]) -> None:
        """Take one non-lane reference on each page of a chain (the prefix
        cache's ownership): the page survives lane releases until
        ``release_pages``. Pages must be live."""
        for phys in pages:
            if self.refcount[phys] <= 0:
                raise ValueError(f"page {phys} is free; cannot retain it")
            self.refcount[phys] += 1
        self._update_gauges()

    def release_pages(self, pages: list[int]) -> None:
        """Drop one reference per page; pages reaching 0 go free."""
        for phys in pages:
            if self.refcount[phys] <= 0:
                raise ValueError(f"page {phys} is already free")
            self.refcount[phys] -= 1
            if self.refcount[phys] == 0:
                self._free.append(phys)
        self._update_gauges()

    def fork_chain(self, lane: int, pages: list[int], first_logical: int) -> None:
        """Map a cached page chain into ``lane`` at logical pages
        [first_logical, first_logical + len(pages)), sharing storage (+1 ref
        per page). Target entries must be unmapped."""
        if first_logical < 0 or first_logical + len(pages) > self.max_pages_per_seq:
            raise ValueError(
                f"chain of {len(pages)} page(s) at logical {first_logical} "
                f"overflows the {self.max_pages_per_seq}-page table"
            )
        row = self.block_tables[lane]
        for i, phys in enumerate(pages):
            if row[first_logical + i] >= 0:
                raise ValueError(
                    f"fork_chain target lane {lane} logical page "
                    f"{first_logical + i} is already mapped"
                )
            self.refcount[phys] += 1
            row[first_logical + i] = phys
        self._update_gauges()

    def unmap_page(self, lane: int, logical_page: int) -> None:
        """Drop one logical-page mapping of ``lane`` (the degraded path when a
        copy-on-write split cannot get its fresh page)."""
        phys = int(self.block_tables[lane, logical_page])
        if phys < 0:
            raise ValueError(f"lane {lane} has no page {logical_page} mapped")
        self.refcount[phys] -= 1
        if self.refcount[phys] == 0:
            self._free.append(phys)
        self.block_tables[lane, logical_page] = UNMAPPED
        self._update_gauges()

    def make_private(self, lane: int, logical_page: int) -> tuple[int, int] | None:
        """Copy-on-write split before ``lane`` writes ``logical_page``.

        Returns (src_phys, dst_phys) when the page was shared (the caller
        must then ``copy_pages(cache, [src], [dst])`` before writing), or
        None when the lane already owns the page exclusively."""
        phys = int(self.block_tables[lane, logical_page])
        if phys < 0:
            raise ValueError(f"lane {lane} has no page {logical_page} mapped")
        if self.refcount[phys] <= 1:
            return None
        if not self._free:
            self._refused()
            raise PageExhausted("copy-on-write split needs a free page")
        fresh = self._free.pop()
        self.refcount[phys] -= 1
        self.refcount[fresh] = 1
        self.block_tables[lane, logical_page] = fresh
        self._update_gauges()
        return phys, fresh
