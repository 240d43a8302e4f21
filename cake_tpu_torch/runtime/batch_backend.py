"""Batch execution backends: the device seam under the serving engine (port
of ``cake_tpu/runtime/batch_backend.py``: the single-device backends and the
TCP one).

The engine (runtime/serving.py) drives a backend through the same
operations over the left-padded lockstep layout (models/llama/batch.py):

  * ``LocalBatchBackend``: a dense KV cache, one ``[max_seq]`` strip per
    lane; attention through the dense decode and chunk kernels.
  * ``PagedLocalBackend``: a shared page pool and a host-side
    ``PageAllocator``; attention through the paged decode and chunk
    kernels. With a prefix cache attached the pool persists across epochs.
  * ``DistributedBatchBackend``: the same dense ops over a TCP topology's
    workers (the master's ``DistributedForwardStep``), one round trip per
    span per op; its decode walks the plan once a step, without a graph.

Both keep the weights resident (fused once), the rope tables built once
and the KV storage for their lifetime (zeroed at each epoch); every per-row
operand a prefill needs (pads, write thresholds, the block table) is
uploaded once per dispatch. A decode chunk runs a ``DecodeChunk``
(models/llama/fused.py), one per (steps, lanes, sampling knobs, and paged:
the table's width): on the card a replay of its CUDA graph, captured at its
first chunk (the capacity edge's shorter chunk gets its own, as the JAX
package compiles another ``n_steps``). The backends own its static buffers:
the pads are copied in at every chunk, the block table only when the
allocator's changed (joins, page extensions), the slot when the previous
chunk did not leave it there. The decode fusions ride the config
(``LlamaConfig.fusion_impl``): each dispatch resolves them once, and the
decode chunks sample through the fused tail when "tail" is on. Each decode
leaves a ``kernel:fused_<name>`` timeline instant an enabled fusion, with
the route its kernel takes ("cuda" on the card, "plain" on the CPU), and a
sampled tail with ``top_p`` (which keeps the unfused composition) one
``kernel-fallback`` flight event a backend; each paged dispatch leaves a
``kernel:<op>`` instant. The TCP backend counts a hop it abandons
(``cake_hop_failures_total``, a ``hop-failed`` flight event), and its
``failover(node)`` ejects a dead worker and re-routes its replica group.
Every backend's ``replay_decode`` runs a decode chunk's one-token steps fed
tokens the engine already holds, without sampling: the engine's failover
migration re-issues an epoch's dispatches through it
(runtime/serving.py ``_migrate_kv``). The
tensor-parallel and pipelined backends and speculative verify are not
ported (ROADMAP.md); a page size the paged kernels do not take raises on
the card.

**Abandoned dispatches.** The engine's stall guard (runtime/admission.py
``StallGuard``) may give up on a dispatch whose thread is still running it.
Torch buffers are written in place, and the decode graphs hold the KV
storage and their static buffers, so a dispatch that wakes later would
write into whatever still shares them. ``abandon()`` therefore drops the
storage and every decode chunk captured over it: the next ``init_kv``
allocates anew and the next decode captures anew, and the abandoned thread
holds the only references to the old buffers. Every dispatch first checks
that its KV is the backend's live storage (``_check_live``), so one that
wakes after the drop raises before it reads the allocator's tables. A
decode binds the chunk cache before that check, so one that passed it and
stalls further in keeps the abandoned cache: the chunks it builds or runs
on waking, and their graphs, stay apart from the next epoch's, and it
captures in a ``CaptureScope`` of its own (models/llama/fused.py). On the
card its chunk runs take turns with the next epoch's (``CARD_RUN_LOCK``):
a capture is invalidated by what another thread does to the context
meanwhile.
"""

from __future__ import annotations

import uuid

import numpy as np
import torch

from cake_tpu_torch.device import resolve_device, upload
from cake_tpu_torch.models.llama import batch as B
from cake_tpu_torch.models.llama import model as M
from cake_tpu_torch.models.llama.cache import SEQ_MULTIPLE, KVCache, init_cache
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.fused import CaptureScope, DecodeChunk
from cake_tpu_torch.models.llama.paged_cache import (
    PageAllocator,
    PagedKVCache,
    copy_pages,
    init_paged_cache,
)
from cake_tpu_torch.ops.fuse import fuse_params, resolve_fusion
from cake_tpu_torch.ops.paged_prefill import paged_kernel_supported
from cake_tpu_torch.ops.rope import model_rope_tables
from cake_tpu_torch.ops.sampling import sample_step
from cake_tpu_torch.obs.timeline import timeline
from cake_tpu_torch.utils import metrics


def _rows(x, device) -> torch.Tensor:
    """A [b] int32 per-row operand on ``device`` (one upload)."""
    return upload(np.asarray(x, np.int32).reshape(-1), device)


def _tokens(x, device) -> torch.Tensor:
    return upload(np.asarray(x, np.int64), device)


class _Chunks(dict):
    """A backend's decode chunks over one KV storage, by key
    (``_chunk_key``), and the ``CaptureScope`` they capture in: the shared
    one, until ``abandon`` gives the next storage's chunks a scope of their
    own."""

    def __init__(self, scope: CaptureScope | None = None):
        super().__init__()
        self.scope = scope


def _chunk_key(kv, n: int, tok, ring, s, shapes: dict) -> tuple:
    """A decode chunk's key: its steps, lanes, ring window and knobs, the
    shapes of its static int32 buffers (pads, block tables) and the KV dtype
    (a graph never replays over a cache of another dtype)."""
    return (n, tok.shape[0], ring.shape[1], s.temperature, s.top_k, s.top_p, s.repeat_penalty,
            kv.k.dtype, *sorted(shapes.items()))


def _decode_chunk(backend, chunks: _Chunks, kv, n: int, tok, ring, s, make_forward,
                  **shapes) -> DecodeChunk:
    """The DecodeChunk in ``chunks`` (the cache the dispatch bound, see
    ``_check_live``) for a chunk of ``n`` steps over ``tok``'s lanes with
    knobs ``s``, built at its first use: ``make_forward(**extra)`` over the
    static int32 ``extra`` buffers of ``shapes``."""
    key = _chunk_key(kv, n, tok, ring, s, shapes)
    chunk = chunks.get(key)
    if chunk is None:
        extra = {name: torch.zeros(shape, dtype=torch.int32, device=backend.device)
                 for name, shape in shapes.items()}
        chunk = chunks[key] = DecodeChunk(
            make_forward(**extra), kv, batch=tok.shape[0], window=ring.shape[1], n_steps=n, s=s,
            fused_tail="tail" in resolve_fusion(backend.config), per_row=True,
            device=backend.device, extra=extra, scope=chunks.scope,
        )
    elif chunk.kv.k.data_ptr() != kv.k.data_ptr():
        raise RuntimeError("decode: the KV storage moved under a captured decode chunk")
    return chunk


def _replay_steps(forward_one, kv, toks: torch.Tensor, slot: int):
    """``forward_one`` over the columns of ``toks`` at slots slot, slot + 1,
    ...; the slot is a 0-d device tensor advanced in place, as in a decode
    chunk (models/llama/fused.py ``sampled_decode_loop``)."""
    slot_t = torch.full((), int(slot), dtype=torch.int64, device=toks.device)
    for i in range(toks.shape[1]):
        _, kv = forward_one(toks[:, i : i + 1], kv, slot_t)
        slot_t.add_(1)
    return kv


def _route(backend) -> str:
    """The route the backend's kernels take: their CUDA kernels on the
    card, their plain versions on the CPU."""
    return "cuda" if backend.device.type == "cuda" else "plain"


def _note_fusion_kernels(backend, s) -> None:
    """Timeline breadcrumbs of the decode fusions: one ``kernel:fused_<name>``
    instant an enabled fusion at every decode dispatch, with the route it
    takes, and one ``kernel-fallback`` flight event a backend when a
    sampled tail with ``top_p`` keeps the unfused composition."""
    fusions = resolve_fusion(backend.config)
    if not fusions:
        return
    lp = backend.params.get("layers", {}) if isinstance(backend.params, dict) else {}
    route = _route(backend)
    sampled = s.temperature is not None and s.temperature > 0.0
    impls = {
        "fused_norm_matmul": ("norm", route),
        "fused_qkv_ingest": ("ingest", route if "wqkv" in lp and "q_norm" not in lp
                             else "composition"),
        "fused_sample_tail": ("tail", "composition" if sampled and s.top_p is not None
                              else route),
    }
    for kernel, (name, impl) in impls.items():
        if name not in fusions:
            continue
        if (kernel == "fused_sample_tail" and impl == "composition"
                and not getattr(backend, "_fusion_fallback_noted", False)):
            backend._fusion_fallback_noted = True
            metrics.flight.record("kernel-fallback", op=kernel,
                                  reason="top_p needs the full sort of the composition")
        timeline.instant(f"kernel:{kernel}", track="engine", args={"impl": impl})


def _check_live(kv, live, op: str) -> None:
    """Raise unless ``kv`` lies on ``live``, the backend's current storage
    (None after ``abandon``): a dispatch the stall guard abandoned must not
    run on after the backend moved on. ``abandon`` drops the storage before
    it replaces the chunk cache, so a decode that reads ``_chunks`` first
    and then passes this check holds the cache of that storage."""
    if live is None or kv.k.data_ptr() != live.k.data_ptr():
        raise RuntimeError(f"{op}: the KV storage was abandoned after a stalled dispatch")


class LocalBatchBackend:
    """Single-device batch ops over the dense KV cache: the engine's default."""

    kv_mode = "dense"

    def __init__(
        self,
        config: LlamaConfig,
        params: M.Params,
        *,
        max_seq_len: int,
        cache_dtype: torch.dtype,
        device: torch.device | str | None = None,
    ):
        self.config = config
        self.device = resolve_device(device)
        self.params = fuse_params(params)
        self.max_seq_len = max_seq_len
        self.cache_dtype = cache_dtype
        padded = -(-max_seq_len // SEQ_MULTIPLE) * SEQ_MULTIPLE  # the cache's length
        self.rope = model_rope_tables(config, padded, self.device)
        self._kv: KVCache | None = None
        self._chunks = _Chunks()  # DecodeChunk per key (_decode_chunk)

    def init_kv(self, b: int) -> KVCache:
        """The epoch's zeroed cache of ``b`` lanes: the first ``b`` lanes of
        one cache kept for the backend's lifetime (each layer's lanes stay
        contiguous), so the decode chunks' graphs keep their addresses. It
        grows, dropping the graphs, when an epoch needs more lanes."""
        c = self.config
        if self._kv is None or self._kv.batch_size < b:
            self._chunks.clear()  # their graphs hold the old cache's addresses
            self._kv = None  # freed before the larger one is made
            self._kv = init_cache(
                c.num_hidden_layers, b, self.max_seq_len, c.num_key_value_heads, c.head_dim,
                self.cache_dtype, self.device,
            )
        kv = KVCache(self._kv.k[:, :b], self._kv.v[:, :b])
        kv.k.zero_()
        kv.v.zero_()
        return kv

    def abandon(self) -> None:
        """Drop the cache and the decode chunks captured over it (the module
        docstring, abandoned dispatches); the storage first (``_check_live``)."""
        self._kv = None
        self._chunks = _Chunks(CaptureScope())

    def decode_builds_chunk(self, kv, tok, ring, n: int, s) -> bool:
        """Whether ``decode`` would build its chunk (on the card: capture its
        graph), which the stall guard grants its first-call grace."""
        return _chunk_key(kv, n, tok, ring, s, {"pads": (tok.shape[0],)}) not in self._chunks

    @torch.inference_mode()
    def prefill(self, tokens, kv, pads):
        """The whole left-padded batch at slots [0, width): (logits, kv)."""
        _check_live(kv, self._kv, "prefill")
        return B.batched_prefill(
            self.params, _tokens(tokens, self.device), kv, _rows(pads, self.device),
            self.config, rope=self.rope,
        )

    @torch.inference_mode()
    def decode(self, kv, tok, slot, pads, keys, ring, ring_idx, n, s):
        """``n`` lockstep steps; the tokens stay on the device: a
        ``DecodeChunk`` run (``batch.decode_chunk`` is its eager plain
        version). Returns (ids [B, n], kv, keys, ring, ring_idx); the last
        three are the chunk's buffers, the next chunk's inputs as they are.
        The sampling tail follows the config's fusions."""
        if slot < 0 or slot + n > kv.max_seq_len:
            raise ValueError(f"decode writes slots [{slot}, {slot + n}) outside the cache's "
                             f"{kv.max_seq_len}")
        chunks = self._chunks  # before the check (_check_live)
        _check_live(kv, self._kv, "decode")
        params, config, rope = self.params, self.config, self.rope
        chunk = _decode_chunk(
            self, chunks, kv, n, tok, ring, s,
            lambda pads: B.batched_forward_one(params, pads, config, rope),
            pads=(tok.shape[0],),
        )
        ids = chunk.run(tok=tok, slot=slot, ring=ring, ring_idx=ring_idx, keys=keys, pads=pads)
        _note_fusion_kernels(self, s)
        return ids, kv, chunk.keys, chunk.ring, chunk.ring_idx

    @torch.inference_mode()
    def replay_decode(self, kv, toks, slot: int, pads):
        """A decode chunk's KV writes again: one-token steps over [slot,
        slot + n) fed ``toks`` [B, n], with the chunk's own forward and a
        device slot, as its graph runs them; nothing is sampled."""
        _check_live(kv, self._kv, "replay_decode")
        fwd = B.batched_forward_one(self.params, _rows(pads, self.device), self.config,
                                    self.rope)
        return _replay_steps(fwd, kv, _tokens(toks, self.device), slot)

    @torch.inference_mode()
    def join(self, kv, row_tokens, pad: int, end: int, lane: int):
        """A continuous-batching join: one row whose prompt ends at the
        epoch's shared slot ``end`` prefills straight into ``lane``'s strip
        of the cache (a view, written in place). Stale slots outside
        ``[pad, end)`` stay, and no read reaches them: keys below the pad
        are masked by ``starts``, and decode writes each later slot before
        ``lengths`` admits it."""
        _check_live(kv, self._kv, "join")
        lane_kv = KVCache(kv.k[:, lane : lane + 1], kv.v[:, lane : lane + 1])
        ends = _rows([end], self.device)
        logits, _ = B.batched_prefill(
            self.params, _tokens(row_tokens, self.device), lane_kv, _rows([pad], self.device),
            self.config, ends=ends, seq_len=end, rope=self.rope,
        )
        return logits, kv


class PagedLocalBackend:
    """Single-device batch ops over the paged KV pool (``kv_mode="paged"``).

    HBM is committed per live page from one pool; the engine owns the
    allocation protocol (map at layout and join, extend at page boundaries,
    release on finish) and this backend uploads the allocator's block
    tables at each dispatch.

    **One capacity per epoch** (``set_epoch_capacity``): the engine sets
    ONE bucketed live capacity per epoch, and every dispatch slices the
    block table to it, so the plain versions' gathered views and every
    kernel's table cover the live capacity, never the full ``max_seq``
    table. It is backend state, not a per-op argument: every prefill, join
    and decode of an epoch must run under the same capacity, or the plain
    path's reduction widths (and so its last bits) change mid-epoch, and a
    smaller per-op capacity would drop live keys. A write past it raises
    (``_check_write_bound``) instead of sinking silently.

    With a prefix cache attached (``attach_prefix_cache``) the pool is
    PERSISTENT: ``init_kv`` hands back the pool retained at the previous
    epoch's end and releases only the lane mappings, so cached chains keep
    their bytes.
    """

    kv_mode = "paged"

    def __init__(
        self,
        config: LlamaConfig,
        params: M.Params,
        *,
        max_seq_len: int,
        cache_dtype: torch.dtype,
        page_size: int = 128,
        max_pages: int | None = None,
        page_reserve: int = 1,
        device: torch.device | str | None = None,
    ):
        self.config = config
        self.device = resolve_device(device)
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        if self.device.type == "cuda" and not paged_kernel_supported(page_size):
            raise ValueError(
                f"page_size {page_size}: the paged CUDA kernels take multiples of 128"
            )
        self.params = fuse_params(params)
        self.max_seq_len = max_seq_len
        self.cache_dtype = cache_dtype
        self.page_size = page_size
        self.pages_per_seq = -(-max_seq_len // page_size)
        self.padded_seq = self.pages_per_seq * page_size
        self.max_pages = max_pages or 8 * self.pages_per_seq
        self.allocator = PageAllocator(
            self.max_pages, page_size, batch=1,
            max_pages_per_seq=self.pages_per_seq, reserve_pages=page_reserve,
        )
        self.rope = model_rope_tables(config, self.padded_seq, self.device)
        self.prefix_cache = None
        self._retained_kv = None
        self._cap_pages: int | None = None
        self._pool: PagedKVCache | None = None
        self._chunks = _Chunks()  # DecodeChunk per key (_decode_chunk)

    # --------------------------------------------------- bounded capacity

    def set_epoch_capacity(self, capacity_slots: int | None) -> None:
        """Bound every dispatch's block table to ``capacity_slots`` (whole
        pages); None restores the full table. Called once per epoch."""
        if capacity_slots is None:
            self._cap_pages = None
            return
        pages = -(-int(capacity_slots) // self.page_size)
        self._cap_pages = max(1, min(pages, self.pages_per_seq))

    def capacity_slots(self) -> int:
        """The slot capacity every dispatch's table currently covers."""
        if self._cap_pages is None:
            return self.padded_seq
        return self._cap_pages * self.page_size

    def _check_write_bound(self, op: str, end_slot: int) -> None:
        if end_slot > self.capacity_slots():
            raise ValueError(
                f"paged {op} writes through slot {end_slot} but the epoch capacity is "
                f"{self.capacity_slots()} slots: the one-capacity-per-epoch bound was violated"
            )

    def _host_tables(self, lanes: slice = slice(None)) -> np.ndarray:
        """The block table rows of ``lanes`` sliced to the epoch capacity."""
        tables = self.allocator.block_tables[lanes]
        if self._cap_pages is not None:
            tables = tables[:, : self._cap_pages]
        return tables

    def _tables(self, lanes: slice = slice(None)) -> torch.Tensor:
        """``_host_tables`` uploaded as one contiguous int32 tensor."""
        return upload(self._host_tables(lanes), self.device)

    def _lane_table(self, lane: int) -> torch.Tensor:
        return self._tables(slice(lane, lane + 1))

    # --------------------------------------------------- pool lifetime

    def attach_prefix_cache(self, cache) -> None:
        """Make the pool persistent for the engine's prefix cache."""
        self.prefix_cache = cache

    def retain_kv(self, kv) -> None:
        """Epoch end (persistent mode): keep the pool for the next epoch."""
        self._retained_kv = kv

    def drop_retained_kv(self) -> None:
        self._retained_kv = None

    def init_kv(self, b: int):
        """The new epoch's pool. Without a prefix cache: allocator reset and
        a zeroed pool. Persistent: lane mappings release (cached chains keep
        their pages) and the retained pool is reused; it is zeroed only when
        nothing was retained (the first epoch, or a failed one, after which
        the engine has cleared the cache). Every epoch's pool is the same
        storage, kept for the backend's lifetime, so the decode chunks'
        graphs keep their addresses."""
        if self.prefix_cache is not None:
            self.allocator.release_lanes(batch=b)
            kv, self._retained_kv = self._retained_kv, None
            if kv is not None:
                return kv
        else:
            self.allocator.reset(batch=b)
        if self._pool is None:
            c = self.config
            self._pool = init_paged_cache(
                c.num_hidden_layers, self.max_pages, c.num_key_value_heads, self.page_size,
                c.head_dim, self.cache_dtype, self.device,
            )
        else:
            self._pool.k.zero_()
            self._pool.v.zero_()
        return self._pool

    def abandon(self) -> None:
        """Drop the pool, the retained pool and the decode chunks captured
        over it (the module docstring, abandoned dispatches); the storage
        first (``_check_live``). The engine clears the prefix cache, whose
        chains lived in the dropped pool."""
        self._pool = None
        self._retained_kv = None
        self._chunks = _Chunks(CaptureScope())

    def decode_builds_chunk(self, kv, tok, ring, n: int, s) -> bool:
        """Whether ``decode`` would build its chunk (on the card: capture its
        graph), which the stall guard grants its first-call grace."""
        shapes = {"pads": (tok.shape[0],), "tables": self._host_tables().shape}
        return _chunk_key(kv, n, tok, ring, s, shapes) not in self._chunks

    # --------------------------------------------------- dispatches

    @torch.inference_mode()
    def _kernel_note(self, op: str) -> None:
        """A timeline breadcrumb a paged dispatch, with its kernels' route."""
        timeline.instant(f"kernel:{op}", track="engine", args={"impl": _route(self)})

    def prefill(self, tokens, kv, pads):
        """The whole left-padded batch at slots [0, width) through the
        lanes' block tables (paged_chunk_attention with ``q_starts = 0``)."""
        _check_live(kv, self._pool, "prefill")
        self._kernel_note("prefill")
        self._check_write_bound("prefill", int(np.shape(tokens)[1]))
        return B.paged_prefill(
            self.params, _tokens(tokens, self.device), kv, _rows(pads, self.device),
            self._tables(), self.config, rope=self.rope,
        )

    @torch.inference_mode()
    def suffix_prefill(self, tokens, kv, pads, write_starts, start: int):
        """Prefix-cache prefill of the window [start, start + W) over the
        live pool prefix, each row's writes below its threshold sunk. EVERY
        cache-enabled prefill goes here, cold epochs included, so warm and
        cold runs share one attention arithmetic."""
        _check_live(kv, self._pool, "suffix_prefill")
        self._kernel_note("suffix_prefill")
        self._check_write_bound("suffix_prefill", int(start) + int(np.shape(tokens)[1]))
        return B.paged_suffix_prefill(
            self.params, _tokens(tokens, self.device), kv, _rows(pads, self.device),
            _rows(write_starts, self.device), self._tables(), self.config, int(start),
            rope=self.rope,
        )

    @torch.inference_mode()
    def suffix_join(self, kv, row_tokens, pad: int, write_start: int, lane: int, start: int):
        """A join on the prefix-cache arithmetic: one row's window
        [start, slot) over its lane's table, sliced to the same capacity."""
        _check_live(kv, self._pool, "suffix_join")
        self._kernel_note("suffix_join")
        self._check_write_bound("suffix_join", int(start) + int(np.shape(row_tokens)[1]))
        return B.paged_suffix_prefill(
            self.params, _tokens(row_tokens, self.device), kv, _rows([pad], self.device),
            _rows([write_start], self.device), self._lane_table(lane), self.config, int(start),
            rope=self.rope,
        )

    @torch.inference_mode()
    def cow_copy(self, kv, src: list[int], dst: list[int]):
        """Device half of the copy-on-write split (``copy_pages``)."""
        _check_live(kv, self._pool, "cow_copy")
        return copy_pages(kv, src, dst)

    @torch.inference_mode()
    def decode(self, kv, tok, slot, pads, keys, ring, ring_idx, n, s):
        """``n`` lockstep steps; the block table holds for the whole chunk: a
        ``DecodeChunk`` run (``batch.paged_decode_chunk`` is its eager plain
        version), the table copied into its buffer every chunk. Returns as
        the dense backend's. The sampling tail follows the config's
        fusions."""
        chunks = self._chunks  # before the check (_check_live)
        _check_live(kv, self._pool, "decode")
        self._check_write_bound("decode", int(slot) + n)
        tables = self._host_tables()
        params, config, rope = self.params, self.config, self.rope
        chunk = _decode_chunk(
            self, chunks, kv, n, tok, ring, s,
            lambda pads, tables: B.paged_forward_one(params, pads, tables, config, rope),
            pads=(tok.shape[0],), tables=tables.shape,
        )
        ids = chunk.run(tok=tok, slot=slot, ring=ring, ring_idx=ring_idx, keys=keys, pads=pads,
                        tables=tables)
        self._kernel_note("decode")
        _note_fusion_kernels(self, s)
        return ids, kv, chunk.keys, chunk.ring, chunk.ring_idx

    @torch.inference_mode()
    def replay_decode(self, kv, toks, slot: int, pads):
        """A decode chunk's KV writes again through the lanes' current
        tables (the dense backend's ``replay_decode``)."""
        _check_live(kv, self._pool, "replay_decode")
        self._check_write_bound("replay_decode", int(slot) + int(np.shape(toks)[1]))
        fwd = B.paged_forward_one(self.params, _rows(pads, self.device), self._tables(),
                                  self.config, self.rope)
        return _replay_steps(fwd, kv, _tokens(toks, self.device), slot)

    @torch.inference_mode()
    def join(self, kv, row_tokens, pad: int, end: int, lane: int):
        """A join without the prefix cache: the row prefills straight
        through its lane's freshly mapped pages."""
        _check_live(kv, self._pool, "join")
        self._check_write_bound("join", end)
        self._kernel_note("join")
        logits, kv = B.paged_prefill(
            self.params, _tokens(row_tokens, self.device), kv, _rows([pad], self.device),
            self._lane_table(lane), self.config, ends=_rows([end], self.device), seq_len=end,
            rope=self.rope,
        )
        return logits, kv


class BackendWorkerError(RuntimeError):
    """A backend op failed because a worker died after the retry/replay
    budget was spent (or lost the epoch's session). The engine finishes the
    epoch's live streams with ``finish_reason="error"`` and keeps serving
    (runtime/serving.py); any other exception still reaches every consumer
    as a raised error."""

    def __init__(self, node: str, op: str, cause: Exception | None = None):
        super().__init__(f"worker {node!r} failed during batch {op} "
                         f"({cause if cause is not None else 'no cause'})")
        self.node = node
        self.op = op


class DistributedBatchBackend:
    """Continuous batching over the TCP topology (master <-> workers).

    The engine's init_kv / prefill / decode / join seam over the SAME
    clients the serialized master walks (runtime/master.py
    ``DistributedForwardStep``), the lockstep layout riding the FORWARD
    header's ``batch`` extension: B rows share every round trip. The master
    holds embed / ln_f / lm_head and its own ranges (``kv`` here is a dict
    of those ranges' caches, maybe empty); each worker keeps the epoch's
    caches for its ranges under the epoch's replay session. Sampling runs
    master-side through ``sample_step``, the step every backend's decode
    runs, so the streams equal the dense local backend's.

    Every epoch opens a replay session (one sid per ``init_kv``): a
    transient wire failure mid-op is absorbed by the client's deadline and
    idempotent resend. When the retries are spent, or the worker lost the
    session, ``_walk`` raises ``BackendWorkerError``; the range is never
    computed on the master instead."""

    kv_mode = "dense"

    def __init__(self, step):
        from cake_tpu_torch.parallel.topology import MASTER_NODE

        # An old worker ignores the ``batch`` header and would run padded
        # rows as a plain chunk: refuse it here, loudly.
        for node, client in step.clients.items():
            info = getattr(client, "info", None)
            if info is None or not getattr(info, "batch_ops", False):
                ver = getattr(info, "version", "unknown")
                raise RuntimeError(
                    f"worker {node!r} (version {ver}) does not support lockstep batch ops; "
                    "upgrade it or drop --api-batch"
                )
        self.step = step
        self.config = step.config
        self.device = step.device
        self.max_seq_len = step.max_seq_len
        self.cache_dtype = step.kv_dtype
        self._master_node = MASTER_NODE
        # The epoch's head request id (the engine sets it); it rides every
        # FORWARD header.
        self.trace_id: str | None = None
        padded = -(-self.max_seq_len // SEQ_MULTIPLE) * SEQ_MULTIPLE
        rope = model_rope_tables(self.config, padded, self.device)
        self._prefill_op, self._decode_op, self._join_op = B.lockstep_range_ops(self.config, rope)
        self._live: dict | None = None  # the current epoch's caches (init_kv)

    def init_kv(self, b: int) -> dict:
        """A new epoch: the router's next route, a fresh replay session on
        every routed worker (the previous one retired where it is held),
        and the master's own ranges' caches of ``b`` lanes."""
        routed = set(self.step.router.refresh().values())
        sid = f"ep-{uuid.uuid4().hex[:12]}"
        for name, client in self.step.clients.items():
            if client.sid is not None:
                try:
                    client.reset()
                except (ConnectionError, TimeoutError, OSError):
                    pass  # a dead socket holds nothing to retire; the LRU ages it out
                client.sid = None
            if name in routed:
                client.begin_session(sid)
        c = self.config
        self._live = {
            (lo, hi): init_cache(hi - lo, b, self.max_seq_len, c.num_key_value_heads, c.head_dim,
                                 self.cache_dtype, self.device)
            for (lo, hi) in self.step.local_params
        }
        return self._live

    def abandon(self) -> None:
        """After a stalled dispatch: its caches are dropped (every epoch
        makes its own) and ``_walk`` sends no further hop for it; the next
        ``init_kv`` opens a new session. The round trip in flight when it
        stalled stays bounded by the wire's ``op_deadline_s``."""
        self._live = None

    def _walk(self, kind: str, x: torch.Tensor, pos: int, kv: dict, batch_hdr: dict, local):
        """``x`` through the whole plan: the master's ranges by
        ``local(layers, x, kv_range)``, each remote span as ONE round trip."""
        from cake_tpu_torch.runtime.worker import torch_to_wire, wire_to_torch

        step = self.step
        plan = step.plan
        i = 0
        while i < len(plan):
            if kv is not self._live:
                raise RuntimeError(f"{kind}: the epoch was abandoned after a stalled dispatch")
            s = plan[i]
            if s.node == self._master_node:
                r = (s.lo, s.hi)
                x, kv[r] = local(step.local_params[r], x, kv[r])
                i += 1
                continue
            ranges = []
            primary = s.node
            while i < len(plan) and plan[i].node == primary:
                ranges.append((plan[i].lo, plan[i].hi))
                i += 1
            node = step.router.route(primary)
            try:
                out = step.clients[node].forward(torch_to_wire(x), ranges, pos, batch=batch_hdr,
                                                 trace=self.trace_id)
            except (ConnectionError, TimeoutError, OSError) as e:
                # The epoch cannot continue: count the hop, re-dial so the
                # next epoch has a live socket, then the typed error the
                # engine isolates.
                metrics.registry.counter(
                    "cake_hop_failures_total",
                    "Worker hops abandoned after deadline/retry "
                    "exhaustion or session loss (each one either "
                    "triggers history replay or fails its streams "
                    "with finish_reason=error).",
                ).inc(node=node)
                metrics.flight.record("hop-failed", self.trace_id, node=node, pos=int(pos),
                                      op=kind, error=str(e)[:200])
                try:
                    step.clients[node].reconnect()
                except (ConnectionError, TimeoutError, OSError):
                    pass
                raise BackendWorkerError(node, kind, e) from e
            step.router.report_success(node)
            x = wire_to_torch(out, step.dtype, self.device)
        return x, kv

    def failover(self, node: str) -> bool:
        """Eject ``node`` and re-route its replica group for the rest of the
        epoch (runtime/router.py). True iff a healthy replica took over:
        the engine then migrates the live streams onto the new route
        (runtime/serving.py); False degrades to the error isolation."""
        return self.step.router.failover(node) is not None

    @torch.inference_mode()
    def prefill(self, tokens, kv, pads):
        """The whole left-padded batch at slots [0, width): (logits, kv)."""
        width = int(np.shape(tokens)[1])
        pads_np = np.asarray(pads, np.int32).reshape(-1)
        pads_t, ends_t = _rows(pads_np, self.device), _rows([width] * len(pads_np), self.device)
        x = M.embed_tokens(self.step.head, _tokens(tokens, self.device), self.config)
        hdr = {"kind": "prefill", "pads": pads_np.tolist(), "ends": [width] * len(pads_np)}
        x, kv = self._walk("prefill", x, 0, kv, hdr,
                           lambda layers, x, kv_r: self._prefill_op(layers, x, kv_r, pads_t, ends_t))
        return M.head_forward(self.step.head, x, width, self.config), kv

    @torch.inference_mode()
    def decode(self, kv, tok, slot, pads, keys, ring, ring_idx, n, s):
        """``n`` lockstep steps, one walk of the plan each; sampling on the
        master (``sample_step``, the fused tail when "tail" is on), which
        pushes into ``ring`` in place (a chunk redone after a migration
        starts from rings the engine rebuilds). Returns (ids [B, n], kv,
        keys, ring, ring_idx)."""
        if slot < 0 or slot + n > self.max_seq_len:
            raise ValueError(f"decode writes slots [{slot}, {slot + n}) outside the cache's "
                             f"{self.max_seq_len}")
        hdr = {"kind": "decode", "pads": [int(p) for p in pads.tolist()]}
        fused_tail = "tail" in resolve_fusion(self.config)
        out = []
        for i in range(n):
            pos = int(slot) + i
            x = M.embed_tokens(self.step.head, tok[:, None], self.config)
            x, kv = self._walk("decode", x, pos, kv, hdr,
                               lambda layers, x, kv_r: self._decode_op(layers, x, kv_r, pads, pos))
            logits = M.head_forward(self.step.head, x, 1, self.config)
            tok, keys, ring, ring_idx = sample_step(
                logits, keys, ring, ring_idx, temperature=s.temperature, top_k=s.top_k,
                top_p=s.top_p, repeat_penalty=s.repeat_penalty, fused_tail=fused_tail,
            )
            out.append(tok)
        return torch.stack(out, dim=1), kv, keys, ring, ring_idx

    @torch.inference_mode()
    def replay_decode(self, kv, toks, slot: int, pads):
        """A decode chunk's KV writes again: one walk of the plan a step,
        fed ``toks`` [B, n]; no head and no sampling."""
        pads_np = np.asarray(pads, np.int32).reshape(-1)
        pads_t = _rows(pads_np, self.device)
        hdr = {"kind": "decode", "pads": pads_np.tolist()}
        toks_t = _tokens(toks, self.device)
        for i in range(toks_t.shape[1]):
            pos = int(slot) + i
            x = M.embed_tokens(self.step.head, toks_t[:, i : i + 1], self.config)
            _, kv = self._walk("decode", x, pos, kv, hdr,
                               lambda layers, x, kv_r: self._decode_op(layers, x, kv_r, pads_t,
                                                                       pos))
        return kv

    @torch.inference_mode()
    def join(self, kv, row_tokens, pad: int, end: int, lane: int):
        """One row whose prompt ends at the shared slot ``end``, prefilled
        into ``lane`` on the master's ranges and every worker's."""
        pads1, ends1 = _rows([pad], self.device), _rows([end], self.device)
        x = M.embed_tokens(self.step.head, _tokens(row_tokens, self.device), self.config)
        hdr = {"kind": "join", "pads": [int(pad)], "ends": [int(end)], "lane": int(lane)}
        x, kv = self._walk(
            "join", x, 0, kv, hdr,
            lambda layers, x, kv_r: self._join_op(layers, x, kv_r, pads1, ends1, int(lane)),
        )
        return M.head_forward(self.step.head, x, int(end), self.config), kv
