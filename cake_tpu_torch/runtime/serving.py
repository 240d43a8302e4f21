"""Concurrent batched serving: a request queue feeding lockstep batch decode
(port of ``cake_tpu/runtime/serving.py``, the epoch scheduler).

HTTP handler threads ``submit()`` requests into a FIFO; one engine thread
owns the device, drains the queue, groups requests whose sampling knobs
match, left-pads the group into ONE batch (models/llama/batch.py) and
decodes every row in lockstep, streaming each row's tokens to its own
consumer as every decode chunk lands.

Batching is CONTINUOUS: an epoch owns up to ``max_batch`` fixed lanes, and at
every decode-chunk boundary finished lanes free up and queued requests with
the same knobs JOIN the running epoch (a single-row prefill whose prompt ends
at the epoch's shared slot). Under ``kv_mode="paged"`` admission and joins
charge pages of the shared pool, decode maps pages at page boundaries, and
finished streams return theirs; with the prefix cache on, a prompt sharing a
cached prefix forks its page chain and prefills only the uncached suffix.

Each row carries its own threefry key (ops/threefry.py: ``prng_key`` of its
seed, split once a step, ops/sampling.sample_per_row), so a row's stream does
not depend on what shares its batch; greedy and seeded sampled streams equal
the JAX package's engine on the same checkpoint (tests/test_torch_serving.py,
tests/test_torch_threefry.py).

Not ported yet (ROADMAP.md): the continuous scheduler with spill/restore,
speculative verify, tenants and fair queueing (the queue is the single-tenant
FIFO), shedding, deadlines, failover, the black box and the observability
ledgers. Asking for a knob that is not ported raises.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import uuid
from collections import deque
from typing import Iterator

import numpy as np
import torch

from cake_tpu_torch.device import upload
from cake_tpu_torch.models.llama import model as M
from cake_tpu_torch.models.llama.batch import first_sample, layout_prompts, prompt_bucket, seed_rings
from cake_tpu_torch.models.llama.chat import Message, encode_dialog
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import SamplingConfig, Token, decode_delta
from cake_tpu_torch.models.llama.paged_cache import PageExhausted
from cake_tpu_torch.models.llama.tokenizer import Tokenizer
from cake_tpu_torch.ops.fuse import parse_fusion_spec
from cake_tpu_torch.ops.threefry import prng_key

__all__ = ["BatchEngine", "ServeConfig", "StreamHandle"]

log = logging.getLogger("cake_tpu_torch.serving")

_DONE = "__done__"

# Epoch attention-capacity granularity (slots): the paged epoch capacity
# rounds up to it.
_CAPACITY_BUCKET = 256
# Join and suffix-prefill windows round up to this many slots.
_WINDOW_BUCKET = 64


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The engine's knobs (one object the CLI and API layers build).

    ``kv_mode="paged"`` serves from a page pool (runtime/batch_backend
    ``PagedLocalBackend``): a request is admitted iff ``ceil(prompt /
    page_size) + page_reserve`` pages are free, decode maps pages at page
    boundaries, finished streams return theirs. ``max_pages`` sizes the pool
    (None = ``max_batch`` dense-equivalent strips). ``prefix_cache`` (paged
    only) keeps finished prompts' prefix pages in a radix cache of
    ``prefix_cache_pages`` pages (0 = half the pool), serving prefixes of at
    least ``prefix_min_tokens`` tokens; ``cache_aware_order`` groups queued
    requests that extend the same cached chain into one epoch.
    ``fusion_impl`` (ops/fuse.py ``parse_fusion_spec``), when not "none",
    overrides the model config's decode fusions for the engine's backend.
    """

    max_batch: int = 8
    decode_chunk_size: int = 8
    admission_window: float = 0.01
    scheduler: str = "epoch"  # "continuous" is not ported yet
    cache_aware_order: bool = True
    kv_mode: str = "dense"  # "dense" | "paged"
    page_size: int = 128
    max_pages: int | None = None
    page_reserve: int = 1
    prefix_cache: bool = False
    prefix_cache_pages: int = 0
    prefix_min_tokens: int = 0
    fusion_impl: str = "none"

    def __post_init__(self):
        parse_fusion_spec(self.fusion_impl)
        if self.scheduler == "continuous":
            raise NotImplementedError(
                "the continuous scheduler is not ported yet (ROADMAP.md queue A)"
            )
        if self.scheduler != "epoch":
            raise ValueError(f"scheduler must be epoch, got {self.scheduler}")
        if self.kv_mode not in ("dense", "paged"):
            raise ValueError(f"kv_mode must be dense|paged, got {self.kv_mode}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.prefix_cache and self.kv_mode != "paged":
            raise ValueError(
                "prefix_cache shares physical KV pages across requests and therefore "
                "needs kv_mode='paged'"
            )
        if self.prefix_cache_pages < 0 or self.prefix_min_tokens < 0:
            raise ValueError("prefix_cache_pages and prefix_min_tokens must be >= 0")
        if self.page_reserve < 1:
            # A left-padded window straddling a page boundary maps one page
            # more than ceil(prompt / page_size): the reserve is what makes
            # the admission charge an upper bound.
            raise ValueError(f"page_reserve must be >= 1, got {self.page_reserve}")


def _knobs(s: SamplingConfig) -> tuple:
    """Batch compatibility: requests sharing these share one lockstep batch
    (the seed is per row)."""
    return (s.temperature, s.top_k, s.top_p, s.repeat_penalty, s.repeat_last_n)


@dataclasses.dataclass
class _Request:
    prompt_ids: list[int]
    max_tokens: int
    sampling: SamplingConfig
    handle: "StreamHandle"
    rid: str = ""
    t_submit: float = 0.0

    def knobs(self) -> tuple:
        return _knobs(self.sampling)


class StreamHandle:
    """Consumer side of one submitted request: ``tokens()`` yields Tokens as
    the engine produces them and returns when the stream finishes;
    ``text()`` blocks to completion. An engine-side failure re-raises here."""

    def __init__(self, n_prompt: int, request_id: str = ""):
        self.prompt_tokens = n_prompt
        self.completion_tokens = 0
        self.finish_reason: str = "length"
        self.request_id = request_id
        self.ttft_s: float | None = None  # submit to first token, engine clock
        self._events: deque = deque()
        self._cv = threading.Condition()

    def _emit(self, item) -> None:
        with self._cv:
            self._events.append(item)
            self._cv.notify()

    def tokens(self) -> Iterator[Token]:
        while True:
            with self._cv:
                while not self._events:
                    self._cv.wait()
                item = self._events.popleft()
            if item is _DONE:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def text(self) -> str:
        return "".join(t.text for t in self.tokens())


class BatchEngine:
    """One device-owning thread serving many concurrent requests."""

    def __init__(
        self,
        config: LlamaConfig,
        params: M.Params,
        tokenizer: Tokenizer,
        *,
        max_seq_len: int | None = None,
        cache_dtype: torch.dtype = torch.bfloat16,
        serve: ServeConfig | None = None,
        speculative_k: int = 0,
        device: torch.device | str | None = None,
    ):
        if speculative_k:
            raise NotImplementedError("speculative decoding is not ported yet (ROADMAP.md)")
        serve = serve or ServeConfig()
        if serve.fusion_impl != "none" and serve.fusion_impl != config.fusion_impl:
            # Before the backend is built: it closes over this config.
            config = dataclasses.replace(config, fusion_impl=serve.fusion_impl)
        self.config = config
        self.tokenizer = tokenizer
        self.max_seq_len = int(max_seq_len or config.max_position_embeddings)
        self.decode_chunk_size = max(1, serve.decode_chunk_size)
        self.max_batch = max(1, serve.max_batch)
        self.admission_window = serve.admission_window
        self.cache_aware_order = serve.cache_aware_order
        from cake_tpu_torch.runtime import batch_backend

        if serve.kv_mode == "paged":
            pages_per_seq = -(-self.max_seq_len // serve.page_size)
            backend = batch_backend.PagedLocalBackend(
                config, params, max_seq_len=self.max_seq_len, cache_dtype=cache_dtype,
                page_size=serve.page_size,
                max_pages=serve.max_pages or self.max_batch * pages_per_seq,
                page_reserve=serve.page_reserve, device=device,
            )
        else:
            backend = batch_backend.LocalBatchBackend(
                config, params, max_seq_len=self.max_seq_len, cache_dtype=cache_dtype,
                device=device,
            )
        self.backend = backend
        self.kv_mode = backend.kv_mode
        dev = backend.device
        # The card the engine thread binds to (the constructing thread's
        # current one unless the backend names one).
        self._cuda_index = (
            (dev.index if dev.index is not None else torch.cuda.current_device())
            if dev.type == "cuda" else None
        )
        # The allocator drives admission, page growth and release; None = dense lanes.
        self._alloc = getattr(backend, "allocator", None)
        self._prefix = None
        if serve.prefix_cache:  # paged only (ServeConfig checks)
            from cake_tpu_torch.runtime.prefix_cache import PrefixCache

            self._prefix = PrefixCache(
                self._alloc,
                max_pages=serve.prefix_cache_pages or max(1, self._alloc.pages_total // 2),
                min_tokens=serve.prefix_min_tokens,
            )
            backend.attach_prefix_cache(self._prefix)
        # Per-lane prefix state of the current epoch (engine thread only): the
        # lease pinning the chain a lane forked, and (request, pad) so the
        # lane's prompt chain can be inserted when its pages return.
        self._lane_leases: dict[int, object] = {}
        self._lane_info: dict[int, tuple[_Request, int]] = {}
        self._epoch_kv_retained = False
        self._queue: deque[_Request] = deque()
        self._cv = threading.Condition()
        self._stop = False
        self._running = False  # an epoch is in flight (under _cv)
        self._thread: threading.Thread | None = None
        # Under _cv: rids live in the current epoch, and rids whose cancel
        # waits for a chunk boundary.
        self._live_rids: set[str] = set()
        self._cancel_ids: set[str] = set()
        # Written by the engine thread; readers take a copy.
        self.stats = {
            "batches": 0, "rows": 0, "max_rows": 0, "joins": 0, "cancelled": 0,
            "page_truncations": 0, "prefix_hits": 0, "prefix_misses": 0,
            "prefill_s": 0.0, "decode_s": 0.0, "decode_chunks": 0, "decode_steps": 0,
        }

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, name="batch-engine", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None

    def snapshot(self) -> dict:
        """Counters for ``GET /stats``: engine stats, live lanes, the pool
        and the prefix cache."""
        out = dict(self.stats)
        with self._cv:
            out["queued"] = len(self._queue)
            out["live"] = len(self._live_rids)
        out["kv_mode"] = self.kv_mode
        if self._alloc is not None:
            out["pages_total"] = self._alloc.pages_total
            out["pages_free"] = self._alloc.pages_free
        if self._prefix is not None:
            out["prefix"] = self._prefix.stats()
        return out

    # ------------------------------------------------------------ submission

    def submit(
        self,
        messages: list[Message],
        max_tokens: int,
        sampling: SamplingConfig,
        request_id: str | None = None,
    ) -> StreamHandle:
        """Queue one chat completion; returns its stream at once. Raises
        ValueError for prompts that can never be served (the API maps it to
        a 400 before any streaming headers go out)."""
        ids = self.tokenizer.encode(encode_dialog(messages, self.config.dialog_template))
        # The left-pad bucket can add slots ahead of the prompt: require room
        # for the bucket plus one generated token (the layout's own helper).
        if prompt_bucket(len(ids), self.max_seq_len) >= self.max_seq_len:
            raise ValueError(
                f"prompt is {len(ids)} tokens but the context window is {self.max_seq_len}"
            )
        if self._alloc is not None:
            need = self._alloc.pages_needed(len(ids)) + self._alloc.reserve_pages
            if need > self._alloc.pages_total:
                raise ValueError(
                    f"prompt needs {need} KV pages (page_size {self._alloc.page_size}) "
                    f"but the pool holds {self._alloc.pages_total}"
                )
        rid = request_id or f"req-{uuid.uuid4()}"
        handle = StreamHandle(n_prompt=len(ids), request_id=rid)
        req = _Request(ids, int(max_tokens), sampling, handle, rid=rid,
                       t_submit=time.perf_counter())
        with self._cv:
            if self._stop:
                raise RuntimeError("engine is stopped")
            self._queue.append(req)
            self._cv.notify_all()
        return handle

    def cancel(self, request_id: str) -> bool:
        """Cancel one request. Queued: finished at once as "cancelled".
        Running: finished at the next chunk boundary, its lane and pages
        freed for joins. False for ids neither queued nor live."""
        with self._cv:
            for r in self._queue:
                if r.rid == request_id:
                    self._queue.remove(r)
                    r.handle.finish_reason = "cancelled"
                    self.stats["cancelled"] += 1
                    r.handle._emit(_DONE)
                    return True
            if request_id in self._live_rids:
                self._cancel_ids.add(request_id)
                return True
        return False

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Wait until the queue is empty and no epoch is running: every
        lane's pages are back in the pool, and the next submissions open an
        epoch of their own (a stream closes before its epoch ends, and a
        request submitted then joins it)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._queue or self._running:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(left)
        return True

    def _row_finished(self, rid: str) -> None:
        with self._cv:
            self._live_rids.discard(rid)
            self._cancel_ids.discard(rid)

    def _apply_cancels(self, rows: list) -> None:
        """Chunk-boundary sweep: flagged rows finish "cancelled"; their
        pages return in the caller's _release_finished pass."""
        with self._cv:
            if not self._cancel_ids:
                return
            pending = set(self._cancel_ids)
        for lane, row in enumerate(rows):
            if row is not None and row.req.rid in pending:
                self.stats["cancelled"] += 1
                row.req.handle.finish_reason = "cancelled"
                row.finish()
                rows[lane] = None

    # ------------------------------------------------------------ scheduler

    def _loop(self) -> None:
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)  # this thread owns the card
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if self._stop:
                    for r in self._queue:
                        r.handle._emit(RuntimeError("engine stopped"))
                    self._queue.clear()
                    return
            # Let a burst of concurrent submissions land in one batch.
            if self.admission_window > 0:
                time.sleep(self.admission_window)
            batch = self._admit()
            if not batch:
                continue
            self.stats["batches"] += 1
            self.stats["rows"] += len(batch)
            self.stats["max_rows"] = max(self.stats["max_rows"], len(batch))
            try:
                self._run_batch(batch)
            except Exception as e:  # noqa: BLE001 - surface to every consumer, keep serving
                log.exception("batch failed")
                for r in batch:
                    r.handle._emit(e)
                    r.handle._emit(_DONE)
            finally:
                with self._cv:
                    self._running = False
                    self._cv.notify_all()

    def _pages_for(self, req: _Request, end_slot: int | None = None) -> int:
        """Admission price: prompt pages + the reserve, less the cached-prefix
        discount. A join knows its pad exactly (``end_slot``); epoch-start
        admission estimates it from the request's solo bucket."""
        n = len(req.prompt_ids)
        served = 0
        if self._prefix is not None:
            end = end_slot if end_slot is not None else prompt_bucket(n, self.max_seq_len)
            served = self._prefix.match_tokens(req.prompt_ids, (end - n) % self._alloc.page_size)
        return self._alloc.pages_needed(n - served) + self._alloc.reserve_pages

    def _admit(self) -> list[_Request]:
        """The queue's head plus every queued request with the same knobs, up
        to max_batch, in FIFO order. Paged: each candidate charges its pages
        against the pool; one that does not fit stays queued while a smaller
        later one may land. With the prefix cache and ``cache_aware_order``,
        only requests extending the head's cached chain join its epoch."""
        head_knobs, ckey, avail = None, None, None

        def radix_key(r: _Request):
            n = len(r.prompt_ids)
            align = (prompt_bucket(n, self.max_seq_len) - n) % self._alloc.page_size
            return self._prefix.radix_key(r.prompt_ids, align)

        def charge(r: _Request) -> bool:
            nonlocal avail
            need = self._pages_for(r)
            if need > avail and self._prefix is not None:
                avail += self._prefix.reclaim(need - avail)
            if need > avail:
                return False
            avail -= need
            return True

        group: list[_Request] = []
        with self._cv:
            for r in list(self._queue):
                if len(group) >= self.max_batch:
                    break
                if head_knobs is None:
                    head_knobs = r.knobs()
                    if self._prefix is not None and self.cache_aware_order:
                        ckey = radix_key(r)
                    if self._alloc is not None:
                        avail = self._alloc.pages_free
                        charge(r)  # the head is always taken (the pool is fresh)
                elif r.knobs() != head_knobs:
                    continue
                elif ckey is not None and radix_key(r) != ckey:
                    continue
                elif avail is not None and not charge(r):
                    continue
                self._queue.remove(r)
                group.append(r)
            # Live while still under the lock that dequeued them, so cancel()
            # always finds a request somewhere.
            self._live_rids.update(r.rid for r in group)
            self._running = bool(group)
        return group

    # ------------------------------------------------- prefix-cache wiring

    def _fork_lane(self, lane: int, req: _Request, pad: int, end: int):
        """Fork the longest cached chain under one lane, split the boundary
        page copy-on-write when the fresh region starts mid-page, and map the
        uncached tail [fresh, end). Returns (fresh, cow_pair): the first slot
        the lane computes and may write, and the (src, dst) pages the caller
        copies before any write (None without a split). Raises PageExhausted
        when even reclaiming the cache cannot supply the tail's pages."""
        fresh, pair = pad, None
        plan = self._prefix.fork(lane, req.prompt_ids, pad)
        if plan is None:
            self.stats["prefix_misses"] += 1
        else:
            self.stats["prefix_hits"] += 1
            self._lane_leases[lane] = plan.lease
            fresh = pad + plan.served
            if plan.cow_logical is not None:
                try:
                    pair = self._alloc.make_private(lane, plan.cow_logical)
                except PageExhausted:
                    if self._prefix.reclaim(1):
                        pair = self._alloc.make_private(lane, plan.cow_logical)
                    else:
                        # Give the shared page back and recompute its tokens
                        # into a fresh page: never write a shared page.
                        self._alloc.unmap_page(lane, plan.cow_logical)
                        fresh = max(pad, plan.cow_logical * self._alloc.page_size)
        try:
            self._alloc.map_range(lane, fresh, end)
        except PageExhausted:
            self._prefix.reclaim(self._alloc.pages_needed(end - fresh) + 1)
            self._alloc.map_range(lane, fresh, end)
        self._lane_info[lane] = (req, pad)
        return fresh, pair

    def _prefix_layout(self, reqs: list, rows: list, pads, bucket: int, kv):
        """Epoch-start layout under the prefix cache: fork every real lane's
        cached chain and map its uncached tail. Returns (kv, write_starts):
        cold lanes' thresholds sit at their pads, dummy lanes' at the window
        tail. A lane that cannot get its pages finishes as "length"."""
        ws = np.asarray(pads, np.int32).copy()
        cow_src: list[int] = []
        cow_dst: list[int] = []
        for lane, r in enumerate(reqs):
            if r is None:
                ws[lane] = bucket - 1
                continue
            try:
                fresh, pair = self._fork_lane(lane, r, int(pads[lane]), bucket)
            except PageExhausted:
                self.stats["page_truncations"] += 1
                rows[lane].req.handle.finish_reason = "length"
                rows[lane].finish()
                rows[lane] = reqs[lane] = None
                self._lane_recycle(lane, insert=False)
                ws[lane] = bucket - 1
                continue
            ws[lane] = fresh
            if pair is not None:
                cow_src.append(pair[0])
                cow_dst.append(pair[1])
        if cow_src:  # one device copy for every lane's boundary split
            kv = self.backend.cow_copy(kv, cow_src, cow_dst)
        return kv, ws

    # -------------------------------------------------- execution (epochs)

    @torch.inference_mode()
    def _run_batch(self, batch: list[_Request]) -> None:
        """One epoch. Any exception reaches every row admitted so far,
        joiners included, as a raised error; the pool is returned either
        way, and a failed epoch clears the prefix cache (its chains must
        never outlive their bytes)."""
        rows: list[_RowState | None] = []
        self._epoch_kv_retained = False
        try:
            self._run_epoch(batch, rows)
        except Exception as e:
            for row in rows:
                if row is not None:
                    row.req.handle._emit(e)
                    row.req.handle._emit(_DONE)
                    self._row_finished(row.req.rid)
            raise
        finally:
            if self._alloc is not None:
                for lane in range(len(rows)):
                    if self._alloc.lane_mapped(lane):
                        self._lane_recycle(lane, insert=self._epoch_kv_retained)
            if self._prefix is not None and not self._epoch_kv_retained:
                self._prefix.clear()
                self.backend.drop_retained_kv()
            self._lane_leases.clear()
            self._lane_info.clear()
            if hasattr(self.backend, "set_epoch_capacity"):
                self.backend.set_epoch_capacity(None)
            with self._cv:
                self._live_rids.difference_update(r.rid for r in batch)
                self._cancel_ids.difference_update(r.rid for r in batch)
                for row in rows:
                    if row is not None:
                        self._live_rids.discard(row.req.rid)
                        self._cancel_ids.discard(row.req.rid)

    def _run_epoch(self, batch: list[_Request], rows: list) -> None:
        s, knobs = batch[0].sampling, batch[0].knobs()
        eos = set(self.config.eos_token_ids)
        dev = self.backend.device
        # Lanes: the next power of two of the group, doubled once for join
        # headroom, capped at max_batch.
        n_lanes = 1
        while n_lanes < len(batch):
            n_lanes *= 2
        n_lanes = min(max(n_lanes * 2, 2), self.max_batch)
        window = s.repeat_last_n
        # Spare lanes carry a one-token dummy prompt and are free for joins.
        reqs: list[_Request | None] = list(batch) + [None] * (n_lanes - len(batch))
        ids_list = [r.prompt_ids if r is not None else [self.config.bos_token_id] for r in reqs]
        rows.extend(
            _RowState(r, eos, self.tokenizer, self) if r is not None else None for r in reqs
        )
        tokens, pads, bucket = layout_prompts(ids_list, self.max_seq_len)
        # ONE bounded capacity for the whole epoch (paged): enough slots for
        # every admitted row's budget, bucketed, capped at max_seq_len.
        cap = self.max_seq_len
        if self._alloc is not None:
            reach = bucket + max(min(r.max_tokens, self.max_seq_len - bucket) for r in batch)
            self.backend.set_epoch_capacity(
                min(self.max_seq_len, -(-reach // _CAPACITY_BUCKET) * _CAPACITY_BUCKET)
            )
            cap = min(self.max_seq_len, self.backend.capacity_slots())

        t0 = time.perf_counter()
        kv = self.backend.init_kv(n_lanes)  # paged: resets or releases the allocator
        write_starts = None
        if self._prefix is not None:
            kv, write_starts = self._prefix_layout(reqs, rows, pads, bucket, kv)
        elif self._alloc is not None:
            # Each real lane's pages over its live window [pad, bucket);
            # dummy lanes hold none (their writes sink).
            for lane, r in enumerate(reqs):
                if r is not None:
                    self._alloc.map_range(lane, int(pads[lane]), bucket)
        if write_starts is not None:
            # Prefix-cache path, cold epochs included: prefill only the
            # window [start, bucket) covering every lane's uncached tail.
            fresh_width = bucket - int(write_starts.min())
            start = bucket - min(-(-fresh_width // _WINDOW_BUCKET) * _WINDOW_BUCKET, bucket)
            logits, kv = self.backend.suffix_prefill(
                tokens[:, start:], kv, pads, write_starts, start
            )
        else:
            logits, kv = self.backend.prefill(tokens, kv, pads)
        ring, ring_idx = seed_rings(ids_list, window)
        keys = prng_key([r.sampling.seed if r is not None else 0 for r in reqs], dev)
        first, keys, ring, ring_idx = first_sample(logits, s, ring, ring_idx, keys)
        self.stats["prefill_s"] += time.perf_counter() - t0
        for lane, row in enumerate(rows):
            if row is not None:
                row.push(int(first[lane]))
                if row.done:
                    rows[lane] = None
        self._release_finished(rows)

        tok = upload(first, dev, torch.int64)
        pads_j = upload(pads, dev)
        ring_j = upload(ring, dev, torch.int64)
        ring_idx_j = upload(ring_idx, dev, torch.int64)
        slot = bucket  # slot of the most recent token, shared by every lane
        while slot < cap - 1:
            if self._stop:
                err = RuntimeError("engine stopped")
                for lane, row in enumerate(rows):
                    if row is not None:
                        row.req.handle._emit(err)
                        row.req.handle._emit(_DONE)
                        self._row_finished(row.req.rid)
                        rows[lane] = None
                return
            self._apply_cancels(rows)
            self._release_finished(rows)
            join_args = self._take_joins(knobs, rows, slot, cap)
            joined: set[int] = set()
            try:
                for lane, req in join_args:
                    tok, kv, keys, ring_j, ring_idx_j = self._join(
                        req, lane, rows, slot, tok, kv, keys, ring_j, ring_idx_j, s
                    )
                    pads_j[lane] = slot - len(req.prompt_ids)
                    joined.add(id(req))
            except Exception as e:
                for _, req in join_args:
                    if id(req) not in joined:
                        req.handle._emit(e)
                        req.handle._emit(_DONE)
                        self._row_finished(req.rid)
                raise
            if not any(r is not None for r in rows):
                break
            n = min(self.decode_chunk_size, cap - 1 - slot)
            if self._alloc is not None and not self._extend_pages(rows, slot, n):
                break  # every remaining row was truncated
            t_chunk = time.perf_counter()
            toks, kv, keys, ring_j, ring_idx_j = self.backend.decode(
                kv, tok, slot, pads_j, keys, ring_j, ring_idx_j, n, s
            )
            toks_np = toks.cpu().numpy()  # the chunk's one readback
            self.stats["decode_s"] += time.perf_counter() - t_chunk
            self.stats["decode_chunks"] += 1
            self.stats["decode_steps"] += n
            for lane, row in enumerate(rows):
                if row is None:
                    continue
                for t in toks_np[lane]:
                    row.push(int(t))
                    if row.done:
                        rows[lane] = None
                        break
            self._release_finished(rows)
            tok = toks[:, -1].clone()
            slot += n

        for row in rows:
            if row is not None:
                row.finish()  # the capacity edge: the stream closes with "length"
        if self._prefix is not None:
            self.backend.retain_kv(kv)  # cached chains' bytes live on
        self._epoch_kv_retained = True

    # ------------------------------------------------- paged-pool accounting

    def _release_finished(self, rows: list) -> None:
        """Return every finished (or never-real) lane's pages and unmap
        them, so the lane's lockstep garbage writes sink instead of landing
        in pages a later join may reuse."""
        if self._alloc is None:
            return
        for lane, row in enumerate(rows):
            if row is None and self._alloc.lane_mapped(lane):
                self._lane_recycle(lane)

    def _lane_recycle(self, lane: int, insert: bool = True) -> None:
        """One lane's pages back to the pool, in prefix-cache order: adopt
        the lane's prompt chain into the cache, unpin the chain it forked,
        then drop its mappings. A failed epoch passes ``insert=False``."""
        if self._prefix is not None:
            info = self._lane_info.pop(lane, None)
            if insert and info is not None:
                req, pad = info
                self._prefix.insert(lane, req.prompt_ids, pad)
            self._prefix.release(self._lane_leases.pop(lane, None))
        self._alloc.release(lane)

    def _extend_pages(self, rows: list, slot: int, n: int) -> bool:
        """Map every live lane's pages over the next chunk [slot, slot + n)
        (only page-boundary crossings allocate). Pool pressure reclaims
        cold prefix-cache pages, retrying while a pass frees something, and
        only then finishes the stream as "length". Returns False when no
        live row is left."""
        any_live = False
        for lane, row in enumerate(rows):
            if row is None:
                continue
            try:
                try:
                    self._alloc.map_range(lane, slot, slot + n)
                except PageExhausted:
                    if self._prefix is None:
                        raise
                    while True:
                        freed = self._prefix.reclaim(self._alloc.pages_needed(n) + 1)
                        try:
                            self._alloc.map_range(lane, slot, slot + n)
                            break
                        except PageExhausted:
                            if not freed:
                                raise
                any_live = True
            except PageExhausted:
                self.stats["page_truncations"] += 1
                row.req.handle.finish_reason = "length"
                row.finish()
                rows[lane] = None
                self._lane_recycle(lane)
        return any_live

    # ------------------------------------------------------------ joins

    def _take_joins(self, knobs: tuple, rows: list, slot: int, cap: int) -> list:
        """Dequeue requests that can join NOW, in FIFO order: same knobs (a
        request with other knobs stops the scan: it bounds this epoch), a
        prompt that ends by the shared slot, a free lane, and enough budget
        left in the epoch that joining delivers what waiting would. Paged:
        joiners charge their pages, reclaiming cold cache pages first."""
        free = [i for i, r in enumerate(rows) if r is None]
        if not free:
            return []
        avail = self._alloc.pages_free if self._alloc is not None else None
        out: list[tuple[int, _Request]] = []
        with self._cv:
            for req in list(self._queue):
                if len(out) >= len(free):
                    break
                if req.knobs() != knobs:
                    break
                n_ids = len(req.prompt_ids)
                solo_budget = min(
                    req.max_tokens, self.max_seq_len - prompt_bucket(n_ids, self.max_seq_len)
                )
                if n_ids > slot or cap - slot < solo_budget:
                    continue
                if avail is not None:
                    need = self._pages_for(req, end_slot=slot)
                    if need > avail and self._prefix is not None:
                        avail += self._prefix.reclaim(need - avail)
                    if need > avail:
                        continue
                    avail -= need
                self._queue.remove(req)
                out.append((free[len(out)], req))
            self._live_rids.update(req.rid for _, req in out)
        return out

    def _join(self, req, lane, rows, slot, tok, kv, keys, ring_j, ring_idx_j, s):
        """Prefill one request into a free lane of the RUNNING epoch: its
        prompt is left-padded to end at the shared slot, and its first token
        samples from its own fresh key, as a solo run would."""
        row = _RowState(req, set(self.config.eos_token_ids), self.tokenizer, self)
        ids = req.prompt_ids
        pad = slot - len(ids)
        t0 = time.perf_counter()
        if self._prefix is not None:
            # Fork the cached chain, map the tail, and prefill the window
            # [start, slot) on the suffix arithmetic: a warm join equals a
            # cold one because hit and miss walk one arithmetic.
            try:
                fresh, pair = self._fork_lane(lane, req, pad, slot)
            except PageExhausted:
                self.stats["page_truncations"] += 1
                req.handle.finish_reason = "length"
                self._lane_recycle(lane, insert=False)
                row.finish()
                return tok, kv, keys, ring_j, ring_idx_j
            if pair is not None:
                kv = self.backend.cow_copy(kv, [pair[0]], [pair[1]])
            width = min(-(-(slot - fresh) // _WINDOW_BUCKET) * _WINDOW_BUCKET, slot)
            start = slot - width
            row_tokens = np.zeros((1, width), np.int32)
            lo = max(pad, start)
            row_tokens[0, lo - start :] = ids[lo - pad :]
            logits, kv = self.backend.suffix_join(kv, row_tokens, pad, fresh, lane, start)
        else:
            width = min(-(-slot // _WINDOW_BUCKET) * _WINDOW_BUCKET, self.max_seq_len)
            row_tokens = np.zeros((1, width), np.int32)
            row_tokens[0, pad:slot] = ids
            if self._alloc is not None:
                self._alloc.map_range(lane, pad, slot)  # _take_joins charged the pool
            logits, kv = self.backend.join(kv, row_tokens, pad, slot, lane)
        # The same first-token arithmetic as the epoch start (batch.first_sample).
        window = s.repeat_last_n
        row_ring, row_ring_idx = seed_rings([ids], window)
        key0 = prng_key([req.sampling.seed], self.backend.device)
        first_arr, key_next, row_ring, row_ring_idx = first_sample(
            logits, s, row_ring, row_ring_idx, key0
        )
        self.stats["prefill_s"] += time.perf_counter() - t0
        first = int(first_arr[0])
        dev = self.backend.device
        if window > 0:
            ring_j[lane] = upload(row_ring[0], dev, torch.int64)
            ring_idx_j[lane] = int(row_ring_idx[0])
        keys[lane] = key_next[0]
        tok[lane] = first
        row.push(first)
        rows[lane] = None if row.done else row
        self.stats["joins"] += 1
        self.stats["rows"] += 1
        return tok, kv, keys, ring_j, ring_idx_j


class _RowState:
    """Engine-side per-row bookkeeping: budget, EOS, incremental detok, events."""

    def __init__(self, req: _Request, eos: set[int], tokenizer: Tokenizer, engine: BatchEngine):
        self.req = req
        self._eos = eos
        self._tokenizer = tokenizer
        self._engine = engine
        self._ids: list[int] = []
        self._decoded_len = 0
        self.n = 0
        self.done = False
        self._finished = False

    def push(self, tid: int) -> None:
        """Accept one decoded id and emit it. The moment the row is done
        (EOS or budget) its stream closes, though its lockstep lane keeps
        computing until the lane is recycled."""
        if self.done:
            return
        self._ids.append(tid)
        self.n += 1
        if self.n == 1:
            self.req.handle.ttft_s = time.perf_counter() - self.req.t_submit
        is_eos = tid in self._eos
        if is_eos:
            self.req.handle.finish_reason = "stop"
            self.done = True
            text = ""
        else:
            text, self._decoded_len = decode_delta(self._tokenizer, self._ids, self._decoded_len)
        self.req.handle.completion_tokens = self.n
        self.req.handle._emit(Token(id=tid, text=text, is_end_of_stream=is_eos))
        if not is_eos and self.n >= self.req.max_tokens:
            self.req.handle.finish_reason = "length"
            self.done = True
        if self.done:
            self.finish()

    def finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        self.done = True
        self.req.handle._emit(_DONE)
        self._engine._row_finished(self.req.rid)
