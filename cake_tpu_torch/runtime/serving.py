"""Concurrent batched serving: a request queue feeding lockstep batch decode
(port of ``cake_tpu/runtime/serving.py``, the epoch and continuous
schedulers).

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

Two schedulers drive that loop (``ServeConfig.scheduler``):

  * ``"epoch"``: admission waits one admission window so a burst lands in
    one batch; joins take every free lane at once; a lane the page pool
    cannot extend finishes as ``"length"``.
  * ``"continuous"``: no admission-window sleep; each chunk boundary is a
    step whose join and restore prefill is bounded by a prompt-token grant
    (runtime/admission.py ``StepBudget``); page pressure PREEMPTS the
    lowest-priority lane instead of truncating it: its history, threefry
    key and penalty ring go to the host (``_SpilledLane``), its pages return
    to the pool, and a later restore re-prefills ``history[:-1]`` into a
    free lane at the shared slot (the join arithmetic) or seeds a new
    segment, and puts the sampling state back, so the resumed stream
    continues the tokens the uninterrupted run would give.

Each row carries its own threefry key (ops/threefry.py: ``prng_key`` of its
seed, split once a step, ops/sampling.sample_per_row), so a row's stream does
not depend on what shares its batch; greedy and seeded sampled streams equal
the JAX package's engine on the same checkpoint, under both schedulers
(tests/test_torch_serving.py, tests/test_torch_threefry.py,
tests/test_torch_continuous.py).

With ``backend=`` the engine serves through a backend built outside it:
runtime/batch_backend.py ``DistributedBatchBackend`` runs the lanes over a
TCP topology's workers (dense KV only), and a worker lost after the wire
retries (``BackendWorkerError``) finishes the epoch's live streams with
``finish_reason="error"`` while the engine keeps serving; ``snapshot()``
names the routed nodes.

Admission (runtime/admission.py, obs/slo.py): each request carries a
tenant and may carry a deadline. ``submit`` charges the tenant's quota
(``QuotaExceeded``, HTTP 429) and then the shed gates (queue depth, free
pages, a deadline the estimated queue wait already exceeds:
``EngineOverloaded``, HTTP 503); the queue is a ``FairQueue``,
deficit-weighted round-robin over the tenants' FIFOs. Past its deadline a
queued request expires without a lane or a page, and a running or spilled
stream finishes ``"deadline"`` at the next chunk boundary. An ``SloTracker``
records each tenant's TTFT, deadline and error SLIs and feeds its burn back
into the fair queue's weights, the shed estimate and the step budget. With
``epoch_stall_s`` every backend dispatch but ``init_kv`` (``_dispatch``)
runs under a ``StallGuard``: a dispatch that stalls is abandoned, the
epoch's live streams finish ``"error"``, and the backend drops the storage
the abandoned dispatch holds (``abandon``), so the next epoch shares no
buffer with it.

Observability (utils/metrics.py, obs/): the engine records what the
reference's records on the same events: the ``cake_*`` metrics and the
flight recorder's lifecycle events, the timeline's span trees (an
``epoch`` span, or under the continuous scheduler a ``segment`` span with
one ``step`` span a scheduler iteration, around ``prefill``, ``join``,
``restore``, ``prefix-fork``, ``decode-chunk`` and ``page-extend`` spans,
and one ``request`` span a lane occupancy), the efficiency ledger (every
dispatch's wall in one bucket, every emitted token in a goodput class), the
decision audit (every admit, defer, join, preempt, spill, restore, budget
and shed verdict with its cause), the request log, the SLI time-series, and
with ``blackbox_dir`` the black box. A dispatch's wall includes its device
work: each timed dispatch ends in a host readback or an event wait on the
engine's stream, never a whole-device synchronize.

Failover (runtime/router.py, runtime/faults.py): when a worker dies
mid-epoch (``BackendWorkerError``) and a healthy replica exists, or on a
local backend with ``failover_local``, the epoch's live streams MIGRATE
instead of finishing ``"error"``: ``_migrate_kv`` rebuilds their KV on the
new route and decode resumes at the same slot with the same sampling state.
Without the prefix cache the rebuild re-issues the epoch's own dispatches
(its prefill, its joins and restores, and each decode chunk as one-token
steps fed the tokens the streams already hold), the same kernels at the
same shapes, so the rebuilt KV holds the lost KV's bits and greedy streams
equal a fault-free run on the card too. That replay costs a step a
position decoded since the epoch began; where its price, measured as it
runs, would overrun ``failover_budget_s``, it stops and the migration takes
the reference's one windowed re-prefill, which costs one prefill but
rounds the generated tokens' K/V otherwise on the card. Under the prefix
cache (whose chains' bytes die with the pool) the rebuild is always that
re-prefill, through the cached-chunk arithmetic. At most
``max_failovers`` migrations an epoch within ``failover_budget_s`` of
migration wall time; past either, or with no healthy replica, the epoch
falls back to the error isolation. With ``heartbeat_interval_s`` the
engine starts a ``HeartbeatMonitor`` over the TCP backend's workers and
attaches it to the router. Every backend dispatch passes the fault plan's ``backend.<op>``
checkpoint first (``_backend_guard``).

Not ported yet (ROADMAP.md): speculative verify. Asking for a knob that is
not ported raises.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
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
from cake_tpu_torch.obs.efficiency import DecisionAudit, EfficiencyLedger
from cake_tpu_torch.obs.requestlog import RequestLog
from cake_tpu_torch.obs.slo import SloObjectives, SloTracker
from cake_tpu_torch.obs.timeline import timeline
from cake_tpu_torch.obs.timeseries import SliTimeseries
from cake_tpu_torch.runtime import faults
from cake_tpu_torch.runtime.admission import (
    DEFAULT_TENANT,
    FairQueue,
    QuotaExceeded,
    StallGuard,
    StepBudget,
    TenantMeter,
    WaitEstimator,
)
from cake_tpu_torch.utils import metrics

__all__ = ["BatchEngine", "EngineOverloaded", "QuotaExceeded", "ServeConfig", "StreamHandle"]

log = logging.getLogger("cake_tpu_torch.serving")

_DONE = "__done__"

# Epoch attention-capacity granularity (slots): the paged epoch capacity
# rounds up to it.
_CAPACITY_BUCKET = 256
# Join and suffix-prefill windows round up to this many slots.
_WINDOW_BUCKET = 64


class EngineOverloaded(RuntimeError):
    """Admission refused by load shedding (queue depth, pool pressure, or a
    deadline the estimated queue wait already exceeds): HTTP 503 with a
    ``Retry-After``. Shedding a request early beats queueing it into a
    timeout."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


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

    ``scheduler`` is ``"epoch"`` or ``"continuous"`` (the module docstring);
    ``step_prefill_tokens`` is the continuous scheduler's prompt tokens of
    join and restore prefill a step (0 = ``StepBudget.AUTO_TOKENS``), and
    ``default_priority`` the class (0 low, 1 normal, 2 high) of a request
    submitted without one: preemption spills the lowest class first.

    Admission (0 turns each gate off): ``shed_queue_depth`` and
    ``shed_min_free_pages`` (paged; cold prefix-cache pages count as free)
    shed with a 503 hint of ``retry_after_s``, scaled by the priority class
    (low sheds at half the depth or twice the page floor and waits twice as
    long, high tolerates twice the depth). ``tenant_rate`` (work tokens,
    prompt + max_tokens, a second), ``tenant_burst`` (0 = twice the rate)
    and ``tenant_streams`` (queued + live) are each tenant's quota (429).
    ``fair_queue`` drains the tenants' FIFOs by deficit-weighted
    round-robin (False = one global FIFO). ``default_deadline_s`` is the
    end-to-end deadline of a request that carries none. ``epoch_stall_s`` bounds each backend dispatch
    (``StallGuard``). ``stream_buffer_tokens`` cancels a stream whose
    consumer left that many tokens unread. The ``slo_*`` knobs declare the
    objectives and windows of the ``SloTracker``; ``slo_feedback`` feeds
    its burn back into admission.

    Observability: ``blackbox_dir`` (None = off) is where diagnostic
    bundles land (obs/blackbox.py), at most ``blackbox_keep`` of them and
    one every ``blackbox_min_interval_s``; ``blackbox_p99_mult`` (0 = off)
    captures a request slower than that multiple of the rolling p99.
    ``peak_tflops`` and ``peak_hbm_gbps`` (0 = the card's table entry, none
    on the CPU) are the roofline's denominators (obs/efficiency.py).

    Failover (the module docstring): ``heartbeat_interval_s`` (0 = off)
    and ``heartbeat_deadline_s`` probe a TCP backend's workers;
    ``max_failovers`` migrations an epoch (0 = error isolation only) within
    ``failover_budget_s`` of migration wall time; ``failover_local`` opts
    the local backends into migration in place; ``failover_cooldown_s`` is
    the router's standby rejoin probation.
    """

    max_batch: int = 8
    decode_chunk_size: int = 8
    admission_window: float = 0.01
    scheduler: str = "epoch"  # "epoch" | "continuous"
    step_prefill_tokens: int = 0
    cache_aware_order: bool = True
    kv_mode: str = "dense"  # "dense" | "paged"
    page_size: int = 128
    max_pages: int | None = None
    page_reserve: int = 1
    prefix_cache: bool = False
    prefix_cache_pages: int = 0
    prefix_min_tokens: int = 0
    fusion_impl: str = "none"
    default_priority: int = 1
    shed_queue_depth: int = 0
    shed_min_free_pages: int = 0
    retry_after_s: float = 1.0
    stream_buffer_tokens: int = 0
    tenant_rate: float = 0.0
    tenant_burst: float = 0.0
    tenant_streams: int = 0
    fair_queue: bool = True
    default_deadline_s: float = 0.0
    epoch_stall_s: float = 0.0
    slo_ttft_ms: float = 0.0
    slo_ttft_target: float = 0.99
    slo_deadline_rate: float = 0.0
    slo_fast_window_s: float = 60.0
    slo_slow_window_s: float = 600.0
    slo_feedback: bool = True
    blackbox_dir: str | None = None
    blackbox_keep: int = 16
    blackbox_min_interval_s: float = 5.0
    blackbox_p99_mult: float = 0.0
    peak_tflops: float = 0.0
    peak_hbm_gbps: float = 0.0
    heartbeat_interval_s: float = 0.0
    heartbeat_deadline_s: float = 2.0
    max_failovers: int = 2
    failover_budget_s: float = 30.0
    failover_local: bool = False
    failover_cooldown_s: float = 5.0

    def __post_init__(self):
        parse_fusion_spec(self.fusion_impl)
        if self.scheduler not in ("epoch", "continuous"):
            raise ValueError(f"scheduler must be epoch|continuous, got {self.scheduler}")
        if self.step_prefill_tokens < 0:
            raise ValueError(
                f"step_prefill_tokens must be >= 0 (0 = auto), got {self.step_prefill_tokens}"
            )
        if self.default_priority not in (0, 1, 2):
            raise ValueError(f"default_priority must be 0|1|2, got {self.default_priority}")
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
        if self.shed_queue_depth < 0 or self.shed_min_free_pages < 0:
            raise ValueError("shed thresholds must be >= 0 (0 = off)")
        if self.stream_buffer_tokens < 0:
            raise ValueError("stream_buffer_tokens must be >= 0")
        if self.tenant_rate < 0 or self.tenant_burst < 0 or self.tenant_streams < 0:
            raise ValueError("tenant_rate, tenant_burst and tenant_streams must be >= 0 (0 = gate off)")
        if self.default_deadline_s < 0 or self.epoch_stall_s < 0:
            raise ValueError("default_deadline_s and epoch_stall_s must be >= 0 (0 = off)")
        if self.slo_fast_window_s <= 0 or self.slo_slow_window_s < self.slo_fast_window_s:
            raise ValueError(f"slo windows need 0 < fast <= slow, got "
                             f"{self.slo_fast_window_s}/{self.slo_slow_window_s}")
        self.slo_objectives()  # raises on a bad objective
        if self.blackbox_keep < 1:
            raise ValueError(f"blackbox_keep must be >= 1, got {self.blackbox_keep}")
        if self.blackbox_min_interval_s < 0 or self.blackbox_p99_mult < 0:
            raise ValueError("blackbox_min_interval_s and blackbox_p99_mult must be >= 0")
        if self.peak_tflops < 0 or self.peak_hbm_gbps < 0:
            raise ValueError("peak_tflops and peak_hbm_gbps must be >= 0 (0 = the device table)")
        if self.max_failovers < 0 or self.failover_budget_s <= 0:
            raise ValueError(
                "max_failovers must be >= 0 and failover_budget_s positive, "
                f"got {self.max_failovers}/{self.failover_budget_s}"
            )
        if self.failover_cooldown_s < 0:
            raise ValueError("failover_cooldown_s must be >= 0")
        if self.heartbeat_interval_s < 0 or self.heartbeat_deadline_s <= 0:
            raise ValueError("heartbeat_interval_s must be >= 0 and heartbeat_deadline_s positive")

    def slo_objectives(self) -> SloObjectives:
        return SloObjectives(ttft_ms=self.slo_ttft_ms, ttft_target=self.slo_ttft_target,
                             deadline_rate=self.slo_deadline_rate)


def _knobs(s: SamplingConfig) -> tuple:
    """Batch compatibility: requests sharing these share one lockstep batch
    (the seed is per row)."""
    return (s.temperature, s.top_k, s.top_p, s.repeat_penalty, s.repeat_last_n)


# Priority classes scale the shed gates and the cost a request charges its
# tenant's deficit: low (0) sheds at half the depth or twice the page floor
# and is told to retry twice as late; high (2) tolerates twice the depth and
# costs half.
_PRIORITY_FACTOR = {0: 0.5, 1: 1.0, 2: 2.0}


def _request_cost(req: "_Request") -> float:
    """A request's DRR cost in the fair queue: its requested work (prompt +
    budget) over its priority factor."""
    return (len(req.prompt_ids) + req.max_tokens) / _PRIORITY_FACTOR[req.priority]


@dataclasses.dataclass
class _Request:
    prompt_ids: list[int]
    max_tokens: int
    sampling: SamplingConfig
    handle: "StreamHandle"
    rid: str = ""
    t_submit: float = 0.0
    t_last_token: float = 0.0
    # When the request left the queue (0 = not yet) and how long submit()'s
    # tokenize and admission gates took: the queue and admission slices of
    # the /explain decomposition (both ride the request span's args).
    t_admit: float = 0.0
    admit_s: float = 0.0
    priority: int = 1  # 0 low / 1 normal / 2 high: preemption spills the lowest first
    tenant: str = DEFAULT_TENANT  # the fair queue's subqueue and the quota's account
    # Absolute end-to-end deadline on the time.monotonic clock; 0.0 = none.
    deadline: float = 0.0

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
        # Fired once when the stream ends (a _DONE or an exception): the
        # one place every finish path goes through, where the tenant meter
        # frees the stream's quota slot.
        self._on_close = None

    def buffered(self) -> int:
        """Events produced and not yet consumed: the output buffer the
        backpressure watermark bounds."""
        with self._cv:
            return len(self._events)

    def _emit(self, item) -> None:
        cb = None
        with self._cv:
            self._events.append(item)
            self._cv.notify()
            if item is _DONE or isinstance(item, Exception):
                cb, self._on_close = self._on_close, None
        if cb is not None:
            cb()

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
        backend=None,
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
        self.scheduler = serve.scheduler
        self.default_priority = serve.default_priority
        self._step_budget = StepBudget(serve.step_prefill_tokens)
        from cake_tpu_torch.runtime import batch_backend

        if backend is not None:
            # An explicit backend (the TCP one) baked its config and KV
            # layout at construction.
            if serve.kv_mode == "paged" and backend.kv_mode != "paged":
                raise ValueError(
                    f"kv_mode='paged' needs a paged backend; the provided "
                    f"{type(backend).__name__} keeps the dense cache"
                )
            self.config = config = backend.config
        elif params is None:
            raise ValueError("BatchEngine needs either params (for a local backend) or backend=")
        elif serve.kv_mode == "paged":
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
        # Admission (runtime/admission.py): the quota meter (429s), the fair
        # queue (the global FIFO with fair_queue=False or one tenant), the
        # queue-wait estimate of deadline-aware shedding, and the stall
        # guard. The SLO tracker records every tenant's SLIs; its burn
        # feeds the queue's weights and the shed scale about once a second.
        self.shed_queue_depth = serve.shed_queue_depth
        self.shed_min_free_pages = serve.shed_min_free_pages
        self.retry_after_s = serve.retry_after_s
        self.stream_buffer_tokens = serve.stream_buffer_tokens
        self.default_deadline_s = serve.default_deadline_s
        self.tenant_meter = TenantMeter(rate=serve.tenant_rate, burst=serve.tenant_burst,
                                        max_streams=serve.tenant_streams)
        self._queue = FairQueue(fair=serve.fair_queue, cost=_request_cost)
        self._wait_est = WaitEstimator()
        self.slo = SloTracker(serve.slo_objectives(), fast_window_s=serve.slo_fast_window_s,
                              slow_window_s=serve.slo_slow_window_s)
        self.slo_feedback = serve.slo_feedback
        # tenant -> shed-estimate scale (> 1), rebound whole by
        # _apply_slo_feedback and read without a lock in submit; the tenants
        # holding a quantum weight > 1 (an evicted one is reset too).
        self._slo_shed_scale: dict[str, float] = {}
        self._slo_weighted: set[str] = set()
        self._slo_next_feedback = 0.0
        self.epoch_stall_s = serve.epoch_stall_s
        # No callback into the engine from the guard, the queue or a stream
        # handle: a reference cycle would keep a stopped engine (and its KV
        # storage) alive until the garbage collector runs.
        self._guard = StallGuard(self.epoch_stall_s) if self.epoch_stall_s > 0 else None
        self._cv = threading.Condition()
        self._stop = False
        self._running = False  # an epoch is in flight (under _cv)
        self._thread: threading.Thread | None = None
        # Under _cv: rids live in the current epoch, and rids whose cancel
        # waits for a chunk boundary.
        self._live_rids: set[str] = set()
        self._cancel_ids: set[str] = set()
        # Under _cv: rid -> _SpilledLane, the lanes the continuous scheduler
        # preempted. A spilled lane holds no pages and no device state.
        self._spilled: dict[str, _SpilledLane] = {}
        # Written by the engine thread (and submit's refusals); readers take
        # a copy. budget_deferrals counts join and restore candidates a
        # step's prefill grant put off; shed, quota_refusals,
        # deadline_expired (queued, running or spilled), epoch_stalls and
        # backpressured count admission's refusals and finishes.
        self.stats = {
            "batches": 0, "rows": 0, "max_rows": 0, "joins": 0, "cancelled": 0,
            "page_truncations": 0, "prefix_hits": 0, "prefix_misses": 0,
            "prefill_s": 0.0, "decode_s": 0.0, "decode_chunks": 0, "decode_steps": 0,
            "preemptions": 0, "restores": 0, "budget_deferrals": 0, "stream_errors": 0,
            "shed": 0, "quota_refusals": 0, "deadline_expired": 0, "epoch_stalls": 0,
            "backpressured": 0, "failovers": 0, "recovered": 0, "failover_reprefills": 0,
        }
        # Failover (the module docstring): the knobs, the epoch's budget
        # (count and migration seconds, reset per epoch), the TCP backend's
        # clients the heartbeat probes and its router, which takes the
        # cooldown and, at start(), the monitor. ``_replay`` is the
        # epoch's dispatch log a migration re-issues (None when the epoch
        # cannot migrate, or migrates by re-prefill under the prefix
        # cache); ``_pads_host`` the host copy of the lanes' pads;
        # ``_replay_s_per_pos`` the last replay's seconds a position, which
        # prices the next (``_replay_log``).
        self.max_failovers = serve.max_failovers
        self.failover_budget_s = serve.failover_budget_s
        self.failover_local = serve.failover_local
        self._fo_count = 0
        self._fo_spent_s = 0.0
        self._replay: list | None = None
        self._pads_host: np.ndarray | None = None
        self._replay_s_per_pos: float | None = None
        step = getattr(backend, "step", None)
        self._hb_clients = getattr(step, "clients", {})
        self.heartbeat_interval_s = serve.heartbeat_interval_s
        self.heartbeat_deadline_s = serve.heartbeat_deadline_s
        self.monitor = None  # HeartbeatMonitor, started with the engine
        self._router = getattr(step, "router", None)
        if self._router is not None:
            self._router.cooldown_s = serve.failover_cooldown_s
        # Latency attribution (obs/critpath.py phases): aggregate phase
        # seconds of finished requests and the per-epoch convoy meter, for
        # /stats and the cake_phase_seconds / cake_convoy_* metrics.
        self._phase_lock = threading.Lock()
        self.phase_totals: dict[str, dict] = {}
        self.convoy_stats = {"epochs": 0, "seconds_total": 0.0, "frac_last": 0.0,
                             "frac_sum": 0.0}
        # Per-epoch scratch (engine thread only; reset in _run_batch).
        self._epoch_rows: list[_RowState] = []
        self._epoch_t0 = 0.0
        self._epoch_head_rid = ""
        self._epoch_stalled = False
        self.blackbox = None
        if serve.blackbox_dir:
            from cake_tpu_torch.obs.blackbox import BlackBox

            self.blackbox = BlackBox(serve.blackbox_dir, keep=serve.blackbox_keep,
                                     min_interval_s=serve.blackbox_min_interval_s,
                                     p99_mult=serve.blackbox_p99_mult)
        # The goodput and hardware-efficiency ledger with the decision
        # audit, the request log (GET /requests, --request-log) and the SLI
        # time-series (GET /timeseries).
        self.audit = DecisionAudit()
        self.efficiency = EfficiencyLedger(config=self.config, peak_tflops=serve.peak_tflops,
                                           peak_hbm_gbps=serve.peak_hbm_gbps, audit=self.audit)
        self.requestlog = RequestLog()
        self.timeseries = SliTimeseries()

    def tenant_stats(self) -> dict:
        """Per-tenant view for ``/stats``: the quota accounting and the fair
        queue's depths."""
        out = self.tenant_meter.snapshot()
        with self._cv:
            queued = self._queue.queued_by_tenant()
        for tenant, n in queued.items():
            out.setdefault(tenant, {})["queued"] = n
        return out

    # ------------------------------------------- latency attribution plane

    def phase_stats(self) -> dict:
        """The ``/stats`` phases block: aggregate phase seconds over
        finished requests and the per-epoch convoy meter."""
        with self._phase_lock:
            totals = {p: dict(d) for p, d in self.phase_totals.items()}
            cv = dict(self.convoy_stats)
        return {
            "phases": {p: {"seconds": round(d["seconds"], 6), "requests": d["requests"]}
                       for p, d in sorted(totals.items())},
            "convoy": {
                "epochs": cv["epochs"],
                "seconds_total": round(cv["seconds_total"], 6),
                "frac_last": round(cv["frac_last"], 4),
                "frac_mean": round(cv["frac_sum"] / cv["epochs"], 4) if cv["epochs"] else 0.0,
            },
        }

    def _phase_observe(self, phase: str, seconds: float) -> None:
        if seconds <= 1e-9:
            return
        metrics.registry.histogram(
            "cake_phase_seconds",
            "Per-request latency attribution by canonical phase "
            "(obs/critpath.py taxonomy; convoy = lockstep epoch tax).",
        ).observe(seconds, phase=phase)
        with self._phase_lock:
            agg = self.phase_totals.setdefault(phase, {"seconds": 0.0, "requests": 0})
            agg["seconds"] += seconds
            agg["requests"] += 1

    def _observe_request(self, row: "_RowState") -> None:
        """Finish-time attribution for one stream: its measured phases into
        the aggregate histograms, then the black box's triggers (an SLO
        breach, a rolling-p99 outlier)."""
        req = row.req
        self._phase_observe("queue", max(0.0, (req.t_admit or row.t_open or req.t_submit)
                                         - req.t_submit))
        self._phase_observe("admission", req.admit_s)
        for phase, v in row.phase.items():
            self._phase_observe(phase, v)
        bb = self.blackbox
        if bb is None:
            return
        e2e = req.admit_s + max(0.0, (row.t_close or time.perf_counter()) - req.t_submit)
        outlier = bb.observe_latency(e2e)
        obj = self.slo.objectives
        reason = None
        if req.handle.finish_reason == "deadline" and obj.deadline_rate > 0:
            reason = "slo-deadline"
        elif obj.ttft_ms > 0 and row.ttft_s is not None and row.ttft_s * 1e3 > obj.ttft_ms:
            reason = "slo-ttft"
        elif outlier:
            reason = "latency-outlier"
        if reason is not None:
            self._capture(reason, req.rid)

    def _record_request(self, req: _Request, row: "_RowState | None" = None,
                        finish: str | None = None) -> None:
        """One completion record per terminated request (obs/requestlog.py):
        every finish path (a row's finish, a queued cancel or expiry, a
        stranded joiner, a failed batch) comes through here, so /requests,
        the --request-log sink and the /timeseries outcomes agree with the
        SLO tracker on what ended how."""
        handle = req.handle
        finish = finish or handle.finish_reason
        now = time.perf_counter()
        n = handle.completion_tokens
        t_open = row.t_open if row is not None else None
        queue_s = max(0.0, ((req.t_admit or t_open) or now) - req.t_submit)
        phases = {"queue": queue_s, "admission": req.admit_s}
        if row is not None:
            phases.update(row.phase)
        phases = {p: round(v, 6) for p, v in phases.items() if v > 1e-9}
        ttft = row.ttft_s if row is not None else None
        tpot = None
        if ttft is not None and n >= 2 and req.t_last_token:
            tpot = max(0.0, req.t_last_token - (req.t_submit + ttft)) / (n - 1)
        t_close = (row.t_close if row is not None else None) or now
        wall = req.admit_s + max(0.0, t_close - req.t_submit)
        deadline_s = None
        if req.deadline:
            # The request's relative deadline again: the absolute monotonic
            # deadline less the submit instant (both clocks tick at wall rate).
            deadline_s = round(req.deadline - (time.monotonic() - (now - req.t_submit)), 3)
        obj = self.slo.objectives
        if finish == "deadline":
            verdict = "deadline_miss"
        elif obj.ttft_ms > 0 and (ttft is None or ttft * 1e3 > obj.ttft_ms):
            verdict = "ttft_miss"
        elif obj.ttft_ms > 0 or req.deadline:
            verdict = "ok"
        else:
            verdict = "none"
        decisions = [f"{d['action']}:{d['cause']}" for d in self.audit.for_request(req.rid)][:16]
        try:
            self.requestlog.record(
                request_id=req.rid, tenant=req.tenant, priority=req.priority,
                prompt_tokens=handle.prompt_tokens, max_tokens=int(req.max_tokens),
                completion_tokens=n, queue_s=round(queue_s, 6), admit_s=round(req.admit_s, 6),
                ttft_s=None if ttft is None else round(ttft, 6),
                tpot_s=None if tpot is None else round(tpot, 6),
                wall_s=round(wall, 6), finish_reason=finish, slo=verdict, phases=phases,
                decisions=decisions, node=self.node_label(), deadline_s=deadline_s,
                t_wall=round(time.time() - (now - req.t_submit) - req.admit_s, 3),
            )
        except ValueError:
            # A finishing stream never dies to its own telemetry.
            log.exception("request-log record failed for %s", req.rid)
        self.timeseries.observe_finish(finish)

    def _record_refusal(self, rid: str, tenant: str, priority: int, kind: str,
                        prompt_tokens: int, max_tokens: int, deadline_s: float | None,
                        admit_s: float) -> None:
        """The record of a refusal (quota 429, shed 503): never admitted,
        but offered traffic all the same."""
        try:
            self.requestlog.record(
                request_id=rid, tenant=tenant, priority=priority, prompt_tokens=prompt_tokens,
                max_tokens=int(max_tokens), completion_tokens=0, queue_s=0.0,
                admit_s=round(admit_s, 6), ttft_s=None, tpot_s=None, wall_s=round(admit_s, 6),
                finish_reason=kind, slo="refused",
                phases={"admission": round(admit_s, 6)} if admit_s > 1e-9 else {},
                decisions=[], node=self.node_label(), deadline_s=deadline_s,
            )
        except ValueError:
            log.exception("request-log refusal record failed for %s", rid)
        self.timeseries.observe_finish(kind)

    def _capture(self, reason: str, rid: str | None) -> None:
        """One diagnostic bundle (rate-limited inside BlackBox). Never
        raises: diagnostics must not take the engine down."""
        bb = self.blackbox
        if bb is None:
            return
        try:
            from cake_tpu_torch.obs import critpath

            events = timeline.snapshot()
            exp = critpath.explain(events, rid) if rid else None
            extra: dict = {
                "engine": dict(self.stats),
                "phase_stats": self.phase_stats(),
                "slo": self.slo.snapshot(),
                "metrics": metrics.registry.snapshot(),
                "efficiency": self.efficiency.snapshot(),
                "decisions": self.audit.snapshot(limit=50),
            }
            if self._alloc is not None:
                extra["pool"] = {"pages_total": self._alloc.pages_total,
                                 "pages_free": self._alloc.pages_free}
            if self._prefix is not None:
                extra["prefix"] = self._prefix.stats()
            bb.capture(reason, rid, explain=exp,
                       timeline=timeline.snapshot(rid) if rid else events[-200:],
                       events=metrics.flight.snapshot()[-200:], extra=extra)
        except Exception:  # noqa: BLE001 - diagnostics never hurt serving
            log.exception("blackbox capture failed")

    def _finish_epoch_convoy(self) -> None:
        """The per-epoch convoy meter, at the epoch's end: the rows' convoy
        shares (padding, unconsumed chunk fractions) plus, under the epoch
        scheduler, the time a lane sat finished or empty while the epoch
        served others. ``cake_convoy_frac`` divides by the lane-seconds
        served: 0 = no lockstep tax."""
        rows = self._epoch_rows
        if not rows or self._epoch_t0 <= 0.0:
            return
        now = time.perf_counter()
        dur = max(1e-9, now - self._epoch_t0)
        lane_occ: dict[int, float] = {}
        convoy = 0.0
        for row in rows:
            if row.t_open:
                occ = max(0.0, (row.t_close or now) - row.t_open)
                lane_occ[row.lane] = lane_occ.get(row.lane, 0.0) + occ
            convoy += row.phase.get("convoy", 0.0)
        idle = 0.0
        if self.scheduler != "continuous":
            idle = sum(max(0.0, dur - min(occ, dur)) for occ in lane_occ.values())
        total = convoy + idle
        frac = min(1.0, total / (dur * max(1, len(lane_occ))))
        metrics.registry.histogram(
            "cake_convoy_seconds",
            "Per-epoch lockstep convoy tax: lane-seconds spent on "
            "co-batched streams' work + finished/idle lane time.",
        ).observe(total)
        metrics.registry.gauge(
            "cake_convoy_frac",
            "Last epoch's convoy fraction of served-lane-seconds "
            "(0 = no lockstep tax).",
        ).set(frac)
        with self._phase_lock:
            cv = self.convoy_stats
            cv["epochs"] += 1
            cv["seconds_total"] += total
            cv["frac_last"] = frac
            cv["frac_sum"] += frac

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        if self.heartbeat_interval_s > 0 and self._hb_clients:
            # Worker liveness: one PING prober a worker of the TCP backend.
            # Routing reads it: a member the monitor sees down leaves the
            # rotation at the next refresh, and its recovery (after the
            # cooldown) readmits it.
            from cake_tpu_torch.runtime.client import HeartbeatMonitor

            self.monitor = HeartbeatMonitor(
                {n: c.host for n, c in self._hb_clients.items()},
                interval_s=self.heartbeat_interval_s, deadline_s=self.heartbeat_deadline_s,
            ).start()
            if self._router is not None:
                self._router.attach_monitor(self.monitor)
        self._thread = threading.Thread(target=self._loop, name="batch-engine", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._guard is not None:
            # Before the join: the engine thread may wait on a stalled
            # dispatch, and the guard's stop wakes it at once.
            self._guard.stop()
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None
        if self.monitor is not None:
            self.monitor.stop()
            self.monitor = None
        with self._cv:
            # The engine thread closes them on its way out; an engine that
            # never started has none to do it.
            self._fail_spilled_locked("engine stopped")

    def node_label(self) -> str:
        """The node(s) serving now, for ``/stats`` and the request log: a TCP
        backend's routed workers ("w1+w2"; "tcp" while it routes none),
        else "local"."""
        router = getattr(getattr(self.backend, "step", None), "router", None)
        if router is None:
            return "local"
        return "+".join(sorted(set(router.snapshot()["routes"].values()))) or "tcp"

    def snapshot(self) -> dict:
        """Counters for ``GET /stats``: engine stats, live lanes, the pool,
        the prefix cache and the node label."""
        out = dict(self.stats)
        out["node"] = self.node_label()
        with self._cv:
            out["queued"] = len(self._queue)
            out["live"] = len(self._live_rids)
            out["spilled"] = len(self._spilled)
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
        priority: int | None = None,
        tenant: str | None = None,
        deadline_s: float | None = None,
    ) -> StreamHandle:
        """Queue one chat completion; returns its stream at once.
        ``priority`` (0 low, 1 normal, 2 high; ServeConfig's
        ``default_priority`` when None) scales the shed gates and orders
        preemption under the continuous scheduler. ``tenant`` keys the quota
        and the fair queue (``QuotaExceeded``: HTTP 429); ``deadline_s``
        (ServeConfig's ``default_deadline_s`` when None; 0 = none) is the
        end-to-end deadline: queued past it the request expires unadmitted,
        running past it the stream finishes ``"deadline"`` at the next chunk
        boundary, and a deadline the estimated queue wait already exceeds
        is shed at once (``EngineOverloaded``: HTTP 503). Raises ValueError
        for prompts that can never be served and for a bad deadline (the
        API maps it to a 400 before any streaming headers go out)."""
        t_enter = time.perf_counter()
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
        if priority is None:
            priority = self.default_priority
        priority = max(0, min(2, int(priority)))
        tenant = (str(tenant).strip() if tenant else "") or DEFAULT_TENANT
        if deadline_s is None and self.default_deadline_s > 0:
            deadline_s = self.default_deadline_s
        if deadline_s is not None and (not isinstance(deadline_s, (int, float))
                                       or isinstance(deadline_s, bool) or deadline_s <= 0):
            raise ValueError(f"deadline_s must be a positive number, got {deadline_s!r}")
        rid = request_id or metrics.new_request_id()
        # The quota first (a 429 the caller can fix by backing off beats a
        # 503); admit() registers the stream, so a later refusal closes it.
        try:
            self.tenant_meter.admit(tenant, rid, len(ids) + int(max_tokens))
        except QuotaExceeded:
            self.stats["quota_refusals"] += 1
            self.slo.observe_refusal(tenant, "quota")
            self._record_refusal(rid, tenant, priority, "quota", len(ids), max_tokens,
                                 deadline_s, time.perf_counter() - t_enter)
            raise
        try:
            self._maybe_shed(priority, deadline_s=deadline_s, tenant=tenant, n_prompt=len(ids))
        except EngineOverloaded:
            # A shed is the server's saturation: the quota charge goes back.
            self.tenant_meter.close(rid, refund=True)
            self._record_refusal(rid, tenant, priority, "shed", len(ids), max_tokens,
                                 deadline_s, time.perf_counter() - t_enter)
            raise
        handle = StreamHandle(n_prompt=len(ids), request_id=rid)
        meter = self.tenant_meter
        handle._on_close = lambda: meter.close(rid)
        req = _Request(ids, int(max_tokens), sampling, handle, rid=rid,
                       t_submit=time.perf_counter(), priority=priority, tenant=tenant,
                       deadline=time.monotonic() + deadline_s if deadline_s else 0.0,
                       admit_s=time.perf_counter() - t_enter)
        # Before the enqueue: once queued the scheduler may admit it at once,
        # and an 'admitted' event must never precede its 'submitted'.
        metrics.registry.counter(
            "cake_engine_submitted_total", "Requests accepted into the queue."
        ).inc()
        metrics.flight.record("submitted", rid, prompt_tokens=len(ids),
                              max_tokens=int(max_tokens))
        with self._cv:
            if self._stop:
                self.tenant_meter.close(rid, refund=True)
                raise RuntimeError("engine is stopped")
            self._queue.append(req)
            self._cv.notify_all()
        return handle

    def _maybe_shed(self, priority: int = 1, deadline_s: float | None = None,
                    tenant: str = DEFAULT_TENANT, n_prompt: int = 0) -> None:
        """Load shedding: refuse now (503 + Retry-After at the API) rather
        than queue into a timeout. Three gates: a deadline the estimated
        queue wait (the EWMA of observed waits, scaled by the depth and the
        tenant's SLO shed scale) already exceeds, the queue depth, and the
        paged pool's free pages (cold prefix-cache pages count as free:
        admission reclaims them before it maps). The last two are off at 0
        and scale with the priority class."""
        factor = _PRIORITY_FACTOR[priority]
        with self._cv:
            depth = len(self._queue)
        est = (self._wait_est.estimate(depth, self.max_batch,
                                       scale=self._slo_shed_scale.get(tenant, 1.0))
               if deadline_s else 0.0)
        reason = cause = None
        if deadline_s and est > deadline_s:
            cause = "deadline_doomed"
            reason = (f"estimated queue wait {est:.2f}s already exceeds the request deadline "
                      f"{deadline_s:.2f}s")
        elif self.shed_queue_depth and depth >= self.shed_queue_depth * factor:
            cause = "queue_depth"
            reason = f"queue depth {depth} >= {self.shed_queue_depth * factor:g} (priority {priority})"
        elif self.shed_min_free_pages and self._alloc is not None:
            free = self._alloc.pages_free + (
                self._prefix.reclaimable() if self._prefix is not None else 0)
            if free < self.shed_min_free_pages / factor:
                cause = "page_pressure"
                reason = (f"{free} free+reclaimable KV pages < floor "
                          f"{self.shed_min_free_pages / factor:g} (priority {priority})")
        if reason is None:
            return
        self.audit.record("shed", cause, tenant=tenant, detail=reason[:120])
        self.stats["shed"] += 1
        self.slo.observe_refusal(tenant, "shed")
        metrics.registry.counter(
            "cake_shed_total",
            "Submissions refused by admission load shedding "
            "(queue-depth / free-page gates; HTTP 503 + Retry-After).",
        ).inc()
        metrics.flight.record("shed", prompt_tokens=n_prompt, reason=reason, priority=priority)
        raise EngineOverloaded(f"engine overloaded: {reason}",
                               retry_after_s=self.retry_after_s / factor)

    def cancel(self, request_id: str) -> bool:
        """Cancel one request. Queued or spilled: finished at once as
        "cancelled" (a spilled lane holds no pages). Running: finished at
        the next chunk boundary, its lane and pages freed for joins. False
        for ids neither queued, spilled nor live."""
        with self._cv:
            for r in self._queue:
                if r.rid == request_id:
                    self._queue.remove(r)
                    self._finish_cancelled_locked(r)
                    return True
            sp = self._spilled.pop(request_id, None)
            if sp is None and request_id in self._live_rids:
                self._cancel_ids.add(request_id)
                return True
        if sp is None:
            return False
        # A spilled lane holds no pages and no device state: finished here.
        self._note_cancelled(sp.row, "spilled")
        sp.row.cancel()
        return True

    def _finish_cancelled_locked(self, req: _Request) -> None:
        """Close a request cancelled off the queue (never admitted)."""
        req.handle.finish_reason = "cancelled"
        self.stats["cancelled"] += 1
        metrics.registry.counter(
            "cake_cancelled_total", "Requests cancelled (queued or live)."
        ).inc()
        metrics.flight.record("cancelled", req.rid, where="queued")
        metrics.flight.record("finished", req.rid, finish_reason="cancelled",
                              completion_tokens=0)
        self._record_request(req)
        req.handle._emit(_DONE)

    def _note_cancelled(self, row: "_RowState", where: str) -> None:
        """The cancel bookkeeping of a running, spilled or preempted lane
        (the stats, the counter, the flight event); the caller closes the
        stream."""
        self.stats["cancelled"] += 1
        metrics.registry.counter(
            "cake_cancelled_total", "Requests cancelled (queued or live)."
        ).inc()
        metrics.flight.record("cancelled", row.req.rid, where=where, completion_tokens=row.n)

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Wait until the queue and the spill table are empty and no epoch
        is running: every lane's pages are back in the pool, and the next
        submissions open an epoch of their own (a stream closes before its
        epoch ends, and a request submitted then joins it)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._queue or self._spilled or self._running:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(left)
        return True

    def _fail_spilled_locked(self, error: str) -> None:
        """Close every spilled stream with a raised error (the caller holds
        the cv): a parked lane never outlives the engine."""
        for sp in self._spilled.values():
            sp.row.req.handle._emit(RuntimeError(error))
            sp.row.req.handle._emit(_DONE)
            sp.row.close_span(error=error)
        self._spilled.clear()

    def _expire_queued(self, req: _Request) -> None:
        """Close a queued request whose deadline passed before admission (the
        caller took it off the queue): it never held a lane or a page."""
        req.handle.finish_reason = "deadline"
        self.stats["deadline_expired"] += 1
        self.audit.record("expire", "deadline_expired", rid=req.rid, tenant=req.tenant,
                          detail="queued")
        metrics.registry.counter(
            "cake_deadline_expired_total",
            "Requests past their end-to-end deadline (where=queued expired "
            "before admission; where=running at a chunk boundary).",
        ).inc(where="queued")
        metrics.flight.record("deadline-expired", req.rid, where="queued")
        metrics.flight.record("finished", req.rid, finish_reason="deadline", completion_tokens=0)
        timeline.instant("deadline-expired", rid=req.rid, track="engine",
                         args={"where": "queued"})
        self.slo.observe_finish(req.tenant, "deadline", had_deadline=True, got_first_token=False)
        self._record_request(req)
        req.handle._emit(_DONE)

    def _apply_deadlines(self, rows: list) -> None:
        """Chunk-boundary deadline sweep: running streams past their
        deadline finish ``"deadline"`` now (their lanes are free this round;
        the caller's _release_finished returns their pages), spilled ones
        are never restored, and queued ones expire unadmitted."""
        now = time.monotonic()
        for lane, row in enumerate(rows):
            if row is not None and row.req.deadline and now > row.req.deadline:
                self.stats["deadline_expired"] += 1
                self.audit.record("expire", "deadline_expired", rid=row.req.rid,
                                  tenant=row.req.tenant, detail="running")
                row.expire()
                rows[lane] = None
        expired_spills = []
        with self._cv:
            for rid, sp in list(self._spilled.items()):
                if sp.row.req.deadline and now > sp.row.req.deadline:
                    del self._spilled[rid]
                    expired_spills.append(sp)
        for sp in expired_spills:
            # A spilled lane holds no pages; its delivered tokens stand.
            self.stats["deadline_expired"] += 1
            sp.row.expire()
        if self._queue.deadline_count:
            expired = []
            with self._cv:
                for r in self._queue:
                    if r.deadline and now > r.deadline:
                        self._queue.remove(r)
                        expired.append(r)
            for r in expired:
                self._expire_queued(r)

    def _shed_backpressure(self, row: "_RowState") -> None:
        """A consumer that stopped reading has ``stream_buffer_tokens``
        tokens parked in its stream: cancel the stream as a client that
        left would be, at this chunk boundary, instead of growing the
        buffer without bound."""
        self.stats["backpressured"] += 1
        metrics.registry.counter(
            "cake_stream_backpressure_total",
            "Streams cancelled at the output-buffer high watermark "
            "(consumer stopped reading).",
        ).inc()
        metrics.flight.record("stream-backpressure", row.req.rid,
                              buffered=row.req.handle.buffered(),
                              watermark=self.stream_buffer_tokens)
        log.warning("stream %s backpressured (%d tokens buffered >= %d); cancelling",
                    row.req.rid, row.req.handle.buffered(), self.stream_buffer_tokens)
        with self._cv:
            if row.req.rid in self._live_rids:
                self._cancel_ids.add(row.req.rid)

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
                self._note_cancelled(row, "epoch")
                row.cancel()
                rows[lane] = None

    # ------------------------------------------------------------ scheduler

    def _loop(self) -> None:
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)  # this thread owns the card
        while True:
            with self._cv:
                while not self._queue and not self._spilled and not self._stop:
                    self._cv.wait()
                if self._stop:
                    for r in self._queue:
                        r.handle._emit(RuntimeError("engine stopped"))
                    self._queue.clear()
                    self._fail_spilled_locked("engine stopped")
                    return
                # Pending spills run first (continuous): previously admitted
                # work, restored as the seed rows of a segment that queued
                # requests with the same knobs join per step.
                spill_seed = self.scheduler == "continuous" and bool(self._spilled)
            # Epoch: let a burst of concurrent submissions land in one batch.
            # The continuous scheduler admits per step instead.
            if self.admission_window > 0 and self.scheduler != "continuous":
                time.sleep(self.admission_window)
            self._apply_slo_feedback()
            batch = [] if spill_seed else self._admit()
            if not batch and not spill_seed:
                continue
            if batch:  # a spill-seeded segment counts itself once its seeds are known
                self._note_batch_started(len(batch))
            try:
                self._run_batch(batch)
            except Exception as e:  # noqa: BLE001 - surface to every consumer, keep serving
                log.exception("batch failed")
                for r in batch:
                    if r.handle._on_close is not None:
                        # Not yet ended: its tenant's error SLI counts it once.
                        self.slo.observe_finish(r.tenant, "error", had_deadline=bool(r.deadline),
                                                got_first_token=r.handle.completion_tokens > 0)
                        self._record_request(r, finish="error")
                    r.handle._emit(e)
                    r.handle._emit(_DONE)
            finally:
                with self._cv:
                    self._running = False
                    self._cv.notify_all()

    def _note_batch_started(self, n_rows: int) -> None:
        self.stats["batches"] += 1
        self.stats["rows"] += n_rows
        self.stats["max_rows"] = max(self.stats["max_rows"], n_rows)
        metrics.registry.counter("cake_engine_batches_total", "Decode epochs started.").inc()
        metrics.registry.histogram(
            "cake_batch_rows", "Requests admitted per epoch at epoch start.",
            buckets=(1, 2, 4, 8, 16, 32, 64),
        ).observe(n_rows)

    def _apply_slo_feedback(self, force: bool = False) -> None:
        """Feed each tenant's burn back into admission (obs/slo.py
        ``adjustments``): a burning tenant's fair-queue quantum is weighted
        up and its shed estimate scaled up. At most about once a second:
        the windows move on second granularity."""
        if not self.slo_feedback:
            return
        now = time.monotonic()
        if not force and now < self._slo_next_feedback:
            return
        self._slo_next_feedback = now + 1.0
        adj = self.slo.adjustments()
        if not adj and not self._slo_shed_scale and not self._slo_weighted:
            return
        self._slo_shed_scale = {t: a["shed_scale"] for t, a in adj.items()
                                if a["shed_scale"] > 1.0}
        with self._cv:
            for t, a in adj.items():
                self._queue.set_weight(t, a["quantum_weight"])
            # A weighted tenant the tracker evicted is reset here, or its
            # boosted share would outlive its burn.
            for t in self._slo_weighted - set(adj):
                self._queue.set_weight(t, 1.0)
        self._slo_weighted = {t for t, a in adj.items() if a["quantum_weight"] > 1.0}

    def _on_epoch_stall(self, op: str) -> None:
        """The guard abandoned a dispatch: the backend drops every buffer
        the abandoned dispatch may still write (its storage and the decode
        graphs captured over it), so the next epoch allocates anew. The
        epoch unwinds through the error isolation of _run_batch."""
        self.stats["epoch_stalls"] += 1
        log.warning("backend %s dispatch stalled past %.3gs: abandoned", op, self.epoch_stall_s)
        # The abandoned dispatch's wall is the bound: the device produced
        # nothing for it.
        self.efficiency.note_stall(self.epoch_stall_s)
        abandon = getattr(self.backend, "abandon", None)
        if abandon is not None:
            abandon()
        # The moment itself, while the timeline still holds the stalled
        # chunk (the guard recorded the epoch-stall instant).
        self._epoch_stalled = True
        self._capture("stall", self._epoch_head_rid or None)

    # The reference's checkpoint site of each dispatch op (a restore is a
    # join there; a copy-on-write split is no dispatch of its own).
    _FAULT_SITES = {"prefill": "prefill", "decode": "decode", "join": "join", "restore": "join"}

    def _backend_guard(self, op: str) -> None:
        """The fault plan's checkpoint in front of a backend dispatch
        (runtime/faults.py ``backend.*`` sites): ``stall`` sleeps, ``kill``
        and ``crash`` raise the ``BackendWorkerError`` a dead worker
        produces, so failover and the error isolation are testable on any
        backend."""
        site = self._FAULT_SITES.get(op)
        spec = faults.check(f"backend.{site}") if site is not None else None
        if spec is None:
            return
        if spec.kind == "stall":
            faults.sleep(spec)
        elif spec.kind in ("kill", "crash"):
            from cake_tpu_torch.runtime.batch_backend import BackendWorkerError

            raise BackendWorkerError("<fault-plan>", site)

    def _dispatch(self, op: str, fn, grace: bool = False):
        """Run one backend dispatch, under the stall guard when
        ``epoch_stall_s`` is on (inline, as it is, when it is off). Under the
        guard ``fn`` runs on the watchdog thread with the engine thread's
        device and current stream (both are per thread in torch) in
        inference mode, and a CUDA event recorded after it on that stream is
        waited for there: a device that took the launches and never
        finishes them is caught too, without synchronizing the whole
        device. A stalled dispatch is abandoned (``_on_epoch_stall``) and
        surfaces as the ``BackendWorkerError`` a lost worker gives.
        ``grace``: the call gets the first call's grace (a decode that
        captures a new graph).

        ``init_kv`` stays inline: it resets the allocator and publishes the
        backend's storage, host state an abandoned thread must never write
        after the next epoch has begun. Its device work (the allocation's
        zeroing) is queued on the engine's stream, so the event of the
        guarded dispatch that follows it waits for that work too."""
        guard = self._guard
        if guard is None:
            self._backend_guard(op)
            return fn()
        from cake_tpu_torch.runtime.batch_backend import BackendWorkerError

        index = self._cuda_index
        stream = torch.cuda.current_stream(index) if index is not None else None

        def job():
            self._backend_guard(op)
            with torch.inference_mode():
                if stream is None:
                    return fn()
                with torch.cuda.device(index), torch.cuda.stream(stream):
                    out = fn()
                    done = torch.cuda.Event()
                    done.record(stream)
                done.synchronize()
                return out

        stalls = guard.stalls
        try:
            return guard.call(job, op, grace=grace, rid=self._epoch_head_rid)
        except BackendWorkerError:
            if guard.stalls != stalls:
                self._on_epoch_stall(op)
            raise

    # ------------------------------------------------------ replica failover

    def _can_migrate(self) -> bool:
        """Whether an epoch may migrate at all: a TCP backend with a router
        (``failover``), or a local one with ``failover_local``."""
        return self.max_failovers > 0 and (
            hasattr(self.backend, "failover") or self.failover_local
        )

    def _log_join(self, row_tokens, pad: int, end: int, lane: int) -> None:
        """Log a join's (or a restore's) prefill for a migration's replay."""
        if self._replay is not None:
            backend = self.backend
            self._replay.append(
                ("call", lambda kv: backend.join(kv, row_tokens, pad, end, lane)[1])
            )

    def _failover_or_raise(self, e) -> None:
        """Gate one failover attempt; re-raises ``e`` when migration is not
        possible (no healthy replica, the budget burned, or too many
        attempts this epoch), so the caller degrades to error isolation."""
        if self._fo_count >= self.max_failovers:
            log.warning("failover limit reached (%d); degrading", self._fo_count)
            raise e
        if self._fo_spent_s >= self.failover_budget_s:
            log.warning("failover budget burned (%.2fs >= %.2fs); degrading",
                        self._fo_spent_s, self.failover_budget_s)
            raise e
        failover = getattr(self.backend, "failover", None)
        if failover is not None:
            # TCP: eject the dead member and re-route its replica group
            # (runtime/router.py records cake_failover_total and the event).
            if not failover(e.node):
                raise e  # no healthy replica left for that span
        elif not self.failover_local:
            raise e  # a backend without replicas and without the opt-in
        else:
            # In place on a local backend (a transient fault): the router's
            # records for the TCP path.
            metrics.registry.counter(
                "cake_failover_total",
                "Failovers away from a worker (labelled by the FAILED node).",
            ).inc(node=e.node)
            metrics.flight.record("failover", node=e.node, to=e.node)
        self._fo_count += 1
        self.stats["failovers"] += 1
        # A bundle at the migration decision (rate-limited): the flight
        # tail still holds the worker's death.
        self._capture("failover", self._epoch_head_rid or None)

    def _migrate_kv(self, rows: list, n_lanes: int, slot: int):
        """Rebuild every live stream's KV on the (re-routed) backend at the
        chunk boundary ``slot``, where ``row.history`` holds the prompt and
        every emitted token, the KV covers ``history[:-1]`` and
        ``history[-1]`` is the pending token at ``slot``. A fresh
        ``init_kv`` (new replay sessions on the new route; paged: the pool
        reset and each live lane's window [pad, slot) mapped again), then:

          * without the prefix cache, the epoch's dispatch log again
            (``_replay_log``), so the rebuilt rows are the lost rows' bits,
            unless replaying it would overrun what is left of
            ``failover_budget_s``: then the reference's one windowed
            re-prefill of each live row's ``history[:-1]``
            (``_reprefill_window``);
          * under the prefix cache (its chains' bytes die with the pool:
            the chains, their pins and the retained pool go first), that
            re-prefill through the cached-chunk arithmetic with every row's
            threshold at its pad.

        Sampling state (keys, rings) is the engine's and rides through."""
        t0 = time.perf_counter()
        live = [(lane, row) for lane, row in enumerate(rows) if row is not None]
        backend = self.backend
        with timeline.span("failover-migrate", track="router",
                           args={"slot": int(slot), "live": len(live)}):
            if self._prefix is not None:
                tokens, pads = self._reprefill_window(live, n_lanes, slot)
                self._prefix.clear(reason="failover-migrate")
                backend.drop_retained_kv()
                self._lane_leases.clear()
                kv = backend.init_kv(n_lanes)
                for lane, _ in live:
                    self._alloc.map_range(lane, int(pads[lane]), slot)
                self._pool_counter()
                _, kv = self._dispatch("prefill", lambda: backend.suffix_prefill(
                    tokens, kv, pads, pads.copy(), 0))
                how = "reprefill"
            else:
                kv = backend.init_kv(n_lanes)
                if self._alloc is not None:
                    for lane, _ in live:
                        self._alloc.map_range(lane, int(self._pads_host[lane]), slot)
                    self._pool_counter()
                kv, how = self._replay_log(kv, live, n_lanes, slot, t0)
            self._settle()
        if how == "reprefill" and self._prefix is None:
            metrics.registry.counter(
                "cake_failover_reprefills_total",
                "Migrations that re-prefilled instead of replaying the epoch, whose replay "
                "would have overrun the failover budget.",
            ).inc()
            self.stats["failover_reprefills"] += 1
        dt = time.perf_counter() - t0
        self._fo_spent_s += dt
        # The migration's rebuild is redone work a worker's death cost.
        self.efficiency.note_failover(dt)
        self.stats["recovered"] += len(live)
        metrics.registry.histogram(
            "cake_failover_seconds",
            "Wall seconds per live-stream migration (re-prefill through the failed-over route).",
        ).observe(dt)
        metrics.registry.counter(
            "cake_streams_recovered_total",
            "Live streams carried through a failover migration (vs cake_stream_errors_total "
            "when no replica could take over).",
        ).inc(len(live))
        metrics.flight.record("failover-migrated", live=len(live), slot=int(slot),
                              seconds=round(dt, 6), how=how)
        log.warning("failover migration (%s): %d live stream(s) rebuilt at slot %d in %.3fs",
                    how, len(live), slot, dt)
        return kv

    def _reprefill_window(self, live: list, n_lanes: int, slot: int):
        """The reference's migration window: each live row's ``history[:-1]``
        left-padded to end at ``slot``, a dead lane one bos at ``slot - 1``,
        ``slot`` rounded up to ``_WINDOW_BUCKET`` within the capacity.
        Returns (tokens [n_lanes, W], pads [n_lanes])."""
        cap = self.max_seq_len
        if hasattr(self.backend, "capacity_slots"):
            cap = min(cap, self.backend.capacity_slots())
        width = min(-(-slot // _WINDOW_BUCKET) * _WINDOW_BUCKET, cap)
        tokens = np.zeros((n_lanes, width), np.int32)
        pads = np.full((n_lanes,), slot - 1, np.int32)
        tokens[:, slot - 1] = self.config.bos_token_id
        for lane, row in live:
            hist = row.history[:-1]
            tokens[lane, slot - len(hist) : slot] = hist
            pads[lane] = slot - len(hist)
        return tokens, pads

    def _replay_log(self, kv, live: list, n_lanes: int, slot: int, t0: float):
        """Re-issue the epoch's dispatch log over the fresh ``kv``: its
        prefill, joins and restores with their own tokens, and each decode
        chunk as one-token steps fed the tokens the live rows hold
        (``_replay_tokens``). Each entry is a dispatch of its own, so the
        stall guard bounds an entry as it bounds a decode chunk, never the
        whole replay; the first passes the ``backend.prefill`` checkpoint,
        as the reference's one migration prefill does.

        A replay costs a step for every position decoded since the epoch
        began. Before the first entry and each decode chunk the positions
        left are priced at the seconds a position measured so far (this
        migration's, else the last one's); when the price would take the migration past
        ``failover_budget_s`` the replay stops there and the reference's
        windowed re-prefill (``_reprefill_window``) rewrites every live row
        over the KV as it is. So a migration takes at most about its budget
        plus one prefill. Returns (kv, "replay" or "reprefill")."""
        backend = self.backend
        fed = {lane: (int(self._pads_host[lane]), list(row.history)) for lane, row in live}
        log_ = list(self._replay)
        left = sum(e[2] for e in log_ if e[0] == "decode")
        budget = self.failover_budget_s - self._fo_spent_s
        rate, done_s, done_n = self._replay_s_per_pos, 0.0, 0
        for i, entry in enumerate(log_):
            op = "prefill" if i == 0 else "migrate"
            priced = rate is not None and (i == 0 or entry[0] == "decode")
            if priced and time.perf_counter() - t0 + rate * left > budget:
                tokens, pads = self._reprefill_window(live, n_lanes, slot)
                _, kv = self._dispatch(op, lambda kv=kv: backend.prefill(tokens, kv, pads))
                return kv, "reprefill"
            if entry[0] == "call":
                kv = self._dispatch(op, lambda fn=entry[1], kv=kv: fn(kv))
                continue
            _, at, n, pads = entry
            toks = _replay_tokens(fed, at, n, n_lanes)
            t = time.perf_counter()
            kv = self._dispatch(op, lambda kv=kv, toks=toks, at=at, pads=pads:
                                backend.replay_decode(kv, toks, at, pads))
            self._settle()
            done_s += time.perf_counter() - t
            done_n += n
            left -= n
            rate = self._replay_s_per_pos = done_s / done_n
        return kv, "replay"

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
        """The fair-order head plus every queued request with the same
        knobs, up to max_batch, in the fair queue's order (per-tenant FIFO;
        the global FIFO with one tenant). A request past its deadline is
        dropped here, before it can hold a lane or a page. Paged: each
        candidate charges its pages against the pool; one that does not fit
        stays queued while a smaller later one may land. With the prefix
        cache and ``cache_aware_order``, only requests extending the head's
        cached chain join its epoch."""
        now = time.monotonic()
        state = {"knobs": None, "avail": None, "ckey": None}

        def radix_key(r: _Request):
            n = len(r.prompt_ids)
            align = (prompt_bucket(n, self.max_seq_len) - n) % self._alloc.page_size
            return self._prefix.radix_key(r.prompt_ids, align)

        def charge(r: _Request) -> bool:
            need = self._pages_for(r)
            if need > state["avail"] and self._prefix is not None:
                state["avail"] += self._prefix.reclaim(need - state["avail"], rid=r.rid)
            if need > state["avail"]:
                return False
            state["avail"] -= need
            return True

        def defer(r: _Request, cause: str) -> str:
            # The verdict and its cause, so /explain says why it queued.
            self.audit.record("defer", cause, rid=r.rid, tenant=r.tenant)
            return "skip"

        def accept(r: _Request) -> str:
            if r.deadline and now > r.deadline:
                self._expire_queued(r)
                return "drop"
            if state["knobs"] is None:
                # The head defines the epoch's knobs and is always taken
                # (the pool is fresh; only cold cache pages may need a reclaim).
                state["knobs"] = r.knobs()
                if self._prefix is not None and self.cache_aware_order:
                    state["ckey"] = radix_key(r)
                if self._alloc is not None:
                    need = self._pages_for(r)
                    free = self._alloc.pages_free
                    if need > free and self._prefix is not None:
                        free += self._prefix.reclaim(need - free, rid=r.rid)
                    state["avail"] = free - need
                self.audit.record("admit", "fair_order", rid=r.rid, tenant=r.tenant)
                return "take"
            if r.knobs() != state["knobs"]:
                return defer(r, "knob_incompatible")
            if state["ckey"] is not None and radix_key(r) != state["ckey"]:
                return defer(r, "cache_group")
            if state["avail"] is not None and not charge(r):
                return defer(r, "page_pressure")
            self.audit.record("admit", "fair_order", rid=r.rid, tenant=r.tenant)
            return "take"

        with self._cv:
            group = self._queue.take(self.max_batch, accept)
            # Live while still under the lock that dequeued them, so cancel()
            # always finds a request somewhere.
            self._live_rids.update(r.rid for r in group)
            self._running = bool(group)
        t_admit = time.perf_counter()
        for r in group:
            r.t_admit = t_admit  # the queue phase's end, for /explain
        self._record_admissions(group, "admitted")
        return group

    def _record_admissions(self, reqs: list[_Request], event: str, **fields) -> None:
        """Requests leaving the queue (epoch admissions and joins): the
        queue-wait histogram and lifecycle event; their waits feed the
        deadline-aware shed estimate."""
        now = time.perf_counter()
        wait_h = metrics.registry.histogram(
            "cake_queue_wait_seconds", "Seconds a request waited in the queue before admission.")
        counter = metrics.registry.counter(
            "cake_engine_admitted_total",
            "Requests admitted into a decode epoch (initial or join).")
        for r in reqs:
            wait = now - r.t_submit
            wait_h.observe(wait)
            self._wait_est.observe(wait)
            counter.inc()
            metrics.flight.record(event, r.rid, queue_wait_s=round(wait, 6), **fields)

    # ------------------------------------------------- prefix-cache wiring

    def _fork_lane(self, lane: int, req: _Request, pad: int, end: int,
                   ids: list[int] | None = None):
        """Fork the longest cached chain under one lane, split the boundary
        page copy-on-write when the fresh region starts mid-page, and map the
        uncached tail [fresh, end). ``ids`` are the tokens matched (a
        restore's history, which starts with the prompt; default the
        prompt). Returns (fresh, cow_pair): the first slot the lane computes
        and may write, and the (src, dst) pages the caller copies before any
        write (None without a split). Raises PageExhausted when even
        reclaiming the cache cannot supply the tail's pages."""
        fresh, pair = pad, None
        plan = self._prefix.fork(lane, req.prompt_ids if ids is None else ids, pad, rid=req.rid)
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
                    if self._prefix.reclaim(1, rid=req.rid):
                        pair = self._alloc.make_private(lane, plan.cow_logical)
                    else:
                        # Give the shared page back and recompute its tokens
                        # into a fresh page: never write a shared page.
                        self._alloc.unmap_page(lane, plan.cow_logical)
                        fresh = max(pad, plan.cow_logical * self._alloc.page_size)
        try:
            self._alloc.map_range(lane, fresh, end)
        except PageExhausted:
            self._prefix.reclaim(self._alloc.pages_needed(end - fresh) + 1, rid=req.rid)
            self._alloc.map_range(lane, fresh, end)
        self._lane_info[lane] = (req, pad)
        return fresh, pair

    def _prefix_layout(self, reqs: list, rows: list, pads, bucket: int, kv, ids_list: list):
        """Epoch-start layout under the prefix cache: fork every real lane's
        cached chain matching its ``ids_list`` row (prompts, or a
        spill-seeded segment's histories) and map its uncached tail.
        Returns (kv, write_starts): cold lanes' thresholds sit at their
        pads, dummy lanes' at the window tail. A lane that cannot get its
        pages finishes as "length"."""
        ws = np.asarray(pads, np.int32).copy()
        cow_src: list[int] = []
        cow_dst: list[int] = []
        # The fork pass is a span of its own, so /explain reports the fork
        # apart from the prefill around it.
        fork_span = timeline.begin("prefix-fork", track="engine", args={"lanes": len(reqs)})
        try:
            for lane, r in enumerate(reqs):
                if r is None:
                    ws[lane] = bucket - 1
                    continue
                try:
                    fresh, pair = self._fork_lane(lane, r, int(pads[lane]), bucket,
                                                  ids_list[lane])
                except PageExhausted:
                    self.stats["page_truncations"] += 1
                    metrics.flight.record("page-truncated", r.rid, slot=int(pads[lane]),
                                          where="admission", completion_tokens=0)
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
        finally:
            timeline.end(fork_span)
        if cow_src:  # one device copy for every lane's boundary split
            kv = self._dispatch("cow_copy", lambda: self.backend.cow_copy(kv, cow_src, cow_dst))
        return kv, ws

    # -------------------------------------------------- execution (epochs)

    @torch.inference_mode()
    def _run_batch(self, batch: list[_Request]) -> None:
        """One epoch (a segment, under the continuous scheduler; ``batch``
        is empty for a spill-seeded one). Any exception reaches every row
        admitted so far, joiners included, and every spilled stream, as a
        raised error; the pool is returned either way, and a failed epoch
        clears the prefix cache (its chains must never outlive their
        bytes)."""
        from cake_tpu_torch.runtime.batch_backend import BackendWorkerError

        rows: list[_RowState | None] = []
        self._epoch_kv_retained = False
        # A fresh failover budget an epoch (count and migration seconds),
        # and the epoch's dispatch log where a migration re-issues it.
        self._fo_count = 0
        self._fo_spent_s = 0.0
        self._replay = [] if self._can_migrate() and self._prefix is None else None
        # Fresh attribution scratch: the convoy meter and the black box's
        # stall and error captures are per epoch.
        self._epoch_rows = []
        self._epoch_t0 = time.perf_counter()
        with self._cv:
            head = batch[0].rid if batch else next(iter(self._spilled), "")
        self._epoch_head_rid = head
        self._epoch_stalled = False
        if hasattr(self.backend, "trace_id"):
            # The epoch's head request id rides every FORWARD header.
            self.backend.trace_id = head or None
        try:
            # The epoch span roots this epoch's timeline tree (a segment's,
            # under the continuous scheduler, with a step span a scheduler
            # iteration); the head request's id keys it.
            with timeline.span(
                "epoch" if self.scheduler != "continuous" else "segment",
                rid=head, track="engine",
                args={"rows": len(batch), "kv_mode": self.kv_mode, "scheduler": self.scheduler,
                      "attention_impl": "cuda" if self.backend.device.type == "cuda" else "plain",
                      "fusion_impl": self.config.fusion_impl},
            ):
                self._run_epoch(batch, rows)
        except BackendWorkerError as e:
            # Failure isolation (a lost worker, or a dispatch the stall
            # guard abandoned): the epoch's LIVE streams finish "error" (the
            # tokens they delivered are the fault-free run's); the engine
            # keeps serving.
            log.warning("epoch lost its worker: %s", e)
            if not self._epoch_stalled and not self._stop:
                # A stall captured its own bundle already; a stop() is the
                # operator's, not an anomaly.
                self._capture("epoch-error", self._epoch_head_rid or None)
            for lane, row in enumerate(rows):
                if row is not None:
                    row.fail(str(e))
                    rows[lane] = None
        except Exception as e:
            for row in rows:
                if row is not None:
                    row.req.handle._emit(e)
                    row.req.handle._emit(_DONE)
                    row.close_span(error=str(e))
                    self._row_finished(row.req.rid)
            # A spilled stream must not retry a deterministically failing
            # segment forever: it gets the error every other consumer sees.
            with self._cv:
                self._fail_spilled_locked(str(e))
            raise
        finally:
            if self._alloc is not None:
                for lane in range(len(rows)):
                    if self._alloc.lane_mapped(lane):
                        self._lane_recycle(lane, insert=self._epoch_kv_retained)
            if self._prefix is not None and not self._epoch_kv_retained:
                self._prefix.clear(reason="epoch-failed")
                self.backend.drop_retained_kv()
            self._lane_leases.clear()
            self._lane_info.clear()
            self._replay = None  # its closures hold the epoch's tokens
            self._pads_host = None
            if hasattr(self.backend, "set_epoch_capacity"):
                self.backend.set_epoch_capacity(None)
            # The lockstep tax, measured (a failed epoch's tax is real too).
            # The rows refer back to the engine: dropped here, so a stopped
            # engine goes with its last reference.
            self._finish_epoch_convoy()
            self._epoch_rows = []
            # The spill table is left as it is: a lane spilled in this epoch
            # is no longer live, and the next segment restores it.
            with self._cv:
                self._live_rids.difference_update(r.rid for r in batch)
                self._cancel_ids.difference_update(r.rid for r in batch)
                for row in rows:
                    if row is not None:
                        self._live_rids.discard(row.req.rid)
                        self._cancel_ids.discard(row.req.rid)

    def _run_epoch(self, batch: list[_Request], rows: list) -> None:
        from cake_tpu_torch.runtime.batch_backend import BackendWorkerError

        seed_spills: list[_SpilledLane] = []
        if not batch:
            # Spill-seeded segment (continuous): the oldest spill's knob
            # group restores as the seed rows. Their KV is rebuilt by the
            # prefill below over each row's history[:-1]; their pending
            # token, key and ring come back from the host copies.
            seed_spills = self._pop_spill_seed()
            if not seed_spills:
                return
            self._note_batch_started(len(seed_spills))
            head = seed_spills[0].row.req
            s, knobs = head.sampling, head.knobs()
        else:
            s, knobs = batch[0].sampling, batch[0].knobs()
        eos = set(self.config.eos_token_ids)
        dev = self.backend.device
        # Lanes: the next power of two of the group, doubled once for join
        # headroom, capped at max_batch.
        n_seed = len(batch) or len(seed_spills)
        n_lanes = 1
        while n_lanes < n_seed:
            n_lanes *= 2
        n_lanes = min(max(n_lanes * 2, 2), self.max_batch)
        window = s.repeat_last_n
        # Spare lanes carry a one-token dummy prompt and are free for joins.
        spare = n_lanes - n_seed
        if seed_spills:
            reqs: list[_Request | None] = [sp.row.req for sp in seed_spills] + [None] * spare
            ids_list = [sp.row.history[:-1] for sp in seed_spills] + [
                [self.config.bos_token_id]] * spare
            for lane, sp in enumerate(seed_spills):
                sp.row.lane = lane
                sp.row.t_close = 0.0
            rows.extend([sp.row for sp in seed_spills] + [None] * spare)
        else:
            reqs = list(batch) + [None] * spare
            ids_list = [r.prompt_ids if r is not None else [self.config.bos_token_id]
                        for r in reqs]
            rows.extend(
                _RowState(r, eos, self.tokenizer, self, lane=lane) if r is not None else None
                for lane, r in enumerate(reqs)
            )
        # One timeline track a lane: the request span opens at admission and
        # closes at the finish (or the spill).
        for row in rows:
            if row is not None:
                row.open_span(slot=None)
        tokens, pads, bucket = layout_prompts(ids_list, self.max_seq_len)
        # ONE bounded capacity for the whole epoch (paged): enough slots for
        # every admitted row's (remaining) budget, bucketed, capped at
        # max_seq_len.
        cap = self.max_seq_len
        if self._alloc is not None:
            budgets = ([max(1, sp.row.req.max_tokens - sp.row.n) for sp in seed_spills]
                       if seed_spills else [r.max_tokens for r in batch])
            reach = bucket + max(min(t, self.max_seq_len - bucket) for t in budgets)
            self.backend.set_epoch_capacity(
                min(self.max_seq_len, -(-reach // _CAPACITY_BUCKET) * _CAPACITY_BUCKET)
            )
            cap = min(self.max_seq_len, self.backend.capacity_slots())

        t0 = time.perf_counter()
        with timeline.span("prefill", rid=self._epoch_head_rid, track="engine",
                           args={"bucket": int(bucket), "lanes": n_lanes,
                                 "restored": len(seed_spills)}):
            while True:
                # The epoch-start prefill has no generated state to migrate:
                # a worker's death here retries it through the failed-over
                # route (init_kv opens new sessions and resets the pool).
                try:
                    kv = self.backend.init_kv(n_lanes)  # paged: resets or releases the allocator
                    write_starts = None
                    if self._prefix is not None:
                        kv, write_starts = self._prefix_layout(reqs, rows, pads, bucket, kv,
                                                               ids_list)
                    elif self._alloc is not None:
                        # Each real lane's pages over its live window [pad,
                        # bucket); dummy lanes hold none (their writes sink).
                        for lane, r in enumerate(reqs):
                            if r is not None:
                                self._alloc.map_range(lane, int(pads[lane]), bucket)
                    if write_starts is not None:
                        # Prefix-cache path, cold epochs included: prefill
                        # only the window [start, bucket) covering every
                        # lane's uncached tail.
                        fresh_width = bucket - int(write_starts.min())
                        start = bucket - min(-(-fresh_width // _WINDOW_BUCKET) * _WINDOW_BUCKET,
                                             bucket)
                        logits, kv = self._dispatch("prefill", lambda: self.backend.suffix_prefill(
                            tokens[:, start:], kv, pads, write_starts, start))
                    else:
                        logits, kv = self._dispatch(
                            "prefill", lambda: self.backend.prefill(tokens, kv, pads))
                    break
                except BackendWorkerError as e:
                    self._failover_or_raise(e)
                    if self._prefix is not None:
                        # The retry rebuilds the pool from zero: cached
                        # chains would outlive their bytes.
                        self._prefix.clear(reason="prefill-retry")
                        self.backend.drop_retained_kv()
                        self._lane_leases.clear()
                        self._lane_info.clear()
            self._pads_host = np.array(pads, np.int32)
            if self._replay is not None:
                backend = self.backend
                self._replay.append(
                    ("call", lambda kv, t=tokens, p=pads: backend.prefill(t, kv, p)[1]))
            ring, ring_idx = seed_rings(ids_list, window)
            if seed_spills:
                # Nothing is sampled: the pending token history[-1] was
                # already delivered, and the key and ring are the spill's
                # copies. The event wait puts the device work in the wall.
                self._settle()
                for lane, sp in enumerate(seed_spills):
                    if sp.ring is not None and window > 0:
                        ring[lane] = sp.ring
                        ring_idx[lane] = sp.ring_idx
                host_keys = prng_key([0] * n_lanes).numpy()
                for lane, sp in enumerate(seed_spills):
                    host_keys[lane] = sp.key
                keys = upload(host_keys, dev, torch.int64)
                first = np.asarray([sp.row.history[-1] for sp in seed_spills] + [0] * spare,
                                   np.int32)
            else:
                # The first samples' readback ends the wall with the device's.
                keys = prng_key([r.sampling.seed if r is not None else 0 for r in reqs], dev)
                first, keys, ring, ring_idx = first_sample(logits, s, ring, ring_idx, keys)
        dt_prefill = time.perf_counter() - t0
        self.stats["prefill_s"] += dt_prefill
        # Attribution: the shared left-padded prefill computes the bucket for
        # every lane; a lane's own share scales with its prompt (or restored
        # history), the rest is convoy. The ledger books a spill-seeded
        # segment's prefill as redone work.
        own_tok = 0
        for row in rows:
            if row is not None:
                if seed_spills:
                    own_tok += len(row.history) - 1
                    row.account_restore(dt_prefill, bucket)
                else:
                    own_tok += len(row.req.prompt_ids)
                    row.account_prefill(dt_prefill, bucket)
        self.efficiency.note_prefill(dt_prefill, n_lanes, bucket, own_tok,
                                     restore=bool(seed_spills))
        if seed_spills:
            for sp in seed_spills:
                sp.row.n_at_restore = sp.row.n
                self._note_restore(sp.row)
        if not seed_spills:
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
                        row.close_span(error="engine stopped")
                        self._row_finished(row.req.rid)
                        rows[lane] = None
                return
            # Cancels, then deadlines: flagged or late rows finish now, and
            # their lanes and pages are free for this round's joins.
            self._apply_cancels(rows)
            self._apply_deadlines(rows)
            self._release_finished(rows)
            # Continuous: grant this step's prefill budget, restore spilled
            # lanes first (admitted work outranks new admissions), then
            # join. Epoch: joins unbudgeted. A segment under sustained joins
            # may never end, so the SLO feedback applies here too.
            budget = None
            step_span = None
            join_args: list = []
            if self.scheduler == "continuous":
                self._apply_slo_feedback()
                budget = {"left": self._grant_step_budget(rows)}
                step_span = timeline.begin(
                    "step", track="engine",
                    args={"slot": int(slot), "live": sum(r is not None for r in rows),
                          "budget": budget["left"]},
                )
            try:
                if budget is not None:
                    kv = self._take_restores(knobs, rows, slot, cap, budget, tok, kv, keys,
                                             ring_j, ring_idx_j, pads_j)
                join_args = self._take_joins(knobs, rows, slot, cap, budget)
                joined: set[int] = set()
                try:
                    for lane, req in join_args:
                        while True:
                            try:
                                tok, kv, keys, ring_j, ring_idx_j = self._join(
                                    req, lane, rows, slot, tok, kv, keys, ring_j, ring_idx_j, s
                                )
                                break
                            except BackendWorkerError as e:
                                # A join's prefill lost its worker: migrate
                                # the live rows to the new route, then retry
                                # the join there (its first token samples
                                # only after the join's prefill returns).
                                self._failover_or_raise(e)
                                kv = self._migrate_kv(rows, n_lanes, slot)
                        pads_j[lane] = slot - len(req.prompt_ids)
                        self._pads_host[lane] = slot - len(req.prompt_ids)
                        joined.add(id(req))
                except Exception as e:
                    for _, req in join_args:
                        if id(req) not in joined:
                            if isinstance(e, BackendWorkerError):
                                _fail_request(req, self, str(e))  # the admitted rows' isolation
                            else:
                                req.handle._emit(e)
                                req.handle._emit(_DONE)
                            self._row_finished(req.rid)
                    raise
            finally:
                if step_span is not None:
                    timeline.end(step_span, args={"joins": len(join_args)})
            live = sum(r is not None for r in rows)
            metrics.registry.gauge(
                "cake_batch_occupancy", "Live lockstep lanes at the current chunk boundary."
            ).set(live)
            if not live:
                break
            n = min(self.decode_chunk_size, cap - 1 - slot)
            if self._alloc is not None and not self._extend_pages(
                rows, slot, n, spill_ctx=(keys, ring_j, ring_idx_j)
            ):
                break  # every remaining row was truncated or spilled
            t_chunk = time.perf_counter()

            def chunk():
                out = self.backend.decode(kv, tok, slot, pads_j, keys, ring_j, ring_idx_j, n, s)
                return out, out[0].cpu().numpy()  # the chunk's one readback

            builds = getattr(self.backend, "decode_builds_chunk", None)
            # The readback inside the span waits for the device: the slice is
            # the chunk's compute, not its launch.
            try:
                with timeline.span("decode-chunk", track="engine",
                                   args={"slot": int(slot), "n": int(n), "live": live}):
                    (toks, kv, keys, ring_j, ring_idx_j), toks_np = self._dispatch(
                        "decode", chunk, grace=self._guard is not None and builds is not None
                        and builds(kv, tok, ring_j, n, s))
            except BackendWorkerError as e:
                # Migration: a worker died and a healthy route exists (or a
                # local backend opted in): rebuild every live stream's KV
                # there and REDO this chunk. tok and keys still hold the
                # state before the chunk; a chunk's steps may have pushed
                # into the rings in place (the TCP backend's), so each live
                # row's ring is rebuilt from its history, and the redone
                # chunk samples the tokens the lost one would have.
                self._failover_or_raise(e)
                kv = self._migrate_kv(rows, n_lanes, slot)
                _rings_from_history(rows, ring_j, ring_idx_j, window)
                continue
            if self._replay is not None:
                self._replay.append(("decode", slot, n, self._pads_host.copy()))
            dt_chunk = time.perf_counter() - t_chunk
            self._step_budget.observe_chunk(dt_chunk)
            self.stats["decode_s"] += dt_chunk
            self.stats["decode_chunks"] += 1
            self.stats["decode_steps"] += n
            live_rows = [(lane, row) for lane, row in enumerate(rows) if row is not None]
            consumed = {lane: row.peek_consumed(toks_np[lane]) for lane, row in live_rows}
            # The ledger: the chunk computed lanes x n positions; consumed
            # ones are decode goodput, live unconsumed tails convoy, dead
            # lanes pad. Before the pushes: a row that finishes mid-chunk
            # flushes its attribution from inside push().
            self.efficiency.note_decode(dt_chunk, len(rows), n, len(live_rows),
                                        sum(consumed.values()), slot=slot)
            for lane, row in live_rows:
                row.account_decode(dt_chunk, n, consumed[lane])
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
        released = False
        for lane, row in enumerate(rows):
            if row is None and self._alloc.lane_mapped(lane):
                self._lane_recycle(lane)
                released = True
        if released:
            self._pool_counter()

    def _pool_counter(self) -> None:
        """The pool's occupancy on the timeline's counter track, on the span
        clock, so page churn lines up with the spans that caused it."""
        timeline.counter(
            "kv_pages",
            {"in_use": float(self._alloc.pages_total - self._alloc.pages_free),
             "free": float(self._alloc.pages_free)},
            track="mem",
        )

    def _settle(self) -> None:
        """Wait for the engine stream's queued work (an event on the
        stream, never the whole device): the wall of a dispatch that ends in
        no readback then includes its device time. A no-op on the CPU."""
        if self._cuda_index is not None:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self._cuda_index))
            done.synchronize()

    def _lane_recycle(self, lane: int, insert: bool = True) -> None:
        """One lane's pages back to the pool, in prefix-cache order: adopt
        the lane's prompt chain into the cache, unpin the chain it forked,
        then drop its mappings. A failed epoch passes ``insert=False``."""
        if self._prefix is not None:
            info = self._lane_info.pop(lane, None)
            if insert and info is not None:
                req, pad = info
                self._prefix.insert(lane, req.prompt_ids, pad, rid=req.rid)
            self._prefix.release(self._lane_leases.pop(lane, None))
        self._alloc.release(lane)

    def _extend_pages(self, rows: list, slot: int, n: int, spill_ctx: tuple | None = None) -> bool:
        """Map every live lane's pages over the next chunk [slot, slot + n)
        (only page-boundary crossings allocate). Pool pressure first
        reclaims cold prefix-cache pages, retrying while a pass frees
        something; then, under the continuous scheduler (``spill_ctx`` =
        the chunk's keys, ring and ring index), preempts (``_preempt_for``);
        only then, or under the epoch scheduler, finishes the stream as
        "length". Returns False when no live row is left."""
        any_live = grew = False
        free0 = self._alloc.pages_free
        with timeline.span("page-extend", track="engine", args={"slot": int(slot), "n": int(n)}):
            for lane, row in enumerate(rows):
                if row is None:
                    continue
                try:
                    try:
                        self._alloc.map_range(lane, slot, slot + n)
                    except PageExhausted:
                        self._reclaim_and_map(lane, slot, n, row.req.rid)
                    any_live = True
                except PageExhausted:
                    if self.scheduler == "continuous" and spill_ctx is not None:
                        if self._preempt_for(rows, lane, slot, n, spill_ctx):
                            any_live = True
                        grew = True
                        continue
                    self.stats["page_truncations"] += 1
                    row.req.handle.finish_reason = "length"
                    metrics.flight.record("page-truncated", row.req.rid, slot=slot,
                                          completion_tokens=row.n)
                    timeline.instant("page-truncated", rid=row.req.rid, track=f"lane{lane}",
                                     args={"slot": int(slot)})
                    row.finish()
                    rows[lane] = None
                    self._lane_recycle(lane)
                    grew = True
            grew = grew or self._alloc.pages_free != free0
        if grew:
            self._pool_counter()
        return any_live

    def _reclaim_and_map(self, lane: int, slot: int, n: int, rid: str = "") -> None:
        """Map [slot, slot + n) for ``lane``, evicting prefix-cache pages
        between attempts while eviction makes progress. Raises PageExhausted
        when there is no cache or a whole reclaim pass freed nothing."""
        if self._prefix is None:
            raise PageExhausted(f"lane {lane} needs pages for [{slot}, {slot + n})")
        while True:
            freed = self._prefix.reclaim(self._alloc.pages_needed(n) + 1, rid=rid)
            try:
                self._alloc.map_range(lane, slot, slot + n)
                return
            except PageExhausted:
                if not freed:
                    raise

    # ------------------------------------------- preemption (spill/restore)
    # Continuous scheduler only: page pressure preempts instead of
    # truncating. A spilled lane's pages return to the pool; its host record
    # (history, threefry key, penalty ring: the chunk-boundary state) waits
    # in ``_spilled`` until pages free, and a restore re-prefills
    # ``history[:-1]`` into a window ending at the shared slot through the
    # join or suffix-join arithmetic, so the resumed stream is the
    # uninterrupted one (tests/test_torch_continuous.py).

    def _pick_victim(self, rows: list, lane: int) -> int | None:
        """The lane to preempt so ``lane`` can extend: the lowest priority
        (never one above the starving lane's), then the most pages (the most
        relief a spill), then the youngest. None: no other lane qualifies,
        and the starving lane spills itself."""
        me = rows[lane].req.priority
        best, best_key = None, None
        for i, row in enumerate(rows):
            if row is None or i == lane or row.req.priority > me:
                continue
            key = (row.req.priority, -self._alloc.lane_pages(i), -row.t_open)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    def _preempt_for(self, rows: list, lane: int, slot: int, n: int, spill_ctx: tuple) -> bool:
        """Spill victims until ``lane``'s next chunk maps (True), or spill
        ``lane`` itself when no lower-priority lane is left (False: the lane
        is parked, and resumes once a restore finds room)."""
        while True:
            victim = self._pick_victim(rows, lane)
            if victim is None:
                self._spill_lane(rows, lane, slot, spill_ctx, reason="self")
                return False
            self._spill_lane(rows, victim, slot, spill_ctx, reason="preempted")
            try:
                try:
                    self._alloc.map_range(lane, slot, slot + n)
                except PageExhausted:
                    # The victim's prompt pages went to the prefix cache on
                    # recycle: reclaim them before the next victim.
                    self._reclaim_and_map(lane, slot, n, rows[lane].req.rid)
                return True
            except PageExhausted:
                continue

    def _spill_lane(self, rows: list, lane: int, slot: int, spill_ctx: tuple,
                    reason: str) -> None:
        """Preempt one lane at the chunk boundary ``slot`` (its pending
        token's), after the chunk's readback: copy its key, ring and ring
        index to the host, return its pages (the prefix cache adopts its
        prompt chain, which the restore may fork back) and park it in the
        spill table. A cancel that raced the preemption wins. A lane that
        made no progress since its last restore and spills itself again can
        never advance on this pool: it finishes as "length" instead of
        cycling."""
        keys, ring_j, ring_idx_j = spill_ctx
        row = rows[lane]
        rid = row.req.rid
        if reason == "self" and row.n == row.n_at_restore:
            self.stats["page_truncations"] += 1
            row.req.handle.finish_reason = "length"
            metrics.flight.record("page-truncated", rid, slot=int(slot), where="respill",
                                  completion_tokens=row.n)
            rows[lane] = None
            row.finish()
            self._lane_recycle(lane)
            return
        window = int(ring_j.shape[1]) if ring_j.ndim == 2 else 0
        sp = _SpilledLane(
            row=row,
            key=keys[lane].cpu().numpy().copy(),
            ring=ring_j[lane].cpu().numpy().copy() if window > 0 else None,
            ring_idx=int(ring_idx_j[lane]) if window > 0 else 0,
        )
        rows[lane] = None
        with self._cv:
            cancelled = rid in self._cancel_ids
            if cancelled:
                self._cancel_ids.discard(rid)
            else:
                self._spilled[rid] = sp
                self._live_rids.discard(rid)
        if cancelled:
            self._note_cancelled(row, "epoch")
            row.cancel()
            self._lane_recycle(lane)
            return
        self.stats["preemptions"] += 1
        # A victim spilled for another lane's pages is a preempt; a starving
        # lane parking itself a spill; both for page pressure.
        self.audit.record("preempt" if reason == "preempted" else "spill", "page_pressure",
                          rid=rid, tenant=row.req.tenant, detail=reason)
        metrics.registry.counter(
            "cake_preemptions_total",
            "Lanes preempted under page pressure (continuous scheduler): "
            "page chain spilled host-side, stream parked for a "
            "bit-identical restore.",
        ).inc()
        metrics.flight.record("preempted", rid, slot=int(slot), reason=reason,
                              completion_tokens=row.n, priority=row.req.priority)
        timeline.instant("preempted", rid=rid, track=f"lane{lane}",
                         args={"slot": int(slot), "reason": reason})
        row.close_span()
        self._lane_recycle(lane, insert=True)

    def _pop_spill_seed(self) -> list[_SpilledLane]:
        """Seed rows of a spill-seeded segment: the oldest spill's knob
        group, oldest first, as many as fit the lanes and the (fully free)
        pool. A spill whose history can never be served again (the window
        or the whole pool is too small for it) finishes as "length", and one
        past its deadline finishes "deadline" (the chunk-boundary sweep's
        rule, so a late spill is never restored)."""
        doomed: list[_SpilledLane] = []
        late: list[_SpilledLane] = []
        out: list[_SpilledLane] = []
        now = time.monotonic()
        with self._cv:
            for rid, sp in list(self._spilled.items()):
                if sp.row.req.deadline and now > sp.row.req.deadline:
                    del self._spilled[rid]
                    late.append(sp)
        for sp in late:
            self.stats["deadline_expired"] += 1
            sp.row.expire()
        with self._cv:
            if not self._spilled:
                return []
            order = sorted(self._spilled.values(), key=lambda e: e.t)
            knobs = order[0].row.req.knobs()
            claimed = 0
            for sp in order:
                if len(out) >= self.max_batch:
                    break
                row = sp.row
                if row.req.knobs() != knobs:
                    continue
                hist = len(row.history) - 1
                if prompt_bucket(hist, self.max_seq_len) >= self.max_seq_len:
                    del self._spilled[row.req.rid]
                    doomed.append(sp)
                    continue
                if self._alloc is not None:
                    need = self._alloc.pages_needed(hist) + self._alloc.reserve_pages
                    if need + claimed > self._alloc.pages_total:
                        if need > self._alloc.pages_total:
                            del self._spilled[row.req.rid]
                            doomed.append(sp)
                        continue
                    claimed += need
                del self._spilled[row.req.rid]
                # Live under the same lock that unparks it: cancel() always
                # finds a request somewhere.
                self._live_rids.add(row.req.rid)
                out.append(sp)
            self._running = self._running or bool(out)
        for sp in doomed:
            self.stats["page_truncations"] += 1
            sp.row.req.handle.finish_reason = "length"
            metrics.flight.record("page-truncated", sp.row.req.rid, where="spilled",
                                  completion_tokens=sp.row.n)
            sp.row.finish()
        return out

    def _take_restores(self, knobs, rows, slot, cap, budget, tok, kv, keys, ring_j, ring_idx_j,
                       pads_j):
        """Step-boundary restores: re-attach spilled lanes (oldest first,
        same knobs) into free lanes while pages and the step's prefill
        budget allow. They run before joins and charge the same budget.
        Returns the KV; the sampling state is written in place."""
        with self._cv:
            if not self._spilled:
                return kv
        free = [i for i, r in enumerate(rows) if r is None]
        if not free:
            return kv
        picks: list[tuple[int, _SpilledLane]] = []
        claimed = 0
        with self._cv:
            for sp in sorted(self._spilled.values(), key=lambda e: e.t):
                if not free:
                    break
                row, req = sp.row, sp.row.req
                hist = len(row.history) - 1
                if req.knobs() != knobs:
                    # another segment's knobs
                    self.audit.record("defer", "knob_incompatible", rid=req.rid,
                                      tenant=req.tenant, detail="spilled")
                    continue
                if hist > slot or cap - 1 - slot < req.max_tokens - row.n:
                    # It needs a taller segment, or restoring here would
                    # truncate it below what a segment of its own gives.
                    self.audit.record("defer", "capacity", rid=req.rid, tenant=req.tenant,
                                      detail="spilled")
                    continue
                if budget["left"] < hist:
                    self.stats["budget_deferrals"] += 1
                    self.audit.record("defer", "step_budget", rid=req.rid, tenant=req.tenant,
                                      detail="spilled")
                    continue
                if self._alloc is not None:
                    need = self._alloc.pages_needed(hist) + self._alloc.reserve_pages
                    avail = self._alloc.pages_free - claimed + (
                        self._prefix.reclaimable() if self._prefix is not None else 0
                    )
                    if need > avail:
                        self.audit.record("defer", "page_pressure", rid=req.rid,
                                          tenant=req.tenant, detail="spilled")
                        continue
                    claimed += need
                budget["left"] -= hist
                del self._spilled[req.rid]
                self._live_rids.add(req.rid)
                self.audit.record("restore", "fair_order", rid=req.rid, tenant=req.tenant)
                picks.append((free.pop(0), sp))
        for lane, sp in picks:
            try:
                kv = self._restore_lane(sp, lane, rows, slot, tok, kv, keys, ring_j, ring_idx_j,
                                        pads_j)
            except PageExhausted:
                # The page estimate raced an eviction: the spill waits for
                # the next step.
                self._unwind_restore(lane, sp)
            except BaseException:
                self._unwind_restore(lane, sp)
                raise
        return kv

    def _unwind_restore(self, lane: int, sp: _SpilledLane) -> None:
        """Put a restore that failed back in the spill table (or finish it,
        when a cancel landed meanwhile) and return the lane's pages."""
        rid = sp.row.req.rid
        sp.row.close_span()
        sp.row.t_close = 0.0
        with self._cv:
            cancelled = rid in self._cancel_ids
            self._cancel_ids.discard(rid)
            self._live_rids.discard(rid)
            if not cancelled:
                self._spilled[rid] = sp
        if self._alloc is not None and self._alloc.lane_mapped(lane):
            self._lane_recycle(lane, insert=False)
        elif self._prefix is not None:
            self._prefix.release(self._lane_leases.pop(lane, None))
            self._lane_info.pop(lane, None)
        if cancelled:
            self._note_cancelled(sp.row, "spilled")
            sp.row.cancel()

    def _restore_lane(self, sp: _SpilledLane, lane: int, rows, slot, tok, kv, keys, ring_j,
                      ring_idx_j, pads_j):
        """Re-attach one spilled lane at the shared slot: re-prefill
        ``history[:-1]`` into a window ending at ``slot`` (the suffix-join
        arithmetic under the prefix cache, which may fork the chain the
        spill gave it; the plain join otherwise), then write the host
        copies of its key and ring, its pending token ``history[-1]`` and
        its pad into the lane's rows of the device state, in place: the
        decode graphs were captured over those buffers. Nothing is
        sampled. Returns the KV."""
        row, req = sp.row, sp.row.req
        hist = row.history[:-1]
        pad = slot - len(hist)
        row.lane = lane
        row.t_close = 0.0
        row.open_span(slot=slot)
        t0 = time.perf_counter()
        try:
            with timeline.span("restore", rid=req.rid, track="engine",
                               args={"lane": lane, "slot": int(slot), "tokens": len(hist)}):
                if self._prefix is not None:
                    fresh, pair = self._fork_lane(lane, req, pad, slot, ids=hist)
                    if pair is not None:
                        kv = self._dispatch("cow_copy", lambda: self.backend.cow_copy(
                            kv, [pair[0]], [pair[1]]))
                    width = min(-(-(slot - fresh) // _WINDOW_BUCKET) * _WINDOW_BUCKET, slot)
                    start = slot - width
                    row_tokens = np.zeros((1, width), np.int32)
                    lo = max(pad, start)
                    row_tokens[0, lo - start :] = hist[lo - pad :]
                    _, kv = self._dispatch("restore", lambda: self.backend.suffix_join(
                        kv, row_tokens, pad, fresh, lane, start))
                else:
                    width = min(-(-slot // _WINDOW_BUCKET) * _WINDOW_BUCKET, self.max_seq_len)
                    row_tokens = np.zeros((1, width), np.int32)
                    row_tokens[0, pad:slot] = hist
                    if self._alloc is not None:
                        self._alloc.map_range(lane, pad, slot)
                    _, kv = self._dispatch("restore", lambda: self.backend.join(
                        kv, row_tokens, pad, slot, lane))
                    self._log_join(row_tokens, pad, slot, lane)
                self._settle()  # nothing is read back: the event ends the wall
        except BaseException as e:
            row.close_span(error=str(e)[:200])
            raise
        dt_restore = time.perf_counter() - t0
        self.stats["prefill_s"] += dt_restore
        row.phase["restore"] += dt_restore
        # A restore's re-prefill is redone work: the preemption's price.
        self.efficiency.note_prefill(dt_restore, 1, width, min(len(hist), width), restore=True)
        dev = self.backend.device
        if sp.ring is not None and ring_j.ndim == 2 and ring_j.shape[1] > 0:
            ring_j[lane] = upload(sp.ring, dev, torch.int64)
            ring_idx_j[lane] = int(sp.ring_idx)
        keys[lane] = upload(sp.key, dev, torch.int64)
        tok[lane] = int(row.history[-1])
        pads_j[lane] = pad
        self._pads_host[lane] = pad
        rows[lane] = row
        row.n_at_restore = row.n
        if self._alloc is not None:
            self._pool_counter()
        self._note_restore(row)
        return kv

    def _note_restore(self, row: "_RowState") -> None:
        self.stats["restores"] += 1
        metrics.registry.counter(
            "cake_restores_total",
            "Spilled lanes re-attached to a running segment "
            "(bit-identical resume).",
        ).inc()
        metrics.flight.record("restored", row.req.rid, completion_tokens=row.n, lane=row.lane)
        timeline.instant("restored", rid=row.req.rid, track=f"lane{row.lane}")

    def _grant_step_budget(self, rows: list) -> int:
        """This step's prefill grant in prompt tokens (``StepBudget``):
        doubled while the SLO feedback says some tenant is burning, cut to a
        quarter while a live stream's deadline slack is inside a few chunk
        walls."""
        now = time.monotonic()
        slack = None
        for row in rows:
            if row is not None and row.req.deadline:
                left = row.req.deadline - now
                if slack is None or left < slack:
                    slack = left
        burning = bool(self._slo_shed_scale)
        grant = self._step_budget.grant(burning=burning, tightest_slack_s=slack)
        if burning or slack is not None:
            # The SLO feedback moved this step's prefill share; the audit
            # keeps one entry a run of identical verdicts.
            self.audit.record("budget", "slo_feedback",
                              detail="burning" if burning else "deadline_slack")
        return grant

    # ------------------------------------------------------------ joins

    def _take_joins(self, knobs: tuple, rows: list, slot: int, cap: int,
                    budget: dict | None = None) -> list:
        """Dequeue requests that can join NOW, in the fair queue's order: the
        same knobs, a prompt that ends by the shared slot, a free lane, and
        enough budget left in the epoch that joining delivers what waiting
        would. Within a tenant the scan stops at its first request with
        other knobs (per-tenant FIFO); while the oldest queued request has
        other knobs nothing joins (it bounds this epoch, the global FIFO's
        guarantee). ``budget`` (continuous) caps this step's join prefill in
        prompt tokens; a candidate over it waits a step. Paged: joiners
        charge their pages, reclaiming cold cache pages first. A request
        past its deadline expires here."""
        free = [i for i, r in enumerate(rows) if r is None]
        if not free:
            return []
        now = time.monotonic()
        state = {"avail": self._alloc.pages_free if self._alloc is not None else None}

        def defer(req: _Request, cause: str, verdict: str = "skip") -> str:
            self.audit.record("defer", cause, rid=req.rid, tenant=req.tenant)
            return verdict

        def accept(req: _Request) -> str:
            if req.deadline and now > req.deadline:
                self._expire_queued(req)
                return "drop"
            if req.knobs() != knobs:
                return defer(req, "knob_incompatible", verdict="next")
            n_ids = len(req.prompt_ids)
            solo_budget = min(
                req.max_tokens, self.max_seq_len - prompt_bucket(n_ids, self.max_seq_len)
            )
            if n_ids > slot or cap - slot < solo_budget:
                return defer(req, "capacity")
            if budget is not None and budget["left"] < n_ids:
                self.stats["budget_deferrals"] += 1
                return defer(req, "step_budget")
            avail = state["avail"]
            if avail is not None:
                need = self._pages_for(req, end_slot=slot)
                if need > avail and self._prefix is not None:
                    avail = state["avail"] = avail + self._prefix.reclaim(need - avail, rid=req.rid)
                if need > avail:
                    return defer(req, "page_pressure")
                state["avail"] = avail - need
            if budget is not None:
                budget["left"] -= n_ids
            self.audit.record("join", "fair_order", rid=req.rid, tenant=req.tenant)
            return "take"

        with self._cv:
            head = self._queue.oldest_head()
            if (head is not None and head.knobs() != knobs
                    and not (head.deadline and now > head.deadline)):
                # The oldest queued request wants other knobs: this epoch
                # stops growing so that it gets its own.
                self.audit.record("defer", "fairness_skip", rid=head.rid, tenant=head.tenant,
                                  detail="epoch_bound")
                return []
            taken = self._queue.take(len(free), accept)
            out = [(free[i], req) for i, req in enumerate(taken)]
            self._live_rids.update(req.rid for _, req in out)
        t_admit = time.perf_counter()
        for _, req in out:
            req.t_admit = t_admit  # the join prefill is lane time, not queue
        return out

    def _join(self, req, lane, rows, slot, tok, kv, keys, ring_j, ring_idx_j, s):
        """Prefill one request into a free lane of the RUNNING epoch: its
        prompt is left-padded to end at the shared slot, and its first token
        samples from its own fresh key, as a solo run would."""
        row = _RowState(req, set(self.config.eos_token_ids), self.tokenizer, self, lane=lane)
        # The lane span opens before the join prefill (the prefill is the
        # joiner's lane time); every failure path below closes it.
        row.open_span(slot=slot)
        try:
            return self._join_inner(req, row, lane, rows, slot, tok, kv, keys, ring_j,
                                    ring_idx_j, s)
        except BaseException as e:
            row.close_span(error=str(e)[:200])
            raise

    def _join_inner(self, req, row, lane, rows, slot, tok, kv, keys, ring_j, ring_idx_j, s):
        ids = req.prompt_ids
        pad = slot - len(ids)
        t0 = time.perf_counter()
        with timeline.span("join", rid=req.rid, track="engine",
                           args={"lane": lane, "slot": int(slot)}):
            if self._prefix is not None:
                # Fork the cached chain, map the tail, and prefill the window
                # [start, slot) on the suffix arithmetic: a warm join equals
                # a cold one because hit and miss walk one arithmetic.
                try:
                    with timeline.span("prefix-fork", track="engine",
                                       args={"lane": lane, "slot": int(slot)}):
                        fresh, pair = self._fork_lane(lane, req, pad, slot)
                except PageExhausted:
                    self.stats["page_truncations"] += 1
                    req.handle.finish_reason = "length"
                    metrics.flight.record("page-truncated", req.rid, slot=int(slot), where="join",
                                          completion_tokens=0)
                    self._lane_recycle(lane, insert=False)
                    row.finish()
                    self._pool_counter()
                    return tok, kv, keys, ring_j, ring_idx_j
                if pair is not None:
                    kv = self._dispatch("cow_copy", lambda: self.backend.cow_copy(
                        kv, [pair[0]], [pair[1]]))
                width = min(-(-(slot - fresh) // _WINDOW_BUCKET) * _WINDOW_BUCKET, slot)
                start = slot - width
                row_tokens = np.zeros((1, width), np.int32)
                lo = max(pad, start)
                row_tokens[0, lo - start :] = ids[lo - pad :]
                logits, kv = self._dispatch("join", lambda: self.backend.suffix_join(
                    kv, row_tokens, pad, fresh, lane, start))
            else:
                width = min(-(-slot // _WINDOW_BUCKET) * _WINDOW_BUCKET, self.max_seq_len)
                row_tokens = np.zeros((1, width), np.int32)
                row_tokens[0, pad:slot] = ids
                if self._alloc is not None:
                    self._alloc.map_range(lane, pad, slot)  # _take_joins charged the pool
                logits, kv = self._dispatch("join", lambda: self.backend.join(
                    kv, row_tokens, pad, slot, lane))
                self._log_join(row_tokens, pad, slot, lane)
            # The same first-token arithmetic as the epoch start
            # (batch.first_sample); its readback ends the wall.
            window = s.repeat_last_n
            row_ring, row_ring_idx = seed_rings([ids], window)
            key0 = prng_key([req.sampling.seed], self.backend.device)
            first_arr, key_next, row_ring, row_ring_idx = first_sample(
                logits, s, row_ring, row_ring_idx, key0
            )
        dt_join = time.perf_counter() - t0
        self.stats["prefill_s"] += dt_join
        first = int(first_arr[0])
        dev = self.backend.device
        if window > 0:
            ring_j[lane] = upload(row_ring[0], dev, torch.int64)
            ring_idx_j[lane] = int(row_ring_idx[0])
        keys[lane] = key_next[0]
        tok[lane] = first
        row.account_join(dt_join)
        # One lane x the window: the prompt's share is prefill, the pad pad.
        self.efficiency.note_prefill(dt_join, 1, width, min(len(ids), width))
        self._record_admissions([req], "joined", lane=lane, slot=slot)
        metrics.registry.counter(
            "cake_engine_joins_total",
            "Requests that joined a RUNNING epoch at a chunk boundary.",
        ).inc()
        row.push(first)
        rows[lane] = None if row.done else row
        self.stats["joins"] += 1
        self.stats["rows"] += 1
        return tok, kv, keys, ring_j, ring_idx_j


@dataclasses.dataclass
class _SpilledLane:
    """Host record of a preempted lane (continuous scheduler): the
    chunk-boundary state a restore needs. ``row`` keeps the history and the
    budget; ``key`` ([2] uint32 words in int64), ``ring`` and ``ring_idx``
    are the lane's sampling state copied from the device at the spill. No
    device memory and no pages."""

    row: "_RowState"
    key: np.ndarray
    ring: np.ndarray | None
    ring_idx: int
    t: float = dataclasses.field(default_factory=time.perf_counter)


class _RowState:
    """Engine-side per-row bookkeeping: budget, EOS, incremental detok,
    events, the lane's timeline span and the row's latency attribution."""

    def __init__(self, req: _Request, eos: set[int], tokenizer: Tokenizer, engine: BatchEngine,
                 lane: int = 0):
        self.req = req
        self._eos = eos
        self._tokenizer = tokenizer
        self._engine = engine
        self._ids: list[int] = []
        # The prompt and every pushed id: what a restore re-prefills.
        self.history: list[int] = list(req.prompt_ids)
        self._decoded_len = 0
        self.n = 0
        self.done = False
        self._finished = False
        self.lane = lane
        self._span: int | None = None
        # Latency attribution (obs/critpath.py phases): wall seconds the
        # engine's dispatch accounting gives this row; convoy is the
        # lockstep tax, work the row rode along for and did not need.
        self.phase: dict[str, float] = {
            "prefill": 0.0, "decode": 0.0, "spec_accepted": 0.0,
            "spec_wasted": 0.0, "convoy": 0.0, "restore": 0.0,
        }
        # When the row took its lane (the victim choice spills the youngest
        # first) and closed it, and its token count at its last restore (-1:
        # never): a lane that spills itself again at that count made no
        # progress.
        self.t_open = time.perf_counter()
        self.t_close = 0.0
        self.ttft_s: float | None = None
        self.n_at_restore = -1
        self._backpressured = False

    # ---- the lane-track timeline span (admission to finish) --------------

    def open_span(self, slot: int | None) -> None:
        """Open the request's span on its lane's track; the queue and
        admission stamps ride its args for /explain."""
        self.t_open = time.perf_counter()
        queue_wait = max(0.0, (self.req.t_admit or self.t_open) - self.req.t_submit)
        args: dict = {"prompt_tokens": len(self.req.prompt_ids),
                      "queue_wait_s": round(queue_wait, 6), "admit_s": round(self.req.admit_s, 6)}
        if slot is not None:
            args["join_slot"] = int(slot)
        self._span = timeline.begin("request", rid=self.req.rid, track=f"lane{self.lane}",
                                    args=args, parent=None)
        if self not in self._engine._epoch_rows:
            # The convoy meter's lane occupancy (a restored row re-opens its
            # span in the same segment: one entry).
            self._engine._epoch_rows.append(self)

    def close_span(self, error: str | None = None) -> None:
        if self.t_close == 0.0:
            self.t_close = time.perf_counter()
        if self._span is None:
            return
        args: dict = {"finish_reason": self.req.handle.finish_reason, "completion_tokens": self.n}
        if error is not None:
            args["error"] = error[:200]
        timeline.end(self._span, args=args)
        self._span = None

    # ---- dispatch-time attribution (engine thread) -----------------------

    def account_prefill(self, dt: float, bucket: int) -> None:
        """The epoch's prefill: the own share scales with the prompt's part
        of the shared bucket; the padding's compute is convoy."""
        share = min(1.0, len(self.req.prompt_ids) / max(1, bucket))
        self.phase["prefill"] += dt * share
        self.phase["convoy"] += dt * (1.0 - share)

    def account_join(self, dt: float) -> None:
        """A join prefill computes this row's window alone."""
        self.phase["prefill"] += dt

    def account_restore(self, dt: float, bucket: int) -> None:
        """A spill-seeded segment's prefill: redone work, split like a
        prefill."""
        share = min(1.0, (len(self.history) - 1) / max(1, bucket))
        self.phase["restore"] += dt * share
        self.phase["convoy"] += dt * (1.0 - share)

    def account_decode(self, dt: float, n: int, used: int) -> None:
        """One decode chunk of n tokens, ``used`` of them consumed; the
        unconsumed tail is convoy."""
        frac = min(1.0, used / max(1, n))
        self.phase["decode"] += dt * frac
        self.phase["convoy"] += dt * (1.0 - frac)

    def peek_consumed(self, toks) -> int:
        """How many of ``toks`` push() will take before the row finishes
        (EOS, or the budget on a non-EOS token)."""
        if self.done:
            return 0
        used = 0
        n = self.n
        for t in toks:
            used += 1
            if int(t) in self._eos:
                break
            n += 1
            if n >= self.req.max_tokens:
                break
        return used

    def push(self, tid: int) -> None:
        """Accept one decoded id and emit it. The moment the row is done
        (EOS or budget) its stream closes, though its lockstep lane keeps
        computing until the lane is recycled."""
        if self.done:
            return
        self._ids.append(tid)
        self.history.append(tid)
        self.n += 1
        eng = self._engine
        now = time.perf_counter()
        if self.n == 1:
            ttft = now - self.req.t_submit
            self.ttft_s = self.req.handle.ttft_s = ttft
            metrics.registry.histogram(
                "cake_ttft_seconds", "Submit-to-first-token latency (queue wait + prefill)."
            ).observe(ttft)
            metrics.flight.record("first-token", self.req.rid, ttft_s=round(ttft, 6))
            timeline.instant("first-token", rid=self.req.rid, track=f"lane{self.lane}",
                             args={"ttft_s": round(ttft, 6)})
            eng.slo.observe_ttft(self.req.tenant, ttft)
            eng.timeseries.observe_ttft(ttft)
        else:
            metrics.registry.histogram(
                "cake_inter_token_seconds",
                "Wall-clock gap between consecutive tokens of one stream.",
            ).observe(now - self.req.t_last_token)
        self.req.t_last_token = now
        eng.timeseries.observe_tokens()
        # The backpressure watermark, checked before this token's emit so a
        # flagged stream still delivers it; it is cancelled at the next
        # chunk boundary.
        if (eng.stream_buffer_tokens and not self._backpressured
                and self.req.handle.buffered() >= eng.stream_buffer_tokens):
            self._backpressured = True
            eng._shed_backpressure(self)
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

    def fail(self, error: str = "") -> None:
        """Failure isolation: finish ``"error"``; the consumer sees a clean
        end of stream (the tokens it got are the fault-free run's prefix)."""
        if self._finished:
            return
        self.done = True
        self.req.handle.finish_reason = "error"
        self._engine.stats["stream_errors"] += 1
        metrics.registry.counter(
            "cake_stream_errors_total",
            "Streams finished with finish_reason=error after a worker failure.",
        ).inc()
        metrics.flight.record("stream-error", self.req.rid, error=error[:200],
                              completion_tokens=self.n)
        timeline.instant("stream-error", rid=self.req.rid, track=f"lane{self.lane}")
        self.close_span(error=error)
        self.finish()

    def cancel(self) -> None:
        """A cancel at the chunk boundary: finish ``"cancelled"``."""
        if self._finished:
            return
        self.done = True
        self.req.handle.finish_reason = "cancelled"
        timeline.instant("cancelled", rid=self.req.rid, track=f"lane{self.lane}")
        self.finish()

    def expire(self) -> None:
        """The end-to-end deadline passed: finish ``"deadline"`` at this
        chunk boundary; the tokens already streamed stand."""
        if self._finished:
            return
        self.done = True
        self.req.handle.finish_reason = "deadline"
        metrics.registry.counter(
            "cake_deadline_expired_total",
            "Requests past their end-to-end deadline (where=queued expired "
            "before admission; where=running at a chunk boundary).",
        ).inc(where="running")
        metrics.flight.record("deadline-expired", self.req.rid, where="running",
                              completion_tokens=self.n)
        timeline.instant("deadline-expired", rid=self.req.rid, track=f"lane{self.lane}")
        self.finish()

    def finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        self.done = True
        metrics.registry.counter(
            "cake_engine_completed_total", "Streams closed (any finish reason)."
        ).inc()
        metrics.flight.record("finished", self.req.rid,
                              finish_reason=self.req.handle.finish_reason,
                              completion_tokens=self.n)
        self.close_span()
        eng = self._engine
        # The tenant's SLIs: deadline hit or miss, errors, goodput; a
        # tokenless deadline or error finish is also a TTFT miss. The
        # ledger classes the same tokens, the attribution folds the row's
        # phases, and the request log keeps the one record: one finish
        # event, so the views agree.
        eng.slo.observe_finish(
            self.req.tenant, self.req.handle.finish_reason, tokens=self.n,
            had_deadline=bool(self.req.deadline), got_first_token=self.n > 0,
        )
        eng.efficiency.note_finish(self.req.tenant, self.req.handle.finish_reason, self.n)
        eng._observe_request(self)
        eng._record_request(self.req, row=self)
        self.req.handle._emit(_DONE)
        eng._row_finished(self.req.rid)


def _rings_from_history(rows: list, ring: torch.Tensor, ring_idx: torch.Tensor,
                        window: int) -> None:
    """Write each live row's repeat-penalty ring as its history gives it
    (``seed_rings``: the last ``window`` ids, the next push evicting the
    oldest), in place. The penalty reads the ring's ids and a push evicts
    the oldest wherever the ring's rotation starts, so this equals the ring
    the row's pushes built."""
    live = [(lane, row) for lane, row in enumerate(rows) if row is not None]
    if window <= 0 or not live:
        return
    r, idx = seed_rings([row.history for _, row in live], window)
    lanes = torch.tensor([lane for lane, _ in live], device=ring.device)
    ring[lanes] = torch.as_tensor(r, device=ring.device).to(ring.dtype)
    ring_idx[lanes] = torch.as_tensor(idx, device=ring.device).to(ring_idx.dtype)


def _replay_tokens(fed: dict, slot: int, n: int, n_lanes: int) -> np.ndarray:
    """The tokens a logged decode chunk over [slot, slot + n) fed each lane:
    ``history[p - pad]`` at position p from ``fed`` ({lane: (pad, history)}
    of the live rows). A position before a lane's current row joined gets
    that history's token or 0: garbage the join logged later rewrites, as a
    dead lane's garbage is never read."""
    toks = np.zeros((n_lanes, n), np.int64)
    for lane, (pad, hist) in fed.items():
        for i in range(n):
            j = slot + i - pad
            if 0 <= j < len(hist):
                toks[lane, i] = hist[j]
    return toks


def _fail_request(req: _Request, engine: BatchEngine, error: str = "") -> None:
    """Finish a request that never took its lane (a joiner stranded by a
    lost worker or an abandoned dispatch) as ``"error"``, without raising
    into the consumer."""
    req.handle.finish_reason = "error"
    metrics.registry.counter(
        "cake_stream_errors_total",
        "Streams finished with finish_reason=error after a worker failure.",
    ).inc()
    metrics.flight.record("stream-error", req.rid, error=error[:200])
    metrics.flight.record("finished", req.rid, finish_reason="error", completion_tokens=0)
    engine.slo.observe_finish(req.tenant, "error", had_deadline=bool(req.deadline),
                              got_first_token=False)
    engine._record_request(req, finish="error")
    req.handle._emit(_DONE)
