"""Admission control of the batch engine (port of
``cake_tpu/runtime/admission.py``): tenants, fair queueing, deadlines,
stalls, and the continuous scheduler's step budget. All of it is host-side;
runtime/serving.py consumes each piece.

  * ``TenantMeter``: per-tenant accounting, a token-bucket rate limit
    (tokens/s and burst, where a "token" is a unit of requested work:
    prompt tokens + max_tokens) and a cap on concurrent streams. A refusal
    is ``QuotaExceeded``, which the API maps to HTTP 429 + Retry-After,
    distinct from the engine's 503 ``EngineOverloaded`` shed: 429 means the
    caller is over its budget, 503 that the server is saturated.
  * ``FairQueue``: the engine's request queue, one FIFO per tenant drained
    by deficit-weighted round-robin (DRR), so a tenant that floods the
    queue still hands the next admission slot to a tenant that queued one.
    Priority classes scale a request's cost. With one tenant (or
    ``fair=False``) the order is the global FIFO.
  * ``WaitEstimator``: an EWMA of observed queue waits, the estimate
    deadline-aware shedding compares a request's ``deadline_s`` with.
  * ``StepBudget``: the continuous scheduler's per-step prefill grant,
    scaled up by SLO burn and down by a running stream's deadline slack.
  * ``StallGuard``: the stuck-epoch watchdog. Each backend dispatch runs on
    a watchdog thread while the engine waits at most ``epoch_stall_s``; a
    dispatch that neither returns nor raises in time is abandoned and the
    engine sees the ``BackendWorkerError`` a dead worker gives, so a hung
    dispatch costs one epoch, not the engine. What keeps an abandoned
    dispatch from writing into the next epoch's buffers is the backend's
    part (runtime/batch_backend.py ``abandon``).

Each records what the reference records: the ``cake_tenant_*``,
``cake_quota_refusals_total`` and ``cake_epoch_stalls*`` metrics
(utils/metrics.py), ``quota-refused`` and ``epoch-stall`` flight events, and
an ``epoch-stall`` timeline instant on the engine track (obs/timeline.py),
beside the engine's ``stats`` counters, ``tenant_stats()`` and the guard's
own counts.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

from cake_tpu_torch.obs.timeline import timeline
from cake_tpu_torch.utils import metrics

__all__ = [
    "DEFAULT_TENANT", "FairQueue", "MAX_TENANTS", "QuotaExceeded", "StallGuard", "StepBudget",
    "TenantMeter", "TokenBucket", "WaitEstimator",
]

DEFAULT_TENANT = "default"

# Keeps the per-tenant state bounded: past this many distinct tenants the
# meter evicts the least recently seen tenant with no open streams (a
# returning tenant starts from a full bucket, which errs on admitting).
MAX_TENANTS = 1024


class QuotaExceeded(RuntimeError):
    """Per-tenant quota refusal (rate limit or stream cap): HTTP 429, with
    a Retry-After from the caller's own bucket arithmetic."""

    def __init__(self, message: str, retry_after_s: float = 1.0,
                 tenant: str = DEFAULT_TENANT, kind: str = "rate"):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.tenant = tenant
        self.kind = kind  # "rate" | "streams"


class TokenBucket:
    """Token bucket over monotonic time (the caller holds the lock).

    A request larger than the burst is granted whenever the bucket is at
    least at its ``min(cost, burst)`` mark and charged in full: the level
    goes negative (debt), delaying later grants, so oversized requests
    eventually pass while the long-run rate still converges to ``rate``.
    """

    def __init__(self, rate: float, burst: float, now: float | None = None):
        self.rate = float(rate)
        self.burst = float(burst)
        self.level = float(burst)
        self.t = time.monotonic() if now is None else now

    def try_take(self, cost: float, now: float | None = None) -> float:
        """0.0 when granted (and charged); else seconds until it would be."""
        now = time.monotonic() if now is None else now
        self.level = min(self.burst, self.level + (now - self.t) * self.rate)
        self.t = now
        need = min(cost, self.burst) if self.burst > 0 else cost
        if self.level >= need:
            self.level -= cost
            return 0.0
        if self.rate <= 0:
            return float("inf")
        return (need - self.level) / self.rate

    def refund(self, cost: float) -> None:
        """Credit back a charge whose request never ran (a 503 shed after
        the quota grant): server overload must not drain the caller's own
        bucket and turn into 429s."""
        self.level = min(self.burst, self.level + cost)


class _Tenant:
    __slots__ = ("bucket", "open_rids", "tokens", "submitted", "refusals")

    def __init__(self, rate: float, burst: float, now: float):
        self.bucket = TokenBucket(rate, burst, now) if rate > 0 else None
        self.open_rids: set[str] = set()
        self.tokens = 0.0
        self.submitted = 0
        self.refusals = 0


class TenantMeter:
    """Per-tenant quota enforcement and accounting (thread-safe: API
    handler threads submit concurrently).

    ``rate``/``burst`` are in work tokens (prompt + max_tokens);
    ``max_streams`` caps a tenant's queued + live streams. 0 turns each
    gate off; the meter keeps its per-tenant counters either way. ``admit``
    either registers the stream or raises ``QuotaExceeded`` leaving no
    state behind. ``time_fn`` is the clock the buckets read.
    """

    def __init__(self, rate: float = 0.0, burst: float = 0.0, max_streams: int = 0,
                 time_fn=time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst) if burst > 0 else (2.0 * rate if rate > 0 else 0.0)
        self.max_streams = int(max_streams)
        self._time = time_fn
        self._lock = threading.Lock()
        self._tenants: OrderedDict[str, _Tenant] = OrderedDict()
        self._rid_tenant: dict[str, tuple[str, float]] = {}

    def _tenant(self, tenant: str) -> _Tenant:
        t = self._tenants.get(tenant)
        if t is None:
            t = self._tenants[tenant] = _Tenant(self.rate, self.burst, self._time())
            while len(self._tenants) > MAX_TENANTS:
                for key, cand in self._tenants.items():
                    if not cand.open_rids and key != tenant:
                        del self._tenants[key]
                        break
                else:
                    break  # every tenant has open streams: over the cap but live
        else:
            self._tenants.move_to_end(tenant)
        return t

    def admit(self, tenant: str, rid: str, cost: float) -> None:
        """Charge one submission; raises QuotaExceeded (429) on refusal."""
        with self._lock:
            t = self._tenant(tenant)
            if self.max_streams and len(t.open_rids) >= self.max_streams:
                self._refused(t, tenant, "streams")
                raise QuotaExceeded(
                    f"tenant {tenant!r} has {len(t.open_rids)} concurrent streams "
                    f"(cap {self.max_streams})",
                    retry_after_s=1.0, tenant=tenant, kind="streams",
                )
            if t.bucket is not None:
                wait = t.bucket.try_take(cost, self._time())
                if wait > 0:
                    self._refused(t, tenant, "rate")
                    raise QuotaExceeded(
                        f"tenant {tenant!r} over its token rate ({self.rate:g} tok/s, burst "
                        f"{self.burst:g}); {cost:g} tokens available in {wait:.2f}s",
                        retry_after_s=max(0.1, wait), tenant=tenant, kind="rate",
                    )
            t.open_rids.add(rid)
            self._rid_tenant[rid] = (tenant, float(cost))
            t.tokens += cost
            t.submitted += 1
            metrics.registry.counter(
                "cake_tenant_submitted_total",
                "Submissions accepted past the per-tenant quota gates.",
            ).inc(tenant=tenant)
            metrics.registry.counter(
                "cake_tenant_tokens_total",
                "Work tokens (prompt + max_tokens) admitted per tenant.",
            ).inc(cost, tenant=tenant)
            metrics.registry.gauge(
                "cake_tenant_active_streams",
                "Queued + live streams per tenant (quota view).",
            ).set(len(t.open_rids), tenant=tenant)

    @staticmethod
    def _refused(t: _Tenant, tenant: str, kind: str) -> None:
        t.refusals += 1
        metrics.registry.counter(
            "cake_quota_refusals_total",
            "Submissions refused by per-tenant quotas (HTTP 429 + "
            "Retry-After; kind=rate|streams).",
        ).inc(tenant=tenant, kind=kind)
        metrics.flight.record("quota-refused", tenant=tenant, kind=kind)

    def close(self, rid: str, refund: bool = False) -> None:
        """A stream finished (any reason); idempotent. ``refund=True`` is for
        a submission the quota granted and a later gate refused (the 503
        shed): the charge is credited back."""
        with self._lock:
            entry = self._rid_tenant.pop(rid, None)
            if entry is None:
                return
            tenant, cost = entry
            t = self._tenants.get(tenant)
            if t is not None:
                t.open_rids.discard(rid)
                if refund:
                    t.tokens -= cost
                    if t.bucket is not None:
                        t.bucket.refund(cost)
                metrics.registry.gauge(
                    "cake_tenant_active_streams",
                    "Queued + live streams per tenant (quota view).",
                ).set(len(t.open_rids), tenant=tenant)

    def snapshot(self) -> dict:
        """Per-tenant accounting for the ``/stats`` tenants block."""
        with self._lock:
            return {
                name: {
                    "active_streams": len(t.open_rids),
                    "submitted": t.submitted,
                    "tokens": round(t.tokens, 1),
                    "quota_refusals": t.refusals,
                    "bucket_level": round(t.bucket.level, 1) if t.bucket is not None else None,
                }
                for name, t in self._tenants.items()
            }


class FairQueue:
    """Deficit-weighted round-robin request queue over tenant subqueues.

    Not thread-safe: every call runs under the engine's condition
    variable, as the deque it replaces did. With ``fair=False`` (or one
    tenant) every request shares one subqueue and the order is the global
    FIFO.

    ``take(limit, accept)`` walks candidates in fair order and asks
    ``accept(req)`` for a verdict:

      * ``"take"``: dequeue it (counts toward ``limit``; its cost is
        charged against the tenant's deficit),
      * ``"skip"``: leave it queued and keep scanning the same tenant (a
        candidate that does not fit this epoch's knobs or pages),
      * ``"next"``: leave it queued and stop scanning this tenant for this
        call (the per-tenant FIFO rule at joins),
      * ``"drop"``: dequeue it without counting it (an expired request the
        caller has just finished).

    The deficit check runs before ``accept``: a head costlier than its
    tenant's deficit blocks that tenant until the next visit. When a whole
    round takes nothing but some head was deficit-blocked, every active
    tenant receives the least number of quanta that unblocks one at once:
    the textbook DRR loop fast-forwarded, so one ``take`` ends in
    O(tenants x queue).

    ``quantum`` is the deficit a visit grants; the engine keeps the
    reference's 256, and the parity tests vary it against the reference.
    """

    def __init__(self, fair: bool = True, quantum: int = 256, cost=None):
        self.fair = bool(fair)
        self.quantum = max(1, int(quantum))
        self._cost = cost or (lambda req: 1.0)
        self._q: dict[str, deque] = {}
        self._rr: deque[str] = deque()  # active (non-empty) tenants, round-robin order
        self._deficit: dict[str, float] = {}
        # Per-tenant quantum weights (the SLO feedback, obs/slo.py): a tenant
        # at weight w accrues w x quantum deficit a visit. Absent = 1.0.
        self._weights: dict[str, float] = {}
        self._total = 0
        self.deadline_count = 0  # queued requests carrying a deadline

    def set_weight(self, tenant: str, weight: float) -> None:
        """Scale ``tenant``'s quantum a visit (SLO burn feedback); 1.0
        restores the unweighted share. A no-op with ``fair=False``: there
        are no subqueues for a weight to act on."""
        if not self.fair:
            return
        weight = max(1.0, float(weight))
        if weight == 1.0:
            self._weights.pop(tenant, None)
        else:
            self._weights[tenant] = weight
        metrics.registry.gauge(
            "cake_tenant_quantum_weight",
            "DRR quantum multiplier per tenant (SLO burn feedback; "
            "1 = unweighted fair share).",
        ).set(weight, tenant=tenant or DEFAULT_TENANT)

    def weight(self, tenant: str) -> float:
        return self._weights.get(tenant, 1.0)

    def _key(self, req) -> str:
        return getattr(req, "tenant", DEFAULT_TENANT) if self.fair else ""

    # ------------------------------------------------------------- mutation

    def append(self, req) -> None:
        key = self._key(req)
        dq = self._q.get(key)
        if dq is None:
            dq = self._q[key] = deque()
        if not dq:
            if key not in self._rr:
                self._rr.append(key)
            self._deficit.setdefault(key, 0.0)
        dq.append(req)
        self._total += 1
        if getattr(req, "deadline", 0.0):
            self.deadline_count += 1
        self._gauge(key)

    def extend(self, reqs) -> None:
        for req in reqs:
            self.append(req)

    def remove(self, req) -> bool:
        key = self._key(req)
        dq = self._q.get(key)
        if dq is None:
            return False
        try:
            dq.remove(req)
        except ValueError:
            return False
        self._dropped(key, req)
        return True

    def clear(self) -> None:
        for key, dq in self._q.items():
            dq.clear()
            self._gauge(key)
        self._q.clear()
        self._rr.clear()
        self._deficit.clear()
        self._total = 0
        self.deadline_count = 0

    def _dropped(self, key: str, req) -> None:
        self._total -= 1
        if getattr(req, "deadline", 0.0):
            self.deadline_count -= 1
        self._gauge(key)
        if not self._q[key]:
            # An emptied subqueue's entries are deleted (tenant-id churn
            # cannot grow them), which is also DRR's no-idle-credit rule: a
            # tenant that reappears starts from deficit 0.
            del self._q[key]
            self._deficit.pop(key, None)
            try:
                self._rr.remove(key)
            except ValueError:
                pass

    def _gauge(self, key: str) -> None:
        metrics.registry.gauge(
            "cake_tenant_queued", "Requests queued per tenant."
        ).set(len(self._q.get(key, ())), tenant=key or DEFAULT_TENANT)

    # -------------------------------------------------------------- queries

    def __len__(self) -> int:
        return self._total

    def __iter__(self):
        for key in list(self._rr):
            yield from list(self._q[key])

    def oldest_head(self):
        """The earliest-submitted request among the tenants' heads: with
        per-tenant FIFOs, the oldest queued request (the one the join
        path's epoch-bounding rule watches)."""
        heads = [self._q[k][0] for k in self._rr if self._q.get(k)]
        if not heads:
            return None
        return min(heads, key=lambda r: getattr(r, "t_submit", 0.0))

    def queued_by_tenant(self) -> dict[str, int]:
        return {(k or DEFAULT_TENANT): len(dq) for k, dq in self._q.items() if dq}

    # ------------------------------------------------------------ scheduling

    def take(self, limit: int, accept) -> list:
        taken: list = []
        if limit <= 0 or not self._total:
            return taken
        stopped: set[str] = set()
        while len(taken) < limit:
            took = False
            shortfall: float | None = None
            if not any(self._q[k] and k not in stopped for k in self._rr):
                break
            # One full rotation is one DRR round: every active tenant is
            # visited once (stopped or emptied keys still use their slot).
            for _ in range(len(self._rr)):
                if len(taken) >= limit or not self._rr:
                    break
                key = self._rr[0]
                self._rr.rotate(-1)
                if key in stopped or not self._q.get(key):
                    continue
                self._deficit[key] += self.quantum * self._weights.get(key, 1.0)
                dq = self._q[key]
                i = 0
                while i < len(dq) and len(taken) < limit:
                    req = dq[i]
                    c = max(1.0, float(self._cost(req)))
                    if c > self._deficit[key]:
                        gap = c - self._deficit[key]
                        if shortfall is None or gap < shortfall:
                            shortfall = gap
                        break
                    verdict = accept(req)
                    if verdict == "take":
                        del dq[i]
                        self._deficit[key] -= c
                        self._dropped(key, req)
                        taken.append(req)
                        took = True
                    elif verdict == "drop":
                        del dq[i]
                        self._dropped(key, req)
                    elif verdict == "skip":
                        i += 1
                    else:  # "next"
                        stopped.add(key)
                        break
            if not took:
                if shortfall is None:
                    break  # nothing blocked on deficit: accept() refused them all
                # Fast-forward the blocked rounds: the same number of quanta
                # to every tenant, each scaled by its weight.
                boost = -(-shortfall // self.quantum) * self.quantum
                for key in self._rr:
                    self._deficit[key] += boost * self._weights.get(key, 1.0)
        return taken


class WaitEstimator:
    """EWMA of observed queue waits: the deadline-aware shed estimate.

    ``estimate`` scales the smoothed wait by the queue depth relative to the
    batch width. It is 0 until the first admission is observed, so a fresh
    engine never sheds on a deadline.
    """

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.ewma = 0.0
        self.samples = 0

    def observe(self, wait_s: float) -> None:
        self.samples += 1
        if self.samples == 1:
            self.ewma = wait_s
        else:
            self.ewma += self.alpha * (wait_s - self.ewma)

    def estimate(self, depth: int, max_batch: int, scale: float = 1.0) -> float:
        """``scale`` (>= 1) is the SLO feedback (obs/slo.py): a tenant
        burning its error budget gets its estimate inflated, so its
        deadline-doomed submissions shed earlier."""
        if not self.samples:
            return 0.0
        return self.ewma * (1.0 + depth / max(1, max_batch)) * max(1.0, scale)


class StepBudget:
    """SLO-aware prefill-vs-decode split for the continuous scheduler.

    Each engine step grants at most ``grant()`` prompt tokens of join /
    restore prefill work before decode resumes. Two feedback signals move
    it:

      * **Burn**: while some tenant's SLO burn is high (queue waits are
        missing the TTFT objective) the grant DOUBLES, so admissions drain
        faster at the cost of slightly slower decode.
      * **Deadline slack**: while a RUNNING stream's deadline slack is
        inside ``SLACK_CHUNKS`` recent chunk walls, the grant QUARTERS
        (floor ``MIN_TOKENS``): a stream about to miss needs decode steps,
        not prefill stalls.

    Engine-thread only (no locks): ``observe_chunk`` feeds the chunk-wall
    EWMA the slack comparison is measured in.
    """

    AUTO_TOKENS = 512     # default base grant (~ a few joins per step)
    MIN_TOKENS = 64       # never starve admission entirely
    SLACK_CHUNKS = 8.0    # deadline pressure threshold in chunk walls

    def __init__(self, base_tokens: int = 0, alpha: float = 0.3):
        self.base = int(base_tokens)
        self.alpha = alpha
        self.chunk_ewma = 0.0

    def observe_chunk(self, wall_s: float) -> None:
        if self.chunk_ewma <= 0.0:
            self.chunk_ewma = wall_s
        else:
            self.chunk_ewma += self.alpha * (wall_s - self.chunk_ewma)

    def grant(
        self, burning: bool = False, tightest_slack_s: float | None = None
    ) -> int:
        out = self.base or self.AUTO_TOKENS
        if burning:
            out *= 2
        if (
            tightest_slack_s is not None
            and self.chunk_ewma > 0.0
            and tightest_slack_s < self.SLACK_CHUNKS * self.chunk_ewma
        ):
            out = max(self.MIN_TOKENS, out // 4)
        return out


class StallGuard:
    """Stuck-epoch watchdog: bound every backend dispatch by ``stall_s``.

    The engine calls ``call(fn, op)``; ``fn`` runs on the guard's watchdog
    thread while the engine waits under a timeout. A dispatch that neither
    returns nor raises within the bound is abandoned: the watchdog thread
    is disposable (a fresh one serves the next call; the stalled one
    discards its late result, counted in ``resolved``, and exits), and the
    engine receives the ``BackendWorkerError`` a dead worker gives. A
    dispatch that never completes leaks one daemon thread.

    ``fn`` is responsible for its own device context: torch's current
    stream and device are per thread (runtime/serving.py ``_dispatch``
    hands the engine's to the job).
    """

    NODE = "<stalled>"

    # The first call of each op may build a kernel or capture a decode
    # graph, which can dwarf a steady-state dispatch: it gets this multiple
    # of the bound, and so does a call its caller marks ``grace`` (the
    # engine marks a decode that builds a new chunk, whose graph it
    # captures). A stall grants the op its grace again.
    FIRST_CALL_GRACE = 10.0

    def __init__(self, stall_s: float):
        self.stall_s = float(stall_s)
        self.stalls = 0
        self.resolved = 0  # abandoned dispatches that completed late
        self._cv = threading.Condition()
        self._stop = False
        self._gen = 0
        self._job = None  # (gen, fn) awaiting pickup
        self._done: dict[int, tuple[bool, object]] = {}
        self._worker: threading.Thread | None = None
        self._seen_ops: set[str] = set()

    # ---- engine side -----------------------------------------------------

    def call(self, fn, op: str, grace: bool = False, rid: str = ""):
        from cake_tpu_torch.runtime.batch_backend import BackendWorkerError

        with self._cv:
            self._gen += 1
            gen = self._gen
            self._job = (gen, fn)
            if self._worker is None:
                self._worker = threading.Thread(target=self._run, name="stall-guard", daemon=True)
                self._worker.start()
            self._cv.notify_all()
            first = grace or op not in self._seen_ops
            bound = self.stall_s * (self.FIRST_CALL_GRACE if first else 1.0)
            self._seen_ops.add(op)
            deadline = time.monotonic() + bound
            while gen not in self._done and not self._stop:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(timeout=left)
            if gen in self._done:
                ok, val = self._done.pop(gen)
                if ok:
                    return val
                raise val
            if self._stop:
                # stop() woke the wait, not a stall: the same typed error
                # unwinds the epoch, without the stall bookkeeping.
                self._job = None
                raise BackendWorkerError(self.NODE, op)
            # Stall: abandon the watchdog thread (it may still be inside the
            # hung dispatch) and grant the op its grace again.
            self._worker = None
            self._job = None
            self._seen_ops.discard(op)
            self.stalls += 1
        metrics.registry.counter(
            "cake_epoch_stalls_total",
            "Backend dispatches abandoned by the stuck-epoch watchdog "
            "(no progress within epoch_stall_s).",
        ).inc()
        metrics.flight.record("epoch-stall", rid, op=op, stall_s=bound)
        timeline.instant(
            "epoch-stall", rid=rid or None, track="engine",
            args={"op": op, "stall_s": bound},
        )
        raise BackendWorkerError(self.NODE, op)

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._worker = None
            self._cv.notify_all()

    # ---- watchdog thread -------------------------------------------------

    def _run(self) -> None:
        me = threading.current_thread()
        while True:
            with self._cv:
                if self._worker is not me or self._stop:
                    return
                job, self._job = self._job, None
                if job is None:
                    # A bounded idle wait, so an abandoned and forgotten
                    # worker never parks forever.
                    self._cv.wait(timeout=0.5)
                    continue
            gen, fn = job
            try:
                result = (True, fn())
            except BaseException as e:  # noqa: BLE001 - relayed to the caller
                result = (False, e)
            # An idle worker holds neither the job (which refers to its
            # caller) nor its outputs.
            job = fn = None
            with self._cv:
                if self._worker is not me:
                    # The engine gave up on this dispatch while it ran.
                    self.resolved += 1
                    metrics.registry.counter(
                        "cake_epoch_stalls_resolved_total",
                        "Stalled dispatches that completed after the "
                        "watchdog had already abandoned them.",
                    ).inc()
                    return
                self._done[gen] = result
                result = None
                self._cv.notify_all()
