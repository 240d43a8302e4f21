"""Per-tenant SLO tracking: rolling multi-window SLIs and burn rates (port
of ``cake_tpu/obs/slo.py``).

  * ``SloObjectives``: the server's declared objectives (``--slo-ttft-ms``
    with a target fraction, ``--slo-deadline-rate``). Objectives are
    server-wide; compliance is tracked per tenant.
  * ``SloTracker``: per-tenant rolling SLIs over a fast and a slow window:
    TTFT p99, the TTFT objective's hit fraction, the deadline hit rate,
    error and shed rates, and goodput tok/s. An objective's error-budget
    burn rate is ``observed_miss_fraction / allowed_miss_fraction`` (1.0
    spends the budget exactly at the sustainable rate). A tenant's headline
    burn is the max over objectives of ``min(fast, slow)``: both windows
    must show the burn.

The SLIs:

  * **TTFT**, over accepted requests: a request that produced a first
    token counts against ``ttft_ms``; one that finished with zero tokens
    as ``deadline`` or ``error`` is a miss. 429/503 refusals are not TTFT
    samples; they feed the shed rate.
  * **Deadline**, over accepted requests that carried a deadline: a hit
    when the stream finished ``stop``/``length``, a miss when it finished
    ``deadline`` (queued expiry included). ``error`` and ``cancelled``
    outcomes are left out.
  * **Goodput**: completion tokens of ``stop``/``length`` finishes per
    window second.

Feedback to admission (``adjustments``): a tenant burning its budget gets
its FairQueue quantum weighted up and its WaitEstimator shed estimate
scaled up (runtime/admission.py); the engine applies both about once a
second (runtime/serving.py ``BatchEngine._apply_slo_feedback``).

Observability: ``cake_slo_*`` gauges (``refresh_metrics``, at scrape
time), the ``GET /slo`` endpoint (snapshot), and ``slo-burn`` flight events
on every burning/recovered transition.

Thread-safe and bounded (the least recently active tenants are evicted past
``max_tenants``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque

from cake_tpu_torch.utils import metrics

__all__ = ["SloObjectives", "SloTracker"]

# Reservoir cap per bucket for TTFT percentile estimation: p99 over the
# window is computed from at most bucket_count * this many samples.
_SAMPLES_PER_BUCKET = 64

# Feedback caps: a burning tenant's quantum weight / shed-estimate scale
# grow with the burn but never past these (isolation must survive feedback).
_MAX_QUANTUM_WEIGHT = 4.0
_MAX_SHED_SCALE = 4.0


@dataclasses.dataclass(frozen=True)
class SloObjectives:
    """Declared service objectives (0 disables each)."""

    # TTFT objective: ``ttft_target`` of accepted requests must see their
    # first token within ``ttft_ms`` milliseconds.
    ttft_ms: float = 0.0
    ttft_target: float = 0.99
    # Deadline objective: this fraction of deadline-carrying requests must
    # finish before their deadline.
    deadline_rate: float = 0.0

    def __post_init__(self) -> None:
        if self.ttft_ms < 0 or not (0.0 < self.ttft_target < 1.0):
            raise ValueError(
                "slo_ttft_ms must be >= 0 and slo_ttft_target in (0, 1), "
                f"got {self.ttft_ms}/{self.ttft_target}"
            )
        if not (0.0 <= self.deadline_rate < 1.0):
            raise ValueError(
                f"slo_deadline_rate must be in [0, 1), got "
                f"{self.deadline_rate}"
            )

    def declared(self) -> bool:
        return self.ttft_ms > 0 or self.deadline_rate > 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Bucket:
    __slots__ = (
        "t0", "ttft_n", "ttft_miss", "ttft_samples", "dl_n", "dl_miss",
        "finished", "errors", "refusals", "quota_refusals", "good_tokens",
    )

    def __init__(self, t0: float):
        self.t0 = t0
        self.ttft_n = 0
        self.ttft_miss = 0
        self.ttft_samples: list[float] = []
        self.dl_n = 0
        self.dl_miss = 0
        self.finished = 0
        self.errors = 0
        self.refusals = 0         # all pre-acceptance refusals (shed+quota)
        self.quota_refusals = 0   # the 429 slice of the above
        self.good_tokens = 0


class _TenantSeries:
    """One tenant's rolling buckets (width = fast_window / 12, deque spans
    the slow window)."""

    __slots__ = ("buckets", "burning")

    def __init__(self) -> None:
        self.buckets: deque[_Bucket] = deque()
        self.burning = False  # transition state for slo-burn events


def _percentile(samples: list[float], q: float) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    i = min(len(s) - 1, max(0, int(round((q / 100.0) * (len(s) - 1)))))
    return s[i]


class SloTracker:
    """Rolling per-tenant SLIs + burn rates against declared objectives."""

    def __init__(
        self,
        objectives: SloObjectives | None = None,
        *,
        fast_window_s: float = 60.0,
        slow_window_s: float = 600.0,
        max_tenants: int = 256,
        time_fn=time.monotonic,
    ):
        if fast_window_s <= 0 or slow_window_s < fast_window_s:
            raise ValueError(
                "slo windows need 0 < fast <= slow, got "
                f"{fast_window_s}/{slow_window_s}"
            )
        self.objectives = objectives or SloObjectives()
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.max_tenants = int(max_tenants)
        self._bucket_s = max(1.0, self.fast_window_s / 12.0)
        self._time = time_fn
        self._lock = threading.Lock()
        self._tenants: OrderedDict[str, _TenantSeries] = OrderedDict()
        # Tenants whose gauges the last refresh_metrics exported: an
        # LRU-evicted tenant's series must be zeroed on the next refresh,
        # or its last burn value would stand in /metrics forever (the
        # registry keeps every series) — a permanent false alert.
        self._exported: set[str] = set()

    # ------------------------------------------------------------ recording

    def _bucket(self, tenant: str) -> _Bucket:
        """Current bucket for ``tenant`` (caller holds the lock)."""
        now = self._time()
        series = self._tenants.get(tenant)
        if series is None:
            series = self._tenants[tenant] = _TenantSeries()
            while len(self._tenants) > self.max_tenants:
                self._tenants.popitem(last=False)  # least recently active
        else:
            self._tenants.move_to_end(tenant)
        horizon = now - self.slow_window_s - self._bucket_s
        while series.buckets and series.buckets[0].t0 < horizon:
            series.buckets.popleft()
        if not series.buckets or now - series.buckets[-1].t0 >= self._bucket_s:
            series.buckets.append(_Bucket(now))
        return series.buckets[-1]

    def observe_ttft(self, tenant: str, ttft_s: float) -> None:
        """A stream produced its first token ``ttft_s`` after submit."""
        with self._lock:
            b = self._bucket(tenant)
            b.ttft_n += 1
            if (
                self.objectives.ttft_ms > 0
                and ttft_s * 1e3 > self.objectives.ttft_ms
            ):
                b.ttft_miss += 1
            if len(b.ttft_samples) < _SAMPLES_PER_BUCKET:
                b.ttft_samples.append(ttft_s)

    def observe_finish(
        self,
        tenant: str,
        finish_reason: str,
        *,
        tokens: int = 0,
        had_deadline: bool = False,
        got_first_token: bool = True,
    ) -> None:
        """A stream ended (any reason; queued deadline expiry included)."""
        with self._lock:
            b = self._bucket(tenant)
            b.finished += 1
            if finish_reason in ("stop", "length"):
                b.good_tokens += int(tokens)
            elif finish_reason == "error":
                b.errors += 1
            if had_deadline and finish_reason in (
                "stop", "length", "deadline"
            ):
                # The deadline SLI is hit-on-clean-finish vs miss-on-
                # expiry. Other outcomes of deadline-carrying requests —
                # "error" (feeds the error-rate SLI) and "cancelled" (a
                # client action) — are excluded rather than silently
                # counted as hits, which would report a 100% hit rate for
                # a tenant whose deadline traffic all errored.
                b.dl_n += 1
                if finish_reason == "deadline":
                    b.dl_miss += 1
            if not got_first_token and finish_reason in ("deadline", "error"):
                # No first token within ANY bound: a TTFT miss by
                # definition (module docstring SLI contract).
                b.ttft_n += 1
                b.ttft_miss += 1

    def observe_refusal(self, tenant: str, kind: str) -> None:
        """A submission refused before acceptance. ``kind`` distinguishes
        server saturation (``"shed"`` — 503) from the tenant's own quota
        (``"quota"`` — 429): both feed the combined shed-rate SLI, and the
        quota slice surfaces separately in the window breakdown."""
        with self._lock:
            b = self._bucket(tenant)
            b.refusals += 1
            if kind == "quota":
                b.quota_refusals += 1

    # ------------------------------------------------------------- windows

    def _window(self, series: _TenantSeries, window_s: float) -> dict:
        """Aggregate SLIs over the trailing ``window_s`` (caller holds the
        lock)."""
        now = self._time()
        lo = now - window_s
        agg = _Bucket(lo)
        for b in series.buckets:
            if b.t0 + self._bucket_s <= lo:
                continue
            agg.ttft_n += b.ttft_n
            agg.ttft_miss += b.ttft_miss
            agg.ttft_samples.extend(b.ttft_samples)
            agg.dl_n += b.dl_n
            agg.dl_miss += b.dl_miss
            agg.finished += b.finished
            agg.errors += b.errors
            agg.refusals += b.refusals
            agg.quota_refusals += b.quota_refusals
            agg.good_tokens += b.good_tokens
        out = {
            "requests": agg.finished,
            "ttft_p99_s": round(_percentile(agg.ttft_samples, 99), 6),
            "deadline_hit_rate": (
                round(1.0 - agg.dl_miss / agg.dl_n, 4) if agg.dl_n else None
            ),
            "error_rate": (
                round(agg.errors / agg.finished, 4) if agg.finished else 0.0
            ),
            "shed_rate": (
                round(agg.refusals / (agg.finished + agg.refusals), 4)
                if (agg.finished + agg.refusals)
                else 0.0
            ),
            "refusals": {
                "shed": agg.refusals - agg.quota_refusals,
                "quota": agg.quota_refusals,
            },
            "goodput_tok_s": round(agg.good_tokens / window_s, 3),
        }
        burns = {}
        if self.objectives.ttft_ms > 0:
            allowed = 1.0 - self.objectives.ttft_target
            frac = agg.ttft_miss / agg.ttft_n if agg.ttft_n else 0.0
            burns["ttft"] = round(frac / allowed, 3)
        if self.objectives.deadline_rate > 0:
            allowed = 1.0 - self.objectives.deadline_rate
            frac = agg.dl_miss / agg.dl_n if agg.dl_n else 0.0
            burns["deadline"] = round(frac / allowed, 3)
        out["burn"] = burns
        return out

    def _burn_locked(self, series: _TenantSeries) -> float:
        fast = self._window(series, self.fast_window_s)["burn"]
        slow = self._window(series, self.slow_window_s)["burn"]
        worst = 0.0
        for obj in fast:
            worst = max(worst, min(fast[obj], slow.get(obj, 0.0)))
        return worst

    def burn(self, tenant: str) -> float:
        """Headline burn rate: max over objectives of min(fast, slow);
        0.0 = inside budget (or no objectives declared)."""
        with self._lock:
            series = self._tenants.get(tenant)
            if series is None:
                return 0.0
            return self._burn_locked(series)

    # ------------------------------------------------------------- outputs

    def snapshot(self) -> dict:
        """The ``GET /slo`` body: objectives, windows, per-tenant SLIs and
        burn rates."""
        with self._lock:
            tenants = {}
            for name, series in self._tenants.items():
                tenants[name] = {
                    "fast": self._window(series, self.fast_window_s),
                    "slow": self._window(series, self.slow_window_s),
                    "burn_rate": round(self._burn_locked(series), 3),
                }
        return {
            "objectives": self.objectives.to_dict(),
            "windows": {
                "fast_s": self.fast_window_s,
                "slow_s": self.slow_window_s,
            },
            "tenants": tenants,
        }

    def adjustments(self) -> dict[str, dict]:
        """Admission feedback per tracked tenant (module docstring):
        ``quantum_weight`` for the FairQueue and ``shed_scale`` for the
        WaitEstimator, both 1.0 when the tenant is inside budget. Also
        emits the burning/recovered transition events."""
        transitions: list[tuple[str, bool, float]] = []
        out: dict[str, dict] = {}
        with self._lock:
            for name, series in self._tenants.items():
                burn = self._burn_locked(series)
                burning = burn >= 1.0
                if burning != series.burning:
                    series.burning = burning
                    transitions.append((name, burning, burn))
                if burning:
                    w = min(_MAX_QUANTUM_WEIGHT, 1.0 + burn)
                    s = min(_MAX_SHED_SCALE, 1.0 + burn)
                else:
                    w = s = 1.0
                out[name] = {
                    "burn": round(burn, 3),
                    "quantum_weight": round(w, 3),
                    "shed_scale": round(s, 3),
                }
        for name, burning, burn in transitions:
            metrics.flight.record(
                "slo-burn", tenant=name,
                state="burning" if burning else "recovered",
                burn=round(burn, 3),
            )
            metrics.registry.counter(
                "cake_slo_burn_transitions_total",
                "Tenant error-budget burn transitions "
                "(state=burning|recovered).",
            ).inc(tenant=name,
                  state="burning" if burning else "recovered")
        return out

    def refresh_metrics(self) -> None:
        """Set the ``cake_slo_*`` gauges from the current windows — called
        at scrape time (GET /metrics), so the exported series always
        reflect the live windows without per-observation gauge churn."""
        snap = self.snapshot()
        p99 = metrics.registry.gauge(
            "cake_slo_ttft_p99_seconds",
            "Rolling TTFT p99 per tenant and window.",
        )
        hit = metrics.registry.gauge(
            "cake_slo_deadline_hit_rate",
            "Rolling deadline hit rate per tenant and window (-1 = no "
            "deadline-carrying traffic in the window).",
        )
        good = metrics.registry.gauge(
            "cake_slo_goodput_tokens_per_second",
            "Rolling goodput (completion tokens of clean finishes) per "
            "tenant and window.",
        )
        burn = metrics.registry.gauge(
            "cake_slo_burn_rate",
            "Error-budget burn rate per tenant, objective and window "
            "(1.0 = consuming budget exactly at the sustainable rate).",
        )
        head = metrics.registry.gauge(
            "cake_slo_tenant_burn",
            "Headline burn per tenant: max over objectives of "
            "min(fast, slow).",
        )
        for tenant, t in snap["tenants"].items():
            for window in ("fast", "slow"):
                w = t[window]
                p99.set(w["ttft_p99_s"], tenant=tenant, window=window)
                hit.set(
                    -1.0 if w["deadline_hit_rate"] is None
                    else w["deadline_hit_rate"],
                    tenant=tenant, window=window,
                )
                good.set(w["goodput_tok_s"], tenant=tenant, window=window)
                for obj, b in w["burn"].items():
                    burn.set(
                        b, tenant=tenant, objective=obj, window=window
                    )
            head.set(t["burn_rate"], tenant=tenant)
        # Tenants evicted since the last refresh: zero their series (the
        # registry keeps them) so a stale burn never stands as a false
        # alert after the tenant aged out of tracking.
        for tenant in self._exported - set(snap["tenants"]):
            head.set(0.0, tenant=tenant)
            for window in ("fast", "slow"):
                p99.set(0.0, tenant=tenant, window=window)
                hit.set(-1.0, tenant=tenant, window=window)
                good.set(0.0, tenant=tenant, window=window)
                for obj in ("ttft", "deadline"):
                    burn.set(
                        0.0, tenant=tenant, objective=obj, window=window
                    )
        self._exported = set(snap["tenants"])
