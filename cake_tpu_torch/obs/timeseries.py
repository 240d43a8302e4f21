"""Rolling SLI time-series (the port's copy of ``cake_tpu/obs/timeseries.py``).

A sliding window of fixed-width buckets — the obs/slo.py bucket idiom,
server-wide instead of per-tenant — each holding a bounded TTFT sample
reservoir plus token/finish/refusal tallies. ``series()`` renders the
window as one point per bucket (p50/p99 TTFT, tok/s, shed+429 rate), the
shape ``GET /timeseries`` serves. Feeds are engine-side: first-token
observations from ``_RowState.push`` and terminal outcomes from the
request-log funnel (runtime/serving.py), so the time-series and the
request log always agree on what finished when.

Stdlib only, injectable clock.
"""

from __future__ import annotations

import collections
import threading
import time


def _percentile(samples: list[float], q: float) -> float:
    """Nearest-rank percentile over a bounded sample list (the obs/slo.py
    estimator: exact for the small reservoirs these buckets keep)."""
    if not samples:
        return 0.0
    s = sorted(samples)
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[idx]


class _Bucket:
    __slots__ = ("idx", "ttft", "tokens", "finished", "refused", "errors")

    def __init__(self, idx: int):
        self.idx = idx  # integer bucket number: floor(now / bucket_s)
        self.ttft: list[float] = []
        self.tokens = 0
        self.finished = 0   # admitted terminals (any finish_reason)
        self.refused = 0    # quota (429) + shed (503)
        self.errors = 0

    def point(self, bucket_s: float, age_s: float) -> dict:
        offered = self.finished + self.refused
        return {
            "age_s": round(age_s, 1),
            "ttft_p50_ms": round(_percentile(self.ttft, 0.50) * 1e3, 2),
            "ttft_p99_ms": round(_percentile(self.ttft, 0.99) * 1e3, 2),
            "tok_s": round(self.tokens / bucket_s, 2),
            "finished": self.finished,
            "refused": self.refused,
            "errors": self.errors,
            "shed_frac": round(self.refused / offered, 4) if offered else 0.0,
        }


class SliTimeseries:
    """Sliding-window histogram rings behind ``GET /timeseries``."""

    def __init__(
        self,
        window_s: float = 300.0,
        bucket_s: float = 5.0,
        max_samples: int = 512,
        time_fn=time.monotonic,
    ):
        if bucket_s <= 0 or window_s < bucket_s:
            raise ValueError(
                f"need window_s >= bucket_s > 0, got {window_s}/{bucket_s}"
            )
        self.window_s = float(window_s)
        self.bucket_s = float(bucket_s)
        self._max_samples = max_samples
        self._time = time_fn
        self._lock = threading.Lock()
        self._buckets: collections.deque[_Bucket] = collections.deque()

    def _bucket(self) -> _Bucket:
        """Current (aligned) bucket; evicts everything past the horizon.
        Caller holds the lock."""
        idx = int(self._time() // self.bucket_s)
        if not self._buckets or self._buckets[-1].idx < idx:
            self._buckets.append(_Bucket(idx))
        oldest = idx - int(round(self.window_s / self.bucket_s))
        while self._buckets and self._buckets[0].idx < oldest:
            self._buckets.popleft()
        return self._buckets[-1]

    def observe_ttft(self, ttft_s: float) -> None:
        with self._lock:
            b = self._bucket()
            if len(b.ttft) < self._max_samples:
                b.ttft.append(float(ttft_s))

    def observe_tokens(self, n: int = 1) -> None:
        with self._lock:
            self._bucket().tokens += n

    def observe_finish(self, finish_reason: str) -> None:
        """Terminal outcome tally — REQUEST_OUTCOMES vocabulary: the two
        refusal kinds feed the shed/429 rate, everything else counts as an
        admitted finish (errors also tallied separately)."""
        with self._lock:
            b = self._bucket()
            if finish_reason in ("quota", "shed"):
                b.refused += 1
            else:
                b.finished += 1
                if finish_reason == "error":
                    b.errors += 1

    def series(self) -> dict:
        """The window as chronological per-bucket points (newest last).
        Empty gaps between observed buckets are materialized as zero
        points so sparklines render real time, not event time."""
        with self._lock:
            now = self._time()
            buckets = {b.idx: b for b in self._buckets}
        head = int(now // self.bucket_s)
        points: list[dict] = []
        n_buckets = int(round(self.window_s / self.bucket_s))
        for idx in range(head - n_buckets + 1, head + 1):
            if idx < 0:
                continue
            b = buckets.get(idx) or _Bucket(idx)
            points.append(
                b.point(self.bucket_s, now - idx * self.bucket_s)
            )
        # Leading all-zero history (a server younger than the window)
        # renders as noise-free left padding; trim it for compactness.
        while points and not (
            points[0]["finished"] or points[0]["refused"]
            or points[0]["tok_s"]
        ):
            points.pop(0)
        return {
            "window_s": self.window_s,
            "bucket_s": self.bucket_s,
            "t_wall": round(time.time(), 3),
            "points": points,
        }
