"""Serving-grade metrics: histograms, counters, gauges, and a flight recorder
(the port's copy of ``cake_tpu/utils/metrics.py``).

  * ``Histogram`` — fixed-bucket latency histograms with Prometheus cumulative
    ``_bucket``/``_sum``/``_count`` exposition and p50/p90/p99 estimation
    (linear interpolation inside the bucket, the histogram_quantile rule).
  * ``Counter`` / ``Gauge`` — monotonic event counts and point-in-time levels.
  * ``MetricsRegistry`` — process-global get-or-create registry (``registry``)
    with full text exposition (# HELP + # TYPE + label escaping), a JSON
    ``snapshot()`` for /stats and a raw ``dump()``; ``merged_exposition``
    renders node-tagged dumps as one scrape.
  * ``FlightRecorder`` — a bounded in-process ring of per-request lifecycle
    events (submitted / admitted / joined / first-token / finished / ...),
    exposed at GET /events and streamable as JSONL (``--events-jsonl``).

Everything is dependency-free, thread-safe, and cheap enough for per-token
call sites (a dict lookup + a lock around integer bumps). Per-request
timing lands in the flight recorder keyed by request id. The exposition
text and the ring's events are the reference's, byte for byte on the same
calls (tests/test_torch_obs_metrics.py).
"""


from __future__ import annotations

import json
import threading
import time
import uuid
from collections import deque
from typing import Any, Iterable

# Latency buckets (seconds): sub-millisecond device dispatches up through
# multi-second cold prefills. Geometric-ish 1-2.5-5 ladder, the Prometheus
# convention, so dashboards compose across deployments.
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


def new_request_id() -> str:
    """Wire-safe request/trace id (compact; JSON header friendly)."""
    return f"req-{uuid.uuid4().hex[:16]}"


def escape_label_value(v: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline): dropped
    characters would silently collide series; a raw newline fails the scrape."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    """Float formatting for exposition: '0.001', '5', '+Inf'."""
    if v == float("inf"):
        return "+Inf"
    return f"{v:.10g}"


def _label_key(labels: dict[str, str]) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render_labels(items: Iterable[tuple[str, str]]) -> str:
    body = ",".join(f'{k}="{escape_label_value(v)}"' for k, v in items)
    return f"{{{body}}}" if body else ""


class _Metric:
    """Shared shell: name, help text, per-labelset series under one lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: dict[tuple, Any] = {}

    def _expose_header(self) -> list[str]:
        return [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} {self.kind}",
        ]


class Counter(_Metric):
    """Monotonic counter. Names should end in ``_total`` by convention."""

    kind = "counter"

    def inc(self, n: float = 1, **labels: str) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + n

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0)

    def expose(self) -> list[str]:
        with self._lock:
            items = sorted(self._series.items())
        lines = self._expose_header()
        for key, v in items:
            lines.append(f"{self.name}{_render_labels(key)} {_fmt(v)}")
        return lines

    def snapshot(self) -> list[dict]:
        with self._lock:
            items = sorted(self._series.items())
        return [
            {"name": self.name, "labels": dict(k), "value": v}
            for k, v in items
        ]

    def dump(self) -> dict:
        """Raw per-series state, JSON all the way down — the federation unit
        a worker ships in a STATS reply (runtime/proto.py) and
        ``merged_exposition`` renders back into one cluster scrape."""
        with self._lock:
            items = sorted(self._series.items())
        return {
            "name": self.name,
            "kind": self.kind,
            "help": self.help,
            "series": [
                {"labels": dict(k), "value": v} for k, v in items
            ],
        }


class Gauge(_Metric):
    """Point-in-time level (set wins; inc/dec for deltas)."""

    kind = "gauge"

    def set(self, v: float, **labels: str) -> None:
        with self._lock:
            self._series[_label_key(labels)] = v

    def inc(self, n: float = 1, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + n

    def dec(self, n: float = 1, **labels: str) -> None:
        self.inc(-n, **labels)

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0)

    expose = Counter.expose
    snapshot = Counter.snapshot
    dump = Counter.dump


class _HistSeries:
    __slots__ = ("counts", "sum", "count", "min", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = 0.0


class Histogram(_Metric):
    """Fixed-bucket histogram with cumulative exposition and percentiles."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name} needs at least one bucket")

    def observe(self, v: float, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(len(self.buckets))
            i = 0
            for b in self.buckets:
                if v <= b:
                    break
                i += 1
            s.counts[i] += 1
            s.sum += v
            s.count += 1
            s.min = min(s.min, v)
            s.max = max(s.max, v)

    def percentile(self, q: float, **labels: str) -> float:
        """Estimate the q-th percentile (q in [0, 100]) from the buckets.

        The histogram_quantile rule: find the bucket holding the target rank,
        interpolate linearly inside it. The overflow bucket reports the max
        observed value (a finite, honest bound) instead of +Inf.
        """
        with self._lock:
            s = self._series.get(_label_key(labels))
            if s is None or s.count == 0:
                return 0.0
            counts = list(s.counts)
            total, vmin, vmax = s.count, s.min, s.max
        target = (q / 100.0) * total
        cum = 0.0
        for i, c in enumerate(counts):
            prev = cum
            cum += c
            if cum >= target and c > 0:
                if i == len(self.buckets):  # overflow bucket
                    return vmax
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                # Clamp to observed extremes: a single sample in a wide
                # bucket should not report the bucket edge as its p50.
                lo = max(lo, min(vmin, hi))
                est = lo + (hi - lo) * ((target - prev) / c)
                return min(est, vmax)
        return vmax

    def expose(self) -> list[str]:
        with self._lock:
            items = sorted(
                (k, (list(s.counts), s.sum, s.count))
                for k, s in self._series.items()
            )
        lines = self._expose_header()
        for key, (counts, total_sum, count) in items:
            cum = 0
            for b, c in zip((*self.buckets, float("inf")), counts):
                cum += c
                le = (*key, ("le", _fmt(b)))
                lines.append(f"{self.name}_bucket{_render_labels(le)} {cum}")
            lbl = _render_labels(key)
            lines.append(f"{self.name}_sum{lbl} {total_sum:.6f}")
            lines.append(f"{self.name}_count{lbl} {count}")
        return lines

    def snapshot(self) -> list[dict]:
        with self._lock:
            keys = sorted(self._series)
        out = []
        for key in keys:
            labels = dict(key)
            with self._lock:
                s = self._series.get(key)
                if s is None:
                    continue
                count, total_sum = s.count, s.sum
            out.append(
                {
                    "name": self.name,
                    "labels": labels,
                    "count": count,
                    "sum": round(total_sum, 6),
                    "mean": round(total_sum / count, 6) if count else 0.0,
                    "p50": round(self.percentile(50, **labels), 6),
                    "p90": round(self.percentile(90, **labels), 6),
                    "p99": round(self.percentile(99, **labels), 6),
                }
            )
        return out

    def dump(self) -> dict:
        """Raw bucket state per series (see Counter.dump): enough for a
        remote renderer to re-emit the exact cumulative exposition AND to
        re-estimate percentiles (min/max travel for the interpolation
        clamp)."""
        with self._lock:
            items = sorted(
                (k, (list(s.counts), s.sum, s.count, s.min, s.max))
                for k, s in self._series.items()
            )
        return {
            "name": self.name,
            "kind": self.kind,
            "help": self.help,
            "buckets": list(self.buckets),
            "series": [
                {
                    "labels": dict(k),
                    "counts": counts,
                    "sum": round(total, 6),
                    "count": count,
                    "min": (None if count == 0 else round(vmin, 6)),
                    "max": round(vmax, 6),
                }
                for k, (counts, total, count, vmin, vmax) in items
            ],
        }


class MetricsRegistry:
    """Process-global named metrics; get-or-create, like trace.SpanRegistry.

    Call sites fetch by name at each use (a dict hit under a lock), so a test
    ``clear()`` between modules cannot leave stale metric objects recording
    into a deregistered family.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, **kw) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def expose(self) -> str:
        """Prometheus text exposition for every registered metric."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        """JSON shape for /stats."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        out: dict[str, list] = {"counters": [], "gauges": [], "histograms": []}
        for m in metrics:
            out[m.kind + "s"].extend(m.snapshot())
        return out

    def dump(self) -> dict:
        """Full raw state of every registered metric (see Counter.dump) —
        what a worker ships over the STATS wire message and what
        ``merged_exposition`` consumes."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        return {"metrics": [m.dump() for m in metrics]}

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


def merged_exposition(dumps: list[tuple[str, dict]]) -> str:
    """Render node-tagged registry dumps as ONE Prometheus text exposition.

    ``dumps`` is ``[(node, registry_dump), ...]`` (see ``MetricsRegistry.
    dump``) — the master's own dump plus one per pulled worker. The cluster
    contract (README "Cluster observability & SLOs"):

      * every series is exposed under a ``node`` label — injected from the
        dump's node name when the series does not already carry one (worker-
        side families like ``cake_worker_op_seconds`` label themselves);
      * a family appearing on several nodes gets ONE ``# HELP``/``# TYPE``
        header (Prometheus requires each family grouped once per scrape);
        the first dump's help text wins, and a same-name family whose KIND
        conflicts is dropped from the later node rather than corrupting the
        scrape with a second TYPE line;
      * series are the nodes' own raw values (pull model: the latest
        snapshot per node REPLACES the previous — a worker restart resets
        that node's counters to the worker's truth, it never double-counts).
    """
    families: dict[str, dict] = {}  # name -> {kind, help, rows}
    order: list[str] = []
    for node, dump in dumps:
        for m in dump.get("metrics", []):
            name = m["name"]
            fam = families.get(name)
            if fam is None:
                fam = families[name] = {
                    "kind": m["kind"],
                    "help": m.get("help", ""),
                    "rows": [],
                }
                order.append(name)
            elif fam["kind"] != m["kind"]:
                continue  # kind collision: keep the scrape well-formed
            for s in m.get("series", []):
                labels = dict(s.get("labels", {}))
                labels.setdefault("node", node)
                # Each series renders against ITS OWN dump's bucket
                # bounds: version-skewed nodes may ship different edges
                # for the same family, and zipping their counts against
                # another node's edges would mislabel cumulative buckets.
                fam["rows"].append((labels, s, m.get("buckets")))
    lines: list[str] = []
    for name in sorted(order):
        fam = families[name]
        lines.append(f"# HELP {name} {_escape_help(fam['help'])}")
        lines.append(f"# TYPE {name} {fam['kind']}")
        for labels, s, raw_buckets in sorted(
            fam["rows"], key=lambda r: _label_key(r[0])
        ):
            lbl = _render_labels(_label_key(labels))
            if fam["kind"] == "histogram":
                buckets = [float(b) for b in (raw_buckets or ())]
                counts = s.get("counts", ())
                if len(counts) != len(buckets) + 1:
                    continue  # malformed series: drop, never mislabel
                cum = 0
                for b, c in zip((*buckets, float("inf")), counts):
                    cum += c
                    le = (*_label_key(labels), ("le", _fmt(b)))
                    lines.append(
                        f"{name}_bucket{_render_labels(le)} {cum}"
                    )
                lines.append(f"{name}_sum{lbl} {float(s['sum']):.6f}")
                lines.append(f"{name}_count{lbl} {s['count']}")
            else:
                lines.append(f"{name}{lbl} {_fmt(s['value'])}")
    return "\n".join(lines) + ("\n" if lines else "")


class FlightRecorder:
    """Bounded ring of request lifecycle events (the in-process black box).

    Events are plain dicts ``{ts, event, request_id?, **fields}`` — JSON all
    the way down so GET /events and the JSONL dump are a serialization, not a
    transformation. The ring is sized, not timed: under load the newest
    ``capacity`` events win, which is what a post-incident read wants.
    """

    def __init__(self, capacity: int = 2048):
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=int(capacity))
        self._jsonl_path: str | None = None

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def record(
        self, event: str, request_id: str | None = None, **fields: Any
    ) -> dict:
        # Both clocks on every event: ``ts`` (wall — comparable across
        # processes) and ``mono`` (perf_counter — drift-free deltas), so the
        # ring merges into the obs timeline's Perfetto export without clock
        # skew. When a timeline span is open in this context, its id rides
        # along — /events entries link straight to their slice in the trace.
        entry: dict[str, Any] = {
            "ts": round(time.time(), 6),
            "mono": round(time.perf_counter(), 6),
            "event": event,
        }
        if request_id is not None:
            entry["request_id"] = request_id
        from cake_tpu_torch.obs.timeline import current_span_id

        sid = current_span_id()
        if sid is not None:
            entry["span"] = sid
        entry.update(fields)
        with self._lock:
            self._ring.append(entry)
            path = self._jsonl_path
        if path is not None:
            # Outside the lock: a slow disk must not serialize the engine.
            # Single-line appends from multiple threads interleave whole
            # lines on POSIX (O_APPEND), so the stream stays parseable.
            try:
                with open(path, "a") as f:
                    f.write(json.dumps(entry, separators=(",", ":")) + "\n")
            except OSError:
                pass
        return entry

    def snapshot(self, request_id: str | None = None) -> list[dict]:
        with self._lock:
            events = list(self._ring)
        if request_id is not None:
            events = [e for e in events if e.get("request_id") == request_id]
        return events

    def attach_jsonl(self, path: str | None) -> None:
        """Stream every future event to ``path`` as one JSON line each
        (the dump hook; None detaches)."""
        with self._lock:
            self._jsonl_path = path

    def dump_jsonl(self, path: str) -> int:
        """Write the CURRENT ring contents to ``path``; returns event count."""
        events = self.snapshot()
        with open(path, "w") as f:
            for e in events:
                f.write(json.dumps(e, separators=(",", ":")) + "\n")
        return len(events)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


# Process-global instances: one registry and one flight recorder serve the
# whole runtime (tests may build private ones).
registry = MetricsRegistry()
flight = FlightRecorder()
