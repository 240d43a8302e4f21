"""Black-box anomaly capture (the port's copy of ``cake_tpu/obs/blackbox.py``):
diagnostic bundles at the moment of failure.

When a request breaches its tenant's SLO objective, lands past a rolling
p99 x K latency multiplier, or dies to a watchdog stall or a whole-epoch
error, the serving engine snapshots a diagnostic bundle into a bounded,
rate-limited on-disk ring (``--blackbox-dir``). A bundle is one JSON file
holding everything a post-mortem needs with no live server:

  * ``explain``   — the critical-path attribution (obs/critpath.py),
  * ``timeline``  — the request's timeline slice (raw ring events),
  * ``events``    — the flight-recorder tail,
  * ``engine`` / ``pool`` / ``prefix`` / ``slo`` — engine counters, page
    allocator, prefix-tree and SLO snapshots,
  * ``metrics``   — the registry snapshot.

``render_report`` renders a human report naming the dominant phase and the
likely cause (``diagnose``); the port has no ``doctor`` subcommand yet
(ROADMAP.md A6), so the report is a library call. The capture ring is
bounded two ways — at most ``keep`` bundles on disk (oldest deleted) and at
most one capture per ``min_interval_s`` (suppressions are counted, not
silent).

Stdlib-only; the engine guards every capture behind ``--blackbox-dir``.
"""


from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from cake_tpu_torch.utils import metrics

BUNDLE_SCHEMA = 1
_PREFIX = "bundle-"

# Rolling end-to-end latency window for the p99 x K outlier trigger: the
# multiplier needs this many samples before it can fire (a cold server's
# first slow request is warmup, not an anomaly).
_MIN_SAMPLES = 30
_WINDOW = 512

# Capture reasons are a bounded enum (they become metric labels and file
# names); the engine maps its failure taxonomy onto them.
REASONS = (
    "stall", "epoch-error", "failover", "slo-ttft", "slo-deadline",
    "latency-outlier", "manual",
)


class BlackBox:
    """Bounded, rate-limited on-disk ring of diagnostic bundles."""

    def __init__(
        self,
        dir: str,
        *,
        keep: int = 16,
        min_interval_s: float = 5.0,
        p99_mult: float = 0.0,
    ):
        if keep < 1:
            raise ValueError(f"blackbox keep must be >= 1, got {keep}")
        if min_interval_s < 0 or p99_mult < 0:
            raise ValueError(
                "blackbox min_interval_s and p99_mult must be >= 0"
            )
        self.dir = dir
        self.keep = int(keep)
        self.min_interval_s = float(min_interval_s)
        self.p99_mult = float(p99_mult)
        self._lock = threading.Lock()
        self._seq = 0
        self._last_capture = 0.0
        self._lat: deque[float] = deque(maxlen=_WINDOW)
        self.captured = 0
        self.suppressed = 0
        os.makedirs(dir, exist_ok=True)

    # ------------------------------------------------------------ triggers

    def observe_latency(self, e2e_s: float) -> bool:
        """Record one end-to-end latency; True when it is a p99 x K outlier
        (the trigger needs ``p99_mult`` > 0 and a warm window). The verdict
        compares against the window BEFORE the sample joins it — an outlier
        must not raise its own bar — but the sample is recorded either way,
        so a sustained slowdown becomes the new normal instead of a
        bundle-per-request storm."""
        if self.p99_mult <= 0:
            return False
        with self._lock:
            warm = len(self._lat) >= _MIN_SAMPLES
            if warm:
                s = sorted(self._lat)
                p99 = s[min(len(s) - 1, int(round(0.99 * (len(s) - 1))))]
            self._lat.append(float(e2e_s))
        return warm and e2e_s > self.p99_mult * p99 > 0.0

    # ------------------------------------------------------------- capture

    def capture(
        self,
        reason: str,
        request_id: str | None = None,
        *,
        explain: dict | None = None,
        timeline: list[dict] | None = None,
        events: list[dict] | None = None,
        extra: dict | None = None,
    ) -> str | None:
        """Write one bundle; returns its path, or None when rate-limited.

        The rate limit is global (not per reason): an incident usually
        trips several triggers at once — the stall, then the epoch error,
        then the latency outliers — and ONE bundle captures them all."""
        now = time.monotonic()
        with self._lock:
            if (
                self.min_interval_s > 0
                and self.captured > 0
                and now - self._last_capture < self.min_interval_s
            ):
                self.suppressed += 1
                metrics.registry.counter(
                    "cake_blackbox_suppressed_total",
                    "Blackbox captures suppressed by the rate limit.",
                ).inc()
                return None
            self._seq += 1
            seq = self._seq
        bundle = {
            "schema": BUNDLE_SCHEMA,
            "captured_wall": round(time.time(), 6),
            "reason": reason,
            "request_id": request_id,
            "explain": explain,
            "timeline": timeline or [],
            "events": events or [],
        }
        if extra:
            bundle.update(extra)
        safe_reason = "".join(
            c if c.isalnum() or c in "-_" else "-" for c in reason
        )[:32]
        path = os.path.join(
            self.dir, f"{_PREFIX}{int(time.time())}-{seq:04d}-{safe_reason}.json"
        )
        try:
            with open(path, "w") as f:
                json.dump(bundle, f, separators=(",", ":"), default=str)
        except OSError:
            # A full disk must not take the engine down — and a FAILED
            # write must not consume the rate-limit slot: nothing landed,
            # so the next trigger deserves a fresh attempt.
            return None
        with self._lock:
            # Commit the rate-limit slot only once a bundle actually
            # exists on disk.
            self._last_capture = now
            self.captured += 1
        metrics.registry.counter(
            "cake_blackbox_bundles_total",
            "Diagnostic bundles captured (labelled by trigger reason).",
        ).inc(reason=safe_reason)
        metrics.flight.record(
            "blackbox-capture", request_id, reason=reason, path=path,
        )
        self._trim()
        return path

    def _trim(self) -> None:
        """Keep only the newest ``keep`` bundles (the on-disk ring bound)."""
        try:
            names = sorted(
                n for n in os.listdir(self.dir)
                if n.startswith(_PREFIX) and n.endswith(".json")
            )
        except OSError:
            return
        for n in names[: max(0, len(names) - self.keep)]:
            try:
                os.unlink(os.path.join(self.dir, n))
            except OSError:
                pass

    def bundles(self) -> list[str]:
        """Bundle paths, oldest first."""
        try:
            return [
                os.path.join(self.dir, n)
                for n in sorted(os.listdir(self.dir))
                if n.startswith(_PREFIX) and n.endswith(".json")
            ]
        except OSError:
            return []

    def stats(self) -> dict:
        with self._lock:
            return {
                "dir": self.dir,
                "keep": self.keep,
                "captured": self.captured,
                "suppressed": self.suppressed,
                "on_disk": len(self.bundles()),
            }


# ------------------------------------------------------------------ doctor


def load_bundle(path: str) -> dict:
    """Read one bundle file (or the NEWEST bundle of a directory)."""
    if os.path.isdir(path):
        names = sorted(
            n for n in os.listdir(path)
            if n.startswith(_PREFIX) and n.endswith(".json")
        )
        if not names:
            raise FileNotFoundError(f"no {_PREFIX}*.json bundles in {path}")
        path = os.path.join(path, names[-1])
    with open(path) as f:
        bundle = json.load(f)
    bundle.setdefault("_path", path)
    return bundle


def diagnose(bundle: dict) -> dict:
    """Name the likely cause of the captured anomaly.

    Precedence (pinned by tests/test_blackbox.py): a watchdog-stall or shed
    trigger IS the cause; otherwise the dominant attribution phase maps —
    queue -> queue, convoy/spec_wasted -> convoy, wire -> wire,
    stall -> stall, failover -> failover, everything compute-shaped
    (prefill/decode/spec_accepted/host) -> compute.
    """
    reason = str(bundle.get("reason", ""))
    exp = bundle.get("explain") or {}
    phases = exp.get("phases") or {}
    dom = exp.get("dominant") or (
        max(phases, key=lambda p: phases.get(p) or 0.0) if phases else None
    )
    if reason == "stall" or dom == "stall":
        # Only a stall TRIGGER or stall-dominated attribution blames the
        # watchdog — a few ms of stall residue on a convoy-dominated
        # request must not steer the operator at worker health.
        cause = "stall"
    elif reason == "shed":
        cause = "shed"
    elif reason == "failover" or dom == "failover":
        cause = "failover"
    elif dom in ("queue", "admission"):
        cause = "queue"
    elif dom in ("convoy", "spec_wasted"):
        cause = "convoy"
    elif dom == "wire":
        cause = "wire"
    elif dom in ("prefill", "decode", "spec_accepted", "prefix_fork",
                 "host", "other"):
        cause = "compute"
    else:
        cause = "unknown"
    out = {"cause": cause, "dominant": dom, "reason": reason}
    eff = bundle.get("efficiency") or {}
    if eff.get("bucket_frac"):
        # Utilization view (obs/efficiency.py ledger, captured with the
        # bundle): which WASTE bucket dominated the device while the
        # anomaly built. Additive — the latency cause above stays pinned;
        # bundles captured before the ledger existed diagnose unchanged.
        frac = eff["bucket_frac"]
        waste = {
            b: float(frac.get(b) or 0.0)
            for b in ("pad", "convoy", "spec_wasted", "host_gap", "stall",
                      "failover", "restore_prefill")
        }
        top = max(waste, key=waste.get)
        out["goodput_frac"] = float(eff.get("goodput_frac") or 0.0)
        if waste[top] >= 0.15:
            out["utilization"] = top
            out["utilization_frac"] = waste[top]
    return out


_HINTS = {
    "stall": "a backend dispatch made no progress within the watchdog "
    "bound (--epoch-stall); check worker/device health and the "
    "cake_epoch_stalls_total trend",
    "queue": "the request waited for a lane, not compute; raise capacity, "
    "lower --api-batch contention, or shed earlier (--shed-queue-depth)",
    "convoy": "the lockstep epoch taxed this request with co-batched "
    "streams' work (the ROADMAP's continuous-batching refactor target); "
    "see cake_convoy_seconds and /stats phases",
    "wire": "worker round trips dominate; check the per-node wire_nodes "
    "breakdown and the cluster RTT table in cake-tpu stats",
    "compute": "prefill/decode compute dominates; this is the kernel "
    "budget — see the bench ledger (BENCH_HISTORY.jsonl / benchdiff)",
    "shed": "admission refused the request (server saturation); see "
    "cake_shed_total and per-tenant /slo burn",
    "failover": "a live-stream migration carried (or failed) this "
    "request; see cake_failover_total and the router events",
    "unknown": "no attribution available; inspect the bundle's timeline "
    "slice and flight events directly",
}

# Hints for the utilization (device-waste) annotation — where the
# HARDWARE went while the anomaly built (obs/efficiency.py buckets).
_UTIL_HINTS = {
    "pad": "the device mostly computed padding / dead lanes; batch shapes "
    "are too tall for the live load — lower --decode-chunk, or let "
    "continuous mode join mid-flight",
    "convoy": "the device computed chunk tails past streams' needs (the "
    "lockstep tax); see /stats phases and --scheduler continuous",
    "spec_wasted": "rejected speculative drafts dominate; lower "
    "--speculative-k or check draft/model divergence",
    "host_gap": "the device sat idle between dispatches; host scheduling "
    "or sampling readback glue dominates — see cake-tpu top",
    "stall": "watchdog-abandoned dispatch wall dominates; check worker "
    "and device health",
    "failover": "migration re-prefills dominate; workers are flapping — "
    "see cake_failover_total",
    "restore_prefill": "preemption restore re-prefills dominate; page "
    "pressure is thrashing lanes — raise --max-pages or shed earlier",
}


def render_report(bundle: dict) -> str:
    """Human report for a bundle (the reference's ``doctor``) — deterministic from the bundle
    alone (the golden-snapshot test depends on that)."""
    d = diagnose(bundle)
    exp = bundle.get("explain") or {}
    phases = exp.get("phases") or {}
    lines = [
        "cake-tpu doctor report",
        f"  bundle:   {bundle.get('_path', '<memory>')}",
        f"  reason:   {bundle.get('reason', '?')}",
        f"  request:  {bundle.get('request_id') or '-'}",
        f"  cause:    {d['cause']}",
        f"  dominant: {d['dominant'] or '-'}",
    ]
    wall = exp.get("wall_s")
    if wall:
        lines.append(
            f"  wall:     {wall * 1e3:.2f} ms  "
            f"(convoy_frac {exp.get('convoy_frac', 0.0):.3f}, "
            f"coverage {exp.get('coverage', 0.0):.3f})"
        )
    if phases:
        lines.append("")
        lines.append(f"  {'phase':14} {'ms':>10}")
        from cake_tpu_torch.obs.critpath import PHASES

        for p in PHASES:
            v = float(phases.get(p, 0.0) or 0.0)
            if v > 0.0:
                lines.append(f"  {p:14} {v * 1e3:>10.2f}")
    eng = bundle.get("engine") or {}
    if eng:
        keys = (
            "batches", "rows", "joins", "shed", "stream_errors",
            "epoch_stalls", "deadline_expired", "page_truncations",
        )
        shown = "  ".join(f"{k}={eng[k]}" for k in keys if k in eng)
        if shown:
            lines.append("")
            lines.append(f"  engine: {shown}")
    pool = bundle.get("pool") or {}
    if pool:
        lines.append(
            f"  pool:   {pool.get('pages_free', '?')}/"
            f"{pool.get('pages_total', '?')} pages free"
        )
    if "goodput_frac" in d:
        # Only bundles captured with the efficiency ledger carry this —
        # older bundles (and the golden snapshot) render unchanged.
        util = d.get("utilization")
        line = f"  device: goodput_frac {d['goodput_frac']:.3f}"
        if util:
            line += (
                f", dominant waste {util} "
                f"({d.get('utilization_frac', 0.0):.3f})"
            )
        lines.append("")
        lines.append(line)
        if util:
            lines.append(f"  waste:  {_UTIL_HINTS.get(util, '')}")
    lines.append("")
    lines.append(f"  likely: {_HINTS.get(d['cause'], _HINTS['unknown'])}")
    return "\n".join(lines)
