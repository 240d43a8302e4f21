"""Goodput & hardware-efficiency ledger + scheduler decision audit (port of
``cake_tpu/obs/efficiency.py``).

The critical-path explainer (obs/critpath.py) answers "where did this
REQUEST's latency go"; this module answers "where did the HARDWARE go":
every second between the engine's first and last backend dispatch is
classified into exactly one bucket of the shared taxonomy
(obs/taxonomy.py BUCKETS), every emitted token into a goodput/waste
class, and an analytic FLOPs/HBM-bytes model per dispatch turns the
useful fraction into MFU / memory-bandwidth-utilization estimates
against device peaks. Paired with it, the :class:`DecisionAudit` ring
records a structured cause for every scheduler verdict — admit, defer,
preempt, spill, restore, shed — so ``GET /explain`` can answer "WHY
was this request queued/preempted", not just "how long".

Accounting invariant (pinned by tests/test_efficiency.py): the engine
thread calls one ``note_*`` per dispatch with the dispatch's measured
wall; the ledger derives the device-idle gap between consecutive
dispatches itself (``host_gap``), so the buckets ALWAYS sum to the
measured device wall — the obs-smoke gate checks ≥95% only to absorb
float rounding and the final in-flight dispatch.

Roofline model (README "Goodput & hardware efficiency"): per dispatch,
``FLOPs ≈ positions · 2 · P_active + 4 · L · d_attn · Σctx +
logit_positions · 2 · V · d_model`` and ``bytes ≈ passes · P_active ·
dtype + (Σctx + positions) · kv_bytes_per_slot`` — an ESTIMATE from the
model config, not a profile; expect ±20% against hardware counters
(attention masking, remat, and collective traffic are not modelled).
MFU/MBU are reported only when a peak is known: ``--peak-tflops`` /
``--peak-hbm-gbps`` override a built-in table keyed by
``torch.cuda.get_device_name()`` (one row: the H100 SXM's datasheet bf16
dense and HBM3 peaks); on the CPU (no card, no override) the snapshot
carries absolute achieved numbers only.

The walls the engine hands the ``note_*`` calls include the device work:
every dispatch it times ends in a host readback (the decode chunk's
tokens, a prefill's first sample) or an event wait on its stream.

Everything here is host-side arithmetic — a few float adds per dispatch
on numbers the engine already measured; no device work, no extra
dispatches.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from cake_tpu_torch.obs.taxonomy import (
    BUCKETS,
    DECISION_ACTIONS,
    DECISION_CAUSES,
    GOODPUT_BUCKETS,
    TOKEN_CLASSES,
)
from cake_tpu_torch.utils import metrics

# bf16 dense peaks per card, (TFLOP/s, HBM GB/s), matched by substring
# against the CUDA device name (most specific first). Datasheet numbers —
# the point is a stable denominator for A/Bs, not a lab-grade MFU. The
# H100 SXM5 (80 GB HBM3): 989.4 dense bf16 TFLOP/s, 3.35 TB/s.
_DEVICE_PEAKS: tuple[tuple[str, float, float], ...] = (
    ("h100 80gb hbm3", 989.4, 3350.0),
)


def device_peaks() -> tuple[float, float, str] | None:
    """(peak_tflops, peak_hbm_gbps, device name) for the current CUDA
    device, or None when there is none or the table has no entry for it."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        kind = torch.cuda.get_device_name()
    except Exception:  # noqa: BLE001 — no card = no peaks
        return None
    low = kind.lower()
    for sub, tf, bw in _DEVICE_PEAKS:
        if sub in low:
            return tf, bw, kind
    return None


def model_active_params(config) -> int:
    """Parameters touched per token (decoder stack only; embeddings and
    the LM head are costed separately at their own positions). MoE
    counts only the routed-active experts."""
    h = int(getattr(config, "hidden_size", 0))
    heads = int(getattr(config, "num_attention_heads", 1))
    kv_heads = int(getattr(config, "num_key_value_heads", heads))
    hd = int(getattr(config, "head_dim_override", None) or (h // max(1, heads)))
    inter = int(getattr(config, "intermediate_size", 0))
    layers = int(getattr(config, "num_hidden_layers", 0))
    attn = h * heads * hd + 2 * h * kv_heads * hd + heads * hd * h
    n_experts = int(getattr(config, "num_local_experts", 0) or 0)
    if n_experts:
        top_k = int(getattr(config, "num_experts_per_tok", 1) or 1)
        e_inter = int(getattr(config, "moe_intermediate_size", 0) or inter)
        mlp = top_k * 3 * h * e_inter + h * n_experts  # + router
    else:
        mlp = 3 * h * inter
    return layers * (attn + mlp)


def dispatch_flops(
    config, positions: int, ctx_sum: int, logit_positions: int = 0
) -> float:
    """Analytic FLOPs of one batched forward: ``positions`` token slots
    through the decoder (2 FLOPs per param per position), attention
    score+value over ``ctx_sum`` total key slots (4·d_attn each per
    layer), plus the LM-head matmul at ``logit_positions``."""
    h = int(getattr(config, "hidden_size", 0))
    heads = int(getattr(config, "num_attention_heads", 1))
    hd = int(getattr(config, "head_dim_override", None) or (h // max(1, heads)))
    layers = int(getattr(config, "num_hidden_layers", 0))
    vocab = int(getattr(config, "vocab_size", 0))
    return (
        2.0 * positions * model_active_params(config)
        + 4.0 * layers * heads * hd * float(ctx_sum)
        + 2.0 * logit_positions * vocab * h
    )


def dispatch_hbm_bytes(
    config, positions: int, ctx_sum: int, passes: int = 1,
    dtype_bytes: int = 2,
) -> float:
    """Analytic HBM traffic of one batched forward: the weight matrices
    stream once per sequential pass (a decode chunk of n steps = n
    passes; a prefill/verify window = 1), KV reads cover ``ctx_sum``
    total key slots, KV writes cover ``positions`` new slots."""
    h = int(getattr(config, "hidden_size", 0))
    heads = int(getattr(config, "num_attention_heads", 1))
    kv_heads = int(getattr(config, "num_key_value_heads", heads))
    hd = int(getattr(config, "head_dim_override", None) or (h // max(1, heads)))
    layers = int(getattr(config, "num_hidden_layers", 0))
    kv_slot = 2 * layers * kv_heads * hd * dtype_bytes  # k + v, one slot
    return (
        float(passes) * model_active_params(config) * dtype_bytes
        + float(ctx_sum + positions) * kv_slot
    )


class DecisionAudit:
    """Bounded ring of structured scheduler verdicts.

    Every admit/defer/preempt/spill/restore/shed decision the engine
    takes lands here as ``{t, action, cause, rid, tenant, detail}`` with
    the action/cause vocabulary pinned to obs/taxonomy.py (an unknown
    name raises — drift fails loudly, and the lint rule catches it
    statically). ``for_request`` answers "why was THIS request
    queued/preempted"; the counters ride
    ``cake_sched_decisions_total{action,cause}``.
    """

    def __init__(self, keep: int = 1024, time_fn=time.time):
        self._ring: deque[dict] = deque(maxlen=max(1, keep))
        self._lock = threading.Lock()
        self._time = time_fn
        self._counts: dict[tuple[str, str], int] = {}
        # Resolved once: record() runs on the scheduler's per-step path.
        self._metric = metrics.registry.counter(
            "cake_sched_decisions_total",
            "Scheduler decision-audit verdicts by action and structured "
            "cause (obs/taxonomy.py vocabulary).",
        )
        # A stuck verdict repeats every scheduler step (a request deferred
        # on page pressure, the engine-wide budget grant): the ring keeps
        # only the FIRST of a consecutive identical run — the counters
        # still count every occurrence — so per-request causes are never
        # evicted by a thousand identical lines.
        self._last: tuple | None = None

    def record(
        self, action: str, cause: str, rid: str = "", tenant: str = "",
        detail: str = "",
    ) -> None:
        if action not in DECISION_ACTIONS:
            raise ValueError(f"unknown decision action {action!r}")
        if cause not in DECISION_CAUSES:
            raise ValueError(f"unknown decision cause {cause!r}")
        key = (action, cause, rid, detail)
        entry = {
            "t": round(self._time(), 3), "action": action, "cause": cause,
            "rid": rid, "tenant": tenant, "detail": detail,
        }
        with self._lock:
            if key != self._last:
                self._ring.append(entry)
                self._last = key
            k = (action, cause)
            self._counts[k] = self._counts.get(k, 0) + 1
        self._metric.inc(action=action, cause=cause)

    def for_request(self, rid: str) -> list[dict]:
        with self._lock:
            return [e for e in self._ring if e["rid"] == rid]

    def snapshot(self, limit: int = 0) -> list[dict]:
        with self._lock:
            out = list(self._ring)
        return out[-limit:] if limit else out

    def counts(self) -> dict[str, int]:
        with self._lock:
            return {
                f"{a}:{c}": n for (a, c), n in sorted(self._counts.items())
            }


class EfficiencyLedger:
    """Per-step device-time + token-goodput accounting (engine thread
    writes, HTTP threads snapshot under one small lock)."""

    def __init__(
        self, config=None, peak_tflops: float = 0.0,
        peak_hbm_gbps: float = 0.0, time_fn=time.perf_counter,
        audit: DecisionAudit | None = None,
    ):
        self._config = config
        self._time = time_fn
        self._lock = threading.Lock()
        self.audit = audit if audit is not None else DecisionAudit()
        self.buckets: dict[str, float] = {b: 0.0 for b in BUCKETS}
        self.tokens: dict[str, int] = {c: 0 for c in TOKEN_CLASSES}
        self.tenants: dict[str, dict[str, int]] = {}
        self.flops_total = 0.0
        self.hbm_bytes_total = 0.0
        self.dispatches = 0
        self._t_first = 0.0
        self._t_last = 0.0
        # Resolved once: _add/note_finish run per dispatch on the engine
        # thread — the registry lookup must not ride the hot path.
        self._seconds_metric = metrics.registry.counter(
            "cake_device_seconds_total",
            "Device wall seconds by efficiency bucket (obs/taxonomy.py "
            "BUCKETS; host_gap = idle between dispatches).",
        )
        self._tokens_metric = metrics.registry.counter(
            "cake_goodput_tokens_total",
            "Emitted tokens by goodput class (completed = kept output; "
            "cancelled/deadline/error = wasted device work).",
        )
        if peak_tflops > 0 or peak_hbm_gbps > 0:
            self.peak_tflops = float(peak_tflops)
            self.peak_hbm_gbps = float(peak_hbm_gbps)
            self.peak_source = "flag"
        else:
            found = device_peaks()
            if found is not None:
                self.peak_tflops, self.peak_hbm_gbps, self.peak_source = found
            else:
                self.peak_tflops = self.peak_hbm_gbps = 0.0
                self.peak_source = "none"

    def reset(self) -> None:
        """Restart the accounting window. The bench warms engines up one
        round so jit compiles land outside its clocks — a reset after
        that round keeps the snapshot to steady state too (the first
        engine to compile would otherwise book multi-second compile
        walls as prefill/pad and skew the scheduler A/B). Prometheus
        counters are monotonic by contract and keep running."""
        with self._lock:
            self.buckets = {b: 0.0 for b in BUCKETS}
            self.tokens = {c: 0 for c in TOKEN_CLASSES}
            self.tenants = {}
            self.flops_total = 0.0
            self.hbm_bytes_total = 0.0
            self.dispatches = 0
            self._t_first = self._t_last = 0.0

    # ------------------------------------------------- dispatch accounting

    def _add(self, dt: float, splits: dict[str, float]) -> None:
        """Land one dispatch's wall into buckets (``splits`` fractions
        must cover 1.0) and advance the host-gap tracker."""
        if dt <= 0.0:
            return
        now = self._time()
        start = now - dt
        counter = self._seconds_metric
        with self._lock:
            if self._t_first == 0.0:
                self._t_first = start
            gap = start - self._t_last if self._t_last else 0.0
            if gap > 0.0:
                self.buckets["host_gap"] += gap
                counter.inc(gap, bucket="host_gap")
            self._t_last = max(self._t_last, now)
            self.dispatches += 1
            for bucket, frac in splits.items():
                if frac <= 0.0:
                    continue
                self.buckets[bucket] += dt * frac
                counter.inc(dt * frac, bucket=bucket)

    def _model(self, positions: int, ctx_sum: int, logit_positions: int,
               passes: int) -> None:
        if self._config is None:
            return
        with self._lock:
            self.flops_total += dispatch_flops(
                self._config, positions, ctx_sum, logit_positions
            )
            self.hbm_bytes_total += dispatch_hbm_bytes(
                self._config, positions, ctx_sum, passes
            )

    def note_prefill(
        self, dt: float, lanes: int, width: int, own_tokens: int,
        restore: bool = False,
    ) -> None:
        """A batched prefill window: ``lanes`` × ``width`` positions
        computed, ``own_tokens`` of them live prompt/history (the rest
        is left-padding + dummy lanes). ``restore=True`` books the live
        share as re-prefill (spill/restore redone work) instead of
        useful prefill."""
        total = max(1, lanes * width)
        own = min(1.0, own_tokens / total)
        self._add(dt, {
            "restore_prefill" if restore else "prefill": own,
            "pad": 1.0 - own,
        })
        # Causal window: position i attends ~i keys; Σctx ≈ width²/2.
        self._model(
            lanes * width, lanes * (width * width) // 2, lanes, passes=1
        )

    def note_decode(
        self, dt: float, lanes: int, n: int, live: int, consumed: int,
        slot: int = 0,
    ) -> None:
        """One decode chunk: ``lanes`` × ``n`` positions computed,
        ``live`` lanes carrying real streams which consumed ``consumed``
        tokens in total. Unconsumed live positions are convoy
        (EOS/budget mid-chunk); dead-lane positions are pad."""
        total = max(1, lanes * n)
        used = min(1.0, consumed / total)
        live_frac = min(1.0, (live * n) / total)
        self._add(dt, {
            "decode": used,
            "convoy": max(0.0, live_frac - used),
            "pad": 1.0 - live_frac,
        })
        self._model(
            lanes * n, lanes * n * (slot + n // 2), lanes * n, passes=n
        )

    def note_spec(
        self, dt: float, lanes: int, k: int, live: int, used: int,
        slot: int = 0,
    ) -> None:
        """One speculative verify round: ``lanes`` × ``k+1`` positions,
        ``used`` accepted into live streams; the rest of the live share
        is the wasted half of the speculative split."""
        width = k + 1
        total = max(1, lanes * width)
        acc = min(1.0, used / total)
        live_frac = min(1.0, (live * width) / total)
        self._add(dt, {
            "spec_accepted": acc,
            "spec_wasted": max(0.0, live_frac - acc),
            "pad": 1.0 - live_frac,
        })
        self._model(
            lanes * width, lanes * width * (slot + width // 2),
            lanes * width, passes=1,
        )

    def note_stall(self, dt: float) -> None:
        """Dispatch wall abandoned by the stuck-epoch watchdog."""
        self._add(dt, {"stall": 1.0})

    def note_failover(self, dt: float) -> None:
        """A live-stream migration's re-prefill wall (redone work)."""
        self._add(dt, {"failover": 1.0})

    # --------------------------------------------------- token accounting

    def note_finish(self, tenant: str, finish_reason: str, tokens: int) -> None:
        """Class every emitted token of a finished stream: ``stop`` /
        ``length`` finishes are goodput (``completed``); cancelled /
        deadline / error tokens were device work for output nobody kept.
        The per-tenant tallies are the attribution the SLO tracker's
        goodput SLI rides next to."""
        if tokens <= 0:
            return
        cls = (
            "completed" if finish_reason in ("stop", "length")
            else finish_reason if finish_reason in TOKEN_CLASSES
            else "error"
        )
        with self._lock:
            self.tokens[cls] += tokens
            t = self.tenants.setdefault(
                tenant, {"goodput_tokens": 0, "wasted_tokens": 0}
            )
            t["goodput_tokens" if cls == "completed" else "wasted_tokens"] += (
                tokens
            )
        self._tokens_metric.inc(tokens, **{"class": cls})

    # ------------------------------------------------------------- views

    def snapshot(self) -> dict:
        with self._lock:
            buckets = dict(self.buckets)
            tokens = dict(self.tokens)
            tenants = {t: dict(d) for t, d in self.tenants.items()}
            flops, hbm = self.flops_total, self.hbm_bytes_total
            dispatches = self.dispatches
            wall = max(0.0, self._t_last - self._t_first)
        accounted = sum(buckets.values())
        device_s = accounted - buckets["host_gap"]
        useful = sum(buckets[b] for b in GOODPUT_BUCKETS)
        goodput_tok = tokens["completed"]
        out = {
            "wall_s": round(wall, 6),
            "accounted_s": round(accounted, 6),
            "device_s": round(device_s, 6),
            "dispatches": dispatches,
            "buckets": {b: round(v, 6) for b, v in buckets.items()},
            "bucket_frac": {
                b: round(v / accounted, 4) if accounted else 0.0
                for b, v in buckets.items()
            },
            "goodput_frac": round(useful / accounted, 4) if accounted else 0.0,
            "tokens": tokens,
            "goodput_tokens": goodput_tok,
            "tenants": tenants,
            "decisions": self.audit.counts(),
        }
        model: dict = {
            "flops_total": round(flops, 1),
            "hbm_bytes_total": round(hbm, 1),
        }
        if device_s > 0:
            model["achieved_tflops"] = round(flops / device_s / 1e12, 4)
            model["achieved_hbm_gbps"] = round(hbm / device_s / 1e9, 4)
        out["model"] = model
        roof: dict = {"source": self.peak_source}
        if self.peak_source != "none":
            roof["peak_tflops"] = self.peak_tflops
            roof["peak_hbm_gbps"] = self.peak_hbm_gbps
            if device_s > 0 and self.peak_tflops > 0:
                roof["mfu"] = round(
                    flops / device_s / (self.peak_tflops * 1e12), 4
                )
            if device_s > 0 and self.peak_hbm_gbps > 0:
                roof["mbu"] = round(
                    hbm / device_s / (self.peak_hbm_gbps * 1e9), 4
                )
        out["roofline"] = roof
        return out

    def refresh_metrics(self) -> None:
        """Scrape-time gauges (the /metrics route calls this, mirroring
        SloTracker.refresh_metrics): snapshot-derived ratios that cannot
        ride monotonic counters."""
        snap = self.snapshot()
        metrics.registry.gauge(
            "cake_goodput_frac",
            "Useful fraction of accounted device wall "
            "(prefill + decode + spec_accepted over all buckets).",
        ).set(snap["goodput_frac"])
        mfu = snap["roofline"].get("mfu")
        if mfu is not None:
            metrics.registry.gauge(
                "cake_mfu",
                "Model FLOPs utilization estimate against the device "
                "peak (analytic roofline; ±20%).",
            ).set(mfu)
        mbu = snap["roofline"].get("mbu")
        if mbu is not None:
            metrics.registry.gauge(
                "cake_mbu",
                "HBM bandwidth utilization estimate against the device "
                "peak (analytic roofline; ±20%).",
            ).set(mbu)
