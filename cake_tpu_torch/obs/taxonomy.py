"""Shared observability name registries (the port's copy of
``cake_tpu/obs/taxonomy.py``, the one source of truth).

Three subsystems classify engine time and tokens — the critical-path
explainer (obs/critpath.py), the goodput/efficiency ledger
(obs/efficiency.py), and the scheduler decision audit — and all of their
names live HERE, as plain tuples, so a bucket renamed in one place cannot
silently diverge from the routes and tests that iterate the taxonomy.
The tuples equal the reference's (tests/test_torch_obs_modules.py).

Pure constants, stdlib only.
"""


from __future__ import annotations

# Per-request latency phases (obs/critpath.py; pinned by
# tests/test_critpath.py). Canonical rendering order.
PHASES = (
    "queue", "admission", "prefix_fork", "prefill", "decode",
    "spec_accepted", "spec_wasted", "convoy", "stall", "failover",
    "restore", "wire", "host", "other",
)

# Device-time buckets (obs/efficiency.py): every second between the
# engine's first and last backend dispatch lands in exactly one bucket,
# so the buckets always sum to the measured device wall.
#
#   * ``prefill``         — positions computed for a live lane's own
#     prompt (epoch-start, suffix, or join prefill).
#   * ``decode``          — decode-chunk positions a live stream consumed.
#   * ``spec_accepted``   — verify-round positions accepted into a stream.
#   * ``spec_wasted``     — verify-round positions computed but rejected
#     (drafts past the acceptance point, co-batched shape).
#   * ``pad``             — positions computed for prompt padding or
#     dead/dummy lanes (the lockstep width tax).
#   * ``convoy``          — decode positions computed for a live lane past
#     its own need (unconsumed chunk tails: EOS/budget mid-chunk).
#   * ``stall``           — dispatch wall abandoned by the stuck-epoch
#     watchdog (bounded by ``epoch_stall_s`` per stall).
#   * ``failover``        — live-stream migration re-prefills (redone work
#     a worker death cost the device).
#   * ``restore_prefill`` — a preempted lane's re-attach prefill (redone
#     work its spill cost; the price of continuous-mode preemption).
#   * ``host_gap``        — wall time between consecutive dispatches when
#     the device sat idle (scheduler bookkeeping, admission-window sleeps,
#     sampling readback glue).
BUCKETS = (
    "prefill", "decode", "spec_accepted", "spec_wasted", "pad", "convoy",
    "stall", "failover", "restore_prefill", "host_gap",
)

# The buckets that count as USEFUL device time: positions whose output a
# stream actually kept. goodput_frac = sum(GOODPUT_BUCKETS) / wall.
GOODPUT_BUCKETS = ("prefill", "decode", "spec_accepted")

# Generated-token classes (obs/efficiency.py): every emitted token,
# classed at stream finish. ``completed`` (stop/length finishes) is
# goodput; the rest is work the device did for output nobody kept.
TOKEN_CLASSES = ("completed", "cancelled", "deadline", "error")

# Scheduler decision-audit actions (what the scheduler did to a request).
DECISION_ACTIONS = (
    "admit", "join", "defer", "preempt", "spill", "restore", "shed",
    "expire", "budget",
)

# Structured causes for those actions (WHY): the bounded vocabulary
# ``GET /explain`` returns, and the label set of
# cake_sched_decisions_total.
DECISION_CAUSES = (
    "fair_order",        # taken in fair-queue (DRR) order
    "step_budget",       # over this step's prefill grant
    "page_pressure",     # pool could not fit the pages needed
    "knob_incompatible", # sampling knobs differ from the running group
    "cache_group",       # cache-aware ordering deferred (radix group)
    "fairness_skip",     # per-tenant FIFO / epoch-bounding stop
    "capacity",          # segment too short / prompt too tall to attach
    "queue_depth",       # shed: queue-depth gate
    "deadline_doomed",   # shed: estimated wait already exceeds deadline
    "deadline_expired",  # request passed its deadline (queued or running)
    "slo_feedback",      # step-budget grant scaled by SLO burn / slack
    "priority",          # preemption victim choice (lowest class spills)
)

# Canonical per-request completion record (obs/requestlog.py): the ONE
# field schema of the request log — the bounded ring behind GET /requests,
# the --request-log JSONL sink, and the loadgen replay trace format are
# all this tuple. A record written with any other key raises at runtime
# (RequestLog.record) and is flagged statically by the
# ``requestlog-field-drift`` lint rule (analysis/rules/obs.py) — the same
# accounting-invariant class as ``taxonomy-drift``. ``seq`` is stamped by
# the log itself (the /requests?since= cursor), never by callers.
REQUEST_LOG_FIELDS = (
    "seq",                # monotone record number (stamped by RequestLog)
    "t_wall",             # arrival wall-clock, unix seconds (replay gaps)
    "request_id",
    "tenant",
    "priority",           # 0 low / 1 normal / 2 high
    "prompt_tokens",
    "max_tokens",
    "completion_tokens",
    "queue_s",            # submit -> admission (0 for refusals)
    "admit_s",            # tokenize + quota + shed gate wall
    "ttft_s",             # submit -> first token (None: none emitted)
    "tpot_s",             # mean inter-token gap (None under 2 tokens)
    "wall_s",             # admission slice + submit -> close
    "finish_reason",      # REQUEST_OUTCOMES member
    "slo",                # REQUEST_SLO_VERDICTS member
    "phases",             # critpath digest: nonzero PHASES -> seconds
    "decisions",          # scheduler audit, compact "action:cause" list
    "node",               # routed backend node(s) serving the request
    "deadline_s",         # requested end-to-end deadline (None = none)
)

# Terminal outcomes a request record may carry: the stream finish taxonomy
# (runtime/serving.py StreamHandle.finish_reason) plus the two admission
# refusals — ``quota`` (HTTP 429, the caller's budget) and ``shed``
# (HTTP 503, server saturation) — so refused traffic is part of the
# replayable trace, not a hole in it.
REQUEST_OUTCOMES = (
    "stop", "length", "error", "cancelled", "deadline", "quota", "shed",
)

# Per-record SLO verdict (obs/requestlog.py derives it at finish from the
# declared objectives): ``none`` = nothing declared and no deadline to
# judge against; ``refused`` = never admitted (quota/shed).
REQUEST_SLO_VERDICTS = (
    "ok", "ttft_miss", "deadline_miss", "refused", "none",
)
