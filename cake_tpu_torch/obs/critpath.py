"""Per-request critical-path attribution over the timeline span tree (the
port's copy of ``cake_tpu/obs/critpath.py``, over the port's timeline).

The timeline records span trees and lane tracks; "where did this request's
1.3 seconds go?" would still mean opening Perfetto. This module answers it as a
pure function over ring events (``Timeline.snapshot()`` or a
``--trace-jsonl`` file read back with ``load_jsonl``): decompose one
request's end-to-end latency into a canonical phase taxonomy, name the
dominant phase, and measure the **epoch convoy** — the lockstep tax the
ROADMAP's continuous-batching refactor must beat in an honest A/B.

Phase taxonomy (the documented contract; pinned by tests/test_critpath.py):

  * ``queue``        — submit to lane (fair-queue wait + admission window),
    from the ``queue_wait_s`` the engine stamps on the request span — PLUS
    a preempted lane's parked gaps: a spilled request closes its lane span
    and opens a fresh one at the restore, and the time between its request
    spans is capacity wait, attributed here (all of a rid's spans merge
    into one explanation; only the live intervals carry engine-span
    attribution).
  * ``admission``    — tokenize + quota/shed gate time inside ``submit()``
    (``admit_s``; t_submit is stamped after it, so this slice ADDS to the
    wall rather than carving into queue).
  * ``prefix_fork``  — prefix-cache chain fork + CoW split (the
    ``prefix-fork`` spans nested in prefill/join).
  * ``prefill``      — the request's OWN share of the epoch prefill (or its
    join prefill): epoch prefill compute covers the shared left-padded
    bucket, so a lane's own share is ``dur * prompt / bucket`` and the
    rest is convoy.
  * ``decode``       — the request's OWN share of each decode chunk it was
    live for: a chunk computes ``n`` tokens for every lane, the request
    consumed ``min(tokens_remaining, n)`` of them; the rest is convoy.
  * ``spec_accepted`` / ``spec_wasted`` — speculative verify rounds split
    by the round's cross-row accepted advance ``a``: the request's
    accepted share is ``dur * min(remaining, a) / (k + 1)``; the rest of
    the round (rejected drafts + co-batched rows' shape) is wasted.
  * ``convoy``       — time the lane sat computing co-batched streams' work
    the request did not need (prefill padding + unconsumed chunk/spec
    fractions). ``convoy_frac = convoy / wall`` is the headline lockstep
    tax: short requests co-batched with long ones show the higher value.
  * ``stall``        — stuck-epoch watchdog waits (``epoch-stall``
    instants), subtracted from the dispatch span they fired inside.
  * ``failover``     — live-stream migration (``failover-migrate`` spans).
  * ``restore``      — a preempted lane's re-attach prefill (``restore``
    spans, continuous scheduler): the redone work its spill cost it.
    Another request's restore in the shared segment is this lane's convoy.
  * ``wire``         — master-side worker round trips (``wire.<node>``
    spans, nested inside dispatches on TCP backends); subtracted from the
    enclosing compute attribution so nothing double-counts, and broken
    down per node in ``wire_nodes`` (merged cluster event lists work here
    too once their clocks are aligned).
  * ``host``         — time inside the request span covered by NO engine
    span: scheduler bookkeeping, detokenization, readback glue. Measured
    as the complement, so the decomposition always sums to the wall.
  * ``other``        — the queue-side residual when the stamps disagree
    (normally ~0).

Everything is stdlib-only and side-effect free; the serving engine keeps
its own cheap live accounting for the aggregate ``cake_phase_seconds`` /
``cake_convoy_seconds`` metrics (runtime/serving.py), while this module
serves ``GET /explain`` and the blackbox bundles.
"""

from __future__ import annotations

from typing import Iterable

# Canonical phase order (rendering + tests iterate this, so the taxonomy
# is a tuple, not a convention). The names live in the shared registry
# (obs/taxonomy.py) next to the efficiency buckets — the taxonomy-drift
# lint rule pins every literal to it; re-exported here for the existing
# importers (blackbox, tests).
from cake_tpu_torch.obs.taxonomy import PHASES  # noqa: E402


# Spans whose interval belongs to the engine's dispatch timeline; anything
# inside the request span not covered by an attribution lands in "host".
# The continuous scheduler's per-iteration ``step`` spans (and its
# ``segment`` root replacing the epoch span) are CONTAINERS, not dispatch
# time — the dispatches below nest inside them, so listing them here would
# double-count.
_ENGINE_SPANS = {
    "prefill", "join", "decode-chunk", "spec-round", "failover-migrate",
    "prefix-fork", "restore",
}


def _closed_spans(events: Iterable[dict]) -> list[dict]:
    """Flatten ring events into closed spans with [t0, t1) mono intervals."""
    out: list[dict] = []
    opens: dict[int, dict] = {}
    for e in events:
        ph = e.get("ph")
        if ph == "X":
            t0 = float(e.get("mono", 0.0))
            out.append({
                "name": e.get("name", ""), "rid": e.get("rid"),
                "t0": t0, "t1": t0 + float(e.get("dur", 0.0)),
                "args": e.get("args") or {}, "track": e.get("track"),
            })
        elif ph == "B" and "id" in e:
            opens[e["id"]] = e
        elif ph == "E" and e.get("id") in opens:
            b = opens.pop(e["id"])
            out.append({
                "name": b.get("name", ""), "rid": b.get("rid"),
                "t0": float(b.get("mono", 0.0)),
                "t1": float(e.get("mono", 0.0)),
                "args": {**(b.get("args") or {}), **(e.get("args") or {})},
                "track": b.get("track"),
            })
    return out


def _overlap(lo: float, hi: float, t0: float, t1: float) -> float:
    return max(0.0, min(hi, t1) - max(lo, t0))


def request_ids(events: Iterable[dict]) -> list[str]:
    """Request ids with a lane-track ``request`` span in the event list,
    oldest first (the ids ``explain`` can decompose)."""
    seen: dict[str, None] = {}
    for e in events:
        if (
            e.get("ph") in ("B", "X")
            and e.get("name") == "request"
            and e.get("rid")
        ):
            seen.setdefault(e["rid"], None)
    return list(seen)


def explain(events: list[dict], request_id: str) -> dict | None:
    """Decompose one request's end-to-end latency into PHASES.

    ``events`` is a timeline ring snapshot (or a loaded ``--trace-jsonl``
    stream); returns None when the request has no ``request`` span in it
    (evicted, shed before admission, or never existed). A request whose
    span is still open is explained up to the newest event and flagged
    ``in_flight``.
    """
    spans = _closed_spans(events)
    # A preempted request closes its lane span at the spill and opens a
    # fresh one at the restore, so one rid may own SEVERAL request spans.
    # They ALL belong to the explanation: the live intervals carry the
    # engine-span attribution, and the parked gaps between them (the lane
    # waiting for capacity again) are queue time — dropping the pre-spill
    # spans would hide exactly the latency preemption caused.
    req_spans = [
        s for s in spans
        if s["name"] == "request" and s["rid"] == request_id
    ]
    in_flight = False
    # Still-open span (B without E): a request mid-flight — possibly a
    # restored lane still decoding after an earlier closed pre-spill span.
    closed_ids = {e.get("id") for e in events if e.get("ph") == "E"}
    open_bs = [
        e for e in events
        if e.get("ph") == "B"
        and e.get("name") == "request"
        and e.get("rid") == request_id
        and e.get("id") not in closed_ids
    ]
    if open_bs:
        t_end = max(
            (float(ev.get("mono", 0.0)) for ev in events),
            default=float(open_bs[0].get("mono", 0.0)),
        )
        for e in open_bs:
            req_spans.append({
                "name": "request", "rid": request_id,
                "t0": float(e.get("mono", 0.0)), "t1": t_end,
                "args": e.get("args") or {}, "track": e.get("track"),
            })
        in_flight = True
    if not req_spans:
        return None
    req_spans.sort(key=lambda s: s["t0"])
    ivs = [(s["t0"], s["t1"]) for s in req_spans]
    b, e_ = ivs[0][0], ivs[-1][1]
    # The merged args: finish/completion from the FINAL span; the
    # queue/admission stamps from the FIRST (the original admission — a
    # restore's span re-stamps them relative to its own open).
    args: dict = {}
    for s in req_spans:
        args.update(s["args"])
    first_args = req_spans[0]["args"]
    # Live lane time vs parked time: span_s is what the engine-span walk
    # can cover (the host complement's denominator); the parked gaps are
    # queue-shaped waits.
    span_s = max(0.0, sum(t1 - t0 for t0, t1 in ivs))
    parked = max(0.0, (e_ - b) - span_s)

    def _live_ov(t0: float, t1: float) -> float:
        return sum(_overlap(a, z, t0, t1) for a, z in ivs)

    # The engine stamps t_submit AFTER submit()'s tokenize/quota/shed
    # work: queue_wait_s already excludes the admission slice, so
    # admission ADDS to the wall instead of carving into queue.
    queue_wait = float(first_args.get("queue_wait_s", 0.0) or 0.0)
    admit_s = float(first_args.get("admit_s", 0.0) or 0.0)
    prompt_tokens = int(args.get("prompt_tokens", 0) or 0)
    completion = int(args.get("completion_tokens", 0) or 0)
    is_join = "join_slot" in first_args

    phases = {p: 0.0 for p in PHASES}
    phases["queue"] = queue_wait + parked
    phases["admission"] = admit_s
    wire_nodes: dict[str, float] = {}

    # Stuck-epoch stalls: point instants carrying the abandoned wait; the
    # wait happened INSIDE the dispatch span it fired in, so that span's
    # effective duration shrinks by it before the own/convoy split.
    stall_marks = [
        (float(ev.get("mono", 0.0)), float(
            (ev.get("args") or {}).get("stall_s", 0.0) or 0.0
        ))
        for ev in events
        if ev.get("ph") == "i" and ev.get("name") == "epoch-stall"
        and any(a <= float(ev.get("mono", 0.0)) <= z for a, z in ivs)
    ]

    def stall_inside(t0: float, t1: float) -> float:
        return sum(s for (tm, s) in stall_marks if t0 <= tm <= t1)

    # Wire round trips (``wire.<node>`` — nested inside dispatch spans on
    # TCP backends): their own phase with a per-node breakdown, and pulled
    # back out of whatever dispatch span they nest in so nothing counts
    # twice. Clock alignment is the merger's: merged cluster event
    # lists explain the same way.
    wire_spans = []
    for s in spans:
        if not s["name"].startswith("wire."):
            continue
        ov = _live_ov(s["t0"], s["t1"])
        if ov <= 0.0:
            continue
        wire_spans.append(s)
        phases["wire"] += ov
        node = s["name"][len("wire."):] or "?"
        wire_nodes[node] = wire_nodes.get(node, 0.0) + ov

    def wire_inside(t0: float, t1: float) -> float:
        return sum(
            _overlap(t0, t1, w["t0"], w["t1"]) for w in wire_spans
        )

    # Prefix-cache fork spans nest inside prefill ("lanes" in args — the
    # epoch-layout pass) or inside some request's join ("lane" in args).
    # They attribute RELATIVE to this request: the epoch fork is shared
    # epoch work (own share 1/lanes, rest convoy), this request's own
    # join fork is all its own, and ANOTHER request's join fork is just
    # part of that join's convoy — never this request's prefix_fork.
    fork_spans = [
        s for s in spans if s["name"] == "prefix-fork"
        and _live_ov(s["t0"], s["t1"]) > 0.0
    ]

    def fork_inside(t0: float, t1: float) -> float:
        return sum(
            _overlap(t0, t1, f["t0"], f["t1"]) for f in fork_spans
        )

    # Chronological walk of the engine spans the request was live for.
    work = sorted(
        (s for s in spans if s["name"] in _ENGINE_SPANS
         and s["name"] != "prefix-fork"
         and _live_ov(s["t0"], s["t1"]) > 0.0),
        key=lambda s: s["t0"],
    )
    # Tokens still owed after the prefill's first sample.
    rem = max(0, completion - 1)

    def _eff(s, ov, forks=0.0):
        """Dispatch-span time net of the stalls, wire hops, and fork
        passes inside it (each attributed to its own phase)."""
        st = min(stall_inside(s["t0"], s["t1"]), ov)
        phases["stall"] += st
        return max(0.0, ov - st - wire_inside(s["t0"], s["t1"]) - forks)

    for s in work:
        ov = _live_ov(s["t0"], s["t1"])
        name = s["name"]
        if name == "failover-migrate":
            phases["failover"] += max(
                0.0, ov - wire_inside(s["t0"], s["t1"])
            )
        elif name == "prefill":
            if is_join:
                continue  # an epoch prefill from before this join's lane
            fov = fork_inside(s["t0"], s["t1"])
            eff = _eff(s, ov, forks=fov)
            bucket = max(1, int((s["args"] or {}).get("bucket", 0) or 1))
            share = min(1.0, prompt_tokens / bucket) if prompt_tokens else 1.0
            phases["prefill"] += eff * share
            phases["convoy"] += eff * (1.0 - share)
            # The epoch-layout fork forks EVERY lane's chain: this
            # request's share is one lane's worth, the rest is convoy.
            lanes = max(1, int((s["args"] or {}).get("lanes", 1) or 1))
            phases["prefix_fork"] += fov / lanes
            phases["convoy"] += fov * (1.0 - 1.0 / lanes)
        elif name == "join":
            fov = fork_inside(s["t0"], s["t1"])
            if s["rid"] != request_id:
                # Another request joining the shared epoch: this lane sat
                # out its prefill — lockstep tax, fork included.
                phases["convoy"] += _eff(s, ov, forks=fov) + fov
                continue
            phases["prefill"] += _eff(s, ov, forks=fov)
            phases["prefix_fork"] += fov
        elif name == "restore":
            fov = fork_inside(s["t0"], s["t1"])
            if s["rid"] != request_id:
                # Another preempted lane re-attaching to the shared
                # segment: this lane rode along — convoy.
                phases["convoy"] += _eff(s, ov, forks=fov) + fov
                continue
            # This request's own re-attach prefill: the price its
            # preemption cost it, fork pass included.
            phases["restore"] += _eff(s, ov, forks=fov) + fov
        elif name == "decode-chunk":
            eff = _eff(s, ov)
            n = max(1, int((s["args"] or {}).get("n", 1) or 1))
            used = min(rem, n)
            rem -= used
            phases["decode"] += eff * (used / n)
            phases["convoy"] += eff * (1.0 - used / n)
        elif name == "spec-round":
            eff = _eff(s, ov)
            a = int((s["args"] or {}).get("accepted", 0) or 0)
            k = max(0, int((s["args"] or {}).get("k", 0) or 0))
            used = min(rem, a)
            rem -= used
            acc = eff * (used / (k + 1))
            phases["spec_accepted"] += acc
            phases["spec_wasted"] += eff - acc

    attributed = sum(
        phases[p] for p in PHASES if p not in ("queue", "admission", "host",
                                               "other")
    )
    phases["host"] = max(0.0, span_s - attributed)
    # Wall covers first-open to last-close: live lane time PLUS the parked
    # preemption gaps (already folded into the queue phase above).
    wall = admit_s + queue_wait + span_s + parked
    phases["other"] = max(0.0, wall - sum(
        phases[p] for p in PHASES if p != "other"
    ))
    phases = {p: round(v, 6) for p, v in phases.items()}
    named = sum(v for p, v in phases.items() if p not in ("host", "other"))
    out = {
        "request_id": request_id,
        "in_flight": in_flight,
        # The phases partition the wall: reported as the sum of the rounded
        # phases, so they add up to it exactly (round(wall, 6) differs from
        # that sum by up to a rounding step a phase).
        "wall_s": round(sum(phases.values()), 6),
        "span_s": round(span_s, 6),
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion,
        "finish_reason": args.get("finish_reason"),
        "phases": phases,
        "dominant": dominant(phases),
        "convoy_frac": round(phases["convoy"] / wall, 4) if wall > 0 else 0.0,
        # How much of the wall the NAMED phases (everything except the
        # host/other complements) explain — the >= 0.95 acceptance gate.
        "coverage": round(named / wall, 4) if wall > 0 else 0.0,
    }
    if wire_nodes:
        out["wire_nodes"] = {n: round(v, 6) for n, v in wire_nodes.items()}
    return out


def explain_all(events: list[dict]) -> list[dict]:
    """``explain`` for every request id in the event list (oldest first) —
    an offline sweep over a ``--trace-jsonl`` stream."""
    out = []
    for rid in request_ids(events):
        res = explain(events, rid)
        if res is not None:
            out.append(res)
    return out


def dominant(phases: dict) -> str:
    """Largest phase by seconds (host/other lose ties to named phases)."""
    best, best_v = "host", -1.0
    for p in PHASES:
        v = float(phases.get(p, 0.0) or 0.0)
        bonus = 0 if p in ("host", "other") else 1e-12
        if v + bonus > best_v:
            best, best_v = p, v + bonus
    return best


def render(res: dict) -> str:
    """Terminal table for one explained request."""
    lines = [
        f"request {res['request_id']}"
        + ("  [in flight]" if res.get("in_flight") else ""),
        f"  wall {res['wall_s'] * 1e3:.2f} ms  "
        f"(prompt {res.get('prompt_tokens', 0)} tok, "
        f"completion {res.get('completion_tokens', 0)} tok, "
        f"finish {res.get('finish_reason') or '?'})",
        f"  dominant phase: {res['dominant']}   "
        f"convoy_frac {res['convoy_frac']:.3f}   "
        f"coverage {res['coverage']:.3f}",
        "",
        f"  {'phase':14} {'ms':>10} {'share':>7}",
    ]
    wall = res["wall_s"] or 1.0
    for p in PHASES:
        v = float(res["phases"].get(p, 0.0) or 0.0)
        if v <= 0.0:
            continue
        lines.append(f"  {p:14} {v * 1e3:>10.2f} {v / wall * 100:>6.1f}%")
    for node, v in sorted(res.get("wire_nodes", {}).items()):
        lines.append(f"    wire.{node:9} {v * 1e3:>10.2f}")
    return "\n".join(lines)
