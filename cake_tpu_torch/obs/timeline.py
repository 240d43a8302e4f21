"""Span-tree timeline: structured profiling events -> Perfetto export (the
port's copy of ``cake_tpu/obs/timeline.py``).

This module answers "WHERE did this request's milliseconds go": a
contextvar-based span tree records begin/end events with parent ids, request ids, and attributes
into a bounded per-process ring, and the exporter renders Chrome trace-event
JSON (``ph: "B"/"E"/"X"`` slices, ``"s"/"f"`` flow arrows, ``"C"`` counter
tracks) loadable in Perfetto or ``chrome://tracing``.

Event model (one dict per ring entry, JSON-serializable end to end):

  * ``span(name)`` — lexically scoped spans become ONE ``"X"`` complete event
    at exit (begin timestamp + duration); nesting rides a contextvar, so the
    parent id is correct across threads and across ``yield`` points.
  * ``begin()/end()`` — non-lexical spans (a serving lane's request occupies
    the lane from admission to finish, across many scheduler iterations)
    become a ``"B"``/``"E"`` pair matched by span id.
  * ``instant()`` / ``counter()`` — point events and counter-track samples
    (HBM bytes-in-use, pool occupancy) on the same clock.
  * ``flow_start()/flow_end()`` — cross-node arrows: the master marks "s"
    when a FORWARD frame leaves, the worker marks "f" when it lands, linked
    by the flow id that rides the frame header — a cross-node request renders
    as one connected timeline.

Every event records BOTH clocks: ``wall`` (time.time — comparable across
processes, the export timestamp) and ``mono`` (perf_counter — drift-free
durations). Merging two nodes' exports needs only NTP-level wall agreement.

The ring is sized, not timed (newest ``capacity`` events win). Everything is
stdlib-only and thread-safe; a ``jsonl`` sink streams each event as one JSON
line for ``--trace-jsonl``.

Scheduler shapes (runtime/serving.py): the lockstep epoch roots its tree in
an ``epoch`` span; the continuous scheduler roots a ``segment`` span and
nests one ``step`` span per scheduler iteration (restores + budgeted joins),
with ``preempted``/``restored`` instants on the lane tracks — obs/critpath.py
attributes ``restore`` spans to their own phase.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Iterable

# Current innermost span: (timeline instance, span id). Context-local, so the
# engine thread, HTTP handler threads, and tests nest independently.
_CURRENT: contextvars.ContextVar[tuple["Timeline", int] | None] = (
    contextvars.ContextVar("cake_obs_span", default=None)
)

_ids = itertools.count(1)


def current_span_id() -> int | None:
    """Span id of the innermost open ``span()`` in this context (None when
    outside any span). utils/metrics.py stamps it onto flight events."""
    cur = _CURRENT.get()
    return cur[1] if cur is not None else None


def _clocks() -> tuple[float, float]:
    return time.time(), time.perf_counter()


class Timeline:
    """Bounded ring of profiling events + the Perfetto exporter over it."""

    def __init__(self, capacity: int = 8192, node: str = "local"):
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=int(capacity))
        self._jsonl_path: str | None = None
        self.node = node  # default pid label; per-event ``node=`` overrides

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    # ------------------------------------------------------------- recording

    def _record(self, ev: dict) -> dict:
        with self._lock:
            self._ring.append(ev)
            path = self._jsonl_path
        if path is not None:
            # Outside the lock (a slow disk must not serialize the engine);
            # whole-line appends interleave atomically on POSIX O_APPEND.
            try:
                with open(path, "a") as f:
                    f.write(json.dumps(ev, separators=(",", ":")) + "\n")
            except (OSError, TypeError, ValueError):
                pass
        return ev

    def _event(
        self,
        ph: str,
        name: str,
        *,
        sid: int | None = None,
        parent: int | None = None,
        rid: str | None = None,
        node: str | None = None,
        track: str | None = None,
        args: dict | None = None,
        wall: float | None = None,
        mono: float | None = None,
        dur: float | None = None,
        flow: int | None = None,
        tag: str | None = None,
    ) -> dict:
        if wall is None or mono is None:
            wall, mono = _clocks()
        ev: dict[str, Any] = {
            "ph": ph,
            "name": name,
            "wall": round(wall, 6),
            "mono": round(mono, 6),
        }
        if sid is not None:
            ev["id"] = sid
        if parent is not None:
            ev["parent"] = parent
        if rid is not None:
            ev["rid"] = rid
        if node is not None:
            ev["node"] = node
        if track is not None:
            ev["track"] = track
        if dur is not None:
            ev["dur"] = round(dur, 6)
        if flow is not None:
            ev["flow"] = flow
        if tag is not None:
            ev["tag"] = tag
        if args:
            ev["args"] = args
        return self._record(ev)

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        *,
        rid: str | None = None,
        node: str | None = None,
        track: str | None = None,
        args: dict | None = None,
    ):
        """Lexically scoped span -> one "X" complete event at exit. Yields the
        span id so the body can parent flight events / flow arrows to it."""
        sid = next(_ids)
        parent = current_span_id()
        wall, mono = _clocks()
        token = _CURRENT.set((self, sid))
        try:
            yield sid
        finally:
            _CURRENT.reset(token)
            self._event(
                "X", name, sid=sid, parent=parent, rid=rid, node=node,
                track=track, args=args, wall=wall, mono=mono,
                dur=time.perf_counter() - mono,
            )

    def begin(
        self,
        name: str,
        *,
        rid: str | None = None,
        node: str | None = None,
        track: str | None = None,
        args: dict | None = None,
        parent: int | None | str = "auto",
    ) -> int:
        """Open a non-lexical span ("B"); pair it with ``end(sid)``. The
        parent defaults to whatever span is current at BEGIN time; pass
        ``parent=None`` for a track-root span (e.g. a serving lane's request
        span, which outlives the engine spans that happen to be open when it
        is admitted — parenting it there would double-count their self time)."""
        sid = next(_ids)
        self._event(
            "B", name, sid=sid,
            parent=current_span_id() if parent == "auto" else parent,
            rid=rid, node=node, track=track, args=args,
        )
        return sid

    def end(self, sid: int, *, args: dict | None = None) -> None:
        """Close a ``begin()`` span. The name/track ride the B side; the
        exporter pairs by id. Unknown/evicted ids still record honestly (the
        exporter drops unpaired ends)."""
        self._event("E", "", sid=sid, args=args)

    def instant(self, name: str, **kw) -> None:
        self._event("i", name, **kw)

    def counter(
        self, name: str, values: dict[str, float], *,
        node: str | None = None, track: str | None = None,
        tag: str | None = None,
    ) -> None:
        """One sample on a counter track (rendered as a stacked area chart).

        ``args`` must stay numeric (Chrome counter values), so ``tag`` — the
        phase-boundary label — rides the raw ring/JSONL event instead; the
        rendered chart shows the series, the raw events say which phase
        sampled them."""
        self._event("C", name, node=node, track=track, args=dict(values),
                    tag=tag)

    def flow_start(self, flow_id: int, name: str, **kw) -> None:
        """Arrow tail: anchored at the current span/track at the call site."""
        self._event("s", name, flow=int(flow_id), **kw)

    def flow_end(self, flow_id: int, name: str, **kw) -> None:
        """Arrow head (binding point = enclosing slice, Chrome ``bp:"e"``)."""
        self._event("f", name, flow=int(flow_id), **kw)

    # ------------------------------------------------------------- sinks

    def attach_jsonl(self, path: str | None) -> None:
        """Stream every future event to ``path`` as one JSON line each
        (``--trace-jsonl``; None detaches)."""
        with self._lock:
            self._jsonl_path = path

    def snapshot(self, request_id: str | None = None) -> list[dict]:
        with self._lock:
            events = list(self._ring)
        if request_id is not None:
            keep_ids = {
                e["id"] for e in events
                if e.get("rid") == request_id and "id" in e
            }
            events = [
                e
                for e in events
                if e.get("rid") == request_id or e.get("id") in keep_ids
            ]
        return events

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # ------------------------------------------------------------- analysis

    def aggregate(self) -> dict[str, dict]:
        """Per-span-name {count, total_s, self_s} over the ring's CLOSED
        spans. Self time = a span's
        duration minus its direct children's (children evicted from the ring
        simply count as self time; the ring is a window, not an archive)."""
        spans = _closed_spans(self.snapshot())
        child_total: dict[int, float] = {}
        for s in spans.values():
            p = s.get("parent")
            if p is not None:
                child_total[p] = child_total.get(p, 0.0) + s["dur"]
        out: dict[str, dict] = {}
        for sid, s in spans.items():
            agg = out.setdefault(
                s["name"], {"count": 0, "total_s": 0.0, "self_s": 0.0}
            )
            agg["count"] += 1
            agg["total_s"] += s["dur"]
            agg["self_s"] += max(0.0, s["dur"] - child_total.get(sid, 0.0))
        for agg in out.values():
            agg["total_s"] = round(agg["total_s"], 6)
            agg["self_s"] = round(agg["self_s"], 6)
        return out

    def export(self, request_id: str | None = None) -> dict:
        """Chrome trace-event JSON for Perfetto / chrome://tracing."""
        return export_events(self.snapshot(request_id), default_node=self.node)


def _closed_spans(events: Iterable[dict]) -> dict[int, dict]:
    """Span id -> {name, parent, dur, ...} for X spans and CLOSED B/E pairs."""
    out: dict[int, dict] = {}
    opens: dict[int, dict] = {}
    for e in events:
        ph = e.get("ph")
        if ph == "X" and "id" in e:
            out[e["id"]] = {
                "name": e["name"], "parent": e.get("parent"),
                "dur": float(e.get("dur", 0.0)),
            }
        elif ph == "B" and "id" in e:
            opens[e["id"]] = e
        elif ph == "E" and e.get("id") in opens:
            b = opens.pop(e["id"])
            out[e["id"]] = {
                "name": b["name"], "parent": b.get("parent"),
                "dur": max(0.0, float(e["mono"]) - float(b["mono"])),
            }
    return out


# ------------------------------------------------------------------ exporter


def export_events(events: list[dict], default_node: str = "local") -> dict:
    """Render ring events as a Chrome trace-event dict.

    pid = node (one Perfetto process group per cluster node), tid = lane /
    stream / track. Timestamps are WALL microseconds so exports from several
    nodes concatenate into one timeline; durations come from the monotonic
    clock. Contract (pinned by tests/test_timeline.py): every emitted "B" has
    a matching "E" on the same pid/tid — open spans and eviction-orphaned
    ends are dropped, never half-emitted.
    """
    pids: dict[str, int] = {}
    tids: dict[tuple[int, str], int] = {}
    meta: list[dict] = []
    out: list[dict] = []

    def pid_of(node: str) -> int:
        if node not in pids:
            pids[node] = len(pids) + 1
            meta.append({
                "ph": "M", "name": "process_name", "pid": pids[node],
                "args": {"name": node},
            })
        return pids[node]

    def tid_of(pid: int, track: str) -> int:
        key = (pid, track)
        if key not in tids:
            tids[key] = len([k for k in tids if k[0] == pid]) + 1
            meta.append({
                "ph": "M", "name": "thread_name", "pid": pid,
                "tid": tids[key], "args": {"name": track},
            })
        return tids[key]

    # Pair B/E by span id first: the exporter only emits COMPLETE pairs.
    ends: dict[int, dict] = {
        e["id"]: e
        for e in events
        if e.get("ph") == "E" and e.get("id") is not None
    }

    for e in events:
        ph = e.get("ph")
        node = e.get("node") or default_node
        pid = pid_of(node)
        track = e.get("track") or "main"
        tid = tid_of(pid, track)
        ts = float(e["wall"]) * 1e6
        args = dict(e.get("args") or {})
        if e.get("rid"):
            args["request_id"] = e["rid"]
        if e.get("parent") is not None:
            args["parent_span"] = e["parent"]
        if e.get("id") is not None:
            args["span_id"] = e["id"]
        base = {"pid": pid, "tid": tid, "ts": round(ts, 3)}
        if ph == "X":
            out.append({
                "ph": "X", "name": e["name"], "cat": "cake",
                "dur": round(float(e.get("dur", 0.0)) * 1e6, 3),
                "args": args, **base,
            })
        elif ph == "B":
            end = ends.get(e.get("id"))
            if end is None:
                continue  # still open: emit nothing rather than a lone B
            out.append({
                "ph": "B", "name": e["name"], "cat": "cake",
                "args": args, **base,
            })
            e_args = dict(end.get("args") or {})
            out.append({
                "ph": "E", "name": e["name"], "cat": "cake",
                "pid": pid, "tid": tid,
                "ts": round(float(end["wall"]) * 1e6, 3),
                "args": e_args,
            })
        elif ph == "E":
            continue  # emitted with its B (orphans dropped)
        elif ph == "i":
            out.append({
                "ph": "i", "name": e["name"], "cat": "cake", "s": "t",
                "args": args, **base,
            })
        elif ph == "C":
            out.append({
                "ph": "C", "name": e["name"], "cat": "cake",
                "args": dict(e.get("args") or {}), **base,
            })
        elif ph in ("s", "f"):
            ev = {
                "ph": ph, "name": e["name"], "cat": "flow",
                "id": e.get("flow", 0), "args": args, **base,
            }
            if ph == "f":
                ev["bp"] = "e"  # bind to the enclosing slice
            out.append(ev)
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def validate_export(trace: dict) -> list[str]:
    """Schema checks over an exported trace; returns problems (empty = OK).

    Pinned contract: valid trace-event JSON, every "B" matched by an "E" on
    the same pid/tid (properly nested per track), flow "s"/"f" pairs that
    land inside real slices on their track.
    """
    problems: list[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    stacks: dict[tuple, list[tuple[str, float]]] = {}
    slices: dict[tuple, list[tuple[float, float]]] = {}
    flows: dict[tuple, list[str]] = {}
    flow_sites: list[tuple[tuple, float, Any, str]] = []
    for i, e in enumerate(events):
        if not isinstance(e, dict) or "ph" not in e or "name" not in e:
            problems.append(f"event {i} lacks ph/name: {e!r}")
            continue
        ph = e["ph"]
        if ph == "M":
            continue
        if "ts" not in e or not isinstance(e["ts"], (int, float)):
            problems.append(f"event {i} ({ph} {e['name']!r}) lacks numeric ts")
            continue
        key = (e.get("pid"), e.get("tid"))
        if ph == "X":
            if not isinstance(e.get("dur"), (int, float)) or e["dur"] < 0:
                problems.append(f"X event {e['name']!r} lacks dur >= 0")
            else:
                slices.setdefault(key, []).append(
                    (e["ts"], e["ts"] + e["dur"])
                )
        elif ph == "B":
            stacks.setdefault(key, []).append((e["name"], e["ts"]))
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                problems.append(
                    f"E {e['name']!r} on track {key} without an open B"
                )
            else:
                _, b_ts = stack.pop()
                slices.setdefault(key, []).append((b_ts, e["ts"]))
        elif ph in ("s", "f"):
            if "id" not in e:
                problems.append(f"flow event {e['name']!r} lacks an id")
                continue
            flows.setdefault((e["id"],), []).append(ph)
            flow_sites.append((key, e["ts"], e["id"], ph))
    for key, stack in stacks.items():
        for name, _ in stack:
            problems.append(f"B {name!r} on track {key} never closed by an E")
    for (fid,), phases in flows.items():
        if "s" not in phases:
            problems.append(f"flow {fid} has an 'f' but no 's'")
    # Flow arrows must land inside a real slice on their track ("flow events
    # reference existing spans"): an arrow anchored in empty space would
    # render detached (or not at all) in Perfetto.
    for key, ts, fid, ph in flow_sites:
        if not any(lo <= ts <= hi for lo, hi in slices.get(key, ())):
            problems.append(
                f"flow {ph} (id {fid}) at ts {ts} on track {key} lands in "
                "no slice"
            )
    return problems


def load_jsonl(path: str) -> list[dict]:
    """Read a ``--trace-jsonl`` stream back into ring-event dicts (malformed
    lines raise — the smoke gate WANTS to fail on a torn write)."""
    events: list[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


# Process-global instance: one timeline serves the whole runtime (tests may
# build private ones). Mirrors metrics.registry / trace.spans.
timeline = Timeline()
span = timeline.span
