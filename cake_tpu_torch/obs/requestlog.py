"""Canonical per-request completion record (the port's copy of
``cake_tpu/obs/requestlog.py``).

Every request the engine terminates — any stream finish, a queued
cancel/expire, a stranded joiner, and the two admission refusals (quota
429 / shed 503) — lands here as ONE flat record whose field schema is
pinned in ``obs/taxonomy.py`` (``REQUEST_LOG_FIELDS``): tenant, priority,
token counts, the arrival/queue/TTFT/TPOT timing ladder, finish reason,
SLO verdict, the critical-path phase digest, the scheduler's decision
causes, and the routed node. Two surfaces share the one record:

  * a bounded in-memory ring, served at ``GET /requests`` (filterable by
    tenant / finish / since-cursor);
  * an optional JSONL sink (``--request-log PATH``) — the durable copy, in
    the reference's replay format (its ``loadgen --replay`` reads it).

Schema drift is refused: ``record()`` raises on a key outside the
registry. Stdlib only.
"""


from __future__ import annotations

import collections
import json
import threading
import time

from cake_tpu_torch.obs.taxonomy import (
    REQUEST_LOG_FIELDS,
    REQUEST_OUTCOMES,
    REQUEST_SLO_VERDICTS,
)

_FIELD_SET = frozenset(REQUEST_LOG_FIELDS)
_CALLER_REQUIRED = ("request_id", "tenant", "finish_reason")


class RequestLog:
    """Bounded ring + optional JSONL sink of request completion records."""

    def __init__(self, keep: int = 2048, time_fn=time.time):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self._ring: collections.deque = collections.deque(maxlen=keep)
        self._lock = threading.Lock()
        self._time = time_fn
        self._seq = 0
        self._jsonl_path: str | None = None

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    @property
    def last_seq(self) -> int:
        """Highest sequence number ever stamped (0 = nothing recorded):
        the ``since`` cursor for tail/follow consumers."""
        with self._lock:
            return self._seq

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def attach_jsonl(self, path: str | None) -> None:
        """Stream every future record to ``path`` as one JSON line (append
        mode — restarts extend the trace). None detaches (tests)."""
        with self._lock:
            self._jsonl_path = path or None

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._seq = 0

    def record(self, **fields) -> dict:
        """Append one completion record. Keys are validated against the
        ``REQUEST_LOG_FIELDS`` registry (obs/taxonomy.py) — an unknown
        field name raises, so the schema cannot drift silently; the
        ``requestlog-field-drift`` lint rule flags the same statically."""
        bad = set(fields) - _FIELD_SET
        if bad:
            raise ValueError(
                f"request-log field(s) {sorted(bad)} not in the "
                "obs/taxonomy.py REQUEST_LOG_FIELDS registry"
            )
        if "seq" in fields:
            raise ValueError("seq is stamped by the log, not callers")
        missing = [k for k in _CALLER_REQUIRED if not fields.get(k)]
        if missing:
            raise ValueError(f"request record missing {missing}")
        finish = fields["finish_reason"]
        if finish not in REQUEST_OUTCOMES:
            raise ValueError(
                f"finish_reason {finish!r} not in REQUEST_OUTCOMES"
            )
        verdict = fields.get("slo", "none")
        if verdict not in REQUEST_SLO_VERDICTS:
            raise ValueError(f"slo verdict {verdict!r} not in registry")
        rec = dict(fields)
        rec.setdefault("slo", "none")
        rec.setdefault("t_wall", round(self._time(), 3))
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)
            path = self._jsonl_path
        if path is not None:
            # Outside the lock (the FlightRecorder idiom): a slow disk must
            # not serialize finishing streams, and single-line O_APPEND
            # writes from multiple threads interleave whole lines on POSIX
            # so the trace stays parseable.
            try:
                with open(path, "a", encoding="utf-8") as f:
                    f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            except OSError:
                # A full disk must never take a finishing stream down; the
                # in-memory ring stays authoritative.
                with self._lock:
                    self._jsonl_path = None
        return rec

    def snapshot(
        self,
        tenant: str | None = None,
        finish: str | None = None,
        since: int | None = None,
        limit: int = 0,
    ) -> list[dict]:
        """Chronological copy of the ring, optionally filtered by tenant,
        finish_reason, and ``seq > since``; ``limit`` keeps the NEWEST N
        matches (0 = all)."""
        with self._lock:
            recs = list(self._ring)
        if tenant is not None:
            recs = [r for r in recs if r.get("tenant") == tenant]
        if finish is not None:
            recs = [r for r in recs if r.get("finish_reason") == finish]
        if since is not None:
            recs = [r for r in recs if r.get("seq", 0) > since]
        if limit > 0:
            recs = recs[-limit:]
        return recs

    def stats(self) -> dict:
        with self._lock:
            return {
                "count": len(self._ring),
                "capacity": self.capacity,
                "last_seq": self._seq,
                "jsonl": self._jsonl_path,
            }


def load_trace(path: str) -> list[dict]:
    """Read a ``--request-log`` JSONL capture back as records, oldest
    first by wall time — the loadgen replay input. Malformed lines are
    skipped (a crash mid-write leaves at most one), records missing the
    replay-critical fields are dropped."""
    records: list[dict] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(rec, dict):
                continue
            if not rec.get("request_id") or "t_wall" not in rec:
                continue
            records.append(rec)
    records.sort(key=lambda r: (r.get("t_wall", 0.0), r.get("seq", 0)))
    return records
