"""Health-driven replica routing for the TCP deployment (port of
``cake_tpu/runtime/router.py``).

The topology may declare several workers over the SAME layer range (replica
groups, parallel/topology.py ``replica_groups``); the router decides which
member serves each group for an epoch:

  * **round-robin among healthy**: ``refresh()`` (at epoch start:
    ``DistributedBatchBackend.init_kv`` / ``DistributedForwardStep.reset``)
    advances each group's cursor to the next healthy member. A route is
    STABLE within an epoch: the epoch's replay session lives on the routed
    worker.
  * **eject on failure**: ``report_failure``/``failover`` take a member out
    of rotation after a hop exhausted its retries on it; ``failover``
    re-picks the group's route at once and returns the replacement (None
    when no healthy member is left).
  * **standby rejoin**: an ejected member is eligible again once its
    ``cooldown_s`` has passed (and the heartbeat monitor, when one is
    attached, reports it healthy); ``report_success`` readmits it early.

The engine attaches its heartbeat monitor (runtime/client.py
``HeartbeatMonitor``) late, at its start (``attach_monitor``): with one, a
member the monitor sees down leaves the rotation at the next refresh and
rejoins only on a live heartbeat after its cooldown. A failover counts in
``cake_failover_total{node}`` (the FAILED node) with a ``failover`` flight
event and timeline instant; a rejoin in ``cake_replica_rejoin_total``, and
each epoch's routes in ``cake_replica_routed_total``. ``events`` keeps the
failover and rejoin records, ``routed`` the picks per node.
"""

from __future__ import annotations

import collections
import logging
import threading
import time

from cake_tpu_torch.obs.timeline import timeline
from cake_tpu_torch.utils import metrics

log = logging.getLogger("cake_tpu_torch.router")


class ReplicaRouter:
    """Per-epoch route selection over replica groups.

    ``groups`` maps each stage-plan primary to its ordered member list
    (primary first, ``Topology.replica_groups``). Single-member groups route
    trivially, so every deployment runs one code path. Thread-safe."""

    def __init__(self, groups: dict[str, list[str]], *, monitor=None, cooldown_s: float = 5.0):
        self.groups = {p: list(members) for p, members in groups.items()}
        for primary, members in self.groups.items():
            if primary not in members:
                raise ValueError(f"replica group for {primary!r} must contain it: {members}")
        self.monitor = monitor
        self.cooldown_s = cooldown_s
        self._lock = threading.Lock()
        self._rr = {p: 0 for p in self.groups}  # next-pick cursor per group
        self._routes = {p: members[0] for p, members in self.groups.items()}
        self._ejected: dict[str, float] = {}  # node -> monotonic eject time
        self.events: collections.deque = collections.deque(maxlen=256)
        self.routed: collections.Counter = collections.Counter()

    def attach_monitor(self, monitor) -> None:
        """Late-bind the heartbeat monitor (the engine builds it at start())."""
        self.monitor = monitor

    # ------------------------------------------------------------- health

    def healthy(self, node: str) -> bool:
        """Routable now: not under ejection probation, and not marked down
        by the heartbeat monitor."""
        with self._lock:
            ok, rejoined = self._healthy_locked(node)
        if rejoined:
            self._record("rejoin", node=node)
        return ok

    def _healthy_locked(self, node: str) -> tuple[bool, bool]:
        """(healthy, rejoined); clears an expired ejection."""
        if self.monitor is not None and not self.monitor.healthy(node):
            return False, False
        t0 = self._ejected.get(node)
        if t0 is None:
            return True, False
        if time.monotonic() - t0 < self.cooldown_s:
            return False, False
        del self._ejected[node]
        return True, True

    # ------------------------------------------------------------- routing

    def route(self, primary: str) -> str:
        """This epoch's member for ``primary``; unknown primaries route to
        themselves."""
        with self._lock:
            return self._routes.get(primary, primary)

    def refresh(self) -> dict[str, str]:
        """Epoch start: advance each group to its next healthy member and
        return the route map. A group with no healthy member keeps its
        previous route (the hop fails fast and the failure path decides)."""
        rejoins: list[str] = []
        with self._lock:
            for primary, members in self.groups.items():
                pick = self._pick_locked(primary, members, rejoins)
                if pick is not None:
                    self._routes[primary] = pick
            routes = dict(self._routes)
            self.routed.update(routes.values())
        for node in rejoins:
            self._record("rejoin", node=node)
        for node in routes.values():
            metrics.registry.counter(
                "cake_replica_routed_total",
                "Epoch routes handed out per worker by the replica router.",
            ).inc(node=node)
        return routes

    def _pick_locked(self, primary: str, members: list[str], rejoins: list[str]) -> str | None:
        start = self._rr[primary]
        for i in range(len(members)):
            node = members[(start + i) % len(members)]
            ok, rejoined = self._healthy_locked(node)
            if rejoined:
                rejoins.append(node)
            if ok:
                self._rr[primary] = (start + i + 1) % len(members)
                return node
        return None

    def prefer(self, node: str) -> None:
        """Pin the NEXT ``refresh`` pick of ``node``'s group to ``node``
        (subject to health)."""
        with self._lock:
            for primary, members in self.groups.items():
                if node in members:
                    self._rr[primary] = members.index(node)

    # ------------------------------------------------------------- failures

    def report_failure(self, node: str) -> None:
        """Eject a member after a hop exhausted its retries on it."""
        with self._lock:
            self._ejected[node] = time.monotonic()
        log.warning("replica %s ejected from rotation", node)

    def report_success(self, node: str) -> None:
        """A hop completed on ``node``: clear its probation early."""
        with self._lock:
            rejoined = self._ejected.pop(node, None) is not None
        if rejoined:
            self._record("rejoin", node=node)

    def failover(self, node: str) -> str | None:
        """Eject ``node`` and re-route every group it serves; the
        replacement in its own group, or None when no healthy member is
        left."""
        self.report_failure(node)
        replacement: str | None = None
        rejoins: list[str] = []
        with self._lock:
            for primary, members in self.groups.items():
                if node not in members:
                    continue
                pick = self._pick_locked(primary, members, rejoins)
                if pick is not None:
                    self._routes[primary] = pick
                    replacement = pick
        for n in rejoins:
            self._record("rejoin", node=n)
        if replacement is None or replacement == node:
            return None
        self._record("failover", node=node, to=replacement)
        return replacement

    def _record(self, event: str, **fields) -> None:
        self.events.append({"event": event, "t": time.time(), **fields})
        log.info("router %s %s", event, fields)
        if event == "failover":
            metrics.registry.counter(
                "cake_failover_total",
                "Failovers away from a worker (labelled by the FAILED node).",
            ).inc(node=fields["node"])
            metrics.flight.record("failover", node=fields["node"], to=fields["to"])
            timeline.instant("failover", track="router",
                             args={"from": fields["node"], "to": fields["to"]})
        else:
            metrics.registry.counter(
                "cake_replica_rejoin_total",
                "Ejected replicas readmitted to rotation (standby rejoin).",
            ).inc(node=fields["node"])
            metrics.flight.record("rejoin", node=fields["node"])
            timeline.instant("rejoin", track="router", args={"node": fields["node"]})

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "routes": dict(self._routes),
                "ejected": sorted(self._ejected),
                "groups": {p: list(m) for p, m in self.groups.items()},
            }
