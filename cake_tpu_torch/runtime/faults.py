"""Deterministic fault injection for the distributed serving stack (the
port's copy of ``cake_tpu/runtime/faults.py``).

The recovery machinery (the client's retry and replay, the worker's
sessions, the engine's failure isolation and failover in
runtime/{client,worker,serving}.py) is only trustworthy if failures can be
produced on demand, deterministically. A ``FaultPlan`` is a seeded list of
fault specs; the code calls ``faults.check(site, node=...)`` at a handful of
named checkpoints and acts on whatever spec fires. With no plan installed a
checkpoint is one ``is None`` test.

Checkpoint sites (grep for ``faults.check``):

  ``client.send``    before a FORWARD frame leaves StageClient.forward
                     (kinds: drop / delay / truncate / kill; kill tears the
                     client socket down before the send, and with
                     ``count=0`` and ``node=`` the worker stays unreachable,
                     the deterministic way to make replica failover happen)
  ``client.recv``    before the reply read (kind: delay)
  ``worker.op``      a worker op about to execute (kinds: stall / kill =
                     tear the connection down mid-op, the session survives /
                     crash = tear down AND drop every session, a process
                     death)
  ``worker.reply``   a computed reply about to be sent (drop / truncate: the
                     op applied but the reply is lost, the idempotent-replay
                     case)
  ``worker.ping``    a PING about to be answered (kind: stall, what a wedged
                     worker looks like to the heartbeat monitor)
  ``backend.prefill`` / ``backend.decode`` / ``backend.join``
                     an engine-side backend op about to dispatch (kinds:
                     stall / kill / crash = raise BackendWorkerError, a
                     worker's death as the engine sees it, on any backend)
  ``api.stream``     an SSE chunk about to be written (kind: stall, a
                     consumer that stopped reading)

Every fired fault shows three ways: the ``cake_faults_injected_total{kind,
site}`` counter, a ``fault-injected`` flight-recorder event and a timeline
instant on the ``faults`` track.

Plans come from three places, one grammar:

  * programmatic (tests): ``faults.install(FaultPlan([FaultSpec(...)], seed=7))``
  * the CLI: ``--faults 'kill@worker.op:after=5'``
  * the environment: ``CAKE_FAULTS='seed=7;drop@client.send:p=0.1;...'``

DSL: ``;``-separated entries; ``seed=N`` sets the plan seed; every other
entry is ``kind@site[:key=value]*`` with keys ``node`` (fnmatch pattern,
default any), ``after`` (skip the first N matching checkpoints), ``count``
(fire at most N times; 0 = unlimited), ``p`` (per-checkpoint probability,
decided by the plan's seeded ``random.Random``, drawn in the reference's
order, so a plan fires at the same checkpoints as the reference's),
``delay_s`` (sleep for delay/stall), ``frac`` (fraction of the frame kept
by truncate). With ``p=1`` a plan is a pure function of the checkpoint
order; with ``p<1`` of the checkpoint order and the seed.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import logging
import os
import random
import threading
import time

log = logging.getLogger("cake_tpu_torch.faults")

KINDS = ("drop", "delay", "truncate", "kill", "crash", "stall")


@dataclasses.dataclass
class FaultSpec:
    """One injectable fault: what (kind), where (site/node), when (after/
    count/p), and how hard (delay_s/frac)."""

    kind: str
    site: str                 # fnmatch pattern over checkpoint site labels
    node: str | None = None   # fnmatch pattern over node names; None = any
    after: int = 0            # skip the first `after` matching checkpoints
    count: int = 1            # fire at most `count` times; 0 = unlimited
    p: float = 1.0            # per-checkpoint probability (seeded RNG)
    delay_s: float = 0.05     # sleep length for delay/stall
    frac: float = 0.5         # fraction of the encoded frame truncate keeps
    seen: int = 0             # matching checkpoints observed (mutated)
    fired: int = 0            # times this spec actually fired (mutated)

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (have {KINDS})"
            )
        if not self.site:
            raise ValueError("fault site pattern must be non-empty")

    def matches(self, site: str, node: str | None) -> bool:
        if not fnmatch.fnmatchcase(site, self.site):
            return False
        if self.node is not None:
            return fnmatch.fnmatchcase(node or "", self.node)
        return True

    def describe(self) -> str:
        where = f"{self.site}" + (f":node={self.node}" if self.node else "")
        return f"{self.kind}@{where}"


class FaultPlan:
    """A seeded, ordered set of fault specs consulted at checkpoints.

    Thread-safe: checkpoints fire from engine/worker/handler threads; the
    lock serializes the seen/fired bookkeeping and the RNG draw so the
    decision sequence is reproducible for a given checkpoint order.
    """

    def __init__(self, specs: list[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def check(self, site: str, node: str | None = None) -> FaultSpec | None:
        """Return the first spec that fires at this checkpoint, else None.

        A spec consumes one "seen" tick per matching checkpoint whether or
        not it fires, so ``after=N`` means "the N+1th matching event".
        """
        with self._lock:
            for spec in self.specs:
                if not spec.matches(site, node):
                    continue
                spec.seen += 1
                if spec.seen <= spec.after:
                    continue
                if spec.count and spec.fired >= spec.count:
                    continue
                if spec.p < 1.0 and self._rng.random() >= spec.p:
                    continue
                spec.fired += 1
                self._record(spec, site, node)
                return spec
        return None

    @staticmethod
    def _record(spec: FaultSpec, site: str, node: str | None) -> None:
        """Every injected fault is a first-class observable event."""
        from cake_tpu_torch.obs.timeline import timeline
        from cake_tpu_torch.utils import metrics

        log.warning(
            "fault injected: %s at %s (node=%s, fired %d)",
            spec.kind, site, node, spec.fired,
        )
        metrics.registry.counter(
            "cake_faults_injected_total",
            "Faults fired by the active fault plan (runtime/faults.py).",
        ).inc(kind=spec.kind, site=site)
        metrics.flight.record(
            "fault-injected", kind=spec.kind, site=site,
            node=node or "", spec=spec.describe(),
        )
        timeline.instant(
            "fault", track="faults",
            args={"kind": spec.kind, "site": site, "node": node or ""},
        )


def parse(text: str) -> FaultPlan:
    """Parse the compact plan DSL (module docstring). Raises ValueError on
    malformed input — a chaos run with a typo'd plan must fail loudly, not
    run fault-free and "pass"."""
    specs: list[FaultSpec] = []
    seed = 0
    for raw in text.split(";"):
        entry = raw.strip()
        if not entry:
            continue
        if entry.startswith("seed="):
            seed = int(entry[len("seed="):])
            continue
        if "@" not in entry:
            raise ValueError(
                f"fault entry {entry!r} is not kind@site[:key=value]*"
            )
        kind, rest = entry.split("@", 1)
        parts = rest.split(":")
        site, kvs = parts[0], parts[1:]
        kw: dict[str, object] = {}
        for kv in kvs:
            if "=" not in kv:
                raise ValueError(f"fault option {kv!r} is not key=value")
            k, v = kv.split("=", 1)
            if k == "node":
                kw[k] = v
            elif k in ("after", "count"):
                kw[k] = int(v)
            elif k in ("p", "delay_s", "frac"):
                kw[k] = float(v)
            else:
                raise ValueError(f"unknown fault option {k!r} in {entry!r}")
        specs.append(FaultSpec(kind=kind.strip(), site=site.strip(), **kw))
    return FaultPlan(specs, seed=seed)


# ---------------------------------------------------------------- module API
#
# One process-global active plan. ``check`` is the hot-path entry: a single
# attribute test when no plan is installed.

_active: FaultPlan | None = None


def install(plan: FaultPlan | None) -> None:
    """Install (or clear, with None) the process-global fault plan."""
    global _active
    _active = plan


def clear() -> None:
    install(None)


def active() -> FaultPlan | None:
    return _active


def check(site: str, node: str | None = None) -> FaultSpec | None:
    """Consult the active plan at a checkpoint; None when no plan or no hit."""
    plan = _active
    if plan is None:
        return None
    return plan.check(site, node)


def sleep(spec: FaultSpec) -> None:
    """The delay/stall action (a helper so call sites stay one line)."""
    time.sleep(spec.delay_s)


def install_from_env() -> FaultPlan | None:
    """Install a plan from ``CAKE_FAULTS`` if set; returns it. Called once at
    import so `CAKE_FAULTS='...' cake-tpu --api ...` needs no code change."""
    text = os.environ.get("CAKE_FAULTS")
    if not text:
        return None
    plan = parse(text)
    install(plan)
    log.warning(
        "CAKE_FAULTS active: %d spec(s), seed=%d — this process will "
        "deliberately misbehave", len(plan.specs), plan.seed,
    )
    return plan


install_from_env()
