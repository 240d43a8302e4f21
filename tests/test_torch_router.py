"""The port's replica router (``cake_tpu_torch/runtime/router.py``): the cases
of tests/test_router.py, with the router's own ``events`` and ``routed``
tally in place of the JAX package's metrics registry (not ported). Round
robin among healthy members per refresh, ejection with ``failover``
re-picking the group at once (None when no healthy member is left), standby
rejoin after the cooldown (gated on a monitor when one is attached), and
``prefer`` pinning the next pick."""

import time

import pytest

from cake_tpu_torch.runtime.router import ReplicaRouter


def two_member_router(**kw):
    return ReplicaRouter({"w0": ["w0", "w0b"]}, **kw)


def test_round_robin_among_members():
    r = two_member_router()
    picks = [r.refresh()["w0"] for _ in range(4)]
    assert picks == ["w0", "w0b", "w0", "w0b"]
    assert r.route("w0") == "w0b"  # stable between refreshes


def test_route_unknown_primary_is_identity():
    assert two_member_router().route("not-a-primary") == "not-a-primary"


def test_group_must_contain_primary():
    with pytest.raises(ValueError):
        ReplicaRouter({"w0": ["w1", "w2"]})


def test_failover_ejects_and_repicks():
    r = two_member_router()
    assert r.refresh()["w0"] == "w0"
    assert r.failover("w0") == "w0b"
    assert r.route("w0") == "w0b"
    assert r.snapshot()["ejected"] == ["w0"]
    assert any(e["event"] == "failover" and e["node"] == "w0" and e["to"] == "w0b"
               for e in r.events)
    assert r.refresh()["w0"] == "w0b"  # ejected members sit out later refreshes


def test_failover_with_no_healthy_member_returns_none():
    r = two_member_router()
    assert r.failover("w0") == "w0b"
    assert r.failover("w0b") is None
    assert ReplicaRouter({"w0": ["w0"]}).failover("w0") is None


def test_cooldown_rejoin_emits_event():
    r = two_member_router(cooldown_s=0.01)
    r.prefer("w0")
    assert r.failover("w0") == "w0b"
    time.sleep(0.02)
    r.prefer("w0")
    assert r.refresh()["w0"] == "w0"
    assert r.snapshot()["ejected"] == []
    assert [e["node"] for e in r.events if e["event"] == "rejoin"] == ["w0"]


def test_monitor_gates_rotation_and_rejoin():
    class FakeMonitor:
        def __init__(self):
            self.down: set[str] = set()

        def healthy(self, node):
            return node not in self.down

    mon = FakeMonitor()
    r = two_member_router(cooldown_s=0.0, monitor=mon)
    mon.down.add("w0")
    assert [r.refresh()["w0"] for _ in range(3)] == ["w0b"] * 3
    r.report_failure("w0b")
    assert r.failover("w0b") is None
    mon.down.clear()
    r.prefer("w0")
    assert r.refresh()["w0"] == "w0"


def test_report_success_clears_probation_early():
    r = two_member_router(cooldown_s=60.0)
    r.report_failure("w0")
    r.prefer("w0")
    assert r.refresh()["w0"] == "w0b"
    r.report_success("w0")
    r.prefer("w0")
    assert r.refresh()["w0"] == "w0"


def test_routed_tally_moves_per_refresh():
    r = two_member_router()
    before = r.routed["w0"]
    r.prefer("w0")
    r.refresh()
    assert r.routed["w0"] == before + 1
    assert r.snapshot()["groups"] == {"w0": ["w0", "w0b"]}
