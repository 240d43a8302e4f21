"""The port's admission classes (``cake_tpu_torch/runtime/admission.py``)
against the JAX package's (``cake_tpu/runtime/admission.py``) on the CPU.

``TokenBucket``, ``TenantMeter``, ``FairQueue`` and ``WaitEstimator`` each
receive the same hypothesis-generated operation sequence as the reference
class, on an injected clock, and must answer the same: grants and waits,
refusals with their kind and ``retry_after_s``, ``take`` order under every
verdict, weights, depths and snapshots. The meter holds its stream cap
under 16 threads admitting and closing at once. ``StallGuard`` is pinned on
its own: pass-through, a stall turned into ``BackendWorkerError`` within the
bound, the first-call grace, a late result counted and discarded, and
``stop`` waking a waiting call.
"""

import threading
import time
from unittest import mock

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from cake_tpu.runtime import admission as ref
from cake_tpu_torch.runtime import admission as port
from cake_tpu_torch.runtime.batch_backend import BackendWorkerError

SETTINGS = settings(max_examples=60, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])


class Clock:
    """The time both packages read: ``monotonic`` for the reference module's
    ``time``, the instance itself as the port's ``time_fn``."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t

    def monotonic(self) -> float:
        return self.t


# ----------------------------------------------------------------- TokenBucket

bucket_ops = st.lists(st.tuples(
    st.sampled_from(["take", "refund"]),
    st.floats(0.0, 5.0, allow_nan=False),  # seconds that pass first
    st.floats(0.0, 80.0, allow_nan=False),  # cost
), max_size=40)


@SETTINGS
@given(rate=st.sampled_from([0.0, 0.5, 3.0, 10.0]), burst=st.sampled_from([0.0, 5.0, 30.0]),
       ops=bucket_ops)
def test_token_bucket_equals_the_reference(rate, burst, ops):
    now = 50.0
    a, b = ref.TokenBucket(rate, burst), port.TokenBucket(rate, burst, now=now)
    a.t = now
    for kind, dt, cost in ops:
        now += dt
        if kind == "take":
            assert b.try_take(cost, now) == a.try_take(cost, now)
        else:
            a.refund(cost)
            b.refund(cost)
        assert (b.level, b.t) == (a.level, a.t)


# ----------------------------------------------------------------- TenantMeter

meter_ops = st.lists(st.one_of(
    st.tuples(st.just("admit"), st.sampled_from(["a", "b", "c"]), st.integers(1, 60)),
    st.tuples(st.just("close"), st.integers(0, 30), st.booleans()),
    st.tuples(st.just("wait"), st.floats(0.0, 4.0, allow_nan=False)),
), max_size=40)


def _outcome(fn):
    try:
        fn()
        return "ok"
    except Exception as e:  # noqa: BLE001 - the refusal is the answer compared
        return (type(e).__name__, str(e), getattr(e, "kind", None),
                getattr(e, "retry_after_s", None), getattr(e, "tenant", None))


@SETTINGS
@given(rate=st.sampled_from([0.0, 5.0, 20.0]), burst=st.sampled_from([0.0, 40.0]),
       streams=st.sampled_from([0, 1, 3]), ops=meter_ops)
def test_tenant_meter_equals_the_reference(rate, burst, streams, ops):
    clock = Clock()
    with mock.patch.object(ref, "time", clock):
        a = ref.TenantMeter(rate=rate, burst=burst, max_streams=streams)
        b = port.TenantMeter(rate=rate, burst=burst, max_streams=streams, time_fn=clock)
        rids = []
        for op in ops:
            if op[0] == "admit":
                rid = f"r{len(rids)}"
                rids.append(rid)
                got = _outcome(lambda: b.admit(op[1], rid, op[2]))
                want = _outcome(lambda: a.admit(op[1], rid, op[2]))
                assert got == want
            elif op[0] == "close" and rids:
                rid = rids[op[1] % len(rids)]
                a.close(rid, refund=op[2])
                b.close(rid, refund=op[2])
            elif op[0] == "wait":
                clock.t += op[1]
            assert b.snapshot() == a.snapshot()


def test_tenant_meter_holds_its_cap_under_threads():
    """API handler threads admit and close at once: the stream cap is never
    exceeded and no admission or close is lost."""
    import sys

    meter = port.TenantMeter(rate=1e9, max_streams=3)
    live = {"n": 0, "max": 0, "granted": 0}
    lock = threading.Lock()

    def handler(k):
        for i in range(300):
            rid = f"w{k}-{i}"
            try:
                meter.admit("t", rid, 1.0)
            except port.QuotaExceeded:
                continue
            with lock:
                live["n"] += 1
                live["max"] = max(live["max"], live["n"])
                live["granted"] += 1
            with lock:
                live["n"] -= 1
            meter.close(rid)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=handler, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    snap = meter.snapshot()["t"]
    assert live["max"] <= 3 and live["granted"] > 0
    assert snap["active_streams"] == 0 and snap["submitted"] == live["granted"]
    assert snap["tokens"] == live["granted"]
    assert snap["quota_refusals"] == 16 * 300 - live["granted"]


def test_tenant_meter_bounds_its_tenants():
    m = port.TenantMeter()
    m.admit("live", "r0", 1)
    for i in range(port.MAX_TENANTS + 10):
        m.admit(f"t{i}", f"x{i}", 1)
        m.close(f"x{i}")
    snap = m.snapshot()
    assert len(snap) == port.MAX_TENANTS and "live" in snap


# ------------------------------------------------------------------- FairQueue


class Req:
    """What the queue reads of a request: tenant, cost inputs, deadline,
    submit time; ``verdict`` is the accept() answer the test gives it."""

    def __init__(self, i, tenant, n_prompt, max_tokens, priority, deadline, verdict):
        self.rid, self.tenant = f"q{i}", tenant
        self.prompt_ids = [0] * n_prompt
        self.max_tokens, self.priority, self.deadline = max_tokens, priority, deadline
        self.t_submit = float(i)
        self.verdict = verdict


FACTOR = {0: 0.5, 1: 1.0, 2: 2.0}


def cost(req) -> float:
    """The engines' ``_req_cost``."""
    return (len(req.prompt_ids) + req.max_tokens) / FACTOR[req.priority]


queue_ops = st.lists(st.one_of(
    st.tuples(st.just("append"), st.sampled_from(["a", "b", "c", "d"]), st.integers(1, 400),
              st.integers(1, 200), st.sampled_from([0, 1, 2]), st.sampled_from([0.0, 5.0]),
              st.sampled_from(["take", "take", "take", "skip", "next", "drop"])),
    st.tuples(st.just("take"), st.integers(0, 6)),
    st.tuples(st.just("remove"), st.integers(0, 40)),
    st.tuples(st.just("weight"), st.sampled_from(["a", "b", "c", "d"]),
              st.sampled_from([0.5, 1.0, 1.5, 3.0, 4.0])),
), max_size=50)


def _state(q) -> tuple:
    head = q.oldest_head()
    return (len(q), [r.rid for r in q], q.deadline_count, q.queued_by_tenant(),
            head.rid if head is not None else None,
            {t: q.weight(t) for t in "abcd"})


@SETTINGS
@given(fair=st.booleans(), quantum=st.sampled_from([1, 64, 256]), ops=queue_ops)
def test_fair_queue_equals_the_reference(fair, quantum, ops):
    a = ref.FairQueue(fair=fair, quantum=quantum, cost=cost)
    b = port.FairQueue(fair=fair, quantum=quantum, cost=cost)
    made = []
    for op in ops:
        if op[0] == "append":
            req = Req(len(made), *op[1:])
            made.append(req)
            a.append(req)
            b.append(req)
        elif op[0] == "take":
            got = [r.rid for r in b.take(op[1], lambda r: r.verdict)]
            assert got == [r.rid for r in a.take(op[1], lambda r: r.verdict)]
        elif op[0] == "remove" and made:
            req = made[op[1] % len(made)]
            assert b.remove(req) == a.remove(req)
        elif op[0] == "weight":
            a.set_weight(op[1], op[2])
            b.set_weight(op[1], op[2])
        assert _state(b) == _state(a)
    a.clear()
    b.clear()
    assert _state(b) == _state(a)


def test_fair_queue_hands_a_flooded_queue_to_the_other_tenant():
    """Tenant A's flood of 24 and tenant B's 2: DRR takes B's both within
    the first take of 8; FIFO takes them last."""
    reqs = [Req(i, "A", 470, 16, 1, 0.0, "take") for i in range(24)]
    reqs += [Req(24 + i, "B", 470, 16, 1, 0.0, "take") for i in range(2)]
    order = {}
    for fair in (True, False):
        q = port.FairQueue(fair=fair, cost=cost)
        q.extend(reqs)
        order[fair] = [r.tenant for k in range(4) for r in q.take(8, lambda r: "take")]
    assert order[True].index("B") < 8 and order[True][:8].count("B") == 2
    assert order[False][-2:] == ["B", "B"] and order[False][:24] == ["A"] * 24


# --------------------------------------------------------------- WaitEstimator

estimator_ops = st.lists(st.one_of(
    st.tuples(st.just("observe"), st.floats(0.0, 30.0, allow_nan=False)),
    st.tuples(st.just("estimate"), st.integers(0, 40), st.integers(0, 16),
              st.floats(0.0, 5.0, allow_nan=False)),
), max_size=30)


@SETTINGS
@given(alpha=st.sampled_from([0.1, 0.3, 0.9]), ops=estimator_ops)
def test_wait_estimator_equals_the_reference(alpha, ops):
    a, b = ref.WaitEstimator(alpha), port.WaitEstimator(alpha)
    for op in ops:
        if op[0] == "observe":
            a.observe(op[1])
            b.observe(op[1])
        else:
            assert b.estimate(*op[1:]) == a.estimate(*op[1:])
        assert (b.ewma, b.samples) == (a.ewma, a.samples)


def test_wait_estimator_cold_start_and_scaling():
    e = port.WaitEstimator()
    assert e.estimate(100, 8) == 0.0  # a fresh engine never sheds on a deadline
    e.observe(2.0)
    assert e.estimate(0, 8) == pytest.approx(2.0)
    assert e.estimate(8, 8) == pytest.approx(4.0)
    assert e.estimate(0, 8, scale=3.0) == pytest.approx(6.0)
    assert e.estimate(0, 8, scale=0.5) == pytest.approx(2.0)  # never deflates


# ------------------------------------------------------------------ StallGuard


def test_stall_guard_passes_values_and_errors_through():
    g = port.StallGuard(stall_s=5.0)
    assert g.call(lambda: 42, op="decode") == 42
    with pytest.raises(KeyError):
        g.call(lambda: {}["x"], op="decode")
    assert g.stalls == 0
    g.stop()


def test_stall_guard_abandons_a_stalled_dispatch():
    g = port.StallGuard(stall_s=0.15)
    assert g.call(lambda: "warm", op="decode") == "warm"  # the op's grace is spent
    release = threading.Event()

    def hung():
        release.wait(10.0)
        return "late"

    t0 = time.monotonic()
    with pytest.raises(BackendWorkerError) as ei:
        g.call(hung, op="decode")
    assert time.monotonic() - t0 < 2.0
    assert ei.value.node == port.StallGuard.NODE and ei.value.op == "decode"
    assert g.stalls == 1
    # A fresh watchdog thread serves the next dispatch at once; the
    # abandoned one's late result is discarded and counted.
    assert g.call(lambda: "ok", op="decode") == "ok"
    release.set()
    deadline = time.monotonic() + 5.0
    while g.resolved == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert g.resolved == 1
    g.stop()


def test_stall_guard_grants_a_first_call_its_grace():
    g = port.StallGuard(stall_s=0.05)
    # 0.2 s is past the bound but inside the first call's 10x grace.
    assert g.call(lambda: time.sleep(0.2) or "built", op="prefill") == "built"
    with pytest.raises(BackendWorkerError):
        g.call(lambda: time.sleep(0.4), op="prefill")
    # The stall granted the op its grace again.
    assert g.call(lambda: time.sleep(0.2) or "again", op="prefill") == "again"
    # A call its caller marks (a decode that captures a new graph) gets the
    # grace however often the op was seen.
    assert g.call(lambda: time.sleep(0.2) or "marked", op="prefill", grace=True) == "marked"
    g.stop()


def test_stall_guard_stop_wakes_a_waiting_call():
    g = port.StallGuard(stall_s=30.0)
    release = threading.Event()
    errors = []

    def engine():
        try:
            g.call(lambda: release.wait(10.0), op="decode")
        except BackendWorkerError as e:
            errors.append(e)

    t = threading.Thread(target=engine)
    t.start()
    time.sleep(0.1)
    t0 = time.monotonic()
    g.stop()
    t.join(5.0)
    release.set()
    assert not t.is_alive() and time.monotonic() - t0 < 2.0
    assert len(errors) == 1 and g.stalls == 0  # a stop is not a stall
