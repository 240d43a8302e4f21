"""The port's admission against the JAX package's on the same submission
script, on the CPU.

One script of tenants, priorities, knobs and deadlines, submitted as one
group before ``start()``, goes through the JAX ``BatchEngine`` and the
port's over the same tiny checkpoint (tests/_continuous_pair.py): a
stream cap refuses one tenant's fourth request (429), the queue-depth gate
sheds a low-priority request at half the depth and a normal one at the
depth (503), a request whose deadline passes before the engine starts
expires unadmitted, and the rest are admitted in the fair queue's order.
Both packages give the same refusals, the same admission order (every
``take`` of their fair queues), the same streams, finish reasons and
token counts, the same counters and the same per-tenant accounting; with
the fair queue on and off, dense and paged, under both schedulers.
"""

import time

import pytest

import _continuous_pair as P
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)

# (tenant, priority, knobs, user turn, max_tokens, deadline_s)
SCRIPT = [
    ("A", 1, "greedy", "tenant a asks the first question", 10, None),
    ("A", 1, "greedy", "tenant a asks again, a longer question this time", 6, None),
    ("A", 2, "sampled", "tenant a's urgent sampled request", 8, None),
    ("A", 1, "greedy", "tenant a's fourth request is over its stream cap", 6, None),
    ("B", 0, "sampled", "tenant b, low priority", 12, None),
    ("B", 2, "greedy", "tenant b, high priority", 5, None),
    ("C", 1, "greedy", "tenant c is already late", 6, 0.001),
    ("D", 0, "greedy", "tenant d, low priority, is shed at half the depth", 6, None),
    ("E", 1, "greedy", "tenant e gets in", 9, 600.0),
    ("E", 1, "sampled", "tenant e's sampled one", 7, None),
    ("F", 2, "greedy", "tenant f, high priority, tolerates twice the depth", 4, None),
    ("G", 1, "greedy", "tenant g is shed at the depth", 6, None),
]
SERVE = dict(tenant_streams=3, shed_queue_depth=8, retry_after_s=2.0)
COUNTS = ("shed", "quota_refusals", "deadline_expired", "batches", "joins", "cancelled",
          "stream_errors", "page_truncations", "preemptions", "restores")


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    return P.packages(P.write_checkpoint(tmp_path_factory.mktemp("tiny_admission_jax")))


def run_script(pkg, eng):
    taken: list[list[str]] = []
    real_take = eng._queue.take

    def take(limit, accept):
        out = real_take(limit, accept)
        if out:
            taken.append([r.rid for r in out])
        return out

    eng._queue.take = take
    refusals, handles = {}, {}
    for i, (tenant, priority, knobs, user, n, deadline) in enumerate(SCRIPT):
        rid = f"s{i}"
        seed = dict(seed=100 + i) if knobs == "sampled" else {}
        try:
            handles[rid] = eng.submit([pkg.message.user(user)], n,
                                      pkg.sampling(**P.KNOBS[knobs], **seed), request_id=rid,
                                      priority=priority, tenant=tenant, deadline_s=deadline)
        except Exception as e:  # noqa: BLE001 - the refusal is the answer compared
            refusals[rid] = (type(e).__name__, getattr(e, "kind", None),
                             getattr(e, "retry_after_s", None))
    time.sleep(0.05)  # tenant c's deadline passes before the engine starts
    eng.start()
    streams = {rid: [t.id for t in h.tokens()] for rid, h in handles.items()}
    assert pkg.idle(eng)
    tenants = {t: {k: v for k, v in s.items() if k != "bucket_level"}
               for t, s in eng.tenant_stats().items()}
    slo = {t: {k: w["fast"][k] for k in ("requests", "deadline_hit_rate", "error_rate",
                                          "refusals")}
           for t, w in eng.slo.snapshot()["tenants"].items()}
    return {
        "refusals": refusals, "taken": taken, "streams": streams,
        "finish": {rid: (h.finish_reason, h.completion_tokens) for rid, h in handles.items()},
        "stats": {k: eng.stats[k] for k in COUNTS}, "tenants": tenants, "slo": slo,
    }


@pytest.mark.parametrize("fair", [True, False], ids=["fair", "fifo"])
@pytest.mark.parametrize("scheduler", ["epoch", "continuous"])
@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_same_script_same_admission(packages, mode, scheduler, fair):
    got = P.both(packages, run_script, scheduler=scheduler, fair_queue=fair, **SERVE,
                 **P.MODES[mode])
    port, jax = got["port"], got["jax"]
    assert port["refusals"] == jax["refusals"] == {
        "s3": ("QuotaExceeded", "streams", 1.0),
        "s7": ("EngineOverloaded", None, 4.0),
        "s11": ("EngineOverloaded", None, 2.0),
    }
    assert port["taken"] == jax["taken"]
    assert port["streams"] == jax["streams"]
    assert port["finish"] == jax["finish"]
    assert port["finish"]["s6"] == ("deadline", 0)
    assert port["stats"] == jax["stats"]
    assert port["tenants"] == jax["tenants"]
    assert port["slo"] == jax["slo"]
    assert port["stats"]["batches"] >= 2 and port["stats"]["deadline_expired"] == 1
