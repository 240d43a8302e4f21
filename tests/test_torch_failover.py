"""Heartbeats and live-stream failover of the port (runtime/client.py
``HeartbeatMonitor``, runtime/router.py, runtime/serving.py
``_failover_or_raise`` / ``_migrate_kv``) held to the JAX package's, on the
CPU.

Each scenario mirrors one of ``tests/test_chaos.py``: a seeded fault plan
(runtime/faults.py) kills the primary of a replica group mid-decode, burns
the failover budget, leaves no healthy replica, lets the ejected primary
rejoin after its cooldown, or crashes a local backend's decode (paged, with
a lane spilled, with lanes holding forked prefix-cache pages). The port runs
the scenario on port workers and its own engine, the JAX package on its
workers and engine, over one tiny f32 checkpoint with the same plan: the
port's greedy streams equal its fault-free run and the JAX engine's streams,
and its records (finish reasons, the engine's failover / recovered /
stream-error counts, the router's routes and ejections, the failover
metrics and flight events) equal the JAX engine's.
"""

import contextlib
import time

import jax.numpy as jnp
import pytest
import torch

import _tcp_cluster as C
from _tcp_cluster import one_torch_thread  # noqa: F401  (autouse)
from cake_tpu.models.llama.chat import Message as JaxMessage
from cake_tpu.models.llama.config import LlamaConfig as JaxConfig
from cake_tpu.models.llama.generator import SamplingConfig as JaxSampling
from cake_tpu.models.llama.tokenizer import ByteTokenizer as JaxByteTokenizer
from cake_tpu.parallel.topology import Topology as JaxTopology
from cake_tpu.runtime import faults as jfaults
from cake_tpu.runtime.batch_backend import DistributedBatchBackend as JaxTcpBackend
from cake_tpu.runtime.master import DistributedForwardStep as JaxStep
from cake_tpu.runtime.router import ReplicaRouter as JaxRouter
from cake_tpu.runtime.serving import BatchEngine as JaxEngine
from cake_tpu.runtime.serving import ServeConfig as JaxServe
from cake_tpu.runtime.worker import Worker as JaxWorker
from cake_tpu.utils import metrics as jmetrics
from cake_tpu_torch.io.safetensors_io import load_params
from cake_tpu_torch.models.llama.chat import Message
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import SamplingConfig
from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer
from cake_tpu_torch.parallel.topology import Topology
from cake_tpu_torch.runtime import faults
from cake_tpu_torch.runtime.batch_backend import DistributedBatchBackend
from cake_tpu_torch.runtime.client import HeartbeatMonitor
from cake_tpu_torch.runtime.master import DistributedForwardStep
from cake_tpu_torch.runtime.router import ReplicaRouter
from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig
from cake_tpu_torch.runtime.worker import Worker
from cake_tpu_torch.utils import metrics

MAX_SEQ = 96
GREEDY = dict(temperature=0.0, repeat_penalty=1.0)
# A short survivor and a long co-batched victim (test_chaos._two_streams).
TWO = [("survivor", 2), ("the long victim stream", 16)]
REPLICAS = {"w0": ["model.layers.0-5"], "w0b": ["model.layers.0-5"]}


@pytest.fixture(autouse=True)
def _clear_plans():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def install(plan: str) -> None:
    """The same plan in both packages."""
    faults.install(faults.parse(plan))
    jfaults.install(jfaults.parse(plan))


def clear_records() -> None:
    for m in (metrics, jmetrics):
        m.registry.clear()
        m.flight.clear()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return C.write_checkpoint(tmp_path_factory.mktemp("failover") / "model", seed=31)


@pytest.fixture(scope="module")
def replicas(ckpt):
    """Port and JAX replica groups over the same checkpoint: two workers of
    each package declaring every layer (the master keeps the head)."""
    with C.port_cluster(ckpt, REPLICAS, max_seq_len=MAX_SEQ) as (topo, _), \
            C.jax_cluster(ckpt, REPLICAS, max_seq_len=MAX_SEQ) as (jtopo, _):
        yield topo, jtopo


def port_tcp_engine(ckpt, topo, **serve):
    cfg = LlamaConfig.from_model_dir(ckpt)
    step = DistributedForwardStep(cfg, ckpt, topo, dtype=torch.float32, max_seq_len=MAX_SEQ,
                                  op_deadline_s=1.0, op_retries=1, reconnect_attempts=2,
                                  reconnect_backoff_s=0.05, device="cpu")
    step.router.prefer("w0")  # the epoch under test routes the group's primary
    serve.setdefault("max_batch", 4)
    serve.setdefault("decode_chunk_size", 4)
    serve.setdefault("admission_window", 0.05)
    eng = BatchEngine(cfg, None, ByteTokenizer(), max_seq_len=MAX_SEQ,
                      cache_dtype=torch.float32, serve=ServeConfig(**serve),
                      backend=DistributedBatchBackend(step))
    eng.start()
    return eng, step


def jax_tcp_engine(ckpt, jtopo, **serve):
    cfg = JaxConfig.from_model_dir(ckpt)
    step = JaxStep(cfg, ckpt, jtopo, dtype=jnp.float32, max_seq_len=MAX_SEQ,
                   op_deadline_s=1.0, op_retries=1, reconnect_attempts=2,
                   reconnect_backoff_s=0.05)
    step.router.prefer("w0")
    serve.setdefault("max_batch", 4)
    serve.setdefault("decode_chunk_size", 4)
    serve.setdefault("admission_window", 0.05)
    eng = JaxEngine(cfg, None, JaxByteTokenizer(), max_seq_len=MAX_SEQ,
                    cache_dtype=jnp.float32, serve=JaxServe(**serve),
                    backend=JaxTcpBackend(step, max_seq_len=MAX_SEQ, cache_dtype=jnp.float32))
    eng.start()
    return eng, step


def run_wave(eng, jax_side: bool, wave=TWO):
    msg, samp = (JaxMessage, JaxSampling) if jax_side else (Message, SamplingConfig)
    handles = [eng.submit([msg.user(p)], n, samp(**GREEDY)) for p, n in wave]
    ids = [[t.id for t in h.tokens()] for h in handles]
    return ids, [h.finish_reason for h in handles]


def record(eng, step, m, ids, fins) -> dict:
    """What the tests compare across the packages."""
    return {
        "ids": ids, "finish": fins,
        "failovers": eng.stats["failovers"], "recovered": eng.stats["recovered"],
        "stream_errors": eng.stats["stream_errors"],
        "router": None if step is None else {k: v for k, v in step.router.snapshot().items()
                                             if k in ("routes", "ejected")},
        "failover_total": m.registry.counter("cake_failover_total").value(
            node="w0" if step is not None else "<fault-plan>"),
        "recovered_total": m.registry.counter("cake_streams_recovered_total").value(),
        "events": sorted({e["event"] for e in m.flight.snapshot()
                          if e["event"] in ("failover", "failover-migrated", "rejoin")}),
    }


@pytest.fixture(scope="module")
def fault_free(ckpt, replicas):
    """Each package's fault-free streams of the wave over its replica group."""
    topo, jtopo = replicas
    want = {}
    for side in ("port", "jax"):
        eng, step = (port_tcp_engine(ckpt, topo) if side == "port"
                     else jax_tcp_engine(ckpt, jtopo))
        want[side], _ = run_wave(eng, side == "jax")
        eng.stop()
        step.close()
    return want


@contextlib.contextmanager
def both_tcp(ckpt, replicas, want, plan: str | None, **serve):
    """The planned runs of both packages (``want``: the fault-free streams):
    yields (port record, JAX record, port fault-free ids, JAX fault-free
    ids, (port engine, port step), (JAX engine, JAX step))."""
    topo, jtopo = replicas
    clear_records()
    if plan is not None:
        install(plan)
    peng, pstep = port_tcp_engine(ckpt, topo, **serve)
    jeng, jstep = jax_tcp_engine(ckpt, jtopo, **serve)
    try:
        prec = record(peng, pstep, metrics, *run_wave(peng, False))
        jrec = record(jeng, jstep, jmetrics, *run_wave(jeng, True))
        yield prec, jrec, want["port"], want["jax"], (peng, pstep), (jeng, jstep)
    finally:
        for e, s in ((peng, pstep), (jeng, jstep)):
            e.stop()
            s.close()


def test_failover_kill_primary_streams_equal(ckpt, replicas, fault_free):
    """kill@client.send makes the primary unreachable mid-decode for good:
    both streams migrate to the replica and finish as the fault-free run,
    one failover, cake_failover_total{w0} 1, nothing "error"; the port's
    record is the JAX engine's."""
    with both_tcp(ckpt, replicas, fault_free, "kill@client.send:node=w0:after=3:count=0") as (
            prec, jrec, want, jwant, _, _):
        assert want == jwant
        assert prec["ids"] == want
        assert prec == jrec
        assert prec["failovers"] == 1 and prec["recovered"] >= 1
        assert prec["stream_errors"] == 0
        assert prec["router"] == {"routes": {"w0": "w0b"}, "ejected": ["w0"]}
        assert prec["failover_total"] == 1
        assert prec["events"] == ["failover", "failover-migrated"]


def test_failover_budget_zero_is_error_isolation(ckpt, replicas, fault_free):
    """max_failovers=0: a healthy replica exists but nothing migrates; the
    live stream finishes "error" in both packages."""
    with both_tcp(ckpt, replicas, fault_free, "kill@client.send:node=w0:after=3:count=0",
                  max_failovers=0) as (prec, jrec, _, _, _, _):
        assert prec == jrec
        assert prec["finish"][1] == "error"
        assert prec["failovers"] == 0 and prec["stream_errors"] >= 1


def test_failover_no_healthy_replica_degrades_to_error(ckpt, replicas, fault_free):
    """Both members unreachable: no route is left, so the error isolation;
    the engine stays up."""
    with both_tcp(ckpt, replicas, fault_free, "kill@client.send:after=3:count=0") as (
            prec, jrec, _, _, _, _):
        assert prec == jrec
        assert prec["finish"][1] == "error"
        assert prec["stream_errors"] >= 1


def test_standby_rejoin_after_cooldown(ckpt, replicas, fault_free):
    """Once the fault clears and the cooldown passes, the ejected primary
    re-enters the rotation (a rejoin event) and serves the next wave with
    the first wave's streams."""
    with both_tcp(ckpt, replicas, fault_free, "kill@client.send:node=w0:after=3:count=0",
                  failover_cooldown_s=0.05) as (prec, jrec, want, _, port, jax_side):
        assert prec == jrec and prec["ids"] == want
        faults.clear()
        jfaults.clear()
        time.sleep(0.1)  # probation
        again = []
        for (eng, step), m, js in ((port, metrics, False), (jax_side, jmetrics, True)):
            step.router.prefer("w0")
            ids, _ = run_wave(eng, js)
            again.append((ids, step.router.snapshot()["ejected"], step.router.route("w0"),
                          any(e["event"] == "rejoin" and e["node"] == "w0"
                              for e in m.flight.snapshot())))
        assert again[0] == again[1] == (want, [], "w0", True)


def test_monitor_gates_rotation_and_rejoin():
    """tests/test_router.py's monitor test on both routers: a member the
    monitor sees down stays out, an ejected one waits for the heartbeat."""

    class FakeMonitor:
        def __init__(self):
            self.down: set[str] = set()

        def healthy(self, node):
            return node not in self.down

    seen = []
    for cls in (ReplicaRouter, JaxRouter):
        mon = FakeMonitor()
        r = cls({"w0": ["w0", "w0b"]}, cooldown_s=0.0)
        r.attach_monitor(mon)  # late, as the engine attaches it at start()
        mon.down.add("w0")
        picks = [r.refresh()["w0"] for _ in range(3)]
        r.report_failure("w0b")
        none = r.failover("w0b")
        mon.down.clear()
        r.prefer("w0")
        seen.append((picks, none, r.refresh()["w0"], r.healthy("w0")))
    assert seen[0] == seen[1] == (["w0b"] * 3, None, "w0", True)


def test_heartbeat_marks_stalled_worker_unhealthy_within_deadline(ckpt):
    """A worker whose PING answers stall (worker.ping) is unhealthy within
    the deadline and healthy again when the stall budget runs out, with the
    reference's gauge, counter and flight events."""
    clear_records()
    with C.port_cluster(ckpt, {"w0": ["model.layers.0-5"]}, max_seq_len=MAX_SEQ) as (topo, _):
        mon = HeartbeatMonitor({"w0": topo.nodes["w0"].host}, interval_s=0.05,
                               deadline_s=0.3).start()
        try:
            deadline = time.time() + 5
            while not mon.snapshot()["w0"] and time.time() < deadline:
                time.sleep(0.02)
            assert mon.healthy("w0") is True
            faults.install(faults.parse("stall@worker.ping:delay_s=0.6:count=3"))
            t0 = time.time()
            while mon.healthy("w0") and time.time() - t0 < 5:
                time.sleep(0.02)
            assert mon.healthy("w0") is False
            assert time.time() - t0 < 0.3 + 0.05 + 1.0
            assert metrics.registry.counter("cake_worker_unhealthy_total").value(node="w0") == 1
            assert metrics.registry.gauge("cake_worker_healthy").value(node="w0") == 0
            t0 = time.time()
            while not mon.healthy("w0") and time.time() - t0 < 10:
                time.sleep(0.02)
            assert mon.healthy("w0") is True
            events = [e["event"] for e in metrics.flight.snapshot()]
            assert "worker-unhealthy" in events and "worker-healthy" in events
            assert metrics.registry.histogram("cake_worker_ping_seconds").snapshot()
        finally:
            mon.stop()


def test_engine_heartbeat_attaches_to_the_router(ckpt, replicas):
    """heartbeat_interval_s > 0: the engine starts a monitor over its TCP
    backend's workers at start(), attaches it to the router and stops it
    with the engine."""
    topo, _ = replicas
    eng, step = port_tcp_engine(ckpt, topo, heartbeat_interval_s=0.05,
                                heartbeat_deadline_s=0.5)
    try:
        assert eng.monitor is not None and step.router.monitor is eng.monitor
        assert sorted(eng.monitor.hosts) == ["w0", "w0b"]
        deadline = time.time() + 5
        while None in eng.monitor.snapshot().values() and time.time() < deadline:
            time.sleep(0.02)
        assert eng.monitor.snapshot() == {"w0": True, "w0b": True}
        ids, fins = run_wave(eng, False)
        assert fins == ["length", "length"]
    finally:
        eng.stop()
        step.close()
    assert eng.monitor is None


# ------------------------------------------ local migration (failover_local)


def local_engines(ckpt, **serve):
    """The port's and the JAX package's local engines over the checkpoint,
    started."""
    from cake_tpu.io.safetensors_io import load_params as jax_load_params

    cfg = LlamaConfig.from_model_dir(ckpt)
    jcfg = JaxConfig.from_model_dir(ckpt)
    max_seq = serve.pop("max_seq_len", MAX_SEQ)
    serve.setdefault("max_batch", 4)
    serve.setdefault("decode_chunk_size", 4)
    serve.setdefault("admission_window", 0.05)
    port = BatchEngine(cfg, load_params(ckpt, cfg, torch.float32), ByteTokenizer(),
                       max_seq_len=max_seq, cache_dtype=torch.float32,
                       serve=ServeConfig(**serve), device="cpu")
    jeng = JaxEngine(jcfg, jax_load_params(ckpt, jcfg, jnp.float32), JaxByteTokenizer(),
                     max_seq_len=max_seq, cache_dtype=jnp.float32, serve=JaxServe(**serve))
    port.start()
    jeng.start()
    return port, jeng


def local_records(ckpt, wave, plan: str | None, warm=None, **serve):
    """(port record, JAX record) of one wave on each package's local engine
    under ``plan`` (installed after the ``warm`` wave, if any)."""
    clear_records()
    port, jeng = local_engines(ckpt, **serve)
    out = []
    try:
        if warm is not None:
            for eng, js in ((port, False), (jeng, True)):
                run_wave(eng, js, warm)
                assert eng.quiesce() if js else eng.wait_idle()
        if plan is not None:
            install(plan)
        for eng, m, js in ((port, metrics, False), (jeng, jmetrics, True)):
            rec = record(eng, None, m, *run_wave(eng, js, wave))
            rec["preemptions"] = eng.stats.get("preemptions", 0)
            rec["restores"] = eng.stats.get("restores", 0)
            if eng.kv_mode == "paged":
                (eng.quiesce if js else eng.wait_idle)()
                if eng._prefix is not None:
                    rec["cache_pages"] = eng._prefix.stats()["pages"] > 0
                    eng._prefix.clear()
                alloc = eng.backend.allocator
                rec["pool_whole"] = alloc.pages_free == alloc.pages_total
            out.append(rec)
    finally:
        port.stop()
        jeng.stop()
    return out


def test_paged_local_migration_streams_equal(ckpt):
    """failover_local: crash@backend.decode on the paged local engine
    migrates the live streams in place; they equal the fault-free run, the
    pool drains, and the port's record is the JAX engine's."""
    wave = [("short survivor", 3), ("the long victim stream", 24)]
    want = local_records(ckpt, wave, None, kv_mode="paged", page_size=16)
    got = local_records(ckpt, wave, "crash@backend.decode:after=3:count=1", kv_mode="paged",
                        page_size=16, failover_local=True)
    assert want[0]["ids"] == want[1]["ids"]
    assert got[0] == got[1]
    assert got[0]["ids"] == want[0]["ids"]
    assert got[0]["finish"] == ["length", "length"]
    assert got[0]["failovers"] == 1 and got[0]["recovered"] >= 1
    assert got[0]["stream_errors"] == 0 and got[0]["pool_whole"]


def test_dense_local_migration_streams_equal(ckpt):
    """The same on the dense local engine (the TCP backend's KV layout)."""
    wave = [("short survivor", 3), ("the long victim stream", 24)]
    want = local_records(ckpt, wave, None)
    got = local_records(ckpt, wave, "crash@backend.decode:after=3:count=1",
                        failover_local=True)
    assert got[0] == got[1]
    assert got[0]["ids"] == want[0]["ids"] == want[1]["ids"]
    assert got[0]["failovers"] == 1 and got[0]["stream_errors"] == 0


def test_kill_while_lane_spilled_restores_equal(ckpt):
    """The backend dies while a preempted lane sits spilled: the live stream
    rides the migration, the spilled lane's restore walks the recovered
    backend; both streams equal the fault-free run and the JAX engine's."""
    prompts = ["alpha prompt padded out to be long " * 2,
               "row two also made quite long here " * 2]
    wave = [(p, 48) for p in prompts]
    kw = dict(max_seq_len=256, admission_window=0.1, scheduler="continuous",
              kv_mode="paged", page_size=16, max_pages=14, failover_local=True)
    want = local_records(ckpt, wave, None, **kw)
    assert want[0]["preemptions"] >= 1 and want[0] == want[1]
    got = local_records(ckpt, wave, "crash@backend.decode:after=10:count=1", **kw)
    assert got[0] == got[1]
    assert got[0]["ids"] == want[0]["ids"]
    assert got[0]["finish"] == ["length", "length"] and got[0]["stream_errors"] == 0
    assert got[0]["failovers"] == 1 and got[0]["restores"] >= 1 and got[0]["pool_whole"]


def test_local_backend_without_optin_keeps_error_isolation(ckpt):
    """No failover_local: an injected crash still finishes the live stream
    "error", in both packages."""
    wave = [("the long victim stream", 24)]
    got = local_records(ckpt, wave, "crash@backend.decode:after=3:count=1", kv_mode="paged",
                        page_size=16)
    assert got[0] == got[1]
    assert got[0]["finish"] == ["error"] and got[0]["failovers"] == 0


PREFIX_SHARED = "A shared system preamble on pages."


def test_migration_with_forked_shared_pages_streams_equal(ckpt):
    """failover_local with the prefix cache: lanes forked a cached chain when
    a crash lands in the warm epoch's decode; the migration clears the cache
    and re-prefills through the cached-chunk arithmetic; the streams equal
    the fault-free warm run, finish re-inserts the chains, the pool
    drains."""
    warm = [(PREFIX_SHARED + " warmup.", 2)]
    wave = [(PREFIX_SHARED + " stream1", 16), (PREFIX_SHARED + " stream2", 16)]
    kw = dict(kv_mode="paged", page_size=16, prefix_cache=True, decode_chunk_size=2)
    want = local_records(ckpt, wave, None, warm=warm, **kw)
    got = local_records(ckpt, wave, "crash@backend.decode:after=2:count=1", warm=warm,
                        failover_local=True, **kw)
    assert got[0] == got[1]
    assert got[0]["ids"] == want[0]["ids"]
    assert got[0]["finish"] == ["length", "length"] and got[0]["failovers"] == 1
    assert got[0]["cache_pages"] and got[0]["pool_whole"]


def test_failover_config_validation():
    """ServeConfig refuses what the reference refuses."""
    for bad in (dict(max_failovers=-1), dict(failover_budget_s=0.0),
                dict(failover_cooldown_s=-1.0), dict(heartbeat_interval_s=-1.0)):
        with pytest.raises(ValueError):
            ServeConfig(**bad)
        if "heartbeat_interval_s" not in bad:
            with pytest.raises(ValueError):
                JaxServe(**bad)


# ------------------------------------------- the migration's price and rings


@pytest.mark.parametrize("kv_mode", ["dense", "paged"])
def test_migration_past_its_budget_reprefills(ckpt, kv_mode):
    """A budget the replay's measured price overruns: after the first
    replayed decode chunk the migration takes the reference's windowed
    re-prefill (the JAX engine's only migration), so the port's record is
    the JAX engine's, the streams equal the fault-free run, and the port
    counts the re-prefill."""
    wave = [("short survivor", 3), ("the long victim stream", 24)]
    kw = dict(kv_mode=kv_mode, page_size=16) if kv_mode == "paged" else {}
    want = local_records(ckpt, wave, None, **kw)
    got = local_records(ckpt, wave, "crash@backend.decode:after=3:count=1",
                        failover_local=True, failover_budget_s=1e-9, **kw)
    assert got[0] == got[1]
    assert got[0]["ids"] == want[0]["ids"]
    assert got[0]["failovers"] == 1 and got[0]["stream_errors"] == 0
    migrated = [e for e in metrics.flight.snapshot() if e["event"] == "failover-migrated"]
    assert [e["how"] for e in migrated] == ["reprefill"]
    assert metrics.registry.counter("cake_failover_reprefills_total").value() == 1


def _migration_dispatches(ckpt, monkeypatch, s_per_pos):
    """The ops the port engine's one local migration dispatches (a paged
    wave crashed at its fourth decode chunk), with the replay priced at
    ``s_per_pos`` before it (None: unpriced), and the wave's ids."""
    ops, seen = [], {"migrating": False}
    real_dispatch, real_migrate = BatchEngine._dispatch, BatchEngine._migrate_kv

    def dispatch(self, op, fn, grace=False):
        if seen["migrating"]:
            ops.append(op)
        return real_dispatch(self, op, fn, grace)

    def migrate(self, *a):
        seen["migrating"] = True
        try:
            return real_migrate(self, *a)
        finally:
            seen["migrating"] = False

    monkeypatch.setattr(BatchEngine, "_dispatch", dispatch)
    monkeypatch.setattr(BatchEngine, "_migrate_kv", migrate)
    cfg = LlamaConfig.from_model_dir(ckpt)
    eng = BatchEngine(cfg, load_params(ckpt, cfg, torch.float32), ByteTokenizer(),
                      max_seq_len=MAX_SEQ, cache_dtype=torch.float32,
                      serve=ServeConfig(max_batch=4, decode_chunk_size=4, admission_window=0.05,
                                        kv_mode="paged", page_size=16, failover_local=True),
                      device="cpu")
    eng._replay_s_per_pos = s_per_pos
    eng.start()
    try:
        install("crash@backend.decode:after=3:count=1")
        ids, _ = run_wave(eng, False, [("the long victim stream", 24)])
    finally:
        eng.stop()
    return ops, ids


def test_migration_replays_an_entry_a_dispatch(ckpt, monkeypatch):
    """Unpriced, the replay runs the epoch's log entry by entry, each a
    guarded dispatch of its own (the prefill's passes the backend.prefill
    checkpoint, the decode chunks' are "migrate"); priced far past the
    budget, the migration is one re-prefill dispatch; both streams equal."""
    ops, ids = _migration_dispatches(ckpt, monkeypatch, None)
    assert ops == ["prefill", "migrate", "migrate", "migrate"]
    priced, priced_ids = _migration_dispatches(ckpt, monkeypatch, 1e3)
    assert priced == ["prefill"]
    assert priced_ids == ids


def test_tcp_redo_rebuilds_the_rings_pushed_mid_chunk(ckpt, replicas):
    """A worker killed in the middle of a TCP decode chunk, under a repeat
    penalty: the steps before the kill pushed into the rings in place, and
    the redone chunk starts from rings rebuilt from the histories, so the
    streams equal the fault-free run's and the JAX engine's."""
    topo, jtopo = replicas
    knobs = dict(temperature=0.0, repeat_penalty=1.3, repeat_last_n=8)
    wave = [("survivor", 3), ("the long victim stream", 16)]
    runs = []
    for plan in (None, "kill@client.send:node=w0:after=3:count=0"):
        clear_records()
        if plan is not None:
            install(plan)
        for side in ("port", "jax"):
            eng, step = (port_tcp_engine(ckpt, topo) if side == "port"
                         else jax_tcp_engine(ckpt, jtopo))
            msg, samp = (Message, SamplingConfig) if side == "port" else (JaxMessage, JaxSampling)
            try:
                hs = [eng.submit([msg.user(p)], n, samp(**knobs)) for p, n in wave]
                runs.append(([[t.id for t in h.tokens()] for h in hs], eng.stats["failovers"]))
            finally:
                eng.stop()
                step.close()
    (want, _), (jwant, _), (got, fo), (jgot, jfo) = runs
    assert want == jwant
    assert got == want and jgot == jwant
    assert fo == jfo == 1
