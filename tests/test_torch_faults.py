"""The port's fault plan (runtime/faults.py) held to the JAX package's, and
its checkpoints in the client, the worker, the engine and the API, on the
CPU.

The DSL tests mirror ``tests/test_chaos.py`` (``TestFaultPlan``) on both
packages side by side: a plan parses to the same specs, fires at the same
checkpoints (a ``p<1`` plan draws the seeded ``random.Random`` in the
reference's order, so the decisions are the reference's), refuses what the
reference refuses, and every fired fault shows in the counter, the flight
recorder and the timeline. Then the live-TCP chaos tests on port workers:
a torn connection replays to completion, a lost reply is answered from the
replay cache, a worker's crash fails only the live stream, each equal to
the JAX engine's streams over the same checkpoint and plan; and the
``backend.*`` and ``api.stream`` checkpoints.
"""

import http.client
import json
import threading

import jax.numpy as jnp
import pytest
import torch

import _tcp_cluster as C
from _tcp_cluster import one_torch_thread  # noqa: F401  (autouse)
from cake_tpu.models.llama.chat import Message as JaxMessage
from cake_tpu.models.llama.config import LlamaConfig as JaxConfig
from cake_tpu.models.llama.generator import SamplingConfig as JaxSampling
from cake_tpu.models.llama.tokenizer import ByteTokenizer as JaxByteTokenizer
from cake_tpu.runtime import faults as jfaults
from cake_tpu.runtime.batch_backend import DistributedBatchBackend as JaxTcpBackend
from cake_tpu.runtime.master import DistributedForwardStep as JaxStep
from cake_tpu.runtime.serving import BatchEngine as JaxEngine
from cake_tpu.runtime.serving import ServeConfig as JaxServe
from cake_tpu_torch import cli
from cake_tpu_torch.io.safetensors_io import load_params
from cake_tpu_torch.models.llama.chat import Message
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import SamplingConfig
from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer
from cake_tpu_torch.obs.timeline import timeline
from cake_tpu_torch.runtime import faults
from cake_tpu_torch.runtime.api import ApiServer
from cake_tpu_torch.runtime.batch_backend import DistributedBatchBackend
from cake_tpu_torch.runtime.master import DistributedForwardStep
from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig
from cake_tpu_torch.utils import metrics

MAX_SEQ = 96
GREEDY = dict(temperature=0.0, repeat_penalty=1.0)
LAYOUT = {"w0": ["model.layers.0-5"]}


@pytest.fixture(autouse=True)
def _clear_plans():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def spec_fields(spec):
    return None if spec is None else (spec.kind, spec.site, spec.node, spec.after, spec.count,
                                      spec.p, spec.delay_s, spec.frac)


PLANS = [
    "seed=7;kill@worker.op:node=w1:after=2:count=1;delay@client.send:delay_s=0.01:count=0",
    "seed=123;drop@site:p=0.5:count=0",
    "seed=5;drop@client.*:p=0.3:count=4;truncate@worker.reply:frac=0.25:after=1;"
    "stall@backend.decode:p=0.7:count=0:delay_s=0",
    "crash@backend.*:node=w?:after=3",
]
CHECKPOINTS = [("worker.op", "w1"), ("worker.op", "w2"), ("client.send", "w1"),
               ("site", None), ("client.recv", "w2"), ("worker.reply", "w1"),
               ("backend.decode", None), ("backend.prefill", "w3")] * 12


@pytest.mark.parametrize("text", PLANS)
def test_plans_parse_and_fire_as_the_reference(text):
    """The same specs, and over a long mixed checkpoint sequence the same
    spec fires at every checkpoint (p<1 decisions included)."""
    plan, jplan = faults.parse(text), jfaults.parse(text)
    assert plan.seed == jplan.seed
    assert [spec_fields(s) for s in plan.specs] == [spec_fields(s) for s in jplan.specs]
    fired = [spec_fields(plan.check(site, node)) for site, node in CHECKPOINTS]
    jfired = [spec_fields(jplan.check(site, node)) for site, node in CHECKPOINTS]
    assert fired == jfired
    assert [(s.seen, s.fired) for s in plan.specs] == [(s.seen, s.fired) for s in jplan.specs]


def test_dsl_parse_and_fire_order():
    """test_chaos.TestFaultPlan.test_dsl_parse_and_fire_order on the port."""
    plan = faults.parse(
        "seed=7;kill@worker.op:node=w1:after=2:count=1;delay@client.send:delay_s=0.01:count=0"
    )
    assert plan.seed == 7
    assert plan.check("worker.op", "w1") is None
    assert plan.check("worker.op", "w2") is None
    assert plan.check("worker.op", "w1") is None
    spec = plan.check("worker.op", "w1")
    assert spec is not None and spec.kind == "kill"
    assert plan.check("worker.op", "w1") is None
    assert plan.check("client.send").kind == "delay"
    assert plan.check("client.send").kind == "delay"


def test_seeded_probability_is_deterministic():
    def decisions(mod):
        plan = mod.parse("seed=123;drop@site:p=0.5:count=0")
        return [plan.check("site") is not None for _ in range(64)]

    a, b = decisions(faults), decisions(faults)
    assert a == b == decisions(jfaults)
    assert any(a) and not all(a)


@pytest.mark.parametrize("bad", ["kill-without-site", "explode@site", "kill@site:wat",
                                 "kill@site:when=3", "kill@:after=1"])
def test_malformed_plans_fail_loudly(bad):
    for mod in (faults, jfaults):
        with pytest.raises(ValueError):
            mod.parse(bad)


def test_fired_fault_is_observable():
    metrics.registry.clear()
    metrics.flight.clear()
    timeline.clear()
    faults.install(faults.parse("stall@x.y:delay_s=0.0"))
    assert faults.active() is not None
    assert faults.check("x.y", "n0") is not None
    assert faults.check("x.y", "n0") is None  # count=1
    assert metrics.registry.counter("cake_faults_injected_total").value(
        kind="stall", site="x.y") == 1
    events = [e for e in metrics.flight.snapshot() if e["event"] == "fault-injected"]
    assert events and events[0]["site"] == "x.y" and events[0]["spec"] == "stall@x.y"
    assert any(e.get("name") == "fault" for e in timeline.snapshot())
    faults.clear()
    assert faults.active() is None and faults.check("x.y") is None


def test_install_from_env(monkeypatch):
    monkeypatch.setenv("CAKE_FAULTS", "seed=4;drop@client.send:p=0.5")
    plan = faults.install_from_env()
    assert plan is faults.active() and plan.seed == 4 and plan.specs[0].kind == "drop"
    monkeypatch.delenv("CAKE_FAULTS")
    faults.clear()
    assert faults.install_from_env() is None and faults.active() is None


def test_cli_faults_flag_installs_and_refuses(tmp_path, capsys):
    """--faults installs the plan before anything is built; a malformed plan
    exits 2 naming the flag."""
    assert cli.main(["--model", str(tmp_path), "--faults", "explode@site"]) == 2
    assert "--faults" in capsys.readouterr().err
    args = cli.build_parser().parse_args(
        ["--model", "m", "--faults", "kill@worker.op", "--failover-max", "3",
         "--failover-budget", "9", "--failover-cooldown", "0.5", "--failover-local",
         "--heartbeat-interval", "0.2", "--heartbeat-deadline", "0.7"])
    serve = cli.serve_config(args)
    assert (serve.max_failovers, serve.failover_budget_s, serve.failover_cooldown_s,
            serve.failover_local, serve.heartbeat_interval_s, serve.heartbeat_deadline_s) == (
        3, 9.0, 0.5, True, 0.2, 0.7)


# ------------------------------------------------- live TCP (one worker)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return C.write_checkpoint(tmp_path_factory.mktemp("faults") / "model", seed=31)


@pytest.fixture(scope="module")
def clusters(ckpt):
    with C.port_cluster(ckpt, LAYOUT, max_seq_len=MAX_SEQ) as (topo, workers), \
            C.jax_cluster(ckpt, LAYOUT, max_seq_len=MAX_SEQ) as (jtopo, _):
        yield topo, workers, jtopo


def _engines(ckpt, clusters):
    topo, _, jtopo = clusters
    cfg, jcfg = LlamaConfig.from_model_dir(ckpt), JaxConfig.from_model_dir(ckpt)
    serve = dict(max_batch=4, decode_chunk_size=4, admission_window=0.05)
    step = DistributedForwardStep(cfg, ckpt, topo, dtype=torch.float32, max_seq_len=MAX_SEQ,
                                  op_deadline_s=1.0, op_retries=2, reconnect_attempts=3,
                                  reconnect_backoff_s=0.05, device="cpu")
    jstep = JaxStep(jcfg, ckpt, jtopo, dtype=jnp.float32, max_seq_len=MAX_SEQ,
                    op_deadline_s=1.0, op_retries=2, reconnect_attempts=3,
                    reconnect_backoff_s=0.05)
    eng = BatchEngine(cfg, None, ByteTokenizer(), max_seq_len=MAX_SEQ, cache_dtype=torch.float32,
                      serve=ServeConfig(**serve), backend=DistributedBatchBackend(step))
    jeng = JaxEngine(jcfg, None, JaxByteTokenizer(), max_seq_len=MAX_SEQ,
                     cache_dtype=jnp.float32, serve=JaxServe(**serve),
                     backend=JaxTcpBackend(jstep, max_seq_len=MAX_SEQ,
                                           cache_dtype=jnp.float32))
    eng.start()
    jeng.start()
    return (eng, step), (jeng, jstep)


def _two_streams(ckpt, clusters, plan: str | None):
    """(port ids and finishes, JAX ids and finishes) of the survivor and the
    long victim under ``plan`` (installed in both packages)."""
    if plan is not None:
        faults.install(faults.parse(plan))
        jfaults.install(jfaults.parse(plan))
    metrics.registry.clear()
    port, jax_side = _engines(ckpt, clusters)
    out = []
    try:
        for (eng, _), (msg, samp) in ((port, (Message, SamplingConfig)),
                                      (jax_side, (JaxMessage, JaxSampling))):
            hs = [eng.submit([msg.user("survivor")], 2, samp(**GREEDY)),
                  eng.submit([msg.user("the long victim stream")], 16, samp(**GREEDY))]
            ids = [[t.id for t in h.tokens()] for h in hs]
            out.append((ids, [h.finish_reason for h in hs], eng.stats["stream_errors"]))
    finally:
        for eng, step in (port, jax_side):
            eng.stop()
            step.close()
    return out


@pytest.fixture(scope="module")
def fault_free(ckpt, clusters):
    return _two_streams(ckpt, clusters, None)


def test_tcp_connection_kill_replays_to_completion(ckpt, clusters, fault_free):
    """kill@worker.op tears the connection mid-decode (the process lives):
    the client re-dials and resends; every stream equals the fault-free
    run and the JAX engine's."""
    want = fault_free
    got = _two_streams(ckpt, clusters, "kill@worker.op:after=4:count=1")
    assert got[0] == got[1] and got[0][0] == want[0][0] == want[1][0]
    assert got[0][2] == 0
    assert metrics.registry.counter("cake_op_retries_total").value(node="w0") >= 1


def test_tcp_reply_drop_served_from_replay_cache(ckpt, clusters, fault_free):
    """drop@worker.reply: the op applied and its reply was lost; the resend
    is answered from the worker's replay cache, not run twice."""
    _, workers, _ = clusters
    want = fault_free
    before = workers["w0"].replays
    got = _two_streams(ckpt, clusters, "drop@worker.reply:after=3:count=1")
    assert got[0] == got[1] and got[0][0] == want[0][0]
    assert workers["w0"].replays > before
    assert metrics.registry.counter("cake_worker_replays_total").value(node="w0") >= 1


def test_tcp_worker_crash_errors_live_streams_only(ckpt, clusters, fault_free):
    """crash@worker.op drops the sessions: the finished survivor is the
    fault-free one, the live victim finishes "error" with a prefix of its
    fault-free stream, in both packages."""
    want = fault_free
    got = _two_streams(ckpt, clusters, "crash@worker.op:after=5:count=1")
    assert got[0] == got[1]
    (short, long_), fins, errors = got[0]
    assert short == want[0][0][0] and fins == ["length", "error"] and errors == 1
    assert long_ == want[0][0][1][: len(long_)] and len(long_) < len(want[0][0][1])


def test_backend_guard_sites_match_the_reference(ckpt):
    """Every dispatch passes backend.<op> first: a crash at backend.prefill
    fails the epoch's streams "error" (no opt-in), a stall only delays, and
    the restore and copy-on-write dispatches check the reference's sites
    (a restore is a join, a copy none)."""
    cfg = LlamaConfig.from_model_dir(ckpt)
    params = load_params(ckpt, cfg, torch.float32)
    eng = BatchEngine(cfg, params, ByteTokenizer(), max_seq_len=MAX_SEQ,
                      cache_dtype=torch.float32, device="cpu",
                      serve=ServeConfig(max_batch=2, decode_chunk_size=4, admission_window=0.0))
    eng.start()
    try:
        faults.install(faults.parse("stall@backend.decode:delay_s=0.01:count=2"))
        h = eng.submit([Message.user("hi")], 6, SamplingConfig(**GREEDY))
        assert len([t for t in h.tokens()]) == 6 and h.finish_reason == "length"
        assert faults.active().specs[0].fired == 2
        assert eng.wait_idle()  # the next request opens an epoch (a prefill), not a join
        faults.install(faults.parse("crash@backend.prefill"))
        h = eng.submit([Message.user("hi")], 6, SamplingConfig(**GREEDY))
        list(h.tokens())
        assert h.finish_reason == "error" and eng.stats["stream_errors"] == 1
    finally:
        eng.stop()
    assert BatchEngine._FAULT_SITES == {"prefill": "prefill", "decode": "decode",
                                        "join": "join", "restore": "join"}


def test_api_stream_checkpoint(ckpt):
    """stall@api.stream sleeps before each SSE chunk is written (a consumer
    that stopped reading); the stream still completes."""
    from cake_tpu_torch.models.llama.generator import LlamaGenerator

    gen = LlamaGenerator.load(ckpt, dtype=torch.float32, max_seq_len=MAX_SEQ,
                              sampling=SamplingConfig(**GREEDY), device="cpu")
    server = ApiServer(gen)
    httpd = server.make_server("127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        faults.install(faults.parse("stall@api.stream:delay_s=0.0:count=0"))
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)
        conn.request("POST", "/api/v1/chat/completions", json.dumps(
            {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 3,
             "stream": True}), {"Content-Type": "application/json"})
        body = conn.getresponse().read().decode()
        assert body.count("data:") >= 3 and "[DONE]" in body
        assert faults.active().specs[0].fired >= 3
    finally:
        httpd.shutdown()
