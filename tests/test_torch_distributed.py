"""The port's master/worker pipeline over TCP on the CPU (runtime/worker.py,
client.py, master.py, router.py), on a live loopback cluster of port
workers: w1 serves layers 0-1, w2 3-4, the master runs 2 and 5.

Greedy and seeded sampled streams equal the port's local step and the JAX
package's ``DistributedForwardStep`` over its own workers; reset and
regenerate on live connections reproduces the stream; prefix reuse gives a
fresh run's stream; the worker answers a bad range with an error frame, a
duplicate (sid, seq) from its replay cache without re-executing, a seq gap
with ``bad-seq`` and an unknown session with ``unknown-session``; a replica
pair routes two sequences to its two members; and the generator recovers
from connection loss (tests/test_recovery.py's three cases)."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _tcp_cluster as C
from _tcp_cluster import one_torch_thread  # noqa: F401  (autouse)
from cake_tpu.models.llama.config import LlamaConfig as JaxConfig
from cake_tpu.runtime.master import DistributedForwardStep as JaxStep
from cake_tpu_torch.io.safetensors_io import load_params
from cake_tpu_torch.models.llama.chat import Message
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import (
    LlamaGenerator,
    LocalForwardStep,
    SamplingConfig,
    StepConnectionError,
)
from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer
from cake_tpu_torch.parallel.topology import Topology
from cake_tpu_torch.runtime import proto
from cake_tpu_torch.runtime.client import SessionLost, StageClient
from cake_tpu_torch.runtime.master import DistributedForwardStep, Master
from cake_tpu_torch.runtime.worker import STATS_NOT_PORTED, Worker, torch_to_wire

PROMPT = "distributed oracle"


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    model_dir = C.write_checkpoint(tmp_path_factory.mktemp("tcp") / "model")
    cfg = LlamaConfig.from_model_dir(model_dir)
    params = load_params(model_dir, cfg, torch.float32)
    with C.port_cluster(model_dir) as (topo, workers):
        yield cfg, params, model_dir, topo, workers


def _step(cluster, **kw):
    cfg, _, model_dir, topo, _ = cluster
    return DistributedForwardStep(cfg, model_dir, topo, dtype=torch.float32,
                                  max_seq_len=C.MAX_SEQ, device="cpu", **kw)


def _local(cfg, params):
    return LocalForwardStep(cfg, params, max_seq_len=C.MAX_SEQ, cache_dtype=torch.float32,
                            device="cpu")


def test_worker_owns_only_its_ranges(cluster):
    _, _, _, _, workers = cluster
    assert workers["w1"].ranges == [(0, 2)] and workers["w2"].ranges == [(3, 5)]
    assert set(workers["w1"].range_params[(0, 2)]) >= {"wqkv", "w_gu", "wo", "w_down"}
    assert workers["w1"].range_params[(0, 2)]["wqkv"].shape[0] == 2


@pytest.mark.parametrize("knobs", sorted(C.KNOBS))
def test_streams_equal_the_local_step_and_the_jax_master(cluster, knobs):
    cfg, params, model_dir, topo, _ = cluster
    want = C.port_ids(cfg, _local(cfg, params), PROMPT, 10, knobs)
    step = _step(cluster)
    try:
        assert C.port_ids(cfg, step, PROMPT, 10, knobs) == want
    finally:
        step.close()
    jcfg = JaxConfig.from_model_dir(model_dir)
    with C.jax_cluster(model_dir) as (jtopo, _):
        jstep = JaxStep(jcfg, model_dir, jtopo, dtype=jnp.float32, max_seq_len=C.MAX_SEQ)
        try:
            assert C.jax_ids(jcfg, jstep, PROMPT, 10, knobs) == want
        finally:
            jstep.close()


def test_reset_and_regenerate_on_live_connections(cluster):
    cfg, params, _, _, _ = cluster
    want = C.port_ids(cfg, _local(cfg, params), PROMPT, 6)
    step = _step(cluster)
    try:
        sids = []
        for _ in range(2):
            assert C.port_ids(cfg, step, PROMPT, 6) == want
            sids.append(step.clients["w1"].sid)
        assert sids[0] != sids[1]  # every sequence runs under a fresh replay session
    finally:
        step.close()


def test_prefix_reuse_matches_a_fresh_run(cluster):
    cfg = cluster[0]

    def two_turns(prefix_cache):
        step = _step(cluster)
        gen = LlamaGenerator(cfg, step, ByteTokenizer(), SamplingConfig(**C.KNOBS["greedy"]),
                             prefix_cache=prefix_cache)
        try:
            user1 = Message.user("distributed prefix reuse probe")
            gen.add_message(user1)
            gen.generate(6)
            reply = ByteTokenizer().decode(
                [t for t in gen.generated_token_ids if t not in cfg.eos_token_ids])
            gen.reset()
            for m in (user1, Message.assistant(reply), Message.user("turn two")):
                gen.add_message(m)
            gen.generate(6)
            return list(gen.generated_token_ids), gen.last_prefill_tokens
        finally:
            step.close()

    got, prefilled = two_turns(True)
    want, full = two_turns(False)
    assert got == want
    assert prefilled < full


def _x(cfg, rows=1, width=1, seed=0):
    g = np.random.default_rng(seed)
    return proto.WireTensor.from_numpy(
        g.standard_normal((rows, width, cfg.hidden_size)).astype(np.float32))


def test_worker_error_frames_and_handshake(cluster):
    cfg, _, _, topo, _ = cluster
    c = StageClient(topo.nodes["w1"].host, "w1")
    try:
        assert c.info.ranges == [[0, 2]] and c.info.device == "cpu"
        assert c.info.batch_ops and not c.info.verify_ops and not c.info.stats_ops
        with pytest.raises(RuntimeError, match="not owned"):
            c.forward(_x(cfg), [(0, 5)], 0)
        assert c.ping() < 1000  # a structured ERROR, not a dropped connection
        proto.write_frame(c._sock, proto.stats_request_frame())
        reply = proto.read_frame(c._sock)
        assert reply.type == proto.MsgType.ERROR and reply.header["error"] == STATS_NOT_PORTED
    finally:
        c.close()


def test_replay_cache_bad_seq_and_unknown_session(cluster):
    cfg, _, _, topo, workers = cluster
    w = workers["w1"]
    c = StageClient(topo.nodes["w1"].host, "w1")
    try:
        frame = proto.forward_frame(_x(cfg, width=4), [(0, 2)], 0, sid="s-replay", seq=0)
        proto.write_frame(c._sock, frame)
        first = proto.read_frame(c._sock)
        ops, replays = w.ops, w.replays
        # The same (sid, seq) again, as after a lost reply: answered from the
        # replay cache, the op not executed a second time.
        proto.write_frame(c._sock, frame)
        again = proto.read_frame(c._sock)
        assert (w.ops, w.replays) == (ops, replays + 1)
        assert again.header == first.header and bytes(again.payload) == bytes(first.payload)
        # seq 2 skips seq 1: the state diverged.
        c.begin_session("s-replay")
        c._seq = 2
        with pytest.raises(SessionLost) as e:
            c.forward(_x(cfg), [(0, 2)], 4)
        assert e.value.code == proto.ERR_BAD_SEQ
        c.begin_session("s-never-opened")
        c._seq = 3
        with pytest.raises(SessionLost) as e:
            c.forward(_x(cfg), [(0, 2)], 4)
        assert e.value.code == proto.ERR_UNKNOWN_SESSION
    finally:
        c.close()


def test_lost_reply_is_resent_and_answered_from_the_cache(cluster, monkeypatch):
    """A reply lost on the wire: the client re-dials and resends the same
    (sid, seq); the worker answers from its cache; the stream is unchanged."""
    cfg, params, _, _, workers = cluster
    want = C.port_ids(cfg, _local(cfg, params), PROMPT, 6)
    step = _step(cluster, reconnect_backoff_s=0.0)
    client = step.clients["w2"]
    real = client._round_trip
    state = {"n": 0}

    def lose_third_reply(*a, **kw):
        out = real(*a, **kw)
        state["n"] += 1
        if state["n"] == 3:
            client._sock.close()
            raise ConnectionError("reply lost")
        return out

    monkeypatch.setattr(client, "_round_trip", lose_third_reply)
    replays = workers["w2"].replays
    try:
        assert C.port_ids(cfg, step, PROMPT, 6) == want
        assert workers["w2"].replays == replays + 1
    finally:
        step.close()


def test_replica_pair_routes_two_sequences_to_two_members(tmp_path):
    model_dir = C.write_checkpoint(tmp_path / "model")
    cfg = LlamaConfig.from_model_dir(model_dir)
    layout = {"w1": ["model.layers.0-2"], "w2": ["model.layers.3-5"],
              "w2b": ["model.layers.3-5"]}
    with C.port_cluster(model_dir, layout) as (topo, workers):
        assert workers["w2b"].ranges == [(3, 6)]
        step = DistributedForwardStep(cfg, model_dir, topo, dtype=torch.float32,
                                      max_seq_len=C.MAX_SEQ, device="cpu")
        try:
            assert step.local_params == {}  # the master runs no layer
            streams, served = [], []
            for _ in range(2):
                before = {n: w.ops for n, w in workers.items()}
                streams.append(C.port_ids(cfg, step, PROMPT, 5))
                served.append(sorted(n for n, w in workers.items() if w.ops > before[n]))
            assert streams[0] == streams[1]
            # Each new sequence advances the group's round robin.
            assert sorted(map(tuple, served)) == [("w1", "w2"), ("w1", "w2b")]
        finally:
            step.close()


@pytest.mark.parametrize("after", [0, 5], ids=["in_the_prefill", "after_5_tokens"])
def test_connection_loss_mid_generation_recovers(cluster, after):
    cfg, params, _, _, _ = cluster
    prompt = "resilience probe"
    want = C.port_ids(cfg, _local(cfg, params), prompt, 12)
    # No wire retry: the blip reaches the generator, which replays its history.
    step = _step(cluster, op_retries=0)
    gen = LlamaGenerator(cfg, step, ByteTokenizer(), SamplingConfig(**C.KNOBS["greedy"]))
    replays = []
    real = gen._replay_history
    gen._replay_history = lambda: (replays.append(1), real())[1]
    try:
        gen.add_message(Message.user(prompt))
        if after:
            gen.generate(after)
        step.clients["w1"]._sock.close()  # a network blip under the master
        gen.generate(12 - after)
        assert gen.generated_token_ids == want
        assert len(replays) == 1
    finally:
        step.close()


def test_replay_feeds_the_shapes_the_stream_was_first_fed(cluster):
    """The replay rebuilds the KV with the calls that first wrote it: the
    prompt's prefill chunks, then one decode step a generated token, so the
    card's kernels give the lost KV's bits (a chunked replay would round
    the generated tokens' K/V otherwise)."""
    cfg = cluster[0]
    step = _step(cluster, op_retries=0)
    calls = []

    class Recorder:
        max_seq_len = step.max_seq_len
        device = step.device

        def reset(self):
            step.reset()

        def __call__(self, tokens, pos, seq_len):
            calls.append((tuple(tokens.shape), int(pos), int(seq_len)))
            return step(tokens, pos, seq_len)

    gen = LlamaGenerator(cfg, Recorder(), ByteTokenizer(),
                         SamplingConfig(**C.KNOBS["greedy"]), prefill_chunk=8)
    try:
        gen.add_message(Message.user("replay shapes"))
        gen.generate(4)
        first = list(calls)
        step.clients["w1"]._sock.close()
        gen.generate(1)
        # The step that failed, then the replay: every call the stream made
        # so far, in order; then the failed step again.
        pending = ((1, 1), first[-1][1] + 1, 1)
        assert calls[len(first):] == [pending, *first, pending]
        assert first[0] == ((1, 8), 0, 8)  # the replayed prompt's chunks
    finally:
        step.close()


def test_recovery_budget_is_per_incident_not_per_call(cluster):
    """Three blips in one generate() call, separated by produced tokens, do
    not abort it: the allowance resets once a token is produced."""
    cfg, params, _, _, _ = cluster
    prompt = "three separate incidents"
    want = C.port_ids(cfg, _local(cfg, params), prompt, 16)
    step = _step(cluster, op_retries=0)
    gen = LlamaGenerator(cfg, step, ByteTokenizer(), SamplingConfig(**C.KNOBS["greedy"]))
    emitted = 0

    def blip_every_4th(tok):
        nonlocal emitted
        emitted += 1
        if emitted in (4, 8, 12):
            step.clients["w1"]._sock.close()

    replays = []
    real = gen._replay_history
    gen._replay_history = lambda: (replays.append(1), real())[1]
    try:
        gen.add_message(Message.user(prompt))
        gen.generate(16, on_token=blip_every_4th)
        assert gen.generated_token_ids == want
        assert len(replays) == 3  # 3 incidents > the budget of 2 in a row
    finally:
        step.close()


def test_recovery_gives_up_after_repeated_failures(cluster, monkeypatch):
    cfg = cluster[0]
    step = _step(cluster, op_retries=0)
    gen = LlamaGenerator(cfg, step, ByteTokenizer(), SamplingConfig(**C.KNOBS["greedy"]))
    try:
        gen.add_message(Message.user("fail forever"))
        gen.generate(2)

        def always_fail(*a, **kw):
            raise StepConnectionError("w1")

        monkeypatch.setattr(step.clients["w1"], "forward", always_fail)
        with pytest.raises(StepConnectionError):
            gen.generate(4)
    finally:
        step.close()


def test_a_failed_hop_raises_and_never_runs_the_range_on_the_master(cluster, monkeypatch):
    cfg = cluster[0]
    step = _step(cluster, op_retries=0, reconnect_attempts=1)
    try:
        def dead(*a, **kw):
            raise ConnectionError("worker gone")

        monkeypatch.setattr(step.clients["w2"], "_round_trip", dead)
        with pytest.raises(StepConnectionError, match="w2"):
            step(np.zeros((1, 16), np.int64), 0, 3)
        assert step.router.snapshot()["ejected"] == ["w2"]
    finally:
        step.close()


def test_master_generate_reports_tokens_per_second(cluster, caplog):
    cfg = cluster[0]
    step = _step(cluster)
    gen = LlamaGenerator(cfg, step, ByteTokenizer(), SamplingConfig(**C.KNOBS["greedy"]))
    gen.add_message(Message.user("hello"))
    tokens = []
    try:
        with caplog.at_level(logging.INFO, logger="cake_tpu_torch.master"):
            Master(gen, sample_len=5).generate(on_token=tokens.append)
        assert len(tokens) == 5 or tokens[-1].is_end_of_stream
        assert any("tok/s" in r.message for r in caplog.records)
    finally:
        step.close()


def test_trace_id_rides_the_forward_header(cluster):
    cfg, _, _, topo, _ = cluster
    c = StageClient(topo.nodes["w1"].host, "w1")
    try:
        proto.write_frame(c._sock, proto.forward_frame(_x(cfg), [(0, 2)], 0, trace="req-wire"))
        reply = proto.read_frame(c._sock)
        assert reply.type == proto.MsgType.TENSOR and reply.header["trace"] == "req-wire"
    finally:
        c.close()


def test_worker_and_master_need_a_gpu_unless_asked_for_the_cpu(cluster):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    cfg, _, model_dir, topo, _ = cluster
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Worker("w1", model_dir, topo, ("127.0.0.1", 0), dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedForwardStep(cfg, model_dir, topo, dtype=torch.float32)


def test_params_seam_equals_the_checkpoint(cluster):
    """Workers and master built from a tree already in memory (the
    chip_smoke seam) give the checkpoint-built cluster's stream."""
    cfg, params, _, _, _ = cluster
    topo = C.topology(Topology)
    workers = []
    try:
        for name in C.LAYOUT:
            w = Worker(name, None, topo, ("127.0.0.1", 0), dtype=torch.float32,
                       max_seq_len=C.MAX_SEQ, device="cpu", config=cfg, params=params)
            w.start()
            topo.nodes[name].host = f"127.0.0.1:{w.address[1]}"
            workers.append(w)
        step = DistributedForwardStep(cfg, None, topo, dtype=torch.float32,
                                      max_seq_len=C.MAX_SEQ, device="cpu", params=params)
        try:
            x = torch_to_wire(torch.zeros(1, 1, cfg.hidden_size))
            assert x.shape == (1, 1, cfg.hidden_size)
            assert (workers[0].range_params[(0, 2)]["wqkv"].data_ptr()
                    == params["layers"]["wqkv"].data_ptr())  # views, no copy
            assert C.port_ids(cfg, step, PROMPT, 6) == C.port_ids(
                cfg, _step(cluster), PROMPT, 6)
        finally:
            step.close()
    finally:
        for w in workers:
            w.stop()
