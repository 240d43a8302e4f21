"""Continuous batching over the TCP topology (the port's
``DistributedBatchBackend``) on the CPU, on a live cluster of port workers
(w1: layers 0-1, w2: 3-4, the master 2 and 5).

The backend's prefill / decode / join equal the dense ``LocalBatchBackend``
(greedy and seeded sampled ids bitwise, join logits); the engine over TCP
gives the streams of the port's dense local engine and of the JAX package's
TCP engine, under the epoch and the continuous scheduler; a worker without
``batch_ops`` is refused; a worker lost mid-epoch finishes the live streams
with ``finish_reason="error"`` while the engine keeps serving; and what the
JAX package refuses over TCP the port refuses too (paged KV, a quantizing
master, the mesh backend)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _tcp_cluster as C
from _tcp_cluster import one_torch_thread  # noqa: F401  (autouse)
from cake_tpu.models.llama.chat import Message as JaxMessage
from cake_tpu.models.llama.config import LlamaConfig as JaxConfig
from cake_tpu.models.llama.generator import SamplingConfig as JaxSampling
from cake_tpu.models.llama.tokenizer import ByteTokenizer as JaxByteTokenizer
from cake_tpu.runtime.batch_backend import DistributedBatchBackend as JaxTcpBackend
from cake_tpu.runtime.master import DistributedForwardStep as JaxStep
from cake_tpu.runtime.serving import BatchEngine as JaxEngine
from cake_tpu_torch import cli
from cake_tpu_torch.io.safetensors_io import load_params
from cake_tpu_torch.models.llama.batch import first_sample, layout_prompts, seed_rings
from cake_tpu_torch.models.llama.chat import Message
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import SamplingConfig
from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer
from cake_tpu_torch.ops.threefry import prng_key
from cake_tpu_torch.runtime.batch_backend import DistributedBatchBackend, LocalBatchBackend
from cake_tpu_torch.runtime.master import DistributedForwardStep
from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig

MAX_SEQ = 256
SERVE = dict(max_batch=4, decode_chunk_size=3, admission_window=0.05)
REQUESTS = [("A", "Tell me about cakes.", 20), ("B", "Capital of France?", 20),
            ("C", "And pies?", 8), ("D", "Name a colour.", 8)]


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    model_dir = C.write_checkpoint(tmp_path_factory.mktemp("tcpb") / "model", seed=31)
    cfg = LlamaConfig.from_model_dir(model_dir)
    params = load_params(model_dir, cfg, torch.float32)
    with C.port_cluster(model_dir, max_seq_len=MAX_SEQ) as (topo, workers):
        step = DistributedForwardStep(cfg, model_dir, topo, dtype=torch.float32,
                                      max_seq_len=MAX_SEQ, device="cpu")
        yield cfg, params, model_dir, topo, workers, step
        step.close()


def _backends(cluster):
    cfg, params, _, _, _, step = cluster
    return (LocalBatchBackend(cfg, params, max_seq_len=MAX_SEQ, cache_dtype=torch.float32,
                              device="cpu"),
            DistributedBatchBackend(step))


def _i64(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.int64)


@pytest.mark.parametrize("knobs", sorted(C.KNOBS))
def test_prefill_decode_matches_local(cluster, knobs):
    s = SamplingConfig(**C.KNOBS[knobs])
    ids_list = [[7, 3, 11, 2][: 2 + r] for r in range(3)]
    tokens, pads, bucket = layout_prompts(ids_list, MAX_SEQ)
    outs = []
    for be in _backends(cluster):
        kv = be.init_kv(3)
        logits, kv = be.prefill(tokens, kv, pads)
        ring, ring_idx = seed_rings(ids_list, s.repeat_last_n)
        first, keys, ring, ring_idx = first_sample(logits, s, ring, ring_idx,
                                                   prng_key([5, 6, 7]))
        toks, kv, keys, ring_j, ridx_j = be.decode(
            kv, _i64(first), bucket, torch.as_tensor(pads), keys, _i64(ring), _i64(ring_idx),
            6, s,
        )
        outs.append((first.tolist(), toks.tolist(), keys.tolist(), ring_j.tolist()))
    assert outs[0] == outs[1]


def test_join_matches_local(cluster):
    s = SamplingConfig(**C.KNOBS["greedy"])
    ids_list = [[5, 9], [4, 8, 2]]
    tokens, pads, bucket = layout_prompts(ids_list, MAX_SEQ)
    join_ids = [6, 1]
    outs = []
    for be in _backends(cluster):
        kv = be.init_kv(2)
        logits, kv = be.prefill(tokens, kv, pads)
        ring, ring_idx = seed_rings(ids_list, 0)
        first, keys, ring, ring_idx = first_sample(logits, s, ring, ring_idx, prng_key([1, 2]))
        pads_j = torch.tensor(pads)  # a copy: the join rewrites a pad in place
        toks1, kv, keys, ring_j, ridx_j = be.decode(
            kv, _i64(first), bucket, pads_j, keys, _i64(ring), _i64(ring_idx), 2, s)
        slot = bucket + 2
        row_tokens = np.zeros((1, 64), np.int32)
        row_tokens[0, slot - len(join_ids) : slot] = join_ids
        jlogits, kv = be.join(kv, row_tokens, slot - len(join_ids), slot, 1)
        pads_j[1] = slot - len(join_ids)
        tok = toks1[:, -1].clone()
        tok[1] = int(jlogits[0].argmax())
        toks2, kv, keys, ring_j, ridx_j = be.decode(kv, tok, slot, pads_j, keys, ring_j,
                                                     ridx_j, 3, s)
        outs.append((toks1.tolist(), jlogits, toks2.tolist()))
    (a1, aj, a2), (b1, bj, b2) = outs
    assert a1 == b1 and a2 == b2
    assert torch.equal(aj, bj)


def test_old_worker_rejected(cluster):
    import dataclasses

    step = cluster[5]
    client = next(iter(step.clients.values()))
    old = client.info
    client.info = dataclasses.replace(old, batch_ops=False)
    try:
        with pytest.raises(RuntimeError, match="does not support lockstep"):
            DistributedBatchBackend(step)
    finally:
        client.info = old


def _scenario(submit, message_cls, sampling, seeded=False):
    """A and B open the epoch; once A has a token, C and D join it."""
    handles = {}

    def go(i, name, user, n):
        s = sampling if not seeded else type(sampling)(**{**sampling.__dict__, "seed": 100 + i})
        handles[name] = submit([message_cls.user(user)], n, s)

    for i, (name, user, n) in enumerate(REQUESTS[:2]):
        go(i, name, user, n)
    first = handles["A"].tokens()
    head = [next(first).id]
    for i, (name, user, n) in enumerate(REQUESTS[2:], 2):
        go(i, name, user, n)
    out = {"A": head + [t.id for t in first]}
    for name in "BCD":
        out[name] = [t.id for t in handles[name].tokens()]
    return out, {n: h.finish_reason for n, h in handles.items()}


def _port_engine(cluster, tcp: bool, **serve_kw):
    cfg, params, _, _, _, step = cluster
    serve = ServeConfig(**SERVE, **serve_kw)
    if tcp:
        eng = BatchEngine(cfg, None, ByteTokenizer(), max_seq_len=MAX_SEQ,
                          cache_dtype=torch.float32, serve=serve,
                          backend=DistributedBatchBackend(step))
    else:
        eng = BatchEngine(cfg, params, ByteTokenizer(), max_seq_len=MAX_SEQ,
                          cache_dtype=torch.float32, serve=serve, device="cpu")
    eng.start()
    return eng


@pytest.fixture(scope="module")
def jax_tcp_streams(cluster):
    model_dir = cluster[2]
    cfg = JaxConfig.from_model_dir(model_dir)
    with C.jax_cluster(model_dir, max_seq_len=MAX_SEQ) as (topo, _):
        jstep = JaxStep(cfg, model_dir, topo, dtype=jnp.float32, max_seq_len=MAX_SEQ)
        eng = JaxEngine(cfg, None, JaxByteTokenizer(), max_seq_len=MAX_SEQ,
                        cache_dtype=jnp.float32, backend=JaxTcpBackend(
                            jstep, max_seq_len=MAX_SEQ, cache_dtype=jnp.float32), **SERVE)
        eng.start()
        try:
            return _scenario(eng.submit, JaxMessage, JaxSampling(**C.KNOBS["greedy"]))[0]
        finally:
            eng.stop()
            jstep.close()


@pytest.mark.parametrize("scheduler", ["epoch", "continuous"])
def test_engine_over_tcp_matches_the_local_engine_and_the_jax_tcp_engine(
        cluster, jax_tcp_streams, scheduler):
    runs = {}
    for tcp in (False, True):
        eng = _port_engine(cluster, tcp, scheduler=scheduler)
        try:
            runs[tcp] = [_scenario(eng.submit, Message, SamplingConfig(**C.KNOBS[k]),
                                   seeded=k == "sampled") for k in ("greedy", "sampled")]
            assert eng.wait_idle(10.0)
            stats = eng.snapshot()
        finally:
            eng.stop()
        assert stats["joins"] >= 1 and stats["stream_errors"] == 0
    assert runs[True] == runs[False]
    assert runs[True][0][0] == jax_tcp_streams
    assert stats["node"] == "w1+w2"


def test_lost_worker_ends_the_epochs_streams_with_error(cluster, monkeypatch):
    cfg, _, _, _, _, step = cluster
    eng = _port_engine(cluster, True)
    client = step.clients["w2"]
    real = client._round_trip
    calls = {"n": 0}

    def dies_mid_epoch(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 4:  # the prefill and two decode steps got through
            raise ConnectionError("worker gone")
        return real(*a, **kw)

    monkeypatch.setattr(client, "op_retries", 0)
    monkeypatch.setattr(client, "_round_trip", dies_mid_epoch)
    try:
        s = SamplingConfig(**C.KNOBS["greedy"])
        handles = [eng.submit([Message.user(u)], 12, s) for _, u, _ in REQUESTS[:2]]
        got = [[t.id for t in h.tokens()] for h in handles]
        assert [h.finish_reason for h in handles] == ["error", "error"]
        assert all(0 < len(ids) < 12 for ids in got)
        # The engine keeps serving: the next request runs a new epoch.
        h = eng.submit([Message.user("after the loss")], 4, s)
        assert len([t.id for t in h.tokens()]) == 4 and h.finish_reason == "length"
        assert eng.snapshot()["stream_errors"] == 2
    finally:
        eng.stop()


def test_paged_kv_refused_over_tcp(cluster):
    step = cluster[5]
    with pytest.raises(ValueError, match="dense cache"):
        BatchEngine(step.config, None, ByteTokenizer(), max_seq_len=MAX_SEQ,
                    serve=ServeConfig(kv_mode="paged", page_size=16),
                    backend=DistributedBatchBackend(step))


@pytest.mark.parametrize("flags, message", [
    (["--api", "127.0.0.1:1", "--api-batch", "4", "--kv-mode", "paged"], "dense cache"),
    (["--quantize", "int4"], "--quantize on a master"),
    (["--backend", "mesh"], "queue A, the in-process pipeline and tensor-parallel backends"),
])
def test_cli_refuses_what_the_tcp_master_does_not_run(cluster, tmp_path, flags, message):
    _, _, model_dir, topo, _, _ = cluster
    path = tmp_path / "topology.yml"
    topo.save(path)
    with pytest.raises(SystemExit, match=message):
        cli.main(["--model", str(model_dir), "--topology", str(path), "--device", "cpu",
                  *flags])


def test_cli_worker_needs_a_topology(cluster, capsys):
    assert cli.main(["--model", str(cluster[2]), "--mode", "worker", "--device", "cpu"]) == 2
    assert "requires --topology" in capsys.readouterr().err


def test_cli_master_over_the_cluster_equals_the_local_prompt(cluster, capsys, tmp_path):
    _, _, model_dir, topo, _, _ = cluster
    path = tmp_path / "topology.yml"
    topo.save(path)
    base = ["--model", str(model_dir), "--device", "cpu", "--dtype", "f32", "--prompt", "hi",
            "-n", "6", "--temperature", "0", "--repeat-penalty", "1.0"]
    outs = []
    for extra in ([], ["--topology", str(path)]):
        assert cli.main(base + extra) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0].strip()
