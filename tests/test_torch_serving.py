"""The port's batch serving engine (``runtime/serving.py``) on the CPU.

One tiny checkpoint, written by the JAX package, is served greedily by the
JAX ``BatchEngine`` and by the port's, dense, paged and paged with the
prefix cache: four requests, two of which join the running epoch and two of
which share a system prompt, give the same token streams in both packages.
On the CPU the JAX engine resolves its attention to the XLA twins; the
kernel-level tests (tests/test_torch_paged.py) hold the port against the
Pallas kernels.

Then the port's own invariants, all bitwise: a second wave served from the
prefix cache equals the cold first wave, a joined request equals the same
request served alone, and paged equals dense. Then the decode fusions: the
fused engine equals the unfused one, greedy and sampled, and the JAX engine
with its fusion kernels, greedy. Then cancel, the refusals of what is not
ported, and the API's engine path with concurrent SSE clients.
"""

import http.client
import json
import threading

import jax.numpy as jnp
import pytest
import torch

from cake_tpu.io.safetensors_io import load_params as jax_load_params
from cake_tpu.io.safetensors_io import save_tiny_checkpoint as jax_save_tiny_checkpoint
from cake_tpu.models.llama import model as JM
from cake_tpu.models.llama.chat import Message as JaxMessage
from cake_tpu.models.llama.config import LlamaConfig as JaxConfig
from cake_tpu.models.llama.generator import SamplingConfig as JaxSampling
from cake_tpu.models.llama.tokenizer import load_tokenizer as jax_load_tokenizer
from cake_tpu.runtime.serving import BatchEngine as JaxEngine
from cake_tpu.runtime.serving import ServeConfig as JaxServe
from cake_tpu_torch.io.safetensors_io import load_params
from cake_tpu_torch.models.llama.chat import Message
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import LlamaGenerator, SamplingConfig
from cake_tpu_torch.models.llama.tokenizer import load_tokenizer
from cake_tpu_torch.runtime.api import ApiServer
from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)

MAX_SEQ = 256
PAGE = 16
GREEDY = dict(temperature=0.0, repeat_penalty=1.0)
SYS = "You are a terse assistant who answers every question in one short sentence."
# (name, system prompt?, user turn, max_tokens): A and B open the epoch, C and
# D join it; A and C share the system prompt.
REQUESTS = [
    ("A", True, "Tell me about cakes.", 40),
    ("B", False, "What is the capital of France?", 40),
    ("C", True, "And about pies?", 12),
    ("D", False, "Name a colour.", 12),
]
MODES = {
    "dense": {},
    "paged": {"kv_mode": "paged", "page_size": PAGE},
    "prefix": {"kv_mode": "paged", "page_size": PAGE, "prefix_cache": True},
}
SERVE = dict(max_batch=4, decode_chunk_size=4, admission_window=0.05)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = JaxConfig.tiny(num_hidden_layers=2)
    params = JM.init_params(cfg, __import__("jax").random.PRNGKey(21), jnp.float32)
    path = tmp_path_factory.mktemp("tiny_engine")
    jax_save_tiny_checkpoint(path, params, cfg)
    return path


def _messages(cls, system: bool, user: str):
    return ([cls.system(SYS)] if system else []) + [cls.user(user)]


def _scenario(submit, message_cls, sampling):
    """Submit A and B, wait for A's first token, then submit C and D (they
    join the running epoch at the next chunk boundary). Returns the id
    streams by name."""
    handles = {}
    for name, system, user, n in REQUESTS[:2]:
        handles[name] = submit(_messages(message_cls, system, user), n, sampling)
    first = handles["A"].tokens()
    head = [next(first).id]
    for name, system, user, n in REQUESTS[2:]:
        handles[name] = submit(_messages(message_cls, system, user), n, sampling)
    out = {"A": head + [t.id for t in first]}
    for name in "BCD":
        out[name] = [t.id for t in handles[name].tokens()]
    return out


@pytest.fixture(scope="module")
def jax_streams(ckpt):
    """The JAX engine's streams, one engine per mode, built once."""
    cfg = JaxConfig.from_model_dir(ckpt)
    params = jax_load_params(ckpt, cfg, jnp.float32)
    tok = jax_load_tokenizer(ckpt)
    out = {}
    for mode, kw in MODES.items():
        eng = JaxEngine(cfg, params, tok, max_seq_len=MAX_SEQ, cache_dtype=jnp.float32,
                        serve=JaxServe(**SERVE, **kw))
        eng.start()
        try:
            out[mode] = _scenario(eng.submit, JaxMessage, JaxSampling(**GREEDY))
        finally:
            eng.stop()
    return out


@pytest.fixture(scope="module")
def port_model(ckpt):
    cfg = LlamaConfig.from_model_dir(ckpt)
    return cfg, load_params(ckpt, cfg, torch.float32, "cpu"), load_tokenizer(ckpt)


def _engine(port_model, **kw):
    cfg, params, tok = port_model
    eng = BatchEngine(cfg, params, tok, max_seq_len=MAX_SEQ, cache_dtype=torch.float32,
                      serve=ServeConfig(**SERVE, **kw), device="cpu")
    eng.start()
    return eng


@pytest.fixture(scope="module")
def port_runs(port_model):
    """Per mode: wave 1 (cold), then wave 2 (the prefix engine serves it from
    its cache), with the engine's stats after each wave."""
    out = {}
    for mode, kw in MODES.items():
        eng = _engine(port_model, **kw)
        try:
            waves, stats = [], []
            for _ in range(2):
                waves.append(_scenario(eng.submit, Message, SamplingConfig(**GREEDY)))
                assert eng.wait_idle(10.0)
                stats.append(eng.snapshot())
        finally:
            eng.stop()
        out[mode] = (waves, stats)
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_streams_match_the_jax_engine(jax_streams, port_runs, mode):
    waves, stats = port_runs[mode]
    assert waves[0] == jax_streams[mode]
    assert all(len(ids) > 0 for ids in waves[0].values())
    assert stats[0]["joins"] >= 1  # C and D joined a running epoch


def test_paged_equals_dense_bitwise(port_runs):
    dense = port_runs["dense"][0][0]
    assert port_runs["paged"][0][0] == dense
    assert port_runs["prefix"][0][0] == dense


def test_warm_prefix_equals_cold(port_runs):
    waves, stats = port_runs["prefix"]
    assert waves[1] == waves[0]
    assert stats[1]["prefix_hits"] > stats[0]["prefix_hits"]
    assert stats[1]["prefix"]["pages"] > 0
    # Every lane's pages came back; only the cache holds pages.
    assert stats[1]["pages_free"] == stats[1]["pages_total"] - stats[1]["prefix"]["pages"]


@pytest.mark.parametrize("mode", list(MODES))
def test_joined_equals_solo(port_model, port_runs, mode):
    solo = {}
    for name, system, user, n in REQUESTS[2:]:
        eng = _engine(port_model, **MODES[mode])  # alone: its own epoch, no join
        try:
            h = eng.submit(_messages(Message, system, user), n, SamplingConfig(**GREEDY))
            solo[name] = [t.id for t in h.tokens()]
            assert eng.stats["joins"] == 0
        finally:
            eng.stop()
    joined = port_runs[mode][0][0]
    assert solo == {k: joined[k] for k in solo}


def test_cancel_queued_and_running(port_model):
    eng = _engine(port_model, kv_mode="paged", page_size=PAGE)
    try:
        s = SamplingConfig(**GREEDY)
        running = eng.submit([Message.user("a long answer please")], 200, s)
        it = running.tokens()
        next(it)
        queued = eng.submit([Message.user("different knobs")], 8, SamplingConfig(temperature=0.5))
        assert eng.cancel(queued.request_id)
        assert list(queued.tokens()) == [] and queued.finish_reason == "cancelled"
        assert eng.cancel(running.request_id)
        rest = list(it)
        assert running.finish_reason == "cancelled"
        assert running.completion_tokens == 1 + len(rest) < 200
        assert not eng.cancel(running.request_id)  # idempotent: no longer live
        assert eng.wait_idle(10.0)
        assert eng.snapshot()["pages_free"] == eng.snapshot()["pages_total"]
        after = eng.submit([Message.user("still serving")], 4, s)
        assert len(list(after.tokens())) >= 1
        assert eng.stats["cancelled"] == 2
    finally:
        eng.stop()


def test_unported_knobs_refuse(port_model):
    cfg, params, tok = port_model
    with pytest.raises(ValueError):
        ServeConfig(scheduler="lockstep")
    with pytest.raises(ValueError):
        ServeConfig(kv_mode="dense", prefix_cache=True)
    with pytest.raises(NotImplementedError):
        BatchEngine(cfg, params, tok, max_seq_len=MAX_SEQ, speculative_k=4, device="cpu")


def test_backend_refuses_a_write_past_the_epoch_capacity(port_model):
    cfg, params, tok = port_model
    from cake_tpu_torch.runtime.batch_backend import PagedLocalBackend

    be = PagedLocalBackend(cfg, params, max_seq_len=MAX_SEQ, cache_dtype=torch.float32,
                           page_size=PAGE, device="cpu")
    be.set_epoch_capacity(40)
    assert be.capacity_slots() == 48
    kv = be.init_kv(1)
    with pytest.raises(ValueError, match="capacity"):
        be.prefill([[1] * 64], kv, [0])


# ----------------------------------------------------------- decode fusions

SAMPLED = dict(temperature=0.9, top_k=20, repeat_penalty=1.1, repeat_last_n=8, seed=11)


@pytest.fixture(scope="module")
def jax_fused_streams(ckpt):
    """The JAX engine with every decode fusion on its Pallas kernels
    (interpret mode), paged with the prefix cache."""
    import dataclasses

    cfg = dataclasses.replace(JaxConfig.from_model_dir(ckpt), fusion_impl="all@pallas")
    params = jax_load_params(ckpt, cfg, jnp.float32)
    eng = JaxEngine(cfg, params, jax_load_tokenizer(ckpt), max_seq_len=MAX_SEQ,
                    cache_dtype=jnp.float32, serve=JaxServe(**SERVE, **MODES["prefix"]))
    eng.start()
    try:
        return _scenario(eng.submit, JaxMessage, JaxSampling(**GREEDY))
    finally:
        eng.stop()


def test_fused_engine_matches_the_jax_fused_engine(port_model, jax_fused_streams):
    """Greedy, every fusion: the port's engine (plain versions on the CPU)
    gives the JAX engine's streams through its fusion kernels."""
    eng = _engine(port_model, fusion_impl="all", **MODES["prefix"])
    try:
        got = _scenario(eng.submit, Message, SamplingConfig(**GREEDY))
    finally:
        eng.stop()
    assert got == jax_fused_streams


@pytest.mark.parametrize("knobs", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
@pytest.mark.parametrize("mode", ["dense", "prefix"])
def test_fused_engine_equals_unfused(port_model, knobs, mode):
    """"all" and "none" give the same streams, greedy and sampled, joins
    included; the fused run goes through the ingest and tail plain versions
    once per layer and step, and the sampled run takes no top_p fallback."""
    from cake_tpu_torch.ops import fused_ingest, fused_sample_tail

    streams, stats = {}, {}
    for spec in ("none", "all"):
        eng = _engine(port_model, fusion_impl=spec, **MODES[mode])
        before = (fused_ingest.fused_qkv_ingest_plain.launches,
                  fused_sample_tail.fused_sample_tail_plain.launches,
                  fused_sample_tail.fused_sample_tail.unfused)
        try:
            streams[spec] = _scenario(eng.submit, Message, SamplingConfig(**knobs))
            assert eng.wait_idle(10.0)
            stats[spec] = eng.snapshot()
        finally:
            eng.stop()
        after = (fused_ingest.fused_qkv_ingest_plain.launches,
                 fused_sample_tail.fused_sample_tail_plain.launches,
                 fused_sample_tail.fused_sample_tail.unfused)
        steps = stats[spec]["decode_steps"]
        n_layers = port_model[0].num_hidden_layers
        want = (n_layers * steps, steps, 0) if spec == "all" else (0, 0, 0)
        assert tuple(a - b for a, b in zip(after, before)) == want
    assert streams["all"] == streams["none"]
    assert stats["all"]["joins"] >= 1


def test_serve_config_fusion_overrides_the_model_config(port_model):
    cfg, params, tok = port_model
    with pytest.raises(ValueError, match="unknown fusion"):
        ServeConfig(fusion_impl="norm,bogus")
    eng = BatchEngine(cfg, params, tok, max_seq_len=MAX_SEQ, device="cpu",
                      serve=ServeConfig(fusion_impl="ingest,tail"))
    assert eng.config.fusion_impl == eng.backend.config.fusion_impl == "ingest,tail"
    eng = BatchEngine(cfg, params, tok, max_seq_len=MAX_SEQ, device="cpu", serve=ServeConfig())
    assert eng.backend.config.fusion_impl == cfg.fusion_impl == "none"


def test_cli_refuses_prefix_cache_on_without_paged(ckpt):
    from cake_tpu_torch.cli import main

    with pytest.raises(SystemExit, match="kv-mode paged"):
        main(["--model", str(ckpt), "--api", "127.0.0.1:0", "--api-batch", "4",
              "--prefix-cache", "on", "--device", "cpu"])


# ------------------------------------------------------------- API engine path


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/api/v1/chat/completions", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def test_api_engine_serves_concurrent_sse_chats(ckpt, port_model):
    gen = LlamaGenerator.load(ckpt, dtype=torch.float32, max_seq_len=MAX_SEQ,
                              sampling=SamplingConfig(**GREEDY), device="cpu")
    engine = _engine(port_model, kv_mode="paged", page_size=PAGE, prefix_cache=True)
    api = ApiServer(gen, default_max_tokens=10, engine=engine)
    srv = api.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    prompts = [f"question number {i}: what is {i} plus {i}?" for i in range(4)]
    results: dict[int, tuple] = {}

    def client(i):
        results[i] = _post(srv.server_port, {
            "messages": [{"role": "user", "content": prompts[i]}], "max_tokens": 10,
            "stream": True, "stream_options": {"include_usage": True},
        })

    try:
        clients = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
        assert not any(c.is_alive() for c in clients)
        for i, (status, body) in results.items():
            assert status == 200
            events = [line[6:] for line in body.splitlines() if line.startswith("data: ")]
            assert events[-1] == "[DONE]"
            chunks = [json.loads(e) for e in events[:-1]]
            assert len({c["id"] for c in chunks}) == 1  # its own stream
            text = "".join(c["choices"][0]["delta"].get("content", "")
                           for c in chunks if c["choices"])
            usage = chunks[-1]["usage"]
            direct = engine.submit([Message.user(prompts[i])], 10, SamplingConfig(**GREEDY))
            want = direct.text()
            assert text == want
            assert usage["prompt_tokens"] == direct.prompt_tokens
            assert usage["completion_tokens"] == direct.completion_tokens
            assert usage["total_tokens"] == usage["prompt_tokens"] + usage["completion_tokens"]
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_port, timeout=30)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())["engine"]
        conn.close()
        assert stats["kv_mode"] == "paged" and stats["rows"] >= 8
        assert stats["prefix_hits"] >= 1 and "pages_free" in stats
        status, _ = _post(srv.server_port, {"messages": [{"role": "user", "content": "x" * 400}]})
        assert status == 400  # longer than the context window
    finally:
        srv.shutdown()
        srv.server_close()
        api.close()
        thread.join(timeout=10)
    assert not thread.is_alive()
