"""The port's whole single-host slice against the JAX package's.

A tiny checkpoint written by the JAX package's ``save_tiny_checkpoint`` is
loaded by both packages' ``LlamaGenerator.load`` (f32, the port on the CPU)
and decoded greedily: the generated token ids must be equal, with and without
chunked prefill. Then the port's entry points: the CLI on ``--device cpu``,
the ApiServer's JSON and SSE chats, its 400s, and the refusal to fall back to
the CPU when CUDA is absent and not asked for. Then fused multi-token decode
(``decode_chunk_size``): chunked streams equal per-step ones, greedy and
seeded sampled, an EOS inside a chunk truncates it, greedy chunked streams
with every fusion equal the JAX generator's, and the CLI's ``--fusion``.
"""

import dataclasses
import http.client
import json
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.io.safetensors_io import load_params as jax_load_params
from cake_tpu.io.safetensors_io import save_tiny_checkpoint as jax_save_tiny_checkpoint
from cake_tpu.models.llama import model as JM
from cake_tpu.models.llama.chat import Message as JaxMessage
from cake_tpu.models.llama.config import LlamaConfig as JaxConfig
from cake_tpu.models.llama.generator import LlamaGenerator as JaxGenerator
from cake_tpu.models.llama.generator import SamplingConfig as JaxSampling
from cake_tpu_torch.io.safetensors_io import load_params, save_tiny_checkpoint
from cake_tpu_torch.models.llama import model as M
from cake_tpu_torch.models.llama.chat import Message
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import LlamaGenerator, SamplingConfig
from cake_tpu_torch.runtime.api import ApiServer
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
PROMPT = "a prompt long enough to span several prefill chunks of the tiny model"
GREEDY = dict(temperature=0.0, repeat_penalty=1.0)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = JaxConfig.tiny(num_hidden_layers=3)
    params = JM.init_params(cfg, jax.random.PRNGKey(4), jnp.float32)
    path = tmp_path_factory.mktemp("tiny")
    jax_save_tiny_checkpoint(path, params, cfg)
    return path


def _port_generator(ckpt, **kw):
    return LlamaGenerator.load(
        ckpt, dtype=torch.float32, max_seq_len=256,
        sampling=SamplingConfig(**GREEDY), device="cpu", **kw,
    )


@pytest.mark.parametrize("prefill_chunk", [None, 16])
def test_greedy_tokens_match_jax(ckpt, prefill_chunk):
    jgen = JaxGenerator.load(
        ckpt, dtype=jnp.float32, max_seq_len=256, sampling=JaxSampling(**GREEDY),
        attention_impl="pallas", prefill_chunk=prefill_chunk,
    )
    jgen.add_message(JaxMessage.user(PROMPT))
    jtext = jgen.generate(16)
    pgen = _port_generator(ckpt, prefill_chunk=prefill_chunk)
    pgen.add_message(Message.user(PROMPT))
    ptext = pgen.generate(16)
    assert pgen.generated_token_ids == jgen.generated_token_ids
    assert len(pgen.generated_token_ids) == len(jgen.generated_token_ids) > 0
    assert ptext == jtext
    assert pgen.last_finish_reason == jgen.last_finish_reason


def test_load_params_matches_the_jax_loader(ckpt):
    cfg = LlamaConfig.from_model_dir(ckpt)
    port = load_params(ckpt, cfg, torch.float32, "cpu")
    ref = jax_load_params(ckpt, JaxConfig.from_model_dir(ckpt), jnp.float32)
    lay, rl = port["layers"], ref["layers"]
    np.testing.assert_array_equal(
        lay["wqkv"].numpy(), np.concatenate([rl["wq"], rl["wk"], rl["wv"]], -1)
    )
    np.testing.assert_array_equal(lay["w_gu"].numpy(), np.concatenate([rl["w_gate"], rl["w_up"]], -1))
    for key in ("wo", "w_down", "ln_attn", "ln_mlp"):
        np.testing.assert_array_equal(lay[key].numpy(), np.asarray(rl[key]))
    for key in ("embed", "ln_f", "lm_head"):
        np.testing.assert_array_equal(port[key].numpy(), np.asarray(ref[key]))
    # Row-major [in, out], as the fused norm-matmul kernel reads lm_head.
    assert port["lm_head"].is_contiguous() and all(t.is_contiguous() for t in lay.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_checkpoint_round_trip(tmp_path, dtype):
    cfg = LlamaConfig.tiny(num_hidden_layers=2, attention_bias=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    save_tiny_checkpoint(tmp_path, params, cfg, dtype=dtype)
    back = load_params(tmp_path, LlamaConfig.from_model_dir(tmp_path), dtype, "cpu")
    want = torch.cat([params["layers"][k] for k in ("bq", "bk", "bv")], -1).to(dtype)
    torch.testing.assert_close(back["layers"]["bqkv"], want, rtol=0, atol=0)
    torch.testing.assert_close(back["embed"], params["embed"].to(dtype), rtol=0, atol=0)


def test_prefix_cache_reuse_keeps_the_stream(ckpt):
    gen = _port_generator(ckpt, prefix_cache=True)
    streams = []
    for _ in range(2):
        gen.reset()
        gen.add_message(Message.user(PROMPT))
        gen.generate(6)
        streams.append(list(gen.generated_token_ids))
    assert streams[0] == streams[1]
    assert gen.last_prefill_tokens == 1  # the second dialog reused the prefix


def test_cli_prompt_on_cpu(ckpt):
    proc = subprocess.run(
        [sys.executable, "-m", "cake_tpu_torch.cli", "--model", str(ckpt), "--prompt", "hi",
         "-n", "4", "--device", "cpu", "--dtype", "f32", "--temperature", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def server(ckpt):
    api = ApiServer(_port_generator(ckpt), default_max_tokens=8)
    srv = api.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield api, srv.server_port
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/api/v1/chat/completions", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def test_api_json_and_sse_match_a_direct_generate(ckpt, server):
    api, port = server
    direct = _port_generator(ckpt)
    direct.add_message(Message.user("hello"))
    want = direct.generate(8)
    msgs = [{"role": "user", "content": "hello"}]

    status, body = _post(port, {"messages": msgs})
    assert status == 200
    reply = json.loads(body)
    assert reply["choices"][0]["message"]["content"] == want
    assert reply["choices"][0]["finish_reason"] in ("stop", "length")
    assert reply["usage"]["completion_tokens"] == direct.generated_count

    status, body = _post(port, {"messages": msgs, "stream": True,
                                "stream_options": {"include_usage": True}})
    assert status == 200
    events = [line[6:] for line in body.splitlines() if line.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks if c["choices"])
    assert text == want
    assert chunks[-1]["usage"]["completion_tokens"] == direct.generated_count


def test_api_rejects_bad_requests(server):
    _, port = server
    assert _post(port, {"messages": []})[0] == 400
    assert _post(port, {"messages": [{"role": "user", "content": "x"}], "max_tokens": 0})[0] == 400
    assert _post(port, {"messages": [{"role": "nobody", "content": "x"}]})[0] == 400
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/health")
    assert json.loads(conn.getresponse().read())["status"] == "ok"
    conn.close()


def _hide_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_no_cpu_fallback_without_cuda(ckpt, monkeypatch):
    _hide_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaGenerator.load(ckpt, dtype=torch.float32)
    from cake_tpu_torch.cli import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--model", str(ckpt), "--prompt", "hi", "-n", "1"])


def test_cli_refuses_cuda_without_a_gpu_in_a_fresh_process(ckpt):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = subprocess.run(
        [sys.executable, "-m", "cake_tpu_torch.cli", "--model", str(ckpt), "--prompt", "hi"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


# ------------------------------------------------------------ fused decode

SAMPLED = dict(temperature=0.9, top_k=20, repeat_penalty=1.1, repeat_last_n=8, seed=13)


@pytest.mark.parametrize("knobs", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
@pytest.mark.parametrize("fusion", ["none", "tail", "all"])
def test_decode_chunks_equal_per_step(ckpt, knobs, fusion):
    """Chunked decode (the first token per step, then chunks of 4, a short
    tail per step) gives the per-step stream; a seeded sampled stream draws
    the same gumbel planes from the dialog's generator in the same order."""
    streams = []
    for chunk in (1, 4):
        gen = LlamaGenerator.load(ckpt, dtype=torch.float32, max_seq_len=256,
                                  sampling=SamplingConfig(**knobs), device="cpu",
                                  decode_chunk_size=chunk, fusion_impl=fusion)
        gen.add_message(Message.user(PROMPT))
        text = gen.generate(11)
        streams.append((list(gen.generated_token_ids), text, gen.last_finish_reason))
    assert streams[0] == streams[1]
    ids, _, finish = streams[0]
    assert len(ids) == 11 if finish == "length" else len(ids) > 5  # chunks ran either way


def test_eos_mid_chunk_truncates(ckpt):
    """An EOS inside a chunk ends the stream there: the chunk's tail is
    dropped, and the stream equals the per-step one with the same EOS."""
    gen = _port_generator(ckpt)
    gen.add_message(Message.user(PROMPT))
    gen.generate(12)
    stream = list(gen.generated_token_ids)
    eos = stream[6]  # the first chunk covers tokens 1-4, the second 5-8
    first = stream.index(eos)
    out = []
    for chunk in (1, 4):
        g = _port_generator(ckpt, decode_chunk_size=chunk)
        g.config = dataclasses.replace(g.config, eos_token_ids=(eos,))
        g.add_message(Message.user(PROMPT))
        calls = []
        step_chunk = g.step.decode_chunk
        g.step.decode_chunk = lambda *a: calls.append(a[2]) or step_chunk(*a)
        g.generate(12)
        out.append((list(g.generated_token_ids), g.last_finish_reason, calls))
    assert out[0][:2] == out[1][:2] == (stream[: first + 1], "stop")
    assert out[1][2] == [4] * (1 + first // 5) and out[0][2] == []


def test_chunked_greedy_matches_the_jax_generator(ckpt):
    """Greedy, every fusion on both sides: the JAX generator's fused decode
    (8-token chunks, the Pallas fusion kernels in interpret mode) and the
    port's give the same ids."""
    from cake_tpu.models.llama.generator import LocalForwardStep as JaxStep

    def fused_step(config, params):
        return JaxStep(dataclasses.replace(config, fusion_impl="all@pallas"), params,
                       max_seq_len=256, cache_dtype=jnp.float32)

    jgen = JaxGenerator.load(ckpt, dtype=jnp.float32, max_seq_len=256,
                             sampling=JaxSampling(**GREEDY), step_factory=fused_step,
                             decode_chunk_size=8)
    jgen.add_message(JaxMessage.user(PROMPT))
    jgen.generate(19)
    pgen = _port_generator(ckpt, decode_chunk_size=8, fusion_impl="all")
    pgen.add_message(Message.user(PROMPT))
    pgen.generate(19)
    assert pgen.generated_token_ids == jgen.generated_token_ids
    assert len(pgen.generated_token_ids) > 1  # past the per-step first token
    assert pgen.last_finish_reason == jgen.last_finish_reason


def test_cli_fusion_flag(ckpt):
    base = [sys.executable, "-m", "cake_tpu_torch.cli", "--model", str(ckpt), "--prompt", "hi",
            "-n", "6", "--device", "cpu", "--dtype", "f32", "--temperature", "0"]
    ok = subprocess.run([*base, "--fusion", "all", "--decode-chunk", "4"],
                        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0, ok.stderr
    plain = subprocess.run(base, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert ok.stdout == plain.stdout
    for spec, message in (("norm,bogus", "unknown fusion 'bogus'"), ("all@pallas", "write 'all'")):
        bad = subprocess.run([*base, "--fusion", spec], cwd=REPO, capture_output=True,
                             text=True, timeout=120)
        assert bad.returncode == 2
        assert "--fusion" in bad.stderr and message in bad.stderr
