"""The port's observability routes and flags on the CPU.

  * Every one of the seven routes (``/metrics``, ``/events``, ``/trace``,
    ``/explain``, ``/efficiency``, ``/requests``, ``/timeseries``) answers on
    the port's server with the batch engine: the exposition parses and its
    counters equal the engine's stats, the trace is valid Chrome trace JSON,
    a request's explanation sums to its wall, the ledger's buckets sum to
    its wall, the request log has a line a finished request. Their 400 and
    404 answers match the reference's.
  * Without the engine, ``/metrics``, ``/events`` and ``/trace`` answer and
    the engine's ledgers are 404s.
  * The CLI: ``--request-log``, ``--trace-jsonl`` and ``--events-jsonl``
    each write their file, ``--blackbox-dir`` its bundles, and the
    blackbox and peak flags reach the engine's ServeConfig;
    ``--request-log`` without the engine is refused.
"""

import http.client
import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)
from cake_tpu_torch.cli import build_parser, serve_config
from cake_tpu_torch.models.llama import model as M
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import LlamaGenerator, LocalForwardStep, SamplingConfig
from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer
from cake_tpu_torch.obs.timeline import load_jsonl, timeline, validate_export
from cake_tpu_torch.runtime.api import ApiServer
from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig
from cake_tpu_torch.utils import metrics

GREEDY = SamplingConfig(temperature=0.0, repeat_penalty=1.0)
CHAT = "/api/v1/chat/completions"
ROUTES = ("/metrics", "/events", "/trace", "/explain", "/efficiency", "/requests", "/timeseries")


@pytest.fixture(scope="module")
def tiny():
    config = LlamaConfig.tiny(num_hidden_layers=2)
    return config, M.init_params(config, torch.Generator().manual_seed(31), torch.float32, "cpu")


def _request(port, method, route, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, route, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read().decode()
    finally:
        conn.close()


@pytest.fixture
def server(tiny, tmp_path):
    config, params = tiny
    started = []

    def serve(engine: bool = True, **api_kw):
        metrics.registry.clear()
        metrics.flight.clear()
        timeline.clear()
        step = LocalForwardStep(config, params, max_seq_len=128, cache_dtype=torch.float32,
                                device="cpu")
        gen = LlamaGenerator(config, step, ByteTokenizer(), GREEDY)
        eng = None
        if engine:
            eng = BatchEngine(config, params, ByteTokenizer(), max_seq_len=128,
                              cache_dtype=torch.float32, device="cpu",
                              serve=ServeConfig(max_batch=4, decode_chunk_size=4,
                                                kv_mode="paged", page_size=16, prefix_cache=True,
                                                blackbox_dir=str(tmp_path / "bb"),
                                                blackbox_min_interval_s=0.0,
                                                slo_ttft_ms=0.001))
        api = ApiServer(gen, default_max_tokens=6, engine=eng, **api_kw)
        srv = api.make_server("127.0.0.1", 0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        started.append((srv, api, thread))
        return srv.server_port, eng

    yield serve
    for srv, api, thread in started:
        srv.shutdown()
        srv.server_close()
        api.close()
        thread.join(10)
    for path in (None,):
        metrics.flight.attach_jsonl(path)
        timeline.attach_jsonl(path)


def _chat(port, text, **extra):
    status, _, body = _request(port, "POST", CHAT,
                               {"messages": [{"role": "user", "content": text}], **extra})
    assert status == 200, body
    return json.loads(body)


def _metric_values(text: str) -> dict:
    """A Prometheus exposition parsed to {series: value}: every line a
    comment or ``name{labels} value``."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            assert line.startswith(("# HELP ", "# TYPE ")) or not line, line
            continue
        series, value = line.rsplit(" ", 1)
        out[series] = float(value)
    return out


def test_every_route_answers_with_the_engine(server, tmp_path):
    log_path, trace_path, events_path = (str(tmp_path / n) for n in
                                         ("req.jsonl", "trace.jsonl", "events.jsonl"))
    port, eng = server(request_log=log_path, trace_jsonl=trace_path, events_jsonl=events_path)
    ids = []
    for text in ("first prompt", "second prompt here", "first prompt"):
        ids.append(_chat(port, text)["id"])
        assert eng.wait_idle(30.0)  # an epoch each: the third forks the first's chain
    answers = {r: _request(port, "GET", r + ("?request_id=" + ids[0] if r == "/explain" else ""))
               for r in ROUTES}
    assert all(status == 200 for status, _, _ in answers.values()), answers

    values = _metric_values(answers["/metrics"][2])
    assert answers["/metrics"][1].startswith("text/plain")
    stats = eng.stats
    assert values["cake_engine_submitted_total"] == 3
    assert values["cake_engine_batches_total"] == stats["batches"] == values["cake_engine_batches"]
    assert values["cake_engine_admitted_total"] == stats["rows"]
    assert values["cake_prefix_hits_total"] == stats["prefix_hits"] >= 1
    completed = sum(json.loads(ln)["completion_tokens"] for ln in open(log_path))
    assert values['cake_goodput_tokens_total{class="completed"}'] == completed

    trace = json.loads(answers["/trace"][2])
    assert validate_export(trace) == []
    assert {e["name"] for e in trace["traceEvents"]} >= {"epoch", "prefill", "decode-chunk",
                                                        "request"}
    explain = json.loads(answers["/explain"][2])
    assert sum(explain["phases"].values()) == pytest.approx(explain["wall_s"], rel=1e-6)
    assert [d["action"] for d in explain["decisions"]] == ["admit"]
    eff = json.loads(answers["/efficiency"][2])
    assert eff["accounted_s"] >= 0.95 * eff["wall_s"] > 0
    assert eff["tokens"]["completed"] == completed and eff["decision_ring"]
    assert eff["roofline"]["source"] == "none" and "mfu" not in eff["roofline"]
    reqs = json.loads(answers["/requests"][2])
    assert [r["request_id"] for r in reqs["requests"]] == ids
    assert json.loads(answers["/timeseries"][2])["points"]
    events = json.loads(answers["/events"][2])["events"]
    assert {"submitted", "admitted", "first-token", "finished"} <= {e["event"] for e in events}

    # The sinks: one request-log line a finished request, every flight event
    # and every timeline event; the black box caught the TTFT objective's
    # misses (1 µs: every request misses it).
    assert [json.loads(ln)["request_id"] for ln in open(log_path)] == ids
    assert len(open(events_path).read().splitlines()) == len(metrics.flight.snapshot())
    assert {e["name"] for e in load_jsonl(trace_path)} >= {"epoch", "request"}
    assert eng.blackbox.stats()["captured"] >= 1
    assert os.listdir(tmp_path / "bb")

    # The reference's 400 and 404s.
    assert _request(port, "GET", "/explain")[0] == 400
    assert _request(port, "GET", "/explain?request_id=nope")[0] == 404
    filtered = json.loads(_request(port, "GET", f"/events?request_id={ids[1]}")[2])["events"]
    assert filtered and {e["request_id"] for e in filtered} == {ids[1]}
    newest = json.loads(_request(port, "GET", "/requests?limit=1")[2])
    assert [r["request_id"] for r in newest["requests"]] == ids[-1:]
    stats_body = json.loads(_request(port, "GET", "/stats")[2])
    assert {"phases", "efficiency", "slo", "blackbox"} <= set(stats_body)


def test_routes_without_the_engine(server):
    port, _ = server(engine=False)
    rid = _chat(port, "hello there")["id"]
    assert _request(port, "GET", "/metrics")[0] == 200
    events = json.loads(_request(port, "GET", f"/events?request_id={rid}")[2])["events"]
    assert [e["event"] for e in events] == ["submitted", "finished"]
    assert validate_export(json.loads(_request(port, "GET", "/trace")[2])) == []
    for route in ("/efficiency", "/requests", "/timeseries", "/slo"):
        assert _request(port, "GET", route)[0] == 404, route
    assert _request(port, "GET", "/explain?request_id=" + rid)[0] == 404


def test_request_log_needs_the_engine(tiny, tmp_path):
    config, params = tiny
    step = LocalForwardStep(config, params, max_seq_len=64, cache_dtype=torch.float32,
                            device="cpu")
    gen = LlamaGenerator(config, step, ByteTokenizer(), GREEDY)
    with pytest.raises(ValueError, match="batch engine"):
        ApiServer(gen, request_log=str(tmp_path / "r.jsonl"))


def test_observability_flags_reach_the_serve_config():
    args = build_parser().parse_args([
        "--model", "m", "--api", "127.0.0.1:1", "--api-batch", "4", "--blackbox-dir", "/b",
        "--blackbox-keep", "3", "--blackbox-interval", "0.5", "--blackbox-p99-mult", "4",
        "--peak-tflops", "900", "--peak-hbm-gbps", "3000", "--request-log", "r.jsonl",
        "--trace-jsonl", "t.jsonl", "--events-jsonl", "e.jsonl",
    ])
    cfg = serve_config(args)
    assert (cfg.blackbox_dir, cfg.blackbox_keep, cfg.blackbox_min_interval_s,
            cfg.blackbox_p99_mult, cfg.peak_tflops, cfg.peak_hbm_gbps) == (
        "/b", 3, 0.5, 4.0, 900.0, 3000.0)
    assert (args.request_log, args.trace_jsonl, args.events_jsonl) == (
        "r.jsonl", "t.jsonl", "e.jsonl")
    defaults = serve_config(build_parser().parse_args(["--model", "m"]))
    assert defaults.blackbox_dir is None and defaults.peak_tflops == 0.0


def test_cli_flags_write_their_files(tiny, tmp_path):
    """A ``--api-batch`` server started by the CLI writes the request log,
    the trace and the events JSONL, and its ``/efficiency`` takes the peak
    flags; ``--request-log`` without the engine exits with an error."""
    from cake_tpu_torch.io.safetensors_io import save_tiny_checkpoint

    config, params = tiny
    model = str(tmp_path / "model")
    save_tiny_checkpoint(model, params, config)
    files = {flag: str(tmp_path / f"{flag.strip('-')}.jsonl")
             for flag in ("--request-log", "--trace-jsonl", "--events-jsonl")}
    with socket_port() as port:
        pass
    cmd = [sys.executable, "-m", "cake_tpu_torch.cli", "--model", model, "--device", "cpu",
           "--dtype", "f32", "--api", f"127.0.0.1:{port}", "--api-batch", "4", "-n", "4",
           "--temperature", "0", "--repeat-penalty", "1.0", "--peak-tflops", "100",
           "--peak-hbm-gbps", "1000", "--blackbox-dir", str(tmp_path / "bb")]
    for flag, path in files.items():
        cmd += [flag, path]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                if _request(port, "GET", "/health")[0] == 200:
                    break
            except OSError:
                pass
            assert proc.poll() is None, proc.stdout.read().decode()
            assert time.monotonic() < deadline
            time.sleep(0.2)
        rid = _chat(port, "hi there")["id"]
        eff = json.loads(_request(port, "GET", "/efficiency")[2])
        assert eff["roofline"]["source"] == "flag" and eff["roofline"]["peak_tflops"] == 100.0
        deadline = time.monotonic() + 30
        while not os.path.exists(files["--request-log"]) and time.monotonic() < deadline:
            time.sleep(0.1)
    finally:
        proc.terminate()
        proc.wait(30)
    assert [json.loads(ln)["request_id"] for ln in open(files["--request-log"])] == [rid]
    assert any(json.loads(ln)["event"] == "finished" for ln in open(files["--events-jsonl"]))
    assert any(e["name"] == "request" for e in load_jsonl(files["--trace-jsonl"]))
    refused = subprocess.run(
        [sys.executable, "-m", "cake_tpu_torch.cli", "--model", model, "--device", "cpu",
         "--request-log", str(tmp_path / "x.jsonl")],
        capture_output=True, text=True, env=env, timeout=120)
    assert refused.returncode != 0 and "--request-log" in refused.stderr


class socket_port:
    """A free localhost port (bound and released)."""

    def __enter__(self) -> int:
        import socket

        self._s = socket.socket()
        self._s.bind(("127.0.0.1", 0))
        return self._s.getsockname()[1]

    def __exit__(self, *exc) -> None:
        self._s.close()
