"""OpenAI-compatible REST API (port of ``cake_tpu/runtime/api.py``).

Routes: ``POST /api/v1/chat/completions`` (JSON, or SSE with
``"stream": true`` and ``stream_options.include_usage``; per-request
temperature / top_k / top_p / seed / max_tokens overrides, and with an
engine a ``priority`` class 0-2, a ``tenant`` (or the ``X-Cake-Tenant``
header) and a ``deadline_s``), ``POST /api/v1/cancel`` (``{"id": ...}``, the
engine only), ``GET /health``, ``GET /api/v1/models``, ``GET /stats`` (with
an engine, its ``tenants`` and ``slo`` blocks) and ``GET /slo`` (the
engine's per-tenant SLIs and burn rates, obs/slo.py), and the
observability routes: ``GET /metrics`` (the Prometheus exposition of the
metrics registry, utils/metrics.py, with the engine's counters),
``/events`` (the flight recorder's ring, ``?request_id=``), ``/trace`` (the
timeline ring as Chrome trace JSON, ``?request_id=``), ``/explain``
(``?request_id=``: a request's latency by phase, obs/critpath.py, with its
scheduler decisions), ``/efficiency`` (the goodput and hardware-efficiency
ledger and the decision ring), ``/requests`` (the request log's ring,
``?tenant= &finish= &since= &limit=``) and ``/timeseries`` (the rolling
SLIs); the last three and ``/slo`` need the engine. ``events_jsonl``,
``trace_jsonl`` and ``request_log`` stream the flight events, the timeline
events and the request records to JSONL files. Without an engine,
requests run one at a time under a lock around the single generator, which
is reset per request. With a batch engine (runtime/serving.py,
``--api-batch``) chat requests bypass that lock: they are submitted to the
engine and decode concurrently as lockstep batches, and a client that
disconnects mid-stream cancels its request. A tenant over its quota gets a
429 and a saturated engine a 503, each with ``Retry-After``; a bad tenant,
deadline or priority is a 400 before any streaming header.

Built on http.server's ThreadingHTTPServer: no third-party server.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from cake_tpu_torch.models.llama.chat import Message
from cake_tpu_torch.models.llama.generator import LlamaGenerator, SamplingConfig, Token
from cake_tpu_torch.obs import critpath
from cake_tpu_torch.obs.timeline import timeline
from cake_tpu_torch.runtime import faults
from cake_tpu_torch.utils import metrics

log = logging.getLogger("cake_tpu_torch.api")

CHAT_ROUTE = "/api/v1/chat/completions"

# HELP text of the engine's stats on /metrics (others: "Engine counter.").
_ENGINE_HELP = {
    "batches": "Lockstep decode batches started.",
    "rows": "Rows ever admitted (initial + joins).",
    "max_rows": "High-water mark of rows per batch.",
    "joins": "Continuous-batching joins.",
    "page_truncations": "Streams force-finished at page exhaustion.",
    "stream_errors": "Streams finished finish_reason=error (worker failure).",
    "cancelled": "Requests cancelled.",
    "shed": "Submissions refused by load shedding.",
    "quota_refusals": "Submissions refused by per-tenant quotas (HTTP 429).",
    "deadline_expired": "Requests past their end-to-end deadline (queued or running).",
    "epoch_stalls": "Backend dispatches abandoned by the stuck-epoch watchdog.",
    "prefix_hits": "Admissions/joins served a cached prefix chain (--prefix-cache).",
    "prefix_misses": "Admissions/joins with no usable cached prefix (--prefix-cache).",
}
CANCEL_ROUTE = "/api/v1/cancel"

# Tenant ids key the quota buckets and the fair queue's subqueues: a longer
# id is a 400, not a truncation (which would merge distinct tenants).
MAX_TENANT_ID_LEN = 64


class ApiError(Exception):
    def __init__(self, code: int, message: str, headers: dict | None = None):
        super().__init__(message)
        self.code = code
        self.headers = headers or {}


@dataclasses.dataclass
class ApiServer:
    generator: LlamaGenerator
    model_name: str = "llama3"
    default_max_tokens: int = 256
    # Max seconds one SSE write may block on a client that stopped reading
    # (the generator lock is held while streaming).
    stream_write_timeout: float = 30.0
    # Optional batch engine (runtime/serving.BatchEngine): chat requests go
    # to it instead of the generator.
    engine: "object | None" = None
    # JSONL sinks: every flight event (--events-jsonl), every timeline event
    # (--trace-jsonl; obs/timeline.load_jsonl + export_events make it a
    # Perfetto trace) and every request record (--request-log, the engine's)
    # is appended as one line; the bounded rings stay live either way.
    events_jsonl: "str | None" = None
    trace_jsonl: "str | None" = None
    request_log: "str | None" = None

    def __post_init__(self) -> None:
        self._lock = threading.Lock()
        self._started = int(time.time())
        if self.events_jsonl:
            metrics.flight.attach_jsonl(self.events_jsonl)
        if self.trace_jsonl:
            timeline.attach_jsonl(self.trace_jsonl)
        if self.request_log:
            reqlog = getattr(self.engine, "requestlog", None)
            if reqlog is None:
                raise ValueError("request_log needs the batch engine (--api-batch > 1)")
            reqlog.attach_jsonl(self.request_log)
        if self.engine is not None:
            self.engine.start()

    def close(self) -> None:
        """Stop the engine thread (if any)."""
        if self.engine is not None:
            self.engine.stop()

    def _sampling(self, opt, base: SamplingConfig) -> SamplingConfig:
        """Per-request overrides over the server's base sampling."""
        return SamplingConfig(
            temperature=opt("temperature", base.temperature, float),
            top_k=opt("top_k", base.top_k, int),
            top_p=opt("top_p", base.top_p, float),
            repeat_penalty=base.repeat_penalty,
            repeat_last_n=base.repeat_last_n,
            seed=opt("seed", base.seed, int),
        )

    def handle_chat(self, body: dict, handler: BaseHTTPRequestHandler) -> dict | None:
        """Run one chat completion; returns the JSON response, or None when
        the reply was streamed to ``handler``."""

        def opt(key, default, cast):
            """Request field, JSON null = unset; a bad type is a 400."""
            v = body.get(key)
            if v is None:
                return default
            try:
                return cast(v)
            except (TypeError, ValueError) as e:
                raise ApiError(400, f"invalid {key!r}: {e}") from e

        raw_messages = body.get("messages", [])
        if not isinstance(raw_messages, list) or not raw_messages:
            raise ApiError(400, "messages must be a non-empty list")
        try:
            messages = [Message.from_dict(m) for m in raw_messages]
        except (KeyError, ValueError, TypeError, AttributeError) as e:
            raise ApiError(400, f"invalid message: {e}") from e
        max_tokens = opt("max_tokens", None, int)
        if max_tokens is None:
            max_tokens = opt("max_completion_tokens", None, int)
        if max_tokens is None:
            max_tokens = self.default_max_tokens
        elif max_tokens < 1:
            raise ApiError(400, f"max_tokens must be >= 1, got {max_tokens}")
        stream = bool(body.get("stream", False))
        stream_options = body.get("stream_options")
        if stream_options is not None and not isinstance(stream_options, dict):
            raise ApiError(400, "stream_options must be an object")
        include_usage = bool((stream_options or {}).get("include_usage"))
        if self.engine is not None:
            return self._handle_chat_batched(
                body, messages, max_tokens, stream, include_usage, opt, handler
            )

        with self._lock:
            gen = self.generator
            base = gen.sampling
            gen.sampling = self._sampling(opt, base)
            try:
                gen.reset()
                for m in messages:
                    gen.add_message(m)
                n_prompt = gen.prompt_token_count()
                if n_prompt >= gen.step.max_seq_len:
                    raise ApiError(
                        400,
                        f"prompt is {n_prompt} tokens but the context window "
                        f"is {gen.step.max_seq_len}",
                    )
                rid = f"chatcmpl-{uuid.uuid4()}"
                created = int(time.time())
                if hasattr(gen.step, "trace_id"):
                    gen.step.trace_id = rid  # rides every FORWARD header (TCP steps)
                metrics.flight.record("submitted", rid, prompt_tokens=n_prompt,
                                      path="serialized")
                if stream:

                    def produce(on_token) -> str:
                        gen.generate(max_tokens, on_token=on_token)
                        return gen.last_finish_reason

                    usage_fn = None
                    if include_usage:
                        usage_fn = lambda: (gen.prompt_tokens, gen.generated_count)  # noqa: E731
                    _SseStream(self, produce, rid, created, usage_fn).run(handler)
                    metrics.flight.record("finished", rid, finish_reason=gen.last_finish_reason,
                                          completion_tokens=gen.generated_count)
                    return None
                text = gen.generate(max_tokens)
                metrics.flight.record("finished", rid, finish_reason=gen.last_finish_reason,
                                      completion_tokens=gen.generated_count)
                return self._completion_response(
                    rid, created, text, gen.last_finish_reason,
                    gen.prompt_tokens, gen.generated_count,
                )
            finally:
                gen.sampling = base
                if hasattr(gen.step, "trace_id"):
                    gen.step.trace_id = None

    def _handle_chat_batched(
        self, body: dict, messages, max_tokens: int, stream: bool, include_usage: bool, opt,
        handler,
    ) -> dict | None:
        """Engine path: no generator lock; submit and consume a stream. The
        response id is the engine's request id, so a client that goes away
        cancels exactly its own request."""
        from cake_tpu_torch.runtime.admission import QuotaExceeded
        from cake_tpu_torch.runtime.serving import EngineOverloaded

        sampling = self._sampling(opt, self.generator.sampling)
        # Priority class (0 low / 1 normal / 2 high; the engine's default
        # otherwise): it scales the shed gates and the 503's Retry-After,
        # and the continuous scheduler preempts the lowest first.
        priority = opt("priority", None, int)
        if priority is not None and priority not in (0, 1, 2):
            raise ApiError(400, f"priority must be 0, 1 or 2, got {priority}")
        # The tenant: the body's field, else the X-Cake-Tenant header, else
        # the engine's default tenant.
        tenant = body.get("tenant")
        if tenant is not None and (not isinstance(tenant, str) or not tenant.strip()):
            raise ApiError(400, "tenant must be a non-empty string")
        if tenant is None:
            tenant = handler.headers.get("X-Cake-Tenant") or None
        if tenant is not None and len(tenant) > MAX_TENANT_ID_LEN:
            raise ApiError(400, f"tenant id longer than {MAX_TENANT_ID_LEN} characters")
        # The end-to-end deadline in seconds (submit to last token).
        deadline_s = opt("deadline_s", None, float)
        if deadline_s is not None and not deadline_s > 0:
            raise ApiError(400, f"deadline_s must be > 0 seconds, got {deadline_s}")
        rid = f"chatcmpl-{uuid.uuid4()}"
        try:
            h = self.engine.submit(messages, max_tokens, sampling, request_id=rid,
                                   priority=priority, tenant=tenant, deadline_s=deadline_s)
        except QuotaExceeded as e:
            # The caller is over its budget; the hint is its own bucket's.
            raise ApiError(429, str(e), headers={
                "Retry-After": str(max(1, math.ceil(e.retry_after_s)))}) from e
        except EngineOverloaded as e:
            # The server is saturated: anyone may retry.
            raise ApiError(503, str(e), headers={
                "Retry-After": str(max(1, int(e.retry_after_s)))}) from e
        except ValueError as e:  # a prompt the engine can never serve: 400 before any header
            raise ApiError(400, str(e)) from e
        created = int(time.time())
        if stream:

            def produce(on_token) -> str:
                for tok in h.tokens():
                    on_token(tok)
                return h.finish_reason

            usage_fn = None
            if include_usage:
                usage_fn = lambda: (h.prompt_tokens, h.completion_tokens)  # noqa: E731
            _SseStream(self, produce, rid, created, usage_fn).run(handler)
            return None
        text = h.text()
        return self._completion_response(
            rid, created, text, h.finish_reason, h.prompt_tokens, h.completion_tokens
        )

    def _client_gone(self, rid: str) -> None:
        """A client left mid-stream: cancel its engine request so its lane
        stops decoding and its pages return to the pool; a flight event
        either way."""
        cancelled = self.engine is not None and bool(self.engine.cancel(rid))
        if cancelled:
            log.info("cancelled %s: its client disconnected", rid)
        metrics.flight.record("client-gone", rid, cancelled=cancelled)

    def metrics_text(self) -> str:
        """The ``/metrics`` body: the engine's stats as ``cake_engine_<k>``
        series, then the registry's exposition, with the scrape-time gauges
        (build info, uptime, the SLO and efficiency gauges) refreshed."""
        from cake_tpu_torch import __version__

        metrics.registry.gauge(
            "cake_build_info", "Constant 1; the labels carry model and version.",
        ).set(1, model=self.model_name, version=__version__)
        if self.engine is not None:
            self.engine.slo.refresh_metrics()
            self.engine.efficiency.refresh_metrics()
        metrics.registry.gauge(
            "cake_uptime_seconds", "Seconds since the API server started.",
        ).set(round(time.time() - self._started, 3))
        lines: list[str] = []
        if self.engine is not None:
            # A high-water mark is a gauge: rate() over it means nothing.
            for k, v in sorted(self.engine.stats.items()):
                kind = "gauge" if k == "max_rows" else "counter"
                lines.append(f"# HELP cake_engine_{k} {_ENGINE_HELP.get(k, 'Engine counter.')}")
                lines.append(f"# TYPE cake_engine_{k} {kind}")
                lines.append(f"cake_engine_{k} {v}")
        return "\n".join(lines) + ("\n" if lines else "") + metrics.registry.expose()

    def _completion_response(
        self, rid, created, text, finish_reason, n_prompt, n_generated
    ) -> dict:
        return {
            "id": rid,
            "object": "chat.completion",
            "created": created,
            "model": self.model_name,
            "choices": [
                {
                    "index": 0,
                    "message": {"role": "assistant", "content": text},
                    "finish_reason": finish_reason,
                }
            ],
            "usage": {
                "prompt_tokens": n_prompt,
                "completion_tokens": n_generated,
                "total_tokens": n_prompt + n_generated,
            },
        }

    def make_server(self, host: str, port: int) -> ThreadingHTTPServer:
        api = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                log.debug("%s " + fmt, self.client_address[0], *args)

            def _json(self, code: int, obj: dict, headers: dict | None = None) -> None:
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def _engine_route(self, name: str, what: str):
                """The engine's ``name`` ledger, or a 404 without an engine."""
                obj = getattr(api.engine, name, None)
                if obj is None:
                    self._json(404, {"error": f"{what} needs the batch engine (--api-batch > 1)"})
                return obj

            def do_GET(self):
                from urllib.parse import parse_qs, urlparse

                parsed = urlparse(self.path)
                route, query = parsed.path, parse_qs(parsed.query)
                rid = query.get("request_id", [None])[0]
                if route == "/health":
                    self._json(200, {"status": "ok", "model": api.model_name})
                elif route == "/stats":
                    body = {"model": api.model_name, "engine": None,
                            "uptime_s": round(time.time() - api._started, 3),
                            "timeline": timeline.aggregate(),
                            "metrics": metrics.registry.snapshot()}
                    if api.engine is not None:
                        body["engine"] = api.engine.snapshot()
                        body["engine"]["scheduler"] = api.engine.scheduler
                        body["tenants"] = api.engine.tenant_stats()
                        body["slo"] = api.engine.slo.snapshot()
                        body["phases"] = api.engine.phase_stats()
                        body["efficiency"] = api.engine.efficiency.snapshot()
                        if api.engine.blackbox is not None:
                            body["blackbox"] = api.engine.blackbox.stats()
                    self._json(200, body)
                elif route == "/metrics":
                    data = api.metrics_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif route == "/events":
                    events = metrics.flight.snapshot(request_id=rid)
                    self._json(200, {"events": events, "count": len(events),
                                     "capacity": metrics.flight.capacity, "cluster": []})
                elif route == "/trace":
                    self._json(200, timeline.export(rid))
                elif route == "/explain":
                    if not rid:
                        self._json(400, {"error": "explain needs a request_id query parameter "
                                                  "(the chatcmpl-... response id)"})
                        return
                    res = critpath.explain(timeline.snapshot(), rid)
                    if res is None:
                        self._json(404, {"error": f"no timeline spans for request {rid!r}: "
                                                  "evicted from the ring, refused before "
                                                  "admission, or unknown"})
                        return
                    if api.engine is not None:
                        res["decisions"] = api.engine.audit.for_request(rid)
                    self._json(200, res)
                elif route == "/efficiency":
                    eff = self._engine_route("efficiency", "the efficiency ledger")
                    if eff is not None:
                        body = eff.snapshot()
                        body["decision_ring"] = api.engine.audit.snapshot(limit=200)
                        self._json(200, body)
                elif route == "/requests":
                    reqlog = self._engine_route("requestlog", "the request log")
                    if reqlog is not None:
                        def int_q(key):
                            try:
                                return int(query.get(key, [None])[0])
                            except (TypeError, ValueError):
                                return None

                        recs = reqlog.snapshot(tenant=query.get("tenant", [None])[0],
                                               finish=query.get("finish", [None])[0],
                                               since=int_q("since"), limit=int_q("limit") or 0)
                        self._json(200, {"requests": recs, "count": len(recs), **reqlog.stats()})
                elif route == "/timeseries":
                    ts = self._engine_route("timeseries", "the SLI time-series")
                    if ts is not None:
                        self._json(200, ts.series())
                elif route == "/slo":
                    if api.engine is None:
                        self._json(404, {"error": "SLO tracking needs the batch engine "
                                                  "(--api-batch > 1)"})
                    else:
                        self._json(200, api.engine.slo.snapshot())
                elif route == "/api/v1/models":
                    self._json(200, {
                        "object": "list",
                        "data": [{
                            "id": api.model_name,
                            "object": "model",
                            "created": api._started,
                            "owned_by": "cake-tpu",
                        }],
                    })
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path not in (CHAT_ROUTE, CANCEL_ROUTE):
                    self._json(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(length) or b"{}")
                except (ValueError, json.JSONDecodeError) as e:
                    self._json(400, {"error": f"bad request body: {e}"})
                    return
                if not isinstance(body, dict):
                    self._json(400, {"error": "request body must be a JSON object"})
                    return
                if self.path == CANCEL_ROUTE:
                    # Frees the request's lane and pages at the next chunk
                    # boundary; the id is the chat response's.
                    rid = body.get("id") or body.get("request_id")
                    if not isinstance(rid, str) or not rid:
                        self._json(400, {"error": "body needs a request 'id'"})
                    elif api.engine is None:
                        self._json(400, {"error": "cancellation needs the batch engine "
                                                  "(--api-batch > 1)"})
                    else:
                        self._json(200, {"id": rid, "cancelled": api.engine.cancel(rid)})
                    return
                try:
                    response = api.handle_chat(body, self)
                except ApiError as e:
                    self._json(e.code, {"error": str(e)}, headers=e.headers)
                    return
                except Exception as e:  # noqa: BLE001 - the server keeps serving; surface as 500
                    log.exception("chat handler failed")
                    self._json(500, {"error": str(e)})
                    return
                if response is not None:
                    self._json(200, response)

        server = ThreadingHTTPServer((host, port), Handler)
        server.daemon_threads = True
        return server

    def serve_forever(self, host: str, port: int) -> None:
        server = self.make_server(host, port)
        log.info("API listening on http://%s:%d%s", host, server.server_port, CHAT_ROUTE)
        try:
            server.serve_forever()
        finally:
            server.server_close()
            self.close()


class _SseStream:
    """SSE emitter for chat.completion.chunk events; ``produce(on_token)``
    drives generation and returns the finish reason."""

    def __init__(self, api: ApiServer, produce, rid: str, created: int, usage_fn=None):
        self.api = api
        self.produce = produce
        self.rid = rid
        self.created = created
        self.usage_fn = usage_fn

    def _payload(self, choices: list, **extra) -> bytes:
        payload = {
            "id": self.rid,
            "object": "chat.completion.chunk",
            "created": self.created,
            "model": self.api.model_name,
            "choices": choices,
            **extra,
        }
        return f"data: {json.dumps(payload)}\n\n".encode()

    def _chunk(self, delta: dict, finish: str | None = None) -> bytes:
        return self._payload([{"index": 0, "delta": delta, "finish_reason": finish}])

    def run(self, handler: BaseHTTPRequestHandler) -> None:
        """Stream the completion under a per-write socket timeout, restored
        afterwards so keep-alive reuse is unaffected."""
        prev_timeout = handler.connection.gettimeout()
        handler.connection.settimeout(self.api.stream_write_timeout)
        try:
            self._run_stream(handler)
        finally:
            try:
                handler.connection.settimeout(prev_timeout)
            except OSError:
                pass

    def _run_stream(self, handler: BaseHTTPRequestHandler) -> None:
        handler.send_response(200)
        handler.send_header("Content-Type", "text/event-stream")
        handler.send_header("Cache-Control", "no-cache")
        handler.send_header("Transfer-Encoding", "chunked")
        handler.end_headers()

        def write(data: bytes) -> None:
            spec = faults.check("api.stream")
            if spec is not None and spec.kind == "stall":
                faults.sleep(spec)  # a consumer that stopped reading
            handler.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

        try:
            write(self._chunk({"role": "assistant", "content": ""}))

            def on_token(tok: Token) -> None:
                if tok.text:
                    write(self._chunk({"content": tok.text}))

            finish = self.produce(on_token)
            write(self._chunk({}, finish=finish))
            if self.usage_fn is not None:
                n_prompt, n_completion = self.usage_fn()
                write(self._payload([], usage={
                    "prompt_tokens": n_prompt,
                    "completion_tokens": n_completion,
                    "total_tokens": n_prompt + n_completion,
                }))
        except (BrokenPipeError, ConnectionResetError, TimeoutError):
            # The client left or stopped reading: the chunked stream was never
            # terminated, so the connection cannot be reused; an engine request
            # is cancelled so its lane stops decoding.
            log.warning("client %s stalled or disconnected mid-stream", handler.client_address)
            self.api._client_gone(self.rid)
            handler.close_connection = True
            return
        except Exception as e:  # noqa: BLE001 - headers are out: report in-band
            log.exception("generation failed mid-stream")
            try:
                write(f"data: {json.dumps({'error': str(e)})}\n\n".encode())
            except (BrokenPipeError, ConnectionResetError, TimeoutError, OSError):
                handler.close_connection = True
                return
        try:
            write(b"data: [DONE]\n\n")
            handler.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError, TimeoutError):
            handler.close_connection = True
