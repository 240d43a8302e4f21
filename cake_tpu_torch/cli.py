"""Command-line entry point of the port: ``python -m cake_tpu_torch.cli``.

    python -m cake_tpu_torch.cli --model DIR --prompt "..." -n 100
    python -m cake_tpu_torch.cli --model DIR --api 127.0.0.1:8080
    python -m cake_tpu_torch.cli --model DIR --api 127.0.0.1:8080 --api-batch 8 --kv-mode paged
    python -m cake_tpu_torch.cli --model DIR --api 127.0.0.1:8080 --api-batch 8 --kv-mode paged \
        --scheduler continuous
    python -m cake_tpu_torch.cli --model DIR --prompt "..." --kv-dtype f8
    python -m cake_tpu_torch.cli --model DIR --mode worker --name w1 \
        --topology topology.yml --address 0.0.0.0:10128
    python -m cake_tpu_torch.cli --model DIR --topology topology.yml --prompt "..."
    python -m cake_tpu_torch.cli --model DIR --topology topology.yml --api 127.0.0.1:8080 \
        --api-batch 8 --heartbeat-interval 0.5 --faults 'kill@client.send:node=w2:after=30:count=0'
    python -m cake_tpu_torch.cli --model MISTRAL_DIR --prompt "..." --prefill-chunk 512

Generation on one CUDA device (``--device cpu`` runs the plain PyTorch
versions of the kernels on the CPU instead; without a CUDA device and
without ``--device cpu`` it exits with an error), or Cake's master/worker
pipeline over TCP: ``--mode worker`` serves the layer ranges its node owns
in the topology file, and a master given ``--topology`` walks the plan,
running the embedding, the head, sampling and the layers no node owns. A
model with one sliding window under ``--prefill-chunk`` decodes over the
rolling window cache (``rolling_budget``). The flags are the subset of
``cake_tpu/cli.py`` that the port has; others are refused by the parser.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys

from cake_tpu_torch.device import DTYPES
from cake_tpu_torch.ops.kv_dtype import KV_DTYPE_CHOICES, resolve_kv_dtype


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cake-tpu-torch",
        description="Llama-family generation on one NVIDIA GPU (PyTorch/CUDA port)",
    )
    p.add_argument("--model", required=True, help="checkpoint directory")
    p.add_argument(
        "--mode", choices=("master", "worker"), default="master",
        help="run as the generation master or as a block-serving worker",
    )
    p.add_argument("--name", default="", help="this worker's node name in the topology")
    p.add_argument(
        "--address", default="127.0.0.1:10128", help="worker bind address host:port",
    )
    p.add_argument(
        "--topology", default=None,
        help="topology file (YAML: node -> host, description, layers)",
    )
    p.add_argument(
        "--backend", choices=("tcp", "local", "mesh"), default=None,
        help="master execution backend: tcp (the default when the topology names workers) "
        "forwards each span to its worker; local runs every layer here. mesh is refused: the "
        "in-process pipeline and tensor-parallel backends are ROADMAP.md queue A items",
    )
    p.add_argument(
        "--api", default=None, metavar="HOST:PORT",
        help="serve the OpenAI-compatible REST API instead of one-shot generation",
    )
    p.add_argument("--prompt", default="Why can't cats taste sweetness?")
    p.add_argument("--system-prompt", default=None)
    p.add_argument("-n", "--sample-len", type=int, default=100)
    p.add_argument("--dtype", choices=tuple(DTYPES), default="bf16")
    p.add_argument(
        "--kv-dtype",
        choices=KV_DTYPE_CHOICES,
        default="auto",
        help="KV-cache storage dtype (auto = --dtype). f8 (float8_e4m3fn) halves KV memory "
        "and per-token cache bandwidth, the long-context lever; attention computes in "
        "--dtype after an on-read upcast. Applies to the generator and to the --api-batch "
        "engine, dense and paged",
    )
    p.add_argument("--max-seq-len", type=int, default=None)
    p.add_argument(
        "--prefill-chunk", type=int, default=None,
        help="prefill long prompts in chunks of at most N tokens",
    )
    p.add_argument(
        "--api-batch", type=int, default=1,
        help="serve up to N API requests as one lockstep decode batch with continuous "
        "admission (runtime/serving.py); 1 = serialized",
    )
    p.add_argument(
        "--scheduler", choices=("epoch", "continuous"), default="epoch",
        help="scheduler of the --api-batch engine: epoch = the lockstep epoch (a burst lands "
        "together after an admission window; page pressure finishes a stream as 'length'); "
        "continuous = per-step admission under a prefill budget a step (--step-prefill), no "
        "admission window, and page pressure preempts the lowest-priority lane (spilled to "
        "the host, restored to the same stream) instead of truncating it",
    )
    p.add_argument(
        "--step-prefill", type=int, default=0, metavar="TOKENS",
        help="continuous scheduler: prompt tokens of join and restore prefill one engine step "
        "may dispatch before decode resumes; 0 = auto (512)",
    )
    p.add_argument(
        "--default-priority", type=int, choices=(0, 1, 2), default=1,
        help="priority class of requests that carry none (0 low / 1 normal / 2 high): low "
        "sheds first under overload and its 503 Retry-After doubles; high tolerates twice the "
        "shed thresholds; the continuous scheduler preempts the lowest class first",
    )
    p.add_argument(
        "--shed-queue-depth", type=int, default=0, metavar="N",
        help="admission load shedding: refuse new requests (HTTP 503 + Retry-After) once the "
        "engine queue is N deep; 0 = off",
    )
    p.add_argument(
        "--shed-free-pages", type=int, default=0, metavar="N",
        help="paged mode: shed new requests while fewer than N KV pages are free; 0 = off",
    )
    p.add_argument(
        "--tenant-rate", type=float, default=0.0, metavar="TOK_S",
        help="per-tenant token-bucket rate limit in work tokens (prompt + max_tokens) per "
        "second; over it a submission is refused with HTTP 429 + Retry-After (the tenant "
        "rides the request's 'tenant' field or X-Cake-Tenant header). 0 = unlimited "
        "(--api-batch)",
    )
    p.add_argument(
        "--tenant-burst", type=float, default=0.0, metavar="TOKENS",
        help="per-tenant token-bucket capacity in work tokens; 0 = auto (2x --tenant-rate)",
    )
    p.add_argument(
        "--tenant-streams", type=int, default=0, metavar="N",
        help="per-tenant concurrent-stream cap (queued + live); over it a submission is "
        "refused with HTTP 429. 0 = uncapped",
    )
    p.add_argument(
        "--no-fair-queue", action="store_true",
        help="disable the deficit-weighted round-robin fair queue across tenants and fall "
        "back to one global FIFO (an abusive tenant can then starve everyone else)",
    )
    p.add_argument(
        "--default-deadline", type=float, default=0.0, metavar="S",
        help="end-to-end deadline applied to requests that carry no 'deadline_s' field: "
        "queued past it a request expires before admission (no lane, no pages), running past "
        "it the stream finishes with finish_reason=deadline at the next chunk boundary, and a "
        "deadline the estimated queue wait already exceeds is shed immediately (503). 0 = none",
    )
    p.add_argument(
        "--slo-ttft-ms", type=float, default=0.0, metavar="MS",
        help="declared TTFT objective: --slo-ttft-target of accepted requests must see their "
        "first token within MS milliseconds. Per-tenant burn rates (fast/slow windows) show "
        "at GET /slo; a burning tenant's fair-queue quantum is boosted and its doomed-deadline "
        "submissions shed earlier. 0 = no TTFT objective (--api-batch)",
    )
    p.add_argument(
        "--slo-ttft-target", type=float, default=0.99, metavar="FRAC",
        help="required fraction of requests meeting --slo-ttft-ms (error budget = 1 - FRAC)",
    )
    p.add_argument(
        "--slo-deadline-rate", type=float, default=0.0, metavar="FRAC",
        help="declared deadline objective: required hit rate over deadline-carrying "
        "requests; burn tracked per tenant at GET /slo. 0 = off (--api-batch)",
    )
    p.add_argument(
        "--epoch-stall", type=float, default=0.0, metavar="S",
        help="stuck-epoch watchdog: a backend dispatch making no progress within S seconds "
        "(10x S for an op's first call, which builds kernels and captures graphs) is "
        "abandoned, its epoch's streams finish with finish_reason=error, and the backend "
        "allocates its KV storage and decode graphs anew. 0 = off",
    )
    p.add_argument(
        "--stream-buffer", type=int, default=8192, metavar="TOKENS",
        help="streaming backpressure watermark: a client that stops reading its SSE stream "
        "is cancelled (pages freed, lane recycled) once this many undelivered tokens buffer "
        "up; 0 = unbounded (--api-batch)",
    )
    p.add_argument(
        "--kv-mode", choices=("dense", "paged"), default="dense",
        help="KV storage of the --api-batch engine: a [max_seq] strip per lane, or a "
        "shared page pool admitted by free pages",
    )
    p.add_argument(
        "--page-size", type=int, default=128,
        help="tokens per KV page under --kv-mode paged (the CUDA kernels take multiples "
        "of 128)",
    )
    p.add_argument(
        "--max-pages", type=int, default=None,
        help="KV pool size in pages under --kv-mode paged; default = --api-batch lanes x "
        "pages per sequence",
    )
    p.add_argument(
        "--prefix-cache", choices=("on", "off", "auto"), default="auto",
        help="KV prefix reuse across API requests: the serialized path reuses the previous "
        "dialog's prefix; the --kv-mode paged engine keeps finished prompts' prefix pages "
        "in a radix cache. auto = on for --api (the engine: on under --kv-mode paged)",
    )
    p.add_argument(
        "--prefix-cache-pages", type=int, default=0, metavar="N",
        help="prefix-cache budget in KV pages; 0 = half the pool",
    )
    p.add_argument(
        "--prefix-min-tokens", type=int, default=0, metavar="N",
        help="do not cache or serve prefixes shorter than N tokens (churn guard); 0 = any "
        "cached page's worth qualifies",
    )
    p.add_argument(
        "--decode-chunk", type=int, default=8,
        help="fused decode granularity: N tokens per device dispatch, read back once, for "
        "the local generator (--prompt, serialized --api) and the --api-batch engine; "
        "1 = per-token. Streaming emits in bursts of N",
    )
    p.add_argument(
        "--fusion", default="none", metavar="SPEC",
        help="decode op fusion: 'none', 'all', or a comma list from {norm,ingest,tail}; "
        "norm folds RMSNorm into the projection it feeds, ingest fuses head split + rope + "
        "the KV cache write, tail fuses the repeat-penalty/temperature/top-k/draw chain. "
        "Each runs its CUDA kernel on the card and its plain PyTorch version on --device "
        "cpu. top-p keeps the plain sort path",
    )
    p.add_argument(
        "--quantize", choices=("int8", "int4"), default=None,
        help="weight-only quantization of the loaded weights: int8 per-channel (halves the "
        "weight bytes) or int4 group-128 (quarters them; every int4 product runs the int4 "
        "CUDA kernel on the card); activations stay --dtype. The --api-batch engine serves "
        "the same quantized weights. A .q8/.q4 checkpoint loads quantized without it",
    )
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--repeat-penalty", type=float, default=1.1)
    p.add_argument("--repeat-last-n", type=int, default=128)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="cuda (default; fails without a GPU) or cpu (plain PyTorch versions)",
    )
    p.add_argument(
        "--op-deadline", type=float, default=30.0, metavar="S",
        help="per-op wire deadline in seconds for worker round trips: a hop that neither "
        "replies nor fails within it is retried (tcp backend)",
    )
    p.add_argument(
        "--op-retries", type=int, default=2, metavar="N",
        help="idempotent resends of a failed worker op before giving up (session replay, "
        "runtime/client.py); 0 = fail fast",
    )
    p.add_argument(
        "--reconnect-attempts", type=int, default=3, metavar="N",
        help="re-dial attempts after a worker connection dies (exponential backoff between "
        "attempts, none after the last)",
    )
    p.add_argument(
        "--reconnect-backoff", type=float, default=0.5, metavar="S",
        help="base reconnect backoff in seconds (doubles per attempt)",
    )
    p.add_argument(
        "--heartbeat-interval", type=float, default=0.0, metavar="S",
        help="ping every worker over a dedicated connection at this cadence "
        "(cake_worker_healthy gauge + cake_worker_unhealthy_total); 0 = no heartbeat "
        "threads. TCP masters only",
    )
    p.add_argument(
        "--heartbeat-deadline", type=float, default=2.0, metavar="S",
        help="a heartbeat PING unanswered for this long marks the worker unhealthy",
    )
    p.add_argument(
        "--failover-max", type=int, default=2, metavar="N",
        help="replica failover: at most N live-stream migrations per epoch after a worker "
        "death before degrading to finish_reason=error; 0 disables migration (error "
        "isolation only) (--api-batch)",
    )
    p.add_argument(
        "--failover-budget", type=float, default=30.0, metavar="S",
        help="replica failover: cumulative migration wall-time budget per epoch; past it the "
        "epoch degrades to finish_reason=error",
    )
    p.add_argument(
        "--failover-cooldown", type=float, default=5.0, metavar="S",
        help="standby rejoin probation: an ejected replica re-enters the routing rotation "
        "after this long (and, with heartbeats on, only once the monitor sees it healthy "
        "again)",
    )
    p.add_argument(
        "--failover-local", action="store_true",
        help="opt the local backends into migration in place: a transient backend fault "
        "rebuilds the live streams' KV instead of finishing them with finish_reason=error",
    )
    p.add_argument(
        "--faults", default=None, metavar="PLAN",
        help="install a deterministic fault plan (runtime/faults.py DSL, e.g. "
        "'seed=7;kill@worker.op:after=5'): chaos testing; also settable via the "
        "CAKE_FAULTS environment variable",
    )
    p.add_argument(
        "--blackbox-dir", default=None, metavar="DIR",
        help="black-box anomaly capture (obs/blackbox.py): when a request breaches a declared "
        "SLO objective, lands past --blackbox-p99-mult x the rolling p99, or dies to a "
        "watchdog stall or a whole-epoch error, a diagnostic bundle (attribution, timeline "
        "slice, flight tail, engine/pool/prefix snapshots) is written here. Unset = off "
        "(--api-batch)",
    )
    p.add_argument("--blackbox-keep", type=int, default=16, metavar="N",
                   help="bound the on-disk bundle ring to the newest N bundles")
    p.add_argument(
        "--blackbox-interval", type=float, default=5.0, metavar="S",
        help="min seconds between bundle captures (an incident storm writes one bundle); "
        "0 = no rate limit",
    )
    p.add_argument(
        "--blackbox-p99-mult", type=float, default=0.0, metavar="K",
        help="capture a bundle when a request finishes slower than K x the rolling "
        "end-to-end p99 (needs a warm window); 0 = off",
    )
    p.add_argument(
        "--peak-tflops", type=float, default=0.0, metavar="TF",
        help="the card's peak dense TFLOP/s for the MFU estimate at GET /efficiency "
        "(obs/efficiency.py); 0 = the built-in table by device name (none on the CPU)",
    )
    p.add_argument(
        "--peak-hbm-gbps", type=float, default=0.0, metavar="GB",
        help="the card's peak memory bandwidth (GB/s) for the bandwidth-utilization estimate "
        "at GET /efficiency; 0 = the built-in table",
    )
    p.add_argument(
        "--events-jsonl", default=None, metavar="PATH",
        help="append every flight-recorder event to this JSONL file; the bounded ring stays "
        "at GET /events either way (--api only)",
    )
    p.add_argument(
        "--trace-jsonl", default=None, metavar="PATH",
        help="stream every timeline event (spans, lane tracks, counters) to this JSONL file "
        "(obs/timeline.load_jsonl + export_events make it a Perfetto trace); the bounded "
        "ring stays at GET /trace (--api only)",
    )
    p.add_argument(
        "--request-log", default=None, metavar="PATH",
        help="append every per-request completion record (obs/requestlog.py) to this JSONL "
        "file; the ring stays at GET /requests (--api with --api-batch > 1)",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _parse_address(addr: str, flag: str = "--api") -> tuple[str, int]:
    from cake_tpu_torch.runtime.client import parse_address

    try:
        return parse_address(addr, default_host="127.0.0.1", what=flag)
    except ValueError as e:
        raise SystemExit(str(e)) from None


def _master_backend(args, topology) -> str:
    """local or tcp, from --backend and the topology (the JAX CLI's choice;
    mesh is refused)."""
    if args.backend == "mesh":
        raise SystemExit(
            "--backend mesh is not ported yet (ROADMAP.md queue A, the in-process pipeline and "
            "tensor-parallel backends)"
        )
    if topology is None:
        if args.backend == "tcp":
            raise SystemExit("--backend tcp requires --topology")
        return "local"
    if args.backend == "local" or (args.backend is None and not topology.nodes):
        return "local"
    if args.quantize:
        # The master's own ranges stay full precision; workers quantize
        # their ranges with their own --quantize.
        raise SystemExit(
            "--quantize on a master runs on the local backend (give workers their own "
            "--quantize for the tcp path)"
        )
    return "tcp"


def _serve_worker(args, kv_dtype) -> int:
    from cake_tpu_torch.parallel.topology import Topology
    from cake_tpu_torch.runtime.worker import Worker

    if not args.topology:
        print("worker mode requires --topology", file=sys.stderr)
        return 2
    worker = Worker(
        args.name, args.model, Topology.from_path(args.topology),
        _parse_address(args.address, "--address"), dtype=DTYPES[args.dtype], kv_dtype=kv_dtype,
        max_seq_len=args.max_seq_len, fusion_impl=args.fusion, quantize=args.quantize,
        device=args.device,
    )
    try:
        worker.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        worker.stop()
    return 0


def serve_config(args: argparse.Namespace):
    """The ``--api-batch`` engine's ServeConfig from parsed flags."""
    from cake_tpu_torch.runtime.serving import ServeConfig

    return ServeConfig(
        max_batch=args.api_batch,
        decode_chunk_size=args.decode_chunk,
        scheduler=args.scheduler,
        step_prefill_tokens=args.step_prefill,
        default_priority=args.default_priority,
        kv_mode=args.kv_mode,
        page_size=args.page_size,
        max_pages=args.max_pages,
        prefix_cache=args.kv_mode == "paged" and args.prefix_cache != "off",
        prefix_cache_pages=args.prefix_cache_pages,
        prefix_min_tokens=args.prefix_min_tokens,
        fusion_impl=args.fusion,
        shed_queue_depth=args.shed_queue_depth,
        shed_min_free_pages=args.shed_free_pages,
        stream_buffer_tokens=args.stream_buffer,
        tenant_rate=args.tenant_rate,
        tenant_burst=args.tenant_burst,
        tenant_streams=args.tenant_streams,
        fair_queue=not args.no_fair_queue,
        default_deadline_s=args.default_deadline,
        epoch_stall_s=args.epoch_stall,
        slo_ttft_ms=args.slo_ttft_ms,
        slo_ttft_target=args.slo_ttft_target,
        slo_deadline_rate=args.slo_deadline_rate,
        blackbox_dir=args.blackbox_dir or None,
        blackbox_keep=args.blackbox_keep,
        blackbox_min_interval_s=args.blackbox_interval,
        blackbox_p99_mult=args.blackbox_p99_mult,
        peak_tflops=args.peak_tflops,
        peak_hbm_gbps=args.peak_hbm_gbps,
        heartbeat_interval_s=args.heartbeat_interval,
        heartbeat_deadline_s=args.heartbeat_deadline,
        max_failovers=args.failover_max,
        failover_budget_s=args.failover_budget,
        failover_cooldown_s=args.failover_cooldown,
        failover_local=args.failover_local,
    )


def rolling_budget(config, args) -> int | None:
    """The reference's rule for the generator's rolling window cache: a
    model with ONE sliding window (not Gemma-2/3's alternating patterns,
    whose full-attention layers need every key) under chunked prefill gets
    a ring of ``window + max(--prefill-chunk, --decode-chunk)`` slots
    (LocalForwardStep decides whether that is smaller than the full
    cache). The engine keeps the full cache."""
    if (
        config.sliding_window is not None
        and not config.alt_sliding_window
        and config.sliding_pattern is None
        and args.prefill_chunk
    ):
        return max(args.prefill_chunk, args.decode_chunk)
    return None


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from cake_tpu_torch.ops.fuse import parse_fusion_spec

    try:
        parse_fusion_spec(args.fusion)
    except ValueError as e:
        print(f"--fusion: {e}", file=sys.stderr)
        return 2
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s",
    )
    if args.faults:
        # Chaos mode: the plan is installed before any socket or engine
        # exists (CAKE_FAULTS does the same at import).
        from cake_tpu_torch.runtime import faults

        try:
            faults.install(faults.parse(args.faults))
        except ValueError as e:
            print(f"--faults: {e}", file=sys.stderr)
            return 2
    from cake_tpu_torch.models.llama.chat import Message
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import LlamaGenerator, SamplingConfig

    sampling = SamplingConfig(
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
        repeat_penalty=args.repeat_penalty,
        repeat_last_n=args.repeat_last_n,
        **({"seed": args.seed} if args.seed is not None else {}),
    )
    kv_dtype = resolve_kv_dtype(args.kv_dtype, DTYPES[args.dtype])
    if args.mode == "worker":
        return _serve_worker(args, kv_dtype)
    from cake_tpu_torch.parallel.topology import Topology

    topology = Topology.from_path(args.topology) if args.topology else None
    backend = _master_backend(args, topology)
    engine_serves = bool(args.api) and args.api_batch > 1
    if args.request_log and not engine_serves:
        raise SystemExit("--request-log records the batch engine's requests: it needs --api "
                         "with --api-batch > 1")
    if engine_serves and backend == "tcp" and args.kv_mode == "paged":
        raise SystemExit(
            "--kv-mode paged runs on the local --api-batch master only (the tcp backend keeps "
            "the dense cache)"
        )
    if engine_serves and args.prefix_cache == "on" and args.kv_mode != "paged":
        raise SystemExit(
            "--prefix-cache on shares physical KV pages across requests and therefore "
            "needs --kv-mode paged"
        )
    if args.prefix_cache == "auto":
        prefix_cache = bool(args.api)
    else:
        prefix_cache = args.prefix_cache == "on"
    if backend == "tcp":
        generator = _tcp_generator(args, topology, sampling, kv_dtype,
                                   prefix_cache and not engine_serves)
    else:
            generator = LlamaGenerator.load(
            args.model,
            dtype=DTYPES[args.dtype],
            kv_dtype=kv_dtype,
            max_seq_len=args.max_seq_len,
            sampling=sampling,
            prefill_chunk=args.prefill_chunk,
            prefix_cache=prefix_cache and not engine_serves,
            device=args.device,
            decode_chunk_size=args.decode_chunk,
            fusion_impl=args.fusion,  # on the config before any step or engine is built
            quantize=args.quantize,
            rolling_budget=rolling_budget(LlamaConfig.from_model_dir(args.model), args),
        )
    if args.api:
        from cake_tpu_torch.runtime.api import ApiServer

        engine = None
        if engine_serves:
            from cake_tpu_torch.runtime.serving import BatchEngine

            serve = serve_config(args)
            step = generator.step
            if backend == "tcp":
                from cake_tpu_torch.runtime.batch_backend import DistributedBatchBackend

                # Continuous batching over the topology: B rows share every
                # worker round trip.
                engine = BatchEngine(
                    generator.config, None, generator.tokenizer, max_seq_len=step.max_seq_len,
                    cache_dtype=kv_dtype, serve=serve,
                    backend=DistributedBatchBackend(step),
                )
            else:
                engine = BatchEngine(
                    generator.config, step.params, generator.tokenizer,
                    max_seq_len=step.max_seq_len, cache_dtype=kv_dtype,
                    serve=serve, device=step.device,
                )
        if args.heartbeat_interval > 0 and engine is None and backend == "tcp":
            # Liveness probing of the serialized path's workers (daemon
            # threads; they die with the server). The batch engine starts
            # its own monitor from its ServeConfig.
            from cake_tpu_torch.runtime.client import HeartbeatMonitor

            step = generator.step
            if step.clients:
                HeartbeatMonitor(
                    {n: c.host for n, c in step.clients.items()},
                    interval_s=args.heartbeat_interval, deadline_s=args.heartbeat_deadline,
                ).start()
        host, port = _parse_address(args.api)
        ApiServer(generator, engine=engine, events_jsonl=args.events_jsonl,
                  trace_jsonl=args.trace_jsonl,
                  request_log=args.request_log).serve_forever(host, port)
        return 0
    if args.system_prompt:
        generator.add_message(Message.system(args.system_prompt))
    generator.add_message(Message.user(args.prompt))
    on_token = lambda t: print(t.text, end="", flush=True)  # noqa: E731
    if backend == "tcp":
        from cake_tpu_torch.runtime.master import Master

        Master(generator, sample_len=args.sample_len).generate(on_token=on_token)
    else:
        generator.generate(args.sample_len, on_token=on_token)
    print()
    return 0


def _tcp_generator(args, topology, sampling, kv_dtype, prefix_cache: bool):
    """The generator over a ``DistributedForwardStep``: the master holds
    the head and the ranges no node owns, one client per node."""
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import LlamaGenerator
    from cake_tpu_torch.models.llama.tokenizer import load_tokenizer
    from cake_tpu_torch.runtime.master import DistributedForwardStep

    config = LlamaConfig.from_model_dir(args.model)
    if args.fusion != "none":
        config = dataclasses.replace(config, fusion_impl=args.fusion)
    step = DistributedForwardStep(
        config, args.model, topology, dtype=DTYPES[args.dtype], max_seq_len=args.max_seq_len,
        kv_dtype=kv_dtype, op_deadline_s=args.op_deadline, op_retries=args.op_retries,
        reconnect_attempts=args.reconnect_attempts, reconnect_backoff_s=args.reconnect_backoff,
        device=args.device,
    )
    return LlamaGenerator(
        config, step, load_tokenizer(args.model), sampling, prefill_chunk=args.prefill_chunk,
        prefix_cache=prefix_cache, decode_chunk_size=args.decode_chunk,
    )


if __name__ == "__main__":
    sys.exit(main())
