"""Worker: serves its topology-assigned block ranges over the wire protocol
(port of ``cake_tpu/runtime/worker.py``).

A worker resolves its own topology entry by name (the first entry when the
name is absent), loads ONLY its block ranges (a replica member serves its
group primary's ranges), accepts master connections, answers the handshake
with its info and the measured latency, and serves FORWARD ops, one thread a
connection. Each range runs as one walk over its stacked layers on the
device, through the same kernels as the local path (models/llama/model.py
``blocks_forward``; the lockstep batch ops of models/llama/batch.py
``lockstep_range_ops`` for the engine's ``batch`` frames).

Replay sessions: a FORWARD carrying ``sid``/``seq`` is served from an
EPOCH-SCOPED SESSION that survives the connection, KV caches keyed by sid in
a bounded LRU, each remembering its last applied seq and the reply it sent.
A master that lost a reply reconnects and RESENDS the same (sid, seq): if
the op was applied the cached reply returns without re-executing it,
otherwise it executes now. A seq gap or an unknown session answers a coded
ERROR (``proto.ERR_BAD_SEQ`` / ``ERR_UNKNOWN_SESSION``), so the client
escalates to history replay (serialized path) or failure isolation (engine)
instead of spending retries. A sid-less FORWARD uses per-connection caches.

Activations cross the wire as raw bytes: bf16 as its 16-bit words (numpy
has no bf16), one device-to-host copy per direction (``torch_to_wire`` /
``wire_to_torch``). A STATS pull is answered with an ERROR frame: cluster
observability is a later item of ROADMAP.md queue A.

The fault plan's worker checkpoints (runtime/faults.py): ``worker.ping``
before a PING's answer (stall: a wedged worker, as the heartbeat monitor
sees one), ``worker.op`` before a FORWARD runs (stall; kill tears the
connection down mid-op and the sessions survive; crash drops every session
too, a process's death) and ``worker.reply`` before a reply's send (drop:
the op applied but the reply is lost; truncate; delay).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import select
import socket
import threading
import time
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from cake_tpu_torch import __version__
from cake_tpu_torch.device import resolve_device, upload
from cake_tpu_torch.models.llama import model as M
from cake_tpu_torch.models.llama.batch import lockstep_range_ops
from cake_tpu_torch.models.llama.cache import SEQ_MULTIPLE, KVCache, init_cache
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.ops.fuse import fuse_layer_tree, parse_fusion_spec
from cake_tpu_torch.ops.quant import QUANT_TYPES, quantize_layer_tree
from cake_tpu_torch.ops.rope import model_rope_tables
from cake_tpu_torch.parallel.topology import Topology
from cake_tpu_torch.runtime import faults, proto
from cake_tpu_torch.utils import metrics

log = logging.getLogger("cake_tpu_torch.worker")

NUM_OPS_TO_STATS = 5  # ops between the throughput log lines

# Replay sessions kept per worker; LRU-evicted beyond this (an evicted
# session answers ERR_UNKNOWN_SESSION, which clients recover from).
MAX_SESSIONS = 8

STATS_NOT_PORTED = (
    "STATS: cluster observability is not ported yet (ROADMAP.md queue A, cluster "
    "observability)"
)

_WIRE_TAGS = {torch.float32: "f32", torch.float16: "f16", torch.bfloat16: "bf16",
              torch.int32: "i32", torch.int8: "i8"}
_TORCH_OF_TAG = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.int16,
                 "i32": torch.int32, "i8": torch.int8}


def torch_to_wire(x: torch.Tensor) -> proto.WireTensor:
    """A tensor as wire bytes: one device-to-host copy, the payload a view
    of the host copy (bf16 as its 16-bit words)."""
    tag = _WIRE_TAGS[x.dtype]
    host = x.detach()
    if x.dtype == torch.bfloat16:
        host = host.view(torch.int16)
    arr = host.contiguous().cpu().numpy()
    return proto.WireTensor(data=arr.reshape(-1).view(np.uint8).data, dtype=tag,
                            shape=tuple(x.shape))


def wire_to_torch(t: proto.WireTensor, compute_dtype: torch.dtype,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """Wire bytes as a ``compute_dtype`` tensor on ``device``: bf16 words
    re-viewed, f32 into a bf16 compute dtype narrowed round-to-nearest-even
    on the host (half the upload), anything else cast on the device."""
    data = t.data
    if isinstance(data, memoryview) and data.readonly or isinstance(data, bytes):
        data = bytearray(data)  # torch.frombuffer wants a writable buffer
    if len(data) == 0:
        host = torch.empty(t.shape, dtype=_TORCH_OF_TAG[t.dtype])
    else:
        host = torch.frombuffer(data, dtype=_TORCH_OF_TAG[t.dtype]).reshape(t.shape)
    if t.dtype == "bf16":
        host = host.view(torch.bfloat16)
    if host.dtype == torch.float32 and compute_dtype == torch.bfloat16:
        host = host.to(torch.bfloat16)
    dev = torch.device(device)
    x = host.to(dev) if dev.type == "cuda" else host.clone()
    return x if x.dtype == compute_dtype else x.to(compute_dtype)


def range_layers(layers: dict, lo: int, hi: int) -> dict:
    """Views of layers [lo, hi) of a stacked layer tree (quantized leaves
    sliced component-wise): no copy."""
    out = {}
    for name, leaf in layers.items():
        if isinstance(leaf, QUANT_TYPES):
            out[name] = type(leaf)(leaf.w[lo:hi], leaf.scale[lo:hi])
        else:
            out[name] = leaf[lo:hi]
    return out


class _ConnectionTorn(Exception):
    """The fault plan tore this connection down (``worker.op`` kill/crash,
    ``worker.reply`` truncate): close it without a reply."""


class _Session:
    """One epoch's replayable state: KV caches and the last applied op.
    ``lock`` serializes ops of one session: a resend can arrive on a new
    connection while the old one's thread still executes that seq."""

    __slots__ = ("caches", "last_seq", "last_reply", "lock")

    def __init__(self, caches):
        self.caches = caches
        self.last_seq = -1
        self.last_reply: bytes | None = None
        self.lock = threading.Lock()


class Worker:
    """Block-range server bound to one topology node.

    From a checkpoint directory (``model_dir``), or, with ``config`` and
    ``params`` (a full stacked tree already on the device, the test and
    chip_smoke seam), from views of those tensors: nothing is read or
    copied."""

    def __init__(
        self,
        name: str,
        model_dir: str | Path | None,
        topology: Topology,
        address: tuple[str, int],
        *,
        dtype: torch.dtype = torch.bfloat16,
        max_seq_len: int | None = None,
        fusion_impl: str | None = None,
        quantize: str | None = None,
        kv_dtype: torch.dtype | None = None,
        io_timeout_s: float = 120.0,
        device: torch.device | str | None = None,
        config: LlamaConfig | None = None,
        params: dict | None = None,
    ):
        if (params is None) == (model_dir is None):
            raise ValueError("Worker takes a model_dir or (config, params), not both")
        if params is not None and config is None:
            raise ValueError("Worker(params=...) needs its config")
        self.device = resolve_device(device)
        if config is None:
            config = LlamaConfig.from_model_dir(model_dir)
        if fusion_impl not in (None, "none"):
            parse_fusion_spec(fusion_impl)  # raises on a malformed spec
            config = dataclasses.replace(config, fusion_impl=fusion_impl)
        self.config = config
        if name not in topology.nodes and topology.nodes:
            fallback = next(iter(topology.nodes))
            log.warning("worker name %r not in topology, using %r", name, fallback)
            name = fallback
        self.name = name
        self.dtype = dtype
        self.kv_dtype = dtype if kv_dtype is None else kv_dtype
        self._max_seq = int(max_seq_len or config.max_position_embeddings)

        plan = topology.stage_plan(config.num_hidden_layers)
        # A replica member serves its group PRIMARY's plan ranges, so the
        # master's router can swap members freely.
        groups = topology.replica_groups()
        primary = next((p for p, members in groups.items() if name in members), name)
        self.ranges = [(s.lo, s.hi) for s in plan if s.node == primary]
        if not self.ranges:
            raise ValueError(f"topology assigns no layers to worker {name!r}")
        if quantize not in (None, "int8", "int4"):
            raise ValueError(f"unknown quantize mode {quantize!r}")

        t0 = time.perf_counter()
        if params is not None:
            layers = fuse_layer_tree(params["layers"])
            self.range_params = {r: range_layers(layers, *r) for r in self.ranges}
        else:
            from cake_tpu_torch.io.safetensors_io import load_params

            self.range_params = {
                (lo, hi): load_params(model_dir, config, dtype, self.device,
                                      layer_range=(lo, hi), head=False)["layers"]
                for lo, hi in self.ranges
            }
        if quantize:
            # Weight-only int8/int4 on this worker's own ranges; the wire
            # activations stay full dtype.
            self.range_params = {
                r: quantize_layer_tree(p, quantize) for r, p in self.range_params.items()
            }
        log.info("worker %s loaded layers %s in %.2fs", name, self.ranges,
                 time.perf_counter() - t0)
        padded = -(-self._max_seq // SEQ_MULTIPLE) * SEQ_MULTIPLE  # the caches' length
        self._rope = model_rope_tables(config, padded, self.device)
        self._bprefill, self._bdecode, self._bjoin = lockstep_range_ops(config, self._rope)

        self._sock = socket.create_server(address, reuse_port=False)
        self.address = self._sock.getsockname()
        # Mid-frame IO deadline; idle waits between frames are exempt.
        self.io_timeout_s = io_timeout_s
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        self._sessions: OrderedDict[str, _Session] = OrderedDict()
        self._sessions_lock = threading.Lock()
        # One op on the device at a time across connections: the kernel
        # wrappers' lazy buffers and counters are process state.
        self._exec_lock = threading.Lock()
        self.ops = 0
        self.replays = 0

    # ------------------------------------------------------------- caches

    def _fresh_caches(self, batch: int) -> dict[tuple[int, int], KVCache]:
        """KV state for every owned range at ``batch`` rows."""
        c = self.config
        return {
            (lo, hi): init_cache(hi - lo, batch, self._max_seq,
                                 c.num_key_value_heads, c.head_dim, self.kv_dtype, self.device)
            for lo, hi in self.ranges
        }

    # ------------------------------------------------------------ sessions

    def _session(self, sid: str, seq: int) -> _Session | None:
        """The replay session for ``sid``, created at seq 0. None = unknown
        at seq > 0: the state this op depends on is gone."""
        with self._sessions_lock:
            sess = self._sessions.get(sid)
            if sess is not None:
                self._sessions.move_to_end(sid)
                return sess
            if seq != 0:
                return None
            # Caches are made by the first op (its batch size is the frame's).
            sess = self._sessions[sid] = _Session(None)
            while len(self._sessions) > MAX_SESSIONS:
                evicted, _ = self._sessions.popitem(last=False)
                log.info("session %s evicted (LRU, cap %d)", evicted, MAX_SESSIONS)
            return sess

    def _drop_session(self, sid: str) -> None:
        with self._sessions_lock:
            self._sessions.pop(sid, None)

    # ------------------------------------------------------------- serving

    def serve_forever(self) -> None:
        log.info("worker %s listening on %s", self.name, self.address)
        self._sock.settimeout(0.5)
        while not self._stop.is_set():
            try:
                conn, peer = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            # Register before spawning: stop() must see every accepted socket.
            with self._conns_lock:
                self._conns.add(conn)
            if self._stop.is_set():
                try:
                    conn.close()
                except OSError:
                    pass
                break
            t = threading.Thread(target=self._serve_connection, args=(conn, peer), daemon=True)
            t.start()
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def start(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        self._serve_thread = t
        t.start()
        return t

    def stop(self) -> None:
        """Stop accepting, close every connection (unblocking its thread)
        and join the threads (bounded)."""
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        serve_t = getattr(self, "_serve_thread", None)
        if serve_t is not None and serve_t is not threading.current_thread():
            serve_t.join(timeout=5.0)
        for t in self._threads:
            if t.is_alive() and t is not threading.current_thread():
                t.join(timeout=5.0)
        with self._sessions_lock:
            self._sessions.clear()

    def _worker_info(self, latency_ms: float) -> proto.WorkerInfo:
        on_card = self.device.type == "cuda"
        return proto.WorkerInfo(
            dtype={torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}[self.dtype],
            device="gpu" if on_card else "cpu",
            device_count=torch.cuda.device_count() if on_card else 1,
            latency_ms=latency_ms,
            ranges=[list(r) for r in self.ranges],
            batch_ops=True,    # understands the FORWARD ``batch`` header
            verify_ops=False,  # speculative verify: ROADMAP.md queue A
            stats_ops=False,   # cluster observability: ROADMAP.md queue A
        )

    def _serve_connection(self, conn: socket.socket, peer) -> None:
        # inference_mode and the current card are thread-local.
        on_card = self.device.type == "cuda"
        with torch.inference_mode(), (torch.cuda.device(self.device) if on_card
                                      else contextlib.nullcontext()):
            self._serve_connection_body(conn, peer)

    def _serve_connection_body(self, conn: socket.socket, peer) -> None:
        log.info("connection from %s", peer)
        conn.settimeout(self.io_timeout_s)
        caches = None  # per-connection KV, made by the first sid-less FORWARD
        ops = read_bytes = write_bytes = 0
        window_start = time.perf_counter()
        try:
            with conn:
                t0 = time.perf_counter()
                try:
                    first = proto.read_frame(conn)
                except (ConnectionError, TimeoutError, OSError, ValueError):
                    return  # a probe that closed, or a peer not speaking the protocol
                latency_ms = (time.perf_counter() - t0) * 1e3
                if first.type != proto.MsgType.HELLO:
                    proto.write_frame(conn, proto.error_frame("expected HELLO"))
                    return
                peer_version = first.header.get("version", "?")
                if peer_version != __version__:
                    log.warning("master version %s != worker version %s", peer_version,
                                __version__)
                proto.write_frame(conn, proto.worker_info_frame(self._worker_info(latency_ms)))

                while not self._stop.is_set():
                    # Idle wait outside the frame read, so io_timeout_s only
                    # measures mid-frame progress.
                    ready, _, _ = select.select([conn], [], [], 0.5)
                    if not ready:
                        continue
                    try:
                        frame = proto.read_frame(conn)
                    except (ConnectionError, TimeoutError, OSError, ValueError):
                        break
                    if frame.type == proto.MsgType.RESET:
                        sid = frame.header.get("sid")
                        if sid is None:
                            caches = None
                        else:
                            self._drop_session(sid)
                        continue
                    if frame.type == proto.MsgType.PING:
                        spec = faults.check("worker.ping", node=self.name)
                        if spec is not None and spec.kind == "stall":
                            faults.sleep(spec)
                        try:
                            proto.write_frame(conn, proto.ping_frame(t=time.time()))
                        except OSError:
                            break  # the prober gave up on a stalled answer and left
                        continue
                    if frame.type == proto.MsgType.STATS:
                        proto.write_frame(conn, proto.error_frame(STATS_NOT_PORTED))
                        continue
                    if frame.type != proto.MsgType.FORWARD:
                        proto.write_frame(conn,
                                          proto.error_frame(f"unexpected {frame.type.name}"))
                        continue
                    read_bytes += len(frame.payload)
                    try:
                        spec = faults.check("worker.op", node=self.name)
                        if spec is not None:
                            if spec.kind == "stall":
                                faults.sleep(spec)
                            elif spec.kind in ("kill", "crash"):
                                if spec.kind == "crash":
                                    # A process's death: the replay state is
                                    # gone too, not just the transport.
                                    with self._sessions_lock:
                                        self._sessions.clear()
                                raise _ConnectionTorn()
                        caches, out_bytes, served = self._serve_forward(frame, caches, conn)
                    except _ConnectionTorn:
                        break  # the fault plan: die mid-op, no reply
                    except (ConnectionError, OSError):
                        break  # the peer went away while we replied
                    except Exception as e:  # a structured error; the connection stays
                        log.exception("forward failed")
                        proto.write_frame(conn, proto.error_frame(str(e)))
                        continue
                    if not served:
                        continue
                    write_bytes += out_bytes
                    ops += 1
                    if ops % NUM_OPS_TO_STATS == 0:
                        dt = time.perf_counter() - window_start
                        log.debug("%s: %.1f ops/s, read %.1f KiB/s, write %.1f KiB/s", peer,
                                  NUM_OPS_TO_STATS / dt, read_bytes / dt / 1024,
                                  write_bytes / dt / 1024)
                        read_bytes = write_bytes = 0
                        window_start = time.perf_counter()
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            log.info("connection from %s closed", peer)

    def _serve_forward(self, frame, caches, conn):
        """One FORWARD through session replay or the per-connection caches.
        Returns (caches, bytes written, served); served False = answered
        from replay state or with a coded error (no fresh op ran)."""
        sid = frame.header.get("sid")
        if sid is None:
            out, caches = self._execute(frame, caches)
            data = proto.encode_frame(proto.tensor_frame(out, trace=frame.header.get("trace")))
            return caches, self._send_reply(conn, data), True
        seq = int(frame.header.get("seq", 0))
        sess = self._session(sid, seq)
        if sess is None:
            proto.write_frame(conn, proto.error_frame(
                f"session {sid!r} unknown at seq {seq} (restarted or evicted); state must be "
                "rebuilt", code=proto.ERR_UNKNOWN_SESSION,
            ))
            return caches, 0, False
        with sess.lock:
            if seq == sess.last_seq and sess.last_reply is not None:
                # The op already applied and only its reply was lost: answer
                # from the cache; the KV writes must not happen twice.
                self.replays += 1
                metrics.registry.counter(
                    "cake_worker_replays_total",
                    "FORWARD ops answered from the session replay cache (duplicate sid/seq "
                    "after a reconnect).",
                ).inc(node=self.name)
                conn.sendall(sess.last_reply)
                return caches, len(sess.last_reply), False
            if seq != sess.last_seq + 1:
                proto.write_frame(conn, proto.error_frame(
                    f"seq {seq} does not follow applied seq {sess.last_seq} for session {sid!r}",
                    code=proto.ERR_BAD_SEQ,
                ))
                return caches, 0, False
            out, sess.caches = self._execute(frame, sess.caches)
            data = proto.encode_frame(proto.tensor_frame(out, trace=frame.header.get("trace")))
            # Commit replay state BEFORE the send: a resend must find it.
            sess.last_seq, sess.last_reply = seq, data
        return caches, self._send_reply(conn, data), True

    def _send_reply(self, conn: socket.socket, data: bytes) -> int:
        """Send an encoded reply frame through the ``worker.reply`` fault
        checkpoint (drop: never sent, the op applied and the reply lost;
        truncate: part of the frame, then the connection torn; delay)."""
        spec = faults.check("worker.reply", node=self.name)
        if spec is not None:
            if spec.kind == "drop":
                return 0
            if spec.kind == "truncate":
                conn.sendall(data[: max(1, int(len(data) * spec.frac))])
                raise _ConnectionTorn()
            if spec.kind == "delay":
                faults.sleep(spec)
        conn.sendall(data)
        return len(data)

    def _execute(self, frame, caches):
        """Run one FORWARD op; returns (out WireTensor, caches)."""
        ranges = [tuple(r) for r in frame.header["ranges"]]
        for r in ranges:
            if r not in self.range_params:
                raise ValueError(f"range {r} not owned (have {self.ranges})")
        pos = int(frame.header["pos"])
        with self._exec_lock:
            x = wire_to_torch(frame.tensor(), self.dtype, self.device)
            if "batch" in frame.header:
                x, caches = self._forward_batch(frame.header["batch"], ranges, pos, x, caches)
            else:
                x, caches = self._forward_stream(ranges, pos, x, caches)
            out = torch_to_wire(x)
            self.ops += 1
        return out, caches

    def _forward_stream(self, ranges, pos: int, x, caches):
        """The single-stream layout: pad-free rows at one position. A new
        sequence (pos 0) at another batch size re-makes the caches."""
        if caches is None:
            caches = self._fresh_caches(batch=int(x.shape[0]))
        cache_batch = next(iter(caches.values())).batch_size
        if x.shape[0] != cache_batch:
            if pos != 0:
                raise ValueError(
                    f"batch changed mid-sequence: cache has {cache_batch} rows, activation has "
                    f"{x.shape[0]} (pos={pos}); RESET or restart at pos 0 first"
                )
            caches = self._fresh_caches(batch=int(x.shape[0]))
        cached = M.is_cached_prefill(pos, x.shape[1])
        for r in ranges:
            x, caches[r] = M.blocks_forward(
                self.range_params[r], x, caches[r], *self._rope, pos, self.config,
                cached_prefill=cached,
            )
        return x, caches

    def _forward_batch(self, b: dict, ranges, pos: int, x, caches):
        """A lockstep batch op: "prefill" (pos 0, fresh caches at the
        frame's rows), "decode" (one token at slot == pos) or "join" (one
        row into ``lane``)."""
        kind = b["kind"]
        pads = upload(np.asarray(b["pads"], np.int32), self.device)
        if kind == "prefill":
            caches = self._fresh_caches(batch=int(x.shape[0]))
        elif caches is None:
            raise ValueError(f"batch {kind} before the epoch's prefill")
        else:
            cache_batch = next(iter(caches.values())).batch_size
            if kind == "join":
                if int(x.shape[0]) != 1:
                    raise ValueError(f"join expects a single row, got {int(x.shape[0])}")
                if int(b["lane"]) >= cache_batch:
                    raise ValueError(f"join lane {b['lane']} out of range for batch {cache_batch}")
            elif kind == "decode" and int(x.shape[0]) != cache_batch:
                raise ValueError(f"batch decode with {int(x.shape[0])} rows against "
                                 f"{cache_batch}-row caches; prefill the epoch first")
        if kind in ("prefill", "join"):
            ends = upload(np.asarray(b["ends"], np.int32), self.device)
        for r in ranges:
            layers = self.range_params[r]
            if kind == "prefill":
                x, caches[r] = self._bprefill(layers, x, caches[r], pads, ends)
            elif kind == "decode":
                x, caches[r] = self._bdecode(layers, x, caches[r], pads, pos)
            elif kind == "join":
                x, caches[r] = self._bjoin(layers, x, caches[r], pads, ends, int(b["lane"]))
            else:
                raise ValueError(f"unknown batch kind {kind!r} (speculative verify over TCP "
                                 "is not ported yet, ROADMAP.md queue A)")
        return x, caches
