"""Master-side proxy for a remote worker (port of
``cake_tpu/runtime/client.py``, ``SessionLost`` and ``StageClient``).

One connection per WORKER: all of a node's contiguous ranges ride one
socket, and a multi-range request is one round trip. Every round trip runs
under a per-op deadline (the socket timeout). With a session active
(``begin_session``) a failed round trip is retried with bounded backoff by
re-dialing and RESENDING the same (sid, seq) frame, which the worker answers
idempotently (runtime/worker.py sessions). Without a session a resend would
apply KV writes twice, so the first failure raises.

``round_trips``, ``tx_bytes`` and ``rx_bytes`` count the client's forwards
and their payload bytes (frame prefix and header excluded). The fault plan's
``client.send`` and ``client.recv`` checkpoints (runtime/faults.py) sit in
front of each FORWARD's send and its reply's read.

``HeartbeatMonitor`` probes every worker's liveness over connections of its
own (the reference's, liveness only: the STATS pull and the clock-offset
feed of the cluster observer wait for the worker's STATS, ROADMAP.md queue
A, and the port's workers advertise ``stats_ops=False``).
"""

from __future__ import annotations

import logging
import socket
import threading
import time

from cake_tpu_torch.obs.timeline import timeline
from cake_tpu_torch.runtime import faults, proto
from cake_tpu_torch.utils import metrics

log = logging.getLogger("cake_tpu_torch.client")


def parse_address(addr: str, *, default_host: str = "0.0.0.0", what: str = "address"
                  ) -> tuple[str, int]:
    """``host:port`` -> (host, port), with an error naming the bad field."""
    host, _, port = addr.rpartition(":")
    if not port.isdigit():
        raise ValueError(f"{what} {addr!r} must be of the form host:port (missing or "
                         "non-numeric port)")
    return host or default_host, int(port)


class SessionLost(ConnectionError):
    """The worker no longer holds this session's state (a coded ERROR reply:
    restarted, evicted, or a sequence gap). A resend cannot succeed; the
    caller rebuilds state (the generator's history replay, the engine's
    failure isolation)."""

    def __init__(self, node: str, code: str, message: str):
        super().__init__(f"worker {node}: {code}: {message}")
        self.node = node
        self.code = code


class StageClient:
    """Connects to one worker and forwards activations through its ranges."""

    def __init__(
        self,
        host: str,
        node_name: str,
        timeout: float = 30.0,
        *,
        op_deadline_s: float | None = None,
        op_retries: int = 2,
        reconnect_attempts: int = 3,
        reconnect_backoff_s: float = 0.5,
    ):
        self.node_name = node_name
        self.host = host
        self._timeout = timeout
        self.op_deadline_s = timeout if op_deadline_s is None else op_deadline_s
        self.op_retries = max(0, op_retries)
        self.reconnect_attempts = max(1, reconnect_attempts)
        self.reconnect_backoff_s = reconnect_backoff_s
        self.sid: str | None = None  # replay session riding every FORWARD
        self._seq = 0
        self.round_trips = 0
        self.tx_bytes = 0
        self.rx_bytes = 0
        self._connect()

    def _connect(self) -> None:
        addr_host, addr_port = parse_address(
            self.host, what=f"topology host for node {self.node_name!r}"
        )
        t0 = time.perf_counter()
        self._sock = socket.create_connection((addr_host, addr_port), timeout=self._timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(self.op_deadline_s)
        proto.write_frame(self._sock, proto.hello_frame())
        reply = proto.read_frame(self._sock)
        if reply.type != proto.MsgType.WORKER_INFO:
            raise ConnectionError(
                f"worker {self.node_name} handshake failed: got {reply.type.name}"
            )
        self.info = proto.WorkerInfo.from_dict(reply.header["info"])
        self.handshake_ms = (time.perf_counter() - t0) * 1e3
        log.info(
            "connected to %s (%s): device=%s dtype=%s ranges=%s in %.1fms",
            self.node_name, self.host, self.info.device, self.info.dtype, self.info.ranges,
            self.handshake_ms,
        )

    # ------------------------------------------------------------- sessions

    def begin_session(self, sid: str) -> None:
        """Start a fresh replay session: later forwards carry increasing seq
        under ``sid`` and become retry-safe."""
        self.sid = sid
        self._seq = 0

    def configure(
        self,
        *,
        op_deadline_s: float | None = None,
        op_retries: int | None = None,
        reconnect_attempts: int | None = None,
        reconnect_backoff_s: float | None = None,
    ) -> None:
        """Apply the wire-resilience knobs to a live client; the deadline
        takes effect on the current socket at once."""
        if op_deadline_s is not None:
            self.op_deadline_s = op_deadline_s
            self._sock.settimeout(op_deadline_s)
        if op_retries is not None:
            self.op_retries = max(0, op_retries)
        if reconnect_attempts is not None:
            self.reconnect_attempts = max(1, reconnect_attempts)
        if reconnect_backoff_s is not None:
            self.reconnect_backoff_s = reconnect_backoff_s

    def reconnect(self, attempts: int | None = None, backoff_s: float | None = None) -> None:
        """Re-dial with bounded exponential backoff (no sleep after the last
        failed attempt). Without a session a fresh connection means fresh
        worker-side KV; with one, the worker's state survives by sid."""
        attempts = self.reconnect_attempts if attempts is None else attempts
        backoff_s = self.reconnect_backoff_s if backoff_s is None else backoff_s
        self.close()
        last: Exception | None = None
        for i in range(attempts):
            try:
                self._connect()
                return
            except OSError as e:
                last = e
                log.warning("reconnect to %s failed (attempt %d/%d): %s",
                            self.node_name, i + 1, attempts, e)
                if i + 1 < attempts:
                    time.sleep(backoff_s * (2**i))
        raise ConnectionError(f"could not reconnect to worker {self.node_name}") from last

    def forward(
        self,
        x: proto.WireTensor,
        ranges: list[tuple[int, int]],
        pos: int,
        batch: dict | None = None,
        trace: str | None = None,
    ) -> proto.WireTensor:
        """One round trip: run ``x`` through the worker's owned ranges.
        ``batch`` selects the lockstep layout (proto.forward_frame);
        ``trace`` rides the header. With a session, a deadline or connection
        failure re-dials and resends the same (sid, seq) up to
        ``op_retries`` times; without one the first failure raises."""
        seq: int | None = None
        if self.sid is not None:
            seq = self._seq
            self._seq += 1
        retries = self.op_retries if seq is not None else 0
        for attempt in range(retries + 1):
            try:
                return self._round_trip(x, ranges, pos, batch, trace, seq)
            except SessionLost:
                raise
            except (ConnectionError, TimeoutError, OSError) as e:
                if attempt >= retries:
                    raise
                log.warning("op to %s failed (attempt %d/%d, seq=%s): %s; reconnecting for an "
                            "idempotent resend", self.node_name, attempt + 1, retries + 1, seq, e)
                metrics.registry.counter(
                    "cake_op_retries_total",
                    "FORWARD round trips resent after a deadline or connection failure "
                    "(session replay path).",
                ).inc(node=self.node_name)
                metrics.flight.record("op-retry", trace, node=self.node_name, seq=seq,
                                      error=str(e)[:200])
                # Never reuse the socket: a late reply to the timed-out op
                # would desync the request/reply stream.
                self.reconnect()
        raise AssertionError("unreachable")

    def _round_trip(self, x, ranges, pos, batch, trace, seq):
        frame = proto.forward_frame(
            x, ranges, pos, batch=batch, trace=trace,
            sid=self.sid if seq is not None else None, seq=seq,
        )
        spec = faults.check("client.send", node=self.node_name)
        if spec is not None and spec.kind == "drop":
            pass  # the frame is "lost on the wire": the reply read times out
        elif spec is not None and spec.kind == "kill":
            # The worker is unreachable from this client: the op never
            # leaves and the socket is torn down. With ``count=0`` and a
            # node the worker stays dead through every retry and reconnect,
            # the deterministic stand-in for a vanished host that drives
            # replica failover (runtime/router.py).
            self.close()
            raise ConnectionError("fault: connection killed pre-send")
        elif spec is not None and spec.kind == "truncate":
            data = proto.encode_frame(frame)
            self._sock.sendall(data[: max(1, int(len(data) * spec.frac))])
            raise ConnectionError("fault: frame truncated mid-send")
        else:
            if spec is not None and spec.kind == "delay":
                faults.sleep(spec)
            proto.write_frame(self._sock, frame)
        spec = faults.check("client.recv", node=self.node_name)
        if spec is not None and spec.kind == "delay":
            faults.sleep(spec)
        reply = proto.read_frame(self._sock)
        self.round_trips += 1
        self.tx_bytes += len(x.data)
        self.rx_bytes += len(reply.payload)
        if reply.type == proto.MsgType.ERROR:
            code = reply.header.get("code")
            if code in (proto.ERR_UNKNOWN_SESSION, proto.ERR_BAD_SEQ):
                raise SessionLost(self.node_name, code, reply.header["error"])
            raise RuntimeError(f"worker {self.node_name}: {reply.header['error']}")
        if reply.type != proto.MsgType.TENSOR:
            raise ConnectionError(f"unexpected reply {reply.type.name}")
        return reply.tensor()

    def reset(self) -> None:
        """Drop worker-side sequence state: with a session, retire the
        current sid (callers then begin a fresh one)."""
        proto.write_frame(self._sock, proto.reset_frame(sid=self.sid))

    def ping(self) -> float:
        t0 = time.perf_counter()
        proto.write_frame(self._sock, proto.ping_frame())
        reply = proto.read_frame(self._sock)
        if reply.type != proto.MsgType.PING:
            raise ConnectionError(f"unexpected ping reply {reply.type.name}")
        return (time.perf_counter() - t0) * 1e3

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class HeartbeatMonitor:
    """Per-worker liveness probing over dedicated PING connections (the
    reference's ``HeartbeatMonitor``, liveness only).

    One daemon thread a worker dials its OWN connection (the op socket is
    strictly request-reply: a concurrent PING would interleave frames) and
    pings every ``interval_s`` under a ``deadline_s`` socket timeout. A
    probe that fails or times out marks the node unhealthy within
    ``interval_s + deadline_s`` of the stall's start:

      * gauge ``cake_worker_healthy{node}``: 1/0 liveness
      * counter ``cake_worker_unhealthy_total{node}``: transitions to down
      * histogram ``cake_worker_ping_seconds{node}``: probe round trip
      * flight events ``worker-unhealthy`` / ``worker-healthy`` and a
        timeline instant a transition.

    The monitor only observes: routing and failover decisions belong to the
    caller (``healthy()``, ``snapshot()``; runtime/router.py)."""

    def __init__(self, hosts: dict[str, str], *, interval_s: float = 2.0,
                 deadline_s: float = 2.0):
        self.hosts = dict(hosts)
        self.interval_s = interval_s
        self.deadline_s = deadline_s
        self._lock = threading.Lock()
        self._healthy: dict[str, bool | None] = {n: None for n in self.hosts}
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    def start(self) -> "HeartbeatMonitor":
        for node, host in self.hosts.items():
            t = threading.Thread(target=self._probe_loop, args=(node, host),
                                 name=f"heartbeat-{node}", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=self.deadline_s + 1.0)
        self._threads = []

    def healthy(self, node: str) -> bool:
        """True until a probe has FAILED: an unprobed worker is presumed
        live (the monitor exists to notice deaths, not to gate startup)."""
        with self._lock:
            return self._healthy.get(node) is not False

    def snapshot(self) -> dict[str, bool | None]:
        with self._lock:
            return dict(self._healthy)

    def _dial(self, host: str, node: str) -> socket.socket:
        addr_host, addr_port = parse_address(host, what=f"heartbeat host for node {node!r}")
        sock = socket.create_connection((addr_host, addr_port), timeout=self.deadline_s)
        try:
            proto.write_frame(sock, proto.hello_frame())
            reply = proto.read_frame(sock)
            if reply.type != proto.MsgType.WORKER_INFO:
                raise ConnectionError(f"heartbeat handshake to {node} got {reply.type.name}")
        except BaseException:
            sock.close()
            raise
        return sock

    def _probe_loop(self, node: str, host: str) -> None:
        sock: socket.socket | None = None
        while not self._stop.is_set():
            try:
                if sock is None:
                    sock = self._dial(host, node)
                t0 = time.perf_counter()
                proto.write_frame(sock, proto.ping_frame())
                reply = proto.read_frame(sock)
                if reply.type != proto.MsgType.PING:
                    raise ConnectionError(f"heartbeat reply {reply.type.name}")
                metrics.registry.histogram(
                    "cake_worker_ping_seconds", "Heartbeat PING round-trip time per worker.",
                ).observe(time.perf_counter() - t0, node=node)
                self._mark(node, True)
            except (ConnectionError, TimeoutError, OSError, ValueError):
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    sock = None
                self._mark(node, False)
            self._stop.wait(self.interval_s)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _mark(self, node: str, ok: bool) -> None:
        with self._lock:
            prev = self._healthy.get(node)
            self._healthy[node] = ok
        metrics.registry.gauge(
            "cake_worker_healthy", "Heartbeat liveness per worker (1 = answering PING in time).",
        ).set(1 if ok else 0, node=node)
        # Only transitions get counters and events (the gauge tracks the
        # level), so the flight ring is not flooded at probe cadence.
        if not ok and prev is not False:
            metrics.registry.counter(
                "cake_worker_unhealthy_total", "Heartbeat transitions to unhealthy per worker.",
            ).inc(node=node)
            metrics.flight.record("worker-unhealthy", node=node)
            timeline.instant("worker-unhealthy", track="health", args={"node": node})
            log.warning("worker %s marked UNHEALTHY (heartbeat)", node)
        elif ok and prev is False:
            metrics.flight.record("worker-healthy", node=node)
            timeline.instant("worker-healthy", track="health", args={"node": node})
            log.info("worker %s healthy again (heartbeat)", node)
